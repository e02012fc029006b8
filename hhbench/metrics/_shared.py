"""What several readers compute alike."""

from __future__ import annotations

# The divided attention's kernels by name: the program's K1/K2 (one
# symbol for both modes) and K6, in bf16 and f32, and PyTorch's SDPA,
# flash and memory-efficient attention kernels, which compute the same op.
ATTENTION_KERNELS = (
    "attention_bf16_kernel", "attention_f32_kernel", "headgrid_bf16_kernel", "headgrid_f32_kernel",
    "flash_fwd", "fmha_", "efficient_attention", "pytorch_flash", "_sdpa",
)


def is_attention(name: str) -> bool:
    return any(k in name for k in ATTENTION_KERNELS)


def idle_share(run):
    """Percent of the traced window with no device operation running."""
    tr = run.trace_data
    if tr is None or tr.window_s <= 0 or not tr.device:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)


def mfu(run, flops_per_item: float):
    """Percent of the tower type's dense peak of the cell's chips that the
    window's items reach: items x FLOPs an item / window seconds / peak."""
    if not run.window_s or not run.items:
        return None
    peak = run.peaks()[run.cfg["precision"]["visual"]] * run.cell.chips
    return 100.0 * run.items * flops_per_item / run.window_s / peak


def attn_roofline(run):
    """Percent: the divided attention's least time for the traced clips
    (``counts.attention``) over the device time of the attention kernels
    in the trace; None without them."""
    from hhbench.counts.attention import ELEMENT_BYTES, tower_least_seconds_per_clip

    tr = run.trace_data
    if tr is None or not run.traced_items or run.cfg["precision"]["visual"] not in ELEMENT_BYTES:
        return None
    seconds = tr.device_seconds(is_attention)
    if not seconds:
        return None
    least = tower_least_seconds_per_clip(run.cfg["visual"], run.cfg["precision"]["visual"], run.peaks())
    return 100.0 * least * run.traced_items / seconds
