"""Divided space-time attention on packed qkv, with its CUDA kernel.

Counterpart of ``helping_hand_for_egocentric_videos_tpu/ops/divided_attention.py``.
The patch queries of one group attend over [CLS key | the group's patch
keys]; a group is one frame (``mode="space"``) or one patch tube across
the frames (``mode="time"``). The CLS query, which attends over the whole
``1 + T*N`` sequence, is assembled from per-group streaming-softmax
partials by ``merge_cls_partials``.

Three things live here:

- ``divided_patch_attention_ref``: the plain PyTorch version. The CPU
  tests compare it with the JAX kernel, and ``chip_smoke.py`` compares the
  CUDA kernel with it on the card.
- ``merge_cls_partials``: joins the partials of any number of groups with
  the CLS self term.
- ``divided_patch_attention``: the wrapper. A CUDA tensor goes to the
  kernel in ``csrc/divided_attention.cu`` (or the call raises); a CPU
  tensor goes to the plain version. Its launches are counted per mode in
  the integer attributes ``launches_space`` and ``launches_time`` (K1,
  K2), and, with ``quant_out=True`` (K3: the output quantized per token to
  int8 for the int8 projection), ``launches_space_quant`` and
  ``launches_time_quant``. Time attention on long clips (``head_grid``,
  K6) goes to ``csrc/divided_attention_long.cu`` and is counted in
  ``launches_time_headgrid``; its plain version is
  ``time_attention_headgrid_ref``.

The kernels have no backward (nor have the JAX package's Pallas kernels:
its backbone is frozen), so on a CUDA tensor the wrapper raises where
grad mode is on and an input requires grad, rather than cut the graph
silently; the plain version on a CPU tensor is differentiable as it is.

Time attention's route on long clips is the port's own choice. The JAX
package's ``divided_patch_attention`` takes ``head_grid`` but never reads
it, and nothing there calls ``needs_head_grid`` or
``_time_attention_headgrid``: its ``_block`` sends time attention at
T = 128 (where ``_kernel_friendly`` fails it) to XLA's plain
``_var_attention``. The port sends the same shapes to K6 instead, which
computes the same function; it keeps the JAX package's TPU thresholds
(``_temporal_block``, ``_scoped_vmem_ask``, ``_VMEM_LIMIT``,
``needs_head_grid``, copied with their numbers) to draw that line where
JAX leaves its kernel, so the int8 path rounds where its JAX counterpart
does (unfused time attention at T = 128). The thresholds say nothing
about the card's memory: on an H100 K2 and K6 each take every T up to
their limits; which of them is faster at which T is measured in PERF.md
(section 5, ``tools/torch_longclip_bench.py``).
"""

from __future__ import annotations

import ctypes

import torch

from ._build import library
from .act_quant import MAX_WIDTH, check_no_grad, quantize_rows_ref

__all__ = [
    "divided_patch_attention",
    "divided_patch_attention_ref",
    "merge_cls_partials",
    "needs_head_grid",
    "time_attention_headgrid_ref",
]

_MODES = ("space", "time")
MAX_HEADGRID_T = 256  # K6 stages a tube's keys and values in shared memory
# the f32 route launches one block row a group in gridDim.z (csrc/divided_attention.cu)
MAX_F32_GROUPS = 65535

# the TPU's scoped-VMEM budget, as the JAX package states it (module docstring)
_VMEM_LIMIT = 100 * 1024 * 1024


def _scoped_vmem_ask(r: int, heads: int) -> int:
    """The JAX package's estimate of one TPU rows-kernel program's
    scoped-VMEM ask in bytes: an (R+1, R) f32 logits and exp pair per head."""
    return heads * 2 * (r + 1) * r * 4


def _temporal_block(t: int, n: int) -> int:
    """Tubes per TPU time tile (R = t * nb rows, aiming at 256), as the JAX
    package chooses them: a multiple of 8 dividing n, at least 8."""
    nb = min(max(256 // t, 8), n)
    nb -= nb % 8
    while nb > 8 and n % nb:
        nb -= 8
    if nb < 8 or n % nb:
        nb = 8 if n % 8 == 0 else n
    return max(nb, 1)


def needs_head_grid(t: int, n: int, heads: int) -> bool:
    """True where the JAX package's single-tile time kernel would overrun
    the TPU's VMEM budget, so that JAX's ``_block`` leaves its kernel for
    XLA's ``_var_attention``: T = 128 at TimeSformer-L widths (N = 256,
    H = 16). There the port takes its head-grid kernel (K6)."""
    r = t * _temporal_block(t, n)
    return _scoped_vmem_ask(r, heads) + 16 * 1024 * 1024 > _VMEM_LIMIT


def _groups(x, mode: str):
    """(B, T, N, H, dh) -> (B, G, H, W, dh): G groups of W rows."""
    return x.permute(0, 1, 3, 2, 4) if mode == "space" else x.permute(0, 2, 3, 1, 4)


def divided_patch_attention_ref(qkv, cls_k, cls_v, cls_q, *, mode: str, heads: int,
                                quant_out: bool = False):
    """Plain version, in f32 whatever the input type.

    Args:
        qkv: (B, T, N, 3D) packed [q|k|v] rows (q not scaled).
        cls_k, cls_v, cls_q: (B, D) the CLS token's key, value and query.
        quant_out: quantize each token's f32 output over all D channels
            (``quantize_rows_ref``) instead of casting it.
    Returns:
        (B, T, N, D) patch output in the type of ``qkv``, or with
        ``quant_out`` (codes int8 (B, T, N, D), scales f32 (B, T, N, 1));
        and the CLS query's partials (m, s, co) over each group's patch
        keys, with the CLS self logit excluded: (B, G, H, 1), (B, G, H, 1),
        (B, G, H, dh) f32, G = T (space) or N (time).
    """
    if mode not in _MODES:
        raise ValueError(f"mode must be one of {_MODES}, got {mode!r}")
    b, t, n, d3 = qkv.shape
    d = d3 // 3
    dh = d // heads
    scale = dh**-0.5
    q, k, v = (
        _groups(z, mode)
        for z in qkv.float().reshape(b, t, n, 3, heads, dh).unbind(3)
    )  # (B, G, H, W, dh)
    ck, cv, cq = (z.float().reshape(b, 1, heads, 1, dh) for z in (cls_k, cls_v, cls_q))

    logits = scale * (q @ k.transpose(-1, -2))  # (B, G, H, W, W)
    lc = scale * (q * ck).sum(-1, keepdim=True)  # CLS-key logit, (B, G, H, W, 1)
    mx = torch.maximum(logits.amax(-1, keepdim=True), lc)
    e_p = torch.exp(logits - mx)
    e_c = torch.exp(lc - mx)
    o = (e_p @ v + e_c * cv) / (e_p.sum(-1, keepdim=True) + e_c)
    o = o.permute(0, 1, 3, 2, 4) if mode == "space" else o.permute(0, 3, 1, 2, 4)
    o = o.reshape(b, t, n, d)
    out = quantize_rows_ref(o) if quant_out else o.to(qkv.dtype)

    lq = scale * (cq * k).sum(-1)  # CLS-query logits over the group, (B, G, H, W)
    pm = lq.amax(-1, keepdim=True)
    e = torch.exp(lq - pm)
    co = (e.unsqueeze(-2) @ v).squeeze(-2)  # (B, G, H, dh)
    return out, (pm, e.sum(-1, keepdim=True), co)


def time_attention_headgrid_ref(qkv, cls_k, cls_v, cls_q, *, heads: int):
    """Plain version of K6, the time attention with the head in the grid.

    The same function as ``divided_patch_attention_ref(mode="time")``, with
    K6's partial grouping: one group a tube, (B, N, H, 1|1|dh) f32. (The
    TPU kernel groups ``_temporal_block(T, N)`` tubes a tile; the merged
    CLS output is the same.)
    """
    return divided_patch_attention_ref(qkv, cls_k, cls_v, cls_q, mode="time", heads=heads)


def merge_cls_partials(m, s, co, cls_q, cls_k, cls_v, heads: int):
    """Combine per-group CLS partials with the CLS self-attention term.

    m/s (B, G, H, 1) f32, co (B, G, H, dh) f32, any G; cls_q/k/v (B, D)
    not scaled -> (B, D) f32 attention output of the CLS query over
    [cls | all patch tokens].
    """
    b = m.shape[0]
    m = m[..., 0]  # (B, G, H)
    s = s[..., 0]
    d = co.shape[-1] * heads
    dh = d // heads
    cqh, ckh, cvh = (z.reshape(b, heads, dh).float() for z in (cls_q, cls_k, cls_v))
    scale = dh**-0.5
    l_self = scale * (cqh * ckh).sum(-1)  # (B, H)

    m_g = torch.maximum(m.amax(1), l_self)  # (B, H)
    w = torch.exp(m - m_g[:, None, :])  # (B, G, H)
    e_self = torch.exp(l_self - m_g)
    denom = (s * w).sum(1) + e_self
    num = (co * w[..., None]).sum(1) + e_self[..., None] * cvh
    return (num / denom[..., None]).reshape(b, d)


def _check_cuda_args(qkv, cls_k, cls_v, cls_q, heads: int):
    if qkv.dim() != 4 or qkv.shape[-1] % (3 * heads):
        raise ValueError(f"qkv must be (B, T, N, 3D) with D divisible by heads, got {tuple(qkv.shape)}")
    if qkv.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"the kernel takes float32 or bfloat16, got {qkv.dtype}")
    b, _, _, d3 = qkv.shape
    dh = d3 // 3 // heads
    if dh not in (32, 64):
        raise ValueError(f"the kernel takes head dims 32 and 64, got {dh}")
    for name, z in (("qkv", qkv), ("cls_k", cls_k), ("cls_v", cls_v), ("cls_q", cls_q)):
        if z.device != qkv.device:
            raise ValueError(f"{name} is on {z.device}, qkv on {qkv.device}")
        if z.dtype != qkv.dtype:
            raise TypeError(f"{name} is {z.dtype}, qkv is {qkv.dtype}")
        if not z.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if z is not qkv and tuple(z.shape) != (b, d3 // 3):
            raise ValueError(f"{name} must be (B, D) = {(b, d3 // 3)}, got {tuple(z.shape)}")
    if qkv.data_ptr() % 16:  # the kernels copy its rows 16 bytes at a time
        raise ValueError("qkv must start on a 16-byte boundary")
    return dh


def check_f32_groups(b: int, t: int, n: int, mode: str):
    """Refuse a batch whose groups (B x T frames in space mode, B x N tubes
    in time mode) overflow the f32 route's grid, before the launch would."""
    groups = b * (t if mode == "space" else n)
    if groups > MAX_F32_GROUPS:
        unit = "frames" if mode == "space" else "patch tubes"
        raise ValueError(
            f"the f32 {mode} kernel takes at most {MAX_F32_GROUPS} groups (B x {unit}), got {b} x "
            f"{groups // b} = {groups}: split the batch into at most {MAX_F32_GROUPS // (groups // b)} clips"
        )


def _launch_kernel(qkv, cls_k, cls_v, cls_q, mode: str, heads: int, quant_out: bool):
    dh = _check_cuda_args(qkv, cls_k, cls_v, cls_q, heads)
    b, t, n, d3 = qkv.shape
    if qkv.dtype == torch.float32:
        check_f32_groups(b, t, n, mode)
    d = d3 // 3
    g = t if mode == "space" else n
    dev = qkv.device
    pm = torch.empty((b, g, heads, 1), dtype=torch.float32, device=dev)
    ps = torch.empty((b, g, heads, 1), dtype=torch.float32, device=dev)
    co = torch.empty((b, g, heads, dh), dtype=torch.float32, device=dev)
    lib = library("divided_attention")
    if quant_out:
        # K3: f32 rows in a scratch, then the row pass quantizes each token
        # over all heads (a block of the attention kernel holds one head)
        if d > MAX_WIDTH:
            raise ValueError(f"quant_out takes D <= {MAX_WIDTH}, got {d}")
        rows = torch.empty((b, t, n, d), dtype=torch.float32, device=dev)
        codes = torch.empty((b, t, n, d), dtype=torch.int8, device=dev)
        scales = torch.empty((b, t, n, 1), dtype=torch.float32, device=dev)
        fn, bufs, out = lib.hh_divided_attention_int8, (rows, codes, scales), (codes, scales)
    else:
        out = torch.empty((b, t, n, d), dtype=qkv.dtype, device=dev)
        fn, bufs = lib.hh_divided_attention, (out,)
    nptr = 4 + len(bufs) + 3
    fn.argtypes = [ctypes.c_void_p] * nptr + [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        rc = fn(
            qkv.data_ptr(), cls_q.data_ptr(), cls_k.data_ptr(), cls_v.data_ptr(),
            *(z.data_ptr() for z in bufs), pm.data_ptr(), ps.data_ptr(), co.data_ptr(),
            b, t, n, heads, dh, int(mode == "time"), int(qkv.dtype == torch.bfloat16),
            dh**-0.5, torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"divided_attention kernel launch failed: cudaError {rc}")
    return out, (pm, ps, co)


def _launch_headgrid(qkv, cls_k, cls_v, cls_q, heads: int):
    dh = _check_cuda_args(qkv, cls_k, cls_v, cls_q, heads)
    b, t, n, d3 = qkv.shape
    if t > MAX_HEADGRID_T:
        raise ValueError(f"the head-grid kernel takes T <= {MAX_HEADGRID_T}, got {t}")
    if any(z.data_ptr() % 16 for z in (cls_q, cls_k, cls_v)):  # copied like qkv's rows
        raise ValueError("the CLS rows must start on a 16-byte boundary")
    dev = qkv.device
    out = torch.empty((b, t, n, d3 // 3), dtype=qkv.dtype, device=dev)
    pm = torch.empty((b, n, heads, 1), dtype=torch.float32, device=dev)
    ps = torch.empty((b, n, heads, 1), dtype=torch.float32, device=dev)
    co = torch.empty((b, n, heads, dh), dtype=torch.float32, device=dev)
    fn = library("divided_attention_long").hh_time_attention_headgrid
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        rc = fn(
            qkv.data_ptr(), cls_q.data_ptr(), cls_k.data_ptr(), cls_v.data_ptr(),
            out.data_ptr(), pm.data_ptr(), ps.data_ptr(), co.data_ptr(),
            b, t, n, heads, dh, int(qkv.dtype == torch.bfloat16),
            dh**-0.5, torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"time_attention_headgrid kernel launch failed: cudaError {rc}")
    return out, (pm, ps, co)


def divided_patch_attention(qkv, cls_k, cls_v, cls_q, *, mode: str, heads: int,
                            quant_out: bool = False, head_grid: bool | None = None):
    """Patch-token divided attention on packed qkv, with the CLS partials.

    Same contract as ``divided_patch_attention_ref``. A CUDA tensor runs
    the CUDA kernel (and raises what it does not take, and where grad mode
    is on and an input requires grad: the kernels have no backward); a
    CPU tensor runs the plain version.

    ``head_grid`` (time mode only) selects K6, the port's route for the
    long clips on which the JAX package leaves its kernel for XLA: ``None``
    takes it where ``needs_head_grid(T, N, heads)``, ``True`` forces it.
    K6 returns its partials per tube and has no ``quant_out``.
    """
    if mode not in _MODES:
        raise ValueError(f"mode must be one of {_MODES}, got {mode!r}")
    b, t, n, _ = qkv.shape
    if mode == "space":
        if head_grid:
            raise ValueError("head_grid is a time-attention kernel; mode is 'space'")
        head_grid = False
    elif head_grid is None:
        head_grid = needs_head_grid(t, n, heads)
    if head_grid and quant_out:
        raise ValueError("the head-grid time kernel (K6) has no quant_out")
    if qkv.device.type == "cpu":
        if head_grid:
            return time_attention_headgrid_ref(qkv, cls_k, cls_v, cls_q, heads=heads)
        return divided_patch_attention_ref(qkv, cls_k, cls_v, cls_q, mode=mode, heads=heads,
                                           quant_out=quant_out)
    if qkv.device.type != "cuda":
        raise ValueError(f"no divided-attention kernel for device {qkv.device}")
    check_no_grad("divided_patch_attention", qkv, cls_k, cls_v, cls_q)
    if head_grid:
        res = _launch_headgrid(qkv, cls_k, cls_v, cls_q, heads)
        attr = "launches_time_headgrid"
    else:
        res = _launch_kernel(qkv, cls_k, cls_v, cls_q, mode, heads, quant_out)
        attr = f"launches_{mode}" + ("_quant" if quant_out else "")
    setattr(divided_patch_attention, attr, getattr(divided_patch_attention, attr) + 1)
    return res


divided_patch_attention.launches_space = 0
divided_patch_attention.launches_time = 0
divided_patch_attention.launches_space_quant = 0
divided_patch_attention.launches_time_quant = 0
divided_patch_attention.launches_time_headgrid = 0
