"""The kernels' rooflines (``ops/bounds.py``) against the "Bound ms" column
of PERF.md's table of kernels (section 6), at its printed precision: the
H100 SXM's peaks, bf16, N = 256 patches a frame (K8: the narrator's 640
sequences x 25 heads, 64 clips of 10), dh = 64. Each of these
calls moves more bytes than the card's rate lets it compute, so each is
bound by bytes."""

import pytest

from helping_hand_for_egocentric_videos_torch.ops.bounds import (
    attention_bound_ms,
    decode_attention_bound_ms,
    rows_bound_ms,
    sampler_bound_ms,
)
from helping_hand_for_egocentric_videos_torch.utils.flops import peaks_for

PEAKS = peaks_for("NVIDIA H100 80GB HBM3")
N, DH = 256, 64


def _attention(mode, b, t, heads=16, quant_out=False):
    return attention_bound_ms(b, t, N, heads, DH, "bfloat16", mode, PEAKS, quant_out=quant_out)


CASES = {  # id: (bound, the printed ms)
    "K1-space-8x16": (_attention("space", 8, 16), 0.0803),
    "K1-space-2x128": (_attention("space", 2, 128), 0.1606),
    "K1-space-16x4": (_attention("space", 16, 4), 0.0402),
    "K1-space-32x4": (_attention("space", 32, 4), 0.0804),
    "K2-time-8x16": (_attention("time", 8, 16), 0.0827),
    "K2-time-16x4": (_attention("time", 16, 4), 0.0453),
    "K2-time-32x4": (_attention("time", 32, 4), 0.0905),
    "K3-space-8x16": (_attention("space", 8, 16, quant_out=True), 0.0703),
    "K3-time-8x16": (_attention("time", 8, 16, quant_out=True), 0.0727),
    "K3-space-2x128": (_attention("space", 2, 128, quant_out=True), 0.1406),
    "K3-space-16x4": (_attention("space", 16, 4, quant_out=True), 0.0352),
    "K3-time-16x4": (_attention("time", 16, 4, quant_out=True), 0.0403),
    "K3-space-32x4": (_attention("space", 32, 4, quant_out=True), 0.0704),
    "K3-time-32x4": (_attention("time", 32, 4, quant_out=True), 0.0805),
    "K4-32768x1024": (rows_bound_ms(32768, 1024, 2, 14, PEAKS), 0.0301),
    "K5-32768x4096": (rows_bound_ms(32768, 4096, 2, 12, PEAKS), 0.1202),
    "K6-time-2x128": (_attention("time", 2, 128), 0.1609),
    "K6-time-1x128": (_attention("time", 1, 128), 0.0805),
    "K7-640x50257": (sampler_bound_ms(640, 50257, PEAKS), 0.0384),
    "K7-640x97": (sampler_bound_ms(640, 97, PEAKS), 0.0001),
    "K8-self-640x25-77keys": (decode_attention_bound_ms("self", 640, 25, 77, DH, "bfloat16", PEAKS), 0.0954),
    "K8-self-640x25-33keys": (decode_attention_bound_ms("self", 640, 25, 33, DH, "bfloat16", PEAKS), 0.0416),
    "K8-self-640x25-1key": (decode_attention_bound_ms("self", 640, 25, 1, DH, "bfloat16", PEAKS), 0.0024),
    "K8-cross-64x10-256keys": (decode_attention_bound_ms("cross", 640, 25, 256, DH, "bfloat16", PEAKS, r=10), 0.0325),
    "K1-space-16x4-H8": (_attention("space", 16, 4, heads=8), 0.0201),
    "K2-time-16x4-H8": (_attention("time", 16, 4, heads=8), 0.0226),
    "K1-space-8x16-H8": (_attention("space", 8, 16, heads=8), 0.0402),
    "K2-time-8x16-H8": (_attention("time", 8, 16, heads=8), 0.0414),
}


@pytest.mark.parametrize("case", list(CASES))
def test_bound_is_perf_mds(case):
    (ms, by), printed = CASES[case]
    assert by == "bytes"
    assert abs(ms - printed) <= 0.00005, ms


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (python -m pytest --noconftest -m cuda tests/test_torch_bounds.py)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_plans_and_timers_on_the_card(cuda_device):
    """The kernels' plan queries name a cut at the model's shapes, and K1's
    device time read from a trace lies above its bound and within the
    events' time through the wrapper (the two clocks differ by well under
    2%); traces that never hold the launches a call was said to make
    raise."""
    import torch

    from helping_hand_for_egocentric_videos_torch.ops import act_quant as aq
    from helping_hand_for_egocentric_videos_torch.ops import divided_attention as da
    from helping_hand_for_egocentric_videos_torch.utils.profiling import cuda_ms, device_ms

    assert set(da.plan(N, 16, DH)) == {"heads_a_block", "warps_a_block", "streamed", "smem_bytes"}
    assert da.headgrid_plan(128, 2 * N * 16, DH)["blocks"] > 0
    x = torch.zeros(32768, 1024, device=cuda_device, dtype=torch.bfloat16)
    assert aq.layer_norm_plan(x)["route"] == "warp_row"
    assert aq.layer_norm_plan(torch.zeros(8, 4096, device=cuda_device, dtype=torch.bfloat16))["route"] == "block_row"

    gen = torch.Generator(device=cuda_device).manual_seed(0)
    qkv = torch.randn(8, 16, N, 3 * 16 * DH, generator=gen, device=cuda_device).to(torch.bfloat16)
    ck, cv, cq = (torch.randn(8, 16 * DH, generator=gen, device=cuda_device).to(torch.bfloat16) for _ in range(3))

    def run():
        return da.divided_patch_attention(qkv, ck, cv, cq, mode="space", heads=16)

    ms = device_ms(run, 20, "attention_bf16_kernel")
    assert _attention("space", 8, 16)[0] < ms <= 1.02 * cuda_ms(run, 20)
    with pytest.raises(RuntimeError, match="the calls launch others"):
        device_ms(run, 20, "attention_bf16_kernel", per_call=2)
