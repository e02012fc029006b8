"""The benchmark's copied arithmetic against the program's: the FLOP
counters at every cell's configuration, the peaks, and the divided
attention's bytes and operations."""

import pytest
import tiny  # noqa: F401  (puts the checkout on sys.path)

from hhbench import harness, weights
from hhbench.counts import attention, flops, peaks
from helping_hand_for_egocentric_videos_torch.utils import flops as port_flops

BENCH = harness.read_json(harness.ROOT / "BENCHMARK.json")
CONFIGS = sorted({w["config"] for w in BENCH["workloads"]})


@pytest.mark.parametrize("name", CONFIGS)
def test_flops_equal_the_programs(name):
    cfg = harness.read_json(harness.HERE / "configs" / f"{name}.json")
    lcfg, dcfg = weights.port_configs(cfg)
    assert flops.vision_fwd_flops(cfg["visual"]) == port_flops.vision_fwd_flops(lcfg.visual)
    assert flops.text_fwd_flops(cfg["text"]) == port_flops.text_fwd_flops(lcfg.text)
    assert flops.decoder_fwd_flops(cfg["decoder"]) == port_flops.decoder_fwd_flops(dcfg)
    assert flops.train_step_flops_per_clip(cfg) == port_flops.train_step_flops_per_clip(lcfg, dcfg)
    assert flops.embed_flops_per_clip(cfg) == (port_flops.vision_fwd_flops(lcfg.visual)
                                               + port_flops.decoder_fwd_flops(dcfg))


def test_peaks_equal_the_programs():
    assert peaks.PEAKS == port_flops.PEAKS
    for name in ("NVIDIA H100 80GB HBM3", "NVIDIA H100 PCIe"):
        assert peaks.peaks_for(name) == port_flops.peaks_for(name)


def test_attention_counts_at_the_embed_shape():
    # (8, 16) clips of 256 patches, D 1024 in bf16: q|k|v in, the output out
    b, t, n, d = 8, 16, 256, 1024
    assert attention.attention_bytes(b, t, n, d, "bfloat16") == 2 * (b * t * n * 4 * d + b * 4 * d)
    assert attention.attention_flops(b, t, n, d, "space") == b * (t * n * 4 * (n + 1) * d + 4 * (1 + t * n) * d)
    assert attention.attention_flops(b, t, n, d, "time") == b * (t * n * 4 * (t + 1) * d + 4 * (1 + t * n) * d)
    sxm = peaks.PEAKS["sxm"]
    # bytes-bound at this shape: 268.5 MB at 3.35 TB/s
    least = attention.least_seconds(b, t, n, d, "space", "bfloat16", sxm)
    assert least == pytest.approx(0.08015e-3, rel=1e-3)
    per_clip = attention.tower_least_seconds_per_clip({"img_size": 224, "patch_size": 14, "width": d, "depth": 24,
                                                       "num_frames": t}, "bfloat16", sxm)
    assert per_clip == pytest.approx(24 * 2 * least / b, rel=1e-6)
    with pytest.raises(ValueError):
        attention.attention_flops(1, 1, 1, 1, "both")
