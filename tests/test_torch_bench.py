"""The port's headline bench, ``tools/torch_bench.py``, on the CPU.

Wedge-proofing as ``tests/test_bench.py`` pins it for ``bench.py``, with
the port's exit codes: the probe's timeout returns None, a failed probe
prints ``gpu_unavailable`` and exits 2 without CUDA ever being initialised
in the calling process, a stage that raises prints its ``_error`` line,
the later stages still run and the exit code is 1, a stage skipped for the
budget is no error; the watchdog's predicate, and its exit code 3. The FLOP counters and the
card's peaks are pinned; the metric names and the keys of each line are
bench.py's (read from its source, never imported), plus the port's.

And the slice against JAX on the CPU, on parameters bridged from JAX's
``init_*`` at tiny widths: the bench's eval forward against JAX's
``encode_image`` -> ``decoder_forward`` -> ``obj_proj`` in f32 within
1e-4 x max|embedding|; its int8 forward against JAX's int8 path (both on
the fused route: Pallas in interpret mode, the kernels' plain versions)
with a cosine of at least 0.9999 a clip; one bench train step against
JAX's ``make_train_step`` on the same batch synthesis, loss terms within
rtol 1e-5; the end-to-end stage's host batches bit-equal to JAX's
``read_clip_chunked`` on the same store.
"""

from __future__ import annotations

import ast
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tools"))

import torch_bench as tb  # noqa: E402
from helping_hand_for_egocentric_videos_torch.cli.common import bounded_device_probe  # noqa: E402
from helping_hand_for_egocentric_videos_torch.models import (  # noqa: E402
    DecoderConfig,
    LavilaConfig,
    SpaceTimeConfig,
    TextConfig,
    from_jax_params,
)
from helping_hand_for_egocentric_videos_torch.utils import flops  # noqa: E402

# keys the port's lines add to bench.py's
PORT_KEYS = {"card", "power_limit_w", "peak_memory_gb", "launches", "launches_total"}
T = 4
JDEC = dict(d_model=64, nhead=4, num_layers=2, dim_feedforward=128, num_queries=13, num_classes=10,
            feature_dim=128, text_width=64, embed_dim=32, num_frames=T, patches_per_frame=49)


# ------------------------------------------------------------ wedge-proofing


def test_probe_timeout_returns_none():
    # 50 ms is not enough to start the probe's interpreter: the timeout branch
    assert bounded_device_probe(timeout=0.05) is None


def test_no_card_prints_gpu_unavailable_and_exits_2():
    env = dict(os.environ, HH_BENCH_PROBE_TIMEOUT="0.05")
    proc = subprocess.run([sys.executable, str(ROOT / "tools" / "torch_bench.py")], capture_output=True, text=True,
                          env=env, timeout=120, cwd=ROOT)
    assert proc.returncode == 2, proc.stderr
    last = json.loads(proc.stdout.strip().splitlines()[-1])
    assert last["metric"] == "gpu_unavailable" and last["value"] == 0.0


def test_failed_probe_never_initialises_cuda(monkeypatch, capsys):
    def refuse():
        raise AssertionError("CUDA was initialised in the calling process")

    monkeypatch.setenv("HH_BENCH_PROBE_TIMEOUT", "0.05")
    monkeypatch.setattr(torch.cuda, "_lazy_init", refuse)
    monkeypatch.setattr(torch.cuda, "init", refuse)
    assert tb.main() == 2
    assert not torch.cuda.is_initialized()
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])["metric"] == "gpu_unavailable"


@pytest.fixture
def fake_card(monkeypatch):
    """A probe that answers, no watchdog thread, stages that print their
    metric: the exit-code logic of ``main`` alone."""
    probe = {"platform": "gpu", "device_kind": "NVIDIA H100 80GB HBM3", "n": 1,
             "card": "NVIDIA H100 80GB HBM3, 700.00 W"}
    monkeypatch.setattr(tb, "bounded_device_probe", lambda timeout: dict(probe))
    monkeypatch.setattr(tb, "Watchdog", lambda *a, **k: type("W", (), {"progress": lambda self: None})())
    monkeypatch.setattr(tb, "bench_train_step", lambda int8_backbone=False, augment=False, card=None: {
        "metric": "train_clips_per_sec_per_chip_4f" + ("_int8_backbone" if int8_backbone else "")
        + ("_augmented" if augment else ""), "value": 1.0, **card})
    monkeypatch.setattr(tb, "bench_e2e", lambda card=None: {"metric": "clips_per_sec_e2e_16f_eval_bf16",
                                                            "value": 1.0, **card})
    monkeypatch.setattr(tb, "bench_eval", lambda quantize, card=None: {
        "metric": "clips_per_sec_per_chip_16f_eval" + ("_int8" if quantize else ""), "value": 1.0, **card})
    for k in ("HH_BENCH_INT8", "HH_BENCH_TRAIN", "HH_BENCH_E2E", "HH_BENCH_AUG", "HH_BENCH_BUDGET"):
        monkeypatch.delenv(k, raising=False)


def _lines(capsys):
    return [json.loads(ln) for ln in capsys.readouterr().out.strip().splitlines()]


def test_stages_in_bench_order_headline_last(fake_card, capsys, monkeypatch):
    monkeypatch.setenv("HH_BENCH_AUG", "1")
    assert tb.main() == 0
    lines = _lines(capsys)
    assert [ln["metric"] for ln in lines] == [
        "device_probe", "train_clips_per_sec_per_chip_4f", "train_clips_per_sec_per_chip_4f_int8_backbone",
        "train_clips_per_sec_per_chip_4f_augmented", "clips_per_sec_e2e_16f_eval_bf16",
        "clips_per_sec_per_chip_16f_eval_int8", "clips_per_sec_per_chip_16f_eval"]
    assert lines[-1]["card"] == "NVIDIA H100 80GB HBM3, 700.00 W" and lines[-1]["power_limit_w"] == 700.0


def test_a_stage_that_raises_prints_its_error_the_rest_runs_and_rc_is_1(fake_card, capsys, monkeypatch):
    def boom(card=None):
        raise RuntimeError("out of memory")

    monkeypatch.setattr(tb, "bench_e2e", boom)
    assert tb.main() == 1
    lines = _lines(capsys)
    assert lines[3]["metric"] == "e2e_error" and "out of memory" in lines[3]["error"]
    assert lines[-1]["metric"] == "clips_per_sec_per_chip_16f_eval"


def test_a_stage_skipped_for_the_budget_is_no_error(fake_card, capsys, monkeypatch):
    monkeypatch.setenv("HH_BENCH_BUDGET", "100")  # below the train stage's 120 s reserve
    assert tb.main() == 0
    lines = _lines(capsys)
    assert lines[1] == {"metric": "train_skipped", "reason": "time budget"}
    assert lines[-1]["metric"] == "clips_per_sec_per_chip_16f_eval"  # never skipped


def test_watchdog_predicate_requires_deadline_and_stall():
    fire = tb.watchdog_should_fire
    assert not fire(now=100.0, t0=0.0, last_progress=0.0, deadline=200.0, stall=50.0)  # before the deadline
    assert not fire(now=300.0, t0=0.0, last_progress=290.0, deadline=200.0, stall=50.0)  # a stage just ended
    assert fire(now=300.0, t0=0.0, last_progress=200.0, deadline=200.0, stall=50.0)  # deadline and silence


def test_watchdog_ends_the_process_with_rc_3():
    """A stalled run ends on ``os._exit(3)`` with a parseable last line,
    whatever the main thread is doing (here: sleeping, as in a kernel)."""
    code = (
        "import sys, time, types\n"
        f"sys.path.insert(0, {str(ROOT / 'tools')!r})\n"
        "import torch_bench as tb\n"
        "real = time.sleep\n"
        "tb.time = types.SimpleNamespace(sleep=lambda s: real(0.01), monotonic=time.monotonic)\n"
        "tb.Watchdog(deadline=0.0, stall=0.0)\n"
        "real(60)\n"
        "print('not reached')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120, cwd=ROOT)
    assert proc.returncode == 3, proc.stderr
    last = json.loads(proc.stdout.strip().splitlines()[-1])
    assert last["metric"] == "gpu_stalled_midrun" and last["value"] == 0.0


def test_card_line_parsing():
    assert tb.card_from_line("NVIDIA H100 80GB HBM3, 700.00 W") == {
        "card": "NVIDIA H100 80GB HBM3, 700.00 W", "power_limit_w": 700.0}
    assert tb.card_from_line(None) == {"card": None, "power_limit_w": None}


# ------------------------------------------------------- counters and peaks


def test_flop_counters_pin_jax_figures():
    from helping_hand_for_egocentric_videos_tpu.models import DecoderConfig as JDecoderConfig
    from helping_hand_for_egocentric_videos_tpu.models.lavila import timesformer_large_config as jlarge
    from helping_hand_for_egocentric_videos_tpu.utils import flops as jflops

    lcfg, dcfg = tb.configs("timesformer_large", 16, pred_traj=False)
    ev = flops.eval_fwd_flops_per_clip(lcfg, dcfg)
    assert abs(ev - 3.458e12) / 3.458e12 < 0.01  # bench.py FLOPS_PER_CLIP_16F
    assert ev == jflops.eval_fwd_flops_per_clip(jlarge(num_frames=16), JDecoderConfig(num_frames=16, pred_traj=False))
    lcfg4, dcfg4 = tb.configs("timesformer_large", 4, pred_traj=True)
    tr = flops.train_step_flops_per_clip(lcfg4, dcfg4, rephrase_factor=5)
    assert tr == jflops.train_step_flops_per_clip(jlarge(num_frames=4), JDecoderConfig(num_frames=4),
                                                  rephrase_factor=5)


def test_peak_table_and_its_column_by_name():
    assert flops.PEAKS == {
        "sxm": {"bytes": 3.35e12, "bfloat16": 989e12, "float32": 67e12, "int8": 1979e12},
        "pcie": {"bytes": 2.0e12, "bfloat16": 756e12, "float32": 51e12, "int8": 1513e12},
    }
    assert flops.peaks_for("NVIDIA H100 80GB HBM3") is flops.PEAKS["sxm"]
    assert flops.peaks_for("NVIDIA H100 PCIe") is flops.PEAKS["pcie"]


# ------------------------------------------------ bench.py's names and keys


def _bench_py_keys(func: str) -> set[str]:
    """The keys of the lines ``bench.py::func`` prints, from its source:
    those of its dict literals with a ``"metric"`` key, and of its
    ``line["..."] = ...`` assignments."""
    tree = ast.parse((ROOT / "bench.py").read_text())
    fn = next(n for n in ast.walk(tree) if isinstance(n, ast.FunctionDef) and n.name == func)
    keys = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Dict):
            names = {k.value for k in node.keys if isinstance(k, ast.Constant)}
            if "metric" in names:
                keys |= names
        elif (isinstance(node, ast.Subscript) and isinstance(node.ctx, ast.Store)
              and isinstance(node.value, ast.Name) and node.value.id == "line"):
            keys.add(node.slice.value)
    return keys


@pytest.fixture(scope="module")
def cpu_lines():
    """Each stage's line on the CPU at a miniature width."""
    kw = dict(device="cpu", backbone="timesformer_tiny")
    return {
        "train": tb.bench_train_step(batch=2, steps=1, **kw),
        "train_int8": tb.bench_train_step(True, batch=2, steps=1, **kw),
        "e2e": tb.bench_e2e(**kw),
        "eval_int8": tb.bench_eval(True, batch=2, steps=1, **kw),
        "eval": tb.bench_eval(False, batch=2, steps=1, **kw),
    }


def test_metric_names_and_keys_are_bench_pys(cpu_lines):
    src = (ROOT / "bench.py").read_text()
    for name in ("train_clips_per_sec_per_chip_4f", "_int8_backbone", "clips_per_sec_e2e_16f_eval_bf16",
                 "clips_per_sec_per_chip_16f_eval", "_int8"):
        assert f'"{name}"' in src
    assert cpu_lines["train"]["metric"] == "train_clips_per_sec_per_chip_4f"
    assert cpu_lines["train_int8"]["metric"] == "train_clips_per_sec_per_chip_4f_int8_backbone"
    assert cpu_lines["eval_int8"]["metric"] == "clips_per_sec_per_chip_16f_eval_int8"
    assert cpu_lines["eval"]["metric"] == "clips_per_sec_per_chip_16f_eval"
    extra = {"train": {"step_ms"}, "train_int8": {"step_ms"}, "e2e": {"batch", "mfu"},
             "eval_int8": {"tflop_per_clip", "forward_ms"}, "eval": {"tflop_per_clip", "forward_ms"}}
    jax_keys = {"train": _bench_py_keys("bench_train_step"), "e2e": _bench_py_keys("bench_e2e"),
                "eval": _bench_py_keys("main")}
    for stage, line in cpu_lines.items():
        want = set(jax_keys[stage.removesuffix("_int8")])
        if stage == "train":  # bench.py adds gated_on only with the int8 backbone
            want.discard("gated_on")
        if stage == "eval":
            want -= {"quant", "gated_on"}
        assert set(line) == want | PORT_KEYS | extra[stage], stage
    assert cpu_lines["eval"]["baseline_assumed"] is True
    assert cpu_lines["eval"]["baseline_source"] in src.replace('"\n    "', "")
    assert all(line["mfu"] is None for line in cpu_lines.values())  # no device metric from the CPU


# --------------------------------------------------------- against JAX


@pytest.fixture(scope="module")
def bridged():
    """JAX's tiny tower and decoder, time attention N(0, 0.05), and the
    port's modules carrying the same weights (kernel route: the plain
    versions on the CPU)."""
    from helping_hand_for_egocentric_videos_tpu.models import lavila as jlv
    from helping_hand_for_egocentric_videos_tpu.models import obj_decoder as jod

    jcfg = jlv.timesformer_tiny_config(num_frames=T)
    jcfg = dataclasses.replace(jcfg, visual=dataclasses.replace(jcfg.visual, attention_backend="pallas_interpret"))
    jdcfg = jod.DecoderConfig(**JDEC, pred_traj=False)
    backbone = jax.tree.map(np.asarray, jlv.init_lavila_params(jax.random.PRNGKey(0), jcfg))
    decoder = jax.tree.map(np.asarray, jod.init_decoder_params(jax.random.PRNGKey(1), jdcfg))
    rng = np.random.default_rng(3)
    ta = backbone["visual"]["blocks"]["timeattn"]
    for name in ("qkv", "proj"):
        ta[name]["w"] = (rng.normal(size=ta[name]["w"].shape) * 0.05).astype(np.float32)
    fields = {f.name for f in dataclasses.fields(SpaceTimeConfig)}
    lcfg = LavilaConfig(
        visual=SpaceTimeConfig(**{k: v for k, v in dataclasses.asdict(jcfg.visual).items() if k in fields
                                  and k != "attention_backend"}),
        text=TextConfig(**{k: v for k, v in dataclasses.asdict(jcfg.text).items()
                           if k in {f.name for f in dataclasses.fields(TextConfig)}}),
        embed_dim=jcfg.embed_dim)
    dcfg = DecoderConfig(**dataclasses.asdict(jdcfg))
    return jcfg, jdcfg, backbone, decoder, lcfg, dcfg


def _jax_eval(jcfg, jdcfg, backbone, decoder, video):
    from helping_hand_for_egocentric_videos_tpu.models import decoder_forward
    from helping_hand_for_egocentric_videos_tpu.models import obj_decoder as jod
    from helping_hand_for_egocentric_videos_tpu.models.lavila import encode_image

    with jax.default_matmul_precision("highest"):
        _, fmap = encode_image(backbone, jcfg, jnp.asarray(video), use_remat=False, dtype=jnp.float32)
        grid = fmap[:, 1:, :].reshape(video.shape[0], T, jcfg.visual.patches_per_frame, -1)
        out = decoder_forward(decoder, jdcfg, grid)
        return np.asarray(jod.obj_proj(decoder, out.hs[-1])[:, -1]), np.asarray(out.pred_boxes)


def test_eval_forward_matches_jax_in_f32(bridged):
    jcfg, jdcfg, backbone, decoder, lcfg, dcfg = bridged
    video = tb.eval_video(2, T, 224)
    want, want_boxes = _jax_eval(jcfg, jdcfg, backbone, decoder, video)
    tower, dec = from_jax_params(backbone, decoder, lcfg, dcfg)
    model = tb.make_eval_model(tower, lcfg, dec, dcfg, dtype=torch.float32)
    emb, boxes = model.embed_clips(torch.as_tensor(video))
    np.testing.assert_allclose(emb.numpy(), want, atol=1e-4 * np.abs(want).max())
    np.testing.assert_allclose(boxes.numpy(), want_boxes, atol=1e-4)


def test_int8_forward_matches_jax_int8_path(bridged):
    from helping_hand_for_egocentric_videos_tpu.models.quant import quantize_lavila_params as jquantize

    jcfg, jdcfg, backbone, decoder, lcfg, dcfg = bridged
    video = tb.eval_video(2, T, 224)
    want, _ = _jax_eval(jcfg, jdcfg, jquantize(backbone), decoder, video)
    tower, dec = from_jax_params(backbone, decoder, lcfg, dcfg)
    model = tb.make_eval_model(tower, lcfg, dec, dcfg, quantize=True, dtype=torch.float32)
    emb, _ = model.embed_clips(torch.as_tensor(video))
    got = emb.numpy()
    cos = (got * want).sum(-1) / np.linalg.norm(got, axis=-1) / np.linalg.norm(want, axis=-1)
    assert (cos >= 0.9999).all(), cos


def test_train_step_matches_jax(bridged):
    from helping_hand_for_egocentric_videos_tpu.models import obj_decoder as jod
    from helping_hand_for_egocentric_videos_tpu.train import step as jstep
    from helping_hand_for_egocentric_videos_torch.train import TrainConfig

    jcfg, _, backbone, _, lcfg, _ = bridged
    jdcfg = jod.DecoderConfig(**JDEC)  # with its trajectory head, as the train step's
    jdecoder = jax.tree.map(np.asarray, jod.init_decoder_params(jax.random.PRNGKey(2), jdcfg))
    dcfg = DecoderConfig(**dataclasses.asdict(jdcfg))
    batch, noun_dict = tb.train_batch(2, T, res=224, text_width=lcfg.text.width)

    jt = jstep.TrainConfig(backbone_dtype=jnp.float32)
    opt = jstep.make_optimizer(jt)
    state = jstep.TrainState(jdecoder, opt.init(jdecoder), jnp.zeros((), jnp.int32))
    jbatch = {k: jnp.asarray(v.astype(np.int32) if v.dtype == np.int64 else v) for k, v in batch.items()}
    with jax.default_matmul_precision("highest"):
        _, jm = jax.jit(jstep.make_train_step(jdcfg, jcfg, jt, opt))(state, backbone, jbatch, jnp.asarray(noun_dict),
                                                                      None)

    tower, dec = from_jax_params(backbone, jdecoder, lcfg, dcfg)
    _, tower, _, tstate, step, data, nd = tb.train_setup(
        2, device="cpu", models=(lcfg, tower, dcfg, dec), tcfg=TrainConfig(backbone_dtype=torch.float32))
    assert all(np.array_equal(data[k].numpy(), v) for k, v in batch.items())  # the bench's batch, as given
    _, tm = step(tstate, tower, data, nd)
    for k in ("total_loss", "nce_loss", "box_loss", "word_loss"):
        assert float(tm[k]) == pytest.approx(float(jm[k]), rel=1e-5), k


def test_e2e_host_batches_equal_jax_reader(tmp_path):
    from helping_hand_for_egocentric_videos_tpu.data.video import read_clip_chunked as jread

    paths, _ = tb.write_clip_store(str(tmp_path))
    n = 2 * tb.E2E_B
    got = [b["video"] for b in tb.e2e_loader(tb.NpyClips(paths, n))]
    assert len(got) == 2
    for bi, batch in enumerate(got):
        for j in range(tb.E2E_B):
            i = bi * tb.E2E_B + j
            start = (i * 0.37) % 2.0
            want, _ = jread(paths[i % len(paths)], start, start + 1.0, clip_length=tb.FRAMES)
            assert batch[j].dtype == want.dtype and np.array_equal(batch[j], want), i
