"""Each per-layer reader against a hand-made Chrome trace, engine stats
and host spans; a reader with nothing to read returns None, never 0."""

import json

import pytest
import tiny

from hhbench import harness, trace
from hhbench.counts.attention import tower_least_seconds_per_clip
from hhbench.counts.flops import embed_flops_per_clip, train_step_flops_per_clip

BENCH = tiny.bench()
NAMES = [m["name"] for m in BENCH["per_layer"]]
ATTN = "void (anonymous namespace)::attention_bf16_kernel<__nv_bfloat16, 64>(...)"


def chrome(tmp_path, window=(1000.0, 11000.0)):
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": trace.WINDOW, "ts": window[0], "dur": window[1] - window[0]},
        {"ph": "X", "cat": "user_annotation", "name": "hhb.train_step", "ts": 1000.0, "dur": 10000.0},
        {"ph": "X", "cat": "cpu_op", "name": "aten::nonzero", "ts": 5000.0, "dur": 2000.0},
        {"ph": "X", "cat": "kernel", "name": ATTN, "ts": 1000.0, "dur": 2000.0},
        {"ph": "X", "cat": "kernel", "name": "gemm", "ts": 2500.0, "dur": 1500.0},   # overlaps: busy 1000-4000
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 8000.0, "dur": 1000.0},
        {"ph": "X", "cat": "kernel", "name": "outside", "ts": 20000.0, "dur": 500.0},  # after the window
        {"ph": "X", "cat": "gpu_user_annotation", "name": "hhb.train_step", "ts": 1000.0, "dur": 10000.0},
    ]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    return trace.parse(str(path))


def make_run(cell, tmp_path=None):
    run = tiny.tiny_run(cell)
    run.cell.cfg = harness.read_json(harness.HERE / "configs" / f"{run.cell.config_name}.json")
    return run


def test_trace_reading(tmp_path):
    tr = chrome(tmp_path)
    assert tr.window_s == pytest.approx(0.01)
    assert tr.busy_s == pytest.approx(0.004)  # 1000-4000 and 8000-9000 us
    assert [k[0] for k in tr.kernels()] == [ATTN, "gemm"]
    assert tr.device_seconds(lambda n: "attention" in n) == pytest.approx(0.002)
    assert tr.device_seconds(lambda n: "nothing" in n) is None
    gaps = dict(tr.idle_gaps())
    assert gaps["hhb.train_step > aten::nonzero"] == pytest.approx(0.004)  # 4000-8000 us
    assert gaps["hhb.train_step"] == pytest.approx(0.002)  # 9000-11000 us
    assert tr.top_device_ops()[0] == [ATTN, pytest.approx(0.002)]


def test_trace_readers(tmp_path):
    run = make_run("pretrain4f.step_b16")
    run.trace_data = chrome(tmp_path)
    run.traced_items, run.traced_steps = 16, 2
    run.items, run.window_s = 160, 2.0
    mod = harness.load_metric
    assert mod("device_idle_share.train").read(run) == pytest.approx(60.0)
    assert mod("launches_per_step.train").read(run) == pytest.approx(1.0)
    least = tower_least_seconds_per_clip(run.cfg["visual"], "bfloat16", run.peaks())
    assert mod("attn_roofline.train").read(run) == pytest.approx(100.0 * least * 16 / 0.002)
    mfu = 100.0 * 80.0 * train_step_flops_per_clip(run.cfg, 5) / 989e12
    assert mod("step_mfu.train").read(run) == pytest.approx(mfu)


def test_host_and_counter_readers():
    run = make_run("embed16.store_b64")
    run.items, run.window_s = 640, 8.0
    run.spans.count["hhb.data_wait"] = 10
    run.spans.seconds["hhb.data_wait"] = 0.4
    assert harness.load_metric("data_wait_share.embed").read(run) == pytest.approx(5.0)
    assert harness.load_metric("step_mfu.embed").read(run) == pytest.approx(
        100.0 * 80.0 * embed_flops_per_clip(run.cfg) / 989e12)
    serve = make_run("serve16.open_r80")
    serve.counters = {"requests": 10, "items": 30, "device_calls": 5, "padded_items": 10}
    assert harness.load_metric("serve_pad_share").read(serve) == pytest.approx(25.0)
    assert harness.load_metric("serve_clips_per_call").read(serve) == pytest.approx(6.0)


@pytest.mark.parametrize("name", NAMES)
def test_nothing_to_read_is_none(name):
    entry = next(m for m in BENCH["per_layer"] if m["name"] == name)
    run = make_run(entry["workloads"][0])
    assert harness.load_metric(name).read(run) is None


def test_trace_without_attention_reads_none(tmp_path):
    run = make_run("embed16.store_b64")
    tr = chrome(tmp_path)
    tr.device = [e for e in tr.device if "attention" not in e[0]]
    run.trace_data, run.traced_items = tr, 8
    assert harness.load_metric("attn_roofline.embed").read(run) is None
