"""The readers of the program's own spans (``metrics/_program.py``): the
step's launches by phase from a hand-made Chrome trace, the embed device
shares and the clip read time from a filled program table, nothing to
read without a trace or from a program that keeps no spans, and a CPU
rehearsal of both cells traced."""

import json

import pytest
import tiny  # noqa: F401  (the repo on sys.path)
from test_hhb_metrics import make_run

from hhbench import harness, trace

PHASES = {"backbone": "hh.step.backbone", "decoder": "hh.step.decoder", "loss": "hh.step.losses",
          "backward": "hh.step.backward", "optim": "hh.step.optim"}
LAUNCH_READERS = [f"{k}_launches.train" for k in PHASES]
EMBED_READERS = ["preprocess_device_share.embed", "tower_device_share.embed", "decoder_device_share.embed",
                 "clip_read_ms.embed"]


def ev(cat, name, ts, dur, tid=1):
    return {"ph": "X", "cat": cat, "name": name, "ts": float(ts), "dur": float(dur), "pid": 1, "tid": tid}


def two_steps(tmp_path):
    """Two steps of five phases, 1000 us each phase, under the window; the
    launches (runtime and driver calls) at known times, the backward's
    mostly on another thread, and some outside every phase."""
    events = [ev("user_annotation", trace.WINDOW, 0, 20000)]
    launches = {"backbone": 3, "decoder": 2, "loss": 4, "backward": 5, "optim": 1}
    names = ["cudaLaunchKernel", "cuLaunchKernelEx", "cudaLaunchKernelExC", "cuLaunchKernel"]
    t = 1000.0
    for _ in range(2):
        for k, span in PHASES.items():
            events.append(ev("user_annotation", span, t, 1000))
            events.append(ev("gpu_user_annotation", span, t + 5, 1000))  # the device's copy: not a host range
            for i in range(launches[k]):
                other = k == "backward" and i > 0  # autograd's device thread
                events.append(ev("cuda_runtime" if i % 2 else "cuda_driver", names[i % 4], t + 100 + 150 * i, 20,
                                 tid=7 if other else 1))
            events.append(ev("cuda_runtime", "cudaMemcpyAsync", t + 900, 10))  # not a launch
            t += 1000
        events.append(ev("cuda_runtime", "cudaLaunchKernel", t + 10, 5))  # between steps: no phase's
        t += 2000
    events.append(ev("kernel", "gemm", 1000, 100))
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    return trace.parse(str(path)), launches


def test_launches_by_phase(tmp_path):
    run = make_run("pretrain4f.step_b16")
    run.trace_data, want = two_steps(tmp_path)
    run.traced_steps = 2
    for k in PHASES:
        assert harness.load_metric(f"{k}_launches.train").read(run) == pytest.approx(want[k])


def test_launch_readers_read_nothing_without_ranges_or_launches(tmp_path):
    run = make_run("pretrain4f.step_b16")
    run.traced_steps = 2
    tr, _ = two_steps(tmp_path)
    run.trace_data = trace.Trace(window=tr.window, device=tr.device,
                                 host=[h for h in tr.host if not h[0].startswith("hh.")])  # an older program
    assert all(harness.load_metric(n).read(run) is None for n in LAUNCH_READERS)
    run.trace_data = trace.Trace(window=tr.window, device=tr.device,
                                 host=[h for h in tr.host if "Launch" not in h[0]])  # a trace of the CPU
    assert all(harness.load_metric(n).read(run) is None for n in LAUNCH_READERS)


def program_table(monkeypatch, table):
    from helping_hand_for_egocentric_videos_torch.utils import profiling

    monkeypatch.setattr(profiling, "spans", lambda: table, raising=False)


def test_embed_readers_from_a_filled_table(monkeypatch, tmp_path):
    run = make_run("embed16.store_b64")
    run.trace_data = trace.Trace(window=(0.0, 2e6))  # 2 s
    program_table(monkeypatch, {
        "hh.eval.preprocess": {"count": 2, "host_s": 0.001, "device_s": 0.04},
        "hh.eval.tower": {"count": 2, "host_s": 0.3, "device_s": 1.7},
        "hh.eval.decoder": {"count": 2, "host_s": 0.01, "device_s": 0.12},
        "hh.data.item": {"count": 128, "host_s": 3.2, "device_s": None},
    })
    read = {n: harness.load_metric(n).read(run) for n in EMBED_READERS}
    assert read == pytest.approx(dict(zip(EMBED_READERS, [2.0, 85.0, 6.0, 25.0])))


def test_embed_readers_read_nothing_without_their_spans(monkeypatch):
    from helping_hand_for_egocentric_videos_torch.utils import profiling

    run = make_run("embed16.store_b64")
    run.trace_data = trace.Trace(window=(0.0, 2e6))
    program_table(monkeypatch, {"hh.eval.tower": {"count": 1, "host_s": 0.1, "device_s": None}})
    assert all(harness.load_metric(n).read(run) is None for n in EMBED_READERS)
    monkeypatch.delattr(profiling, "spans")  # an older program
    assert all(harness.load_metric(n).read(run) is None for n in EMBED_READERS)
    program_table(monkeypatch, {"hh.eval.tower": {"count": 1, "host_s": 0.1, "device_s": 0.1}})
    run.trace_data = None
    assert all(harness.load_metric(n).read(run) is None for n in EMBED_READERS)


@pytest.mark.parametrize("cell", ["embed16.store_b64", "pretrain4f.step_b16"])
def test_traced_rehearsal_reads_the_program_spans(cell):
    """The CPU rehearsal of a cell with ``--trace 1``: the embed cell reads
    its device shares (host time on the CPU) and the clip read time; the
    train cell's trace holds no launch calls on the CPU, so its launch
    readers leave their metrics out."""
    from test_hhb_rehearsal import f32_run, run_module

    run = f32_run(cell, seconds=1.0, trace=True)
    line = run_module().execute(run)
    assert line["correct"] is True, line["compared"]
    m = line["metrics"]
    print(cell, {k: v["value"] for k, v in m.items()})
    if cell.startswith("embed"):
        assert set(EMBED_READERS) <= set(m) and all(m[n]["value"] > 0 for n in EMBED_READERS)
        assert sum(m[n]["value"] for n in EMBED_READERS[:3]) <= 100.0
    else:
        assert not set(LAUNCH_READERS) & set(m)
