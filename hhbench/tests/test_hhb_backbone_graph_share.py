"""The reader of the backbone's CUDA graph share
(``metrics/backbone_graph_share.train.py``): replays over backbone calls
from a filled program table, nothing to read without a backbone call or
from a program whose catalogue has no replay span, and 0 in a CPU
rehearsal of the train cell traced (no graph on the CPU)."""

import pytest
import tiny  # noqa: F401  (the repo on sys.path)
from test_hhb_metrics import make_run
from test_hhb_program_spans import program_table

from hhbench import harness, trace

NAME = "backbone_graph_share.train"


def traced_run():
    run = make_run("pretrain4f.step_b16")
    run.trace_data = trace.Trace(window=(0.0, 1e6))
    return run


@pytest.mark.parametrize("replays, want", [(3, 100.0), (1, 100.0 / 3), (0, 0.0)])
def test_share_from_a_filled_table(monkeypatch, replays, want):
    table = {"hh.step.backbone": {"count": 3, "host_s": 0.02, "device_s": None}}
    if replays:
        table["hh.step.backbone.replay"] = {"count": replays, "host_s": 0.001, "device_s": None}
    program_table(monkeypatch, table)
    assert harness.load_metric(NAME).read(traced_run()) == pytest.approx(want)


def test_nothing_to_read_without_its_spans(monkeypatch):
    from helping_hand_for_egocentric_videos_torch.utils import profiling

    read = harness.load_metric(NAME).read
    program_table(monkeypatch, {"hh.step.decoder": {"count": 3, "host_s": 0.02, "device_s": None}})
    assert read(traced_run()) is None  # no backbone call traced
    program_table(monkeypatch, {"hh.step.backbone": {"count": 3, "host_s": 0.02, "device_s": None}})
    monkeypatch.setattr(profiling, "SPANS", {k: v for k, v in profiling.SPANS.items() if not k.endswith(".replay")})
    assert read(traced_run()) is None  # an older program, which has no graph


def test_traced_cpu_rehearsal_reads_no_replay():
    from test_hhb_rehearsal import f32_run, run_module

    line = run_module().execute(f32_run("pretrain4f.step_b16", seconds=1.0, trace=True))
    assert line["correct"] is True, line["compared"]
    assert line["metrics"][NAME] == {"value": 0.0, "unit": "%"}
