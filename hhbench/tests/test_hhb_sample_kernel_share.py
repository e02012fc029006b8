"""``sample_kernel_share.narrate``: the hand-written sampler kernel's rows
over the tokens drawn, from the program's counters; nothing from a program
without the kernel's counter (one that samples by a sort), from a CPU run
(which takes the plain version) or without a trace."""

from test_hhb_metrics import make_run

from hhbench import harness, trace

CELL, NAME = "narrate4f336.b64x10", "sample_kernel_share.narrate"


def program_table(monkeypatch, table):
    from helping_hand_for_egocentric_videos_torch.utils import profiling

    monkeypatch.setattr(profiling, "spans", lambda: table, raising=False)


def test_reads_the_kernel_rows_over_the_tokens(monkeypatch):
    run = make_run(CELL)
    run.trace_data = trace.Trace(window=(0.0, 2e6))
    program_table(monkeypatch, {"hh.narrate.tokens": {"count": 48640, "host_s": 0.0, "device_s": None},
                                "hh.narrate.sample_kernel_rows": {"count": 48640, "host_s": 0.0, "device_s": None}})
    assert harness.load_metric(NAME).read(run) == 100.0


def test_reads_nothing_without_the_counter(monkeypatch):
    from helping_hand_for_egocentric_videos_torch.utils import profiling

    run = make_run(CELL)
    run.trace_data = trace.Trace(window=(0.0, 2e6))
    program_table(monkeypatch, {"hh.narrate.tokens": {"count": 48640, "host_s": 0.0, "device_s": None}})
    assert harness.load_metric(NAME).read(run) is None  # the parent, or a CPU run
    monkeypatch.delattr(profiling, "spans")  # an older program
    assert harness.load_metric(NAME).read(run) is None
    run.trace_data = None
    assert harness.load_metric(NAME).read(run) is None
