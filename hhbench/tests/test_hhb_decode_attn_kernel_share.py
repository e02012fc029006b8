"""``decode_attn_kernel_share.narrate``: the hand-written decode attention
kernel's calls over the decode steps' attention calls (48 self and 24
cross a step), from the program's counters; nothing from a program without
the kernel's counter (one that attends through SDPA), with no step, or
without a trace."""

from test_hhb_metrics import make_run

from hhbench import harness, trace

CELL, NAME = "narrate4f336.b64x10", "decode_attn_kernel_share.narrate"


def program_table(monkeypatch, table):
    from helping_hand_for_egocentric_videos_torch.utils import profiling

    monkeypatch.setattr(profiling, "spans", lambda: table, raising=False)


def _counter(n):
    return {"count": n, "host_s": 0.0, "device_s": None}


def test_reads_the_kernel_calls_over_the_steps_attention_calls(monkeypatch):
    run = make_run(CELL)
    run.trace_data = trace.Trace(window=(0.0, 2e6))
    program_table(monkeypatch, {"hh.narrate.decode_steps": _counter(76),
                                "hh.narrate.decode_attn_kernel_calls": _counter(76 * 72)})
    assert harness.load_metric(NAME).read(run) == 100.0
    program_table(monkeypatch, {"hh.narrate.decode_steps": _counter(76),
                                "hh.narrate.decode_attn_kernel_calls": _counter(76 * 48)})
    assert harness.load_metric(NAME).read(run) == 100.0 * 48 / 72  # the self calls alone


def test_reads_nothing_without_the_counter_or_a_step(monkeypatch):
    from helping_hand_for_egocentric_videos_torch.utils import profiling

    run = make_run(CELL)
    run.trace_data = trace.Trace(window=(0.0, 2e6))
    program_table(monkeypatch, {"hh.narrate.decode_steps": _counter(76)})
    assert harness.load_metric(NAME).read(run) is None  # the parent, or a CPU run
    program_table(monkeypatch, {"hh.narrate.decode_steps": _counter(0),
                                "hh.narrate.decode_attn_kernel_calls": _counter(0)})
    assert harness.load_metric(NAME).read(run) is None
    monkeypatch.delattr(profiling, "spans")  # an older program
    assert harness.load_metric(NAME).read(run) is None
    run.trace_data = None
    assert harness.load_metric(NAME).read(run) is None
