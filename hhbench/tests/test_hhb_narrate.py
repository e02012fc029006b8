"""The narrator cell (``narrate4f336.b64x10``) on the CPU at tiny widths
(``conftest.py``): its driver rehearsed traced and not, the fp8 and bf16
controls and both planted faults making ``correct`` false, the warm-up's
stopping rule, ``counts/narrator.py`` against the program's FLOP counter,
each new reader on a hand-made trace or span table, the reference's
isolation, and a program without the narrator failing at once."""

import json
import subprocess
import sys
import time

import pytest
import tiny
from test_hhb_metrics import make_run
from test_hhb_rehearsal import f32_run, run_module

from hhbench import harness, narrate_faults, narrator_weights, trace
from hhbench.counts import attention
from hhbench.counts import narrator as counts
from hhbench.mixes import narrate
from hhbench.counts.peaks import PEAKS

CELL = "narrate4f336.b64x10"
READERS = ["step_mfu.narrate", "tower_device_share.narrate", "decode_device_share.narrate",
           "sample_device_share.narrate", "decode_launches_per_step.narrate", "decode_attn_roofline.narrate",
           "attn_roofline.narrate"]
SHARES = ["tower_device_share.narrate", "decode_device_share.narrate", "sample_device_share.narrate"]


def full_cfg():
    return harness.read_json(harness.HERE / "configs" / "lavila-vclm-l14-336-gpt2xl.json")


@pytest.mark.parametrize("trace_on", [False, True])
def test_rehearsal(trace_on):
    run = f32_run(CELL, seconds=0.5, trace=trace_on)
    line = run_module().execute(run)
    assert line["correct"] is True, line["compared"]
    c = line["compared"]
    assert c["logit_gap"]["value"] < 1e-4 and c["nucleus_miss"]["value"] == 0.0
    assert line["attempted"] % 2 == 0 and line["attempted"] >= 2
    if trace_on:
        m = line["metrics"]
        # on the CPU the spans' device time is host time; no launch calls and no roofline off the card
        assert set(SHARES) <= set(m) and "step_mfu.narrate" in m
        assert not {"decode_launches_per_step.narrate", "decode_attn_roofline.narrate", "attn_roofline.narrate"} & set(m)
        assert sum(m[n]["value"] for n in SHARES) <= 100.0
    else:
        assert set(line["metrics"]) == {"embed_clips_per_s", "setup_s"}


@pytest.mark.parametrize("fault", narrate_faults.FAULTS)
def test_fault_fails_the_check(fault):
    run = f32_run(CELL, seconds=0.3)
    with narrate_faults.planted(fault):
        line = run_module().execute(run)
    assert line["correct"] is False, line["compared"]


@pytest.mark.parametrize("control", ["ref_fp8_lm", "ref_fp8"])
def test_fp8_controls_fail_the_check(control):
    """The language model in fp8 fails by ``logit_gap`` alone (its tower and
    pooler are float32); every part in fp8 also moves the tower's and the
    pooler's gaps."""
    from hhbench import calibrate_narrate

    run = f32_run(CELL)
    compared = calibrate_narrate.control_compared(run.cell, 2**31 + 7, "cpu", *calibrate_narrate.CONTROLS[control])
    ok, judged = harness.judge(compared, run.cell.limits)
    assert not ok and judged["logit_gap"]["value"] > judged["logit_gap"]["limit"], judged
    gaps = [judged["vis_gap"]["value"], judged["pool_gap"]["value"]]
    assert all(g < 1e-6 for g in gaps) if control == "ref_fp8_lm" else all(g > 1e-3 for g in gaps)


def test_bf16_logits_control_fails_by_the_logits_type_alone():
    """The language model's LayerNorms, softmax and logits in bf16: its gaps
    stay within their limits (no gap tells bf16 rounding there from the
    bf16 model's own), but every logit is one that bf16 holds."""
    from hhbench import calibrate_narrate

    run = f32_run(CELL)
    compared = calibrate_narrate.control_compared(run.cell, 2**31 + 7, "cpu",
                                                  *calibrate_narrate.CONTROLS["ref_bf16_ln_softmax_logits"])
    ok, judged = harness.judge(compared, run.cell.limits)
    assert not ok and judged["logit_bf16_share"]["value"] == 1.0, judged
    assert all(judged[n]["value"] <= judged[n]["limit"] for n in judged if n != "logit_bf16_share"), judged
    assert judged["logit_gap"]["value"] > 1e-4  # the rounding shows, under the limit


@pytest.mark.parametrize("ms, want", [
    # batch times read on an H100 (ms): the first replay, a slow stretch, the drop, 3 batches after it
    ([1951.9, 1925.5, 1934.9, 1933.0, 1914.2, 1913.0, 1913.9], True),
    ([1951.9, 1925.5, 1934.9, 1933.0, 1914.2, 1913.0], False),
    # fast from the first replay on: no drop, the time cap ends the warm-up
    ([1937.9, 1915.4, 1914.5, 1915.1, 1913.9, 1913.8, 1915.0], False),
    # the slow stretch is as flat as the lasting time: not settled
    ([1936.3, 1933.2, 1935.5, 1934.7, 1935.4, 1933.6, 1930.1], False),
])
def test_warm_up_settles_after_the_drop(ms, want):
    assert narrate.settled(ms, 3, 0.006) is want


def test_warm_up_stops_at_the_drop_or_the_cap():
    class Model:
        def __init__(self, ms):
            self.ms, self.calls = list(ms), 0

        def narrate(self, batch, generator):
            time.sleep(self.ms[min(self.calls, len(self.ms) - 1)] / 1e3)
            self.calls += 1

    p = {"warmup_s": 5.0, "warmup_min_s": 0.0, "settle": 3, "drop": 0.3}  # sleeps jitter by more than 0.6%
    slow_then_fast = Model([0, 60, 60, 60, 60, 20, 20, 20, 20])
    got = narrate.warm_up(slow_then_fast, [None], 1, "cpu", p)
    assert got["settled"] and slow_then_fast.calls == 8 and len(got["batch_ms"]) == 7
    floored = Model([0, 60, 60, 20])
    got = narrate.warm_up(floored, [None], 1, "cpu", dict(p, warmup_min_s=0.4))
    assert got["settled"] and floored.calls > 5 and got["s"] - got["eager_s"] >= 0.4
    flat = Model([0, 20])
    got = narrate.warm_up(flat, [None], 1, "cpu", dict(p, warmup_s=0.3))
    assert not got["settled"] and 0.3 <= got["s"] - got["eager_s"] < 1.0


@pytest.mark.parametrize("tiny_widths", [False, True])
def test_counts_equal_the_programs(tiny_widths):
    from helping_hand_for_egocentric_videos_torch.utils import flops as port_flops

    cfg = tiny.tiny_cfg(full_cfg()) if tiny_widths else full_cfg()
    pc = narrator_weights.port_config(cfg)
    assert counts.pool_flops(cfg) == port_flops.narrator_pool_flops(pc)
    assert counts.cross_kv_flops(cfg) == port_flops.narrator_cross_kv_flops(pc)
    assert counts.token_flops(cfg["lm"], 7, 8) == port_flops.gpt2_token_flops(pc.lm, 7, 8)
    assert counts.flops_per_clip(cfg) == port_flops.narrator_flops_per_clip(pc)
    if not tiny_widths:  # about 2.0 TFLOP of tower and 2.6 of decoding a clip
        assert 4.5e12 < counts.flops_per_clip(cfg) < 4.8e12


def test_decode_attention_work_by_hand():
    cfg = tiny.tiny_cfg(full_cfg())  # 3 sequences of 6 positions, 4 blocks (2 cross), d 64, 8 latents
    nbytes, ops = counts.decode_attn_work(cfg, clips=2, dtype="bfloat16")
    n, d, keys = 6, 64, sum(range(1, 6))
    want_bytes = 2 * (4 * (n * 2 * d * keys + 2 * n * d * 5) + 2 * 5 * (2 * 2 * 8 * d + 2 * n * d))
    assert nbytes == want_bytes
    assert ops == 4 * n * 4 * d * keys + 2 * 5 * n * 4 * 8 * d
    least = counts.decode_attn_least_seconds(cfg, 2, "bfloat16", PEAKS["sxm"])
    assert least == pytest.approx(want_bytes / 3.35e12)  # bandwidth-bound
    full = counts.decode_attn_work(full_cfg(), clips=64, dtype="bfloat16")[0]
    # a batch: 575 GB of self-cache reads over the 76 steps, 191 GB of cross cache, 22 GB of rows
    assert 0.78e12 < full < 0.80e12


def program_table(monkeypatch, table):
    from helping_hand_for_egocentric_videos_torch.utils import profiling

    monkeypatch.setattr(profiling, "spans", lambda: table, raising=False)


def test_share_readers_from_a_filled_table(monkeypatch):
    run = make_run(CELL)
    run.trace_data = trace.Trace(window=(0.0, 4e6))  # 4 s
    run.traced_items, run.traced_steps = 64, 76
    program_table(monkeypatch, {
        "hh.narrate.tower": {"count": 1, "host_s": 0.1, "device_s": 0.4},
        "hh.narrate.decode": {"count": 76, "host_s": 1.0, "device_s": 2.0},
        "hh.narrate.sample": {"count": 76, "host_s": 0.2, "device_s": 0.6},
    })
    read = {n: harness.load_metric(n).read(run) for n in SHARES}
    assert read == pytest.approx(dict(zip(SHARES, [10.0, 50.0, 15.0])))


def test_roofline_reader_reads_the_attention_kernels_but_the_towers():
    run = make_run(CELL)
    run.traced_items = 64
    run.peaks = lambda: PEAKS["sxm"]
    tower = "void (anonymous namespace)::attention_bf16_kernel<__nv_bfloat16, 64>(...)"
    sdpa = "cudnn_generated_fort_native_sdpa_sm80_flash_fprop_wmma_f16_knob_3_64x64x64_4x1x1_cga1x1x1_kernel0_0"
    device = [(tower, 0.0, 100000.0, "kernel"), (sdpa, 1e5, 300000.0, "kernel"), ("flash_fwd_kernel", 5e5, 200000.0,
                                                                                  "kernel"),
              ("nvjet_gemm", 8e5, 100000.0, "kernel")]
    run.trace_data = trace.Trace(window=(0.0, 1e6), device=device)
    least = counts.decode_attn_least_seconds(run.cfg, 64, "bfloat16", PEAKS["sxm"])
    assert harness.load_metric("decode_attn_roofline.narrate").read(run) == pytest.approx(100.0 * least / 0.5)
    run.trace_data = trace.Trace(window=(0.0, 1e6), device=device[:1])  # no decode attention: a CPU run's
    assert harness.load_metric("decode_attn_roofline.narrate").read(run) is None


def test_tower_roofline_reader_reads_the_towers_kernels_alone():
    run = make_run(CELL)
    run.traced_items = 64
    run.peaks = lambda: PEAKS["sxm"]
    tower = "void (anonymous namespace)::attention_bf16_kernel<__nv_bfloat16, 64>(...)"
    sdpa = "cudnn_generated_fort_native_sdpa_sm80_flash_fprop_wmma_f16_knob_3_64x64x64_4x1x1_cga1x1x1_kernel0_0"
    device = [(tower, 0.0, 100000.0, "kernel"), (sdpa, 1e5, 300000.0, "kernel"), ("nvjet_gemm", 4e5, 1e5, "kernel")]
    run.trace_data = trace.Trace(window=(0.0, 1e6), device=device)
    # a clip at 336 px over 4 frames: 24 blocks of a space call (577 keys) and a time call (5 keys)
    least = attention.tower_least_seconds_per_clip(run.cfg["visual"], "bfloat16", PEAKS["sxm"])
    assert least == pytest.approx(24 * sum(attention.least_seconds(1, 4, 576, 1024, m, "bfloat16", PEAKS["sxm"])
                                           for m in ("space", "time")))
    assert harness.load_metric("attn_roofline.narrate").read(run) == pytest.approx(100.0 * 64 * least / 0.1)
    run.trace_data = trace.Trace(window=(0.0, 1e6), device=device[1:])  # no tower kernel: a CPU run's
    assert harness.load_metric("attn_roofline.narrate").read(run) is None


def test_mfu_reader():
    run = make_run(CELL)
    run.items, run.window_s = 640, 10.0
    want = 100.0 * 64.0 * counts.flops_per_clip(run.cfg) / 989e12
    assert harness.load_metric("step_mfu.narrate").read(run) == pytest.approx(want)


def test_launch_reader_from_a_hand_made_trace(tmp_path):
    def ev(cat, name, ts, dur):
        return {"ph": "X", "cat": cat, "name": name, "ts": float(ts), "dur": float(dur), "pid": 1, "tid": 1}

    events = [ev("user_annotation", trace.WINDOW, 0, 10000)]
    for s in range(2):  # two decode steps of 3 launches (a graph's in one), a sampling launch after each
        t = 1000 + 3000 * s
        events.append(ev("user_annotation", "hh.narrate.decode", t, 1000))
        names = ["cudaLaunchKernel", "cuLaunchKernel", "cudaGraphLaunch"]
        events += [ev("cuda_runtime", names[i], t + 100 + 200 * i, 10) for i in range(3)]
        events.append(ev("user_annotation", "hh.narrate.sample", t + 1500, 500))
        events.append(ev("cuda_runtime", "cudaLaunchKernel", t + 1600, 10))
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    run = make_run(CELL)
    run.trace_data, run.traced_steps = trace.parse(str(path)), 2
    assert harness.load_metric("decode_launches_per_step.narrate").read(run) == pytest.approx(3.0)
    run.trace_data = trace.Trace(window=run.trace_data.window, host=[h for h in run.trace_data.host
                                                                     if not h[0].startswith("hh.")])
    assert harness.load_metric("decode_launches_per_step.narrate").read(run) is None  # an older program


def test_reference_process_loads_no_program_module():
    code = ("import sys; sys.path.insert(0, %r); import hhbench.reference.narrator; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))") % str(harness.ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, check=True).stdout
    tops = set(json.loads(out.replace("'", '"')))
    assert "helping_hand_for_egocentric_videos_torch" not in tops and not tops & set(harness.FORBIDDEN)


def test_a_program_without_the_narrator_fails_at_once(monkeypatch):
    """An older program, which has no narrator, under this benchmark:
    ``mixes/narrate.py`` raises before any work."""
    import time

    monkeypatch.setitem(sys.modules, "helping_hand_for_egocentric_videos_torch.models.narrator", None)
    t0 = time.perf_counter()
    with pytest.raises(ImportError):
        harness.drive(f32_run(CELL))
    assert time.perf_counter() - t0 < 5.0
