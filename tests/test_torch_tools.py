"""The port's host tools against the JAX package's, on the CPU.

- ``cli.doctor``: ``--device cpu`` reports a usable CPU (rc 0) with the
  JAX report's host fields equal; without a CUDA device the default
  reports the missing device (rc 1); ``_with_timeout``'s cases (a hung
  call, a value, an error); ``released_weights_report`` with the weights
  absent and present, as JAX's, its md5 sidecar in the checkout's
  ``build/``;
- ``cli.extract_clips``: through ``tests/test_ffmpeg_path.py``'s fake
  ``ffmpeg`` (the native pipe: skip-existing, ``--overwrite``, a corrupt
  source leaving no store) and through the cv2 fallback on real mp4s,
  the ``.npy`` stores equal to JAX's bit for bit;
- ``utils/profiling.py``: ``top_ops`` on a CPU trace of ``trace`` (host
  operators, self time, descending), on a hand-made trace (self time =
  duration less the direct children's; device events by name), and
  without a trace.
"""

import json
import os
import shutil
import time

import numpy as np
import pytest
import torch

from helping_hand_for_egocentric_videos_tpu.cli import doctor as j_doctor
from helping_hand_for_egocentric_videos_tpu.cli import extract_clips as j_extract
from helping_hand_for_egocentric_videos_tpu.data import native as j_native
from helping_hand_for_egocentric_videos_tpu.data import video as j_video
from helping_hand_for_egocentric_videos_torch.cli import doctor, extract_clips
from helping_hand_for_egocentric_videos_torch.data import native as t_native
from helping_hand_for_egocentric_videos_torch.data import video as t_video
from helping_hand_for_egocentric_videos_torch.ops._build import BUILD_DIR
from helping_hand_for_egocentric_videos_torch.utils import profiling
from test_ffmpeg_path import _calls, _frame_values, fake_ffmpeg  # noqa: F401  (fixture re-export)

# ---------------------------------------------------------------- doctor


def test_doctor_cpu_is_usable_and_reports_the_host_as_jax(capsys):
    rc = doctor.main(["--device", "cpu", "--timeout", "60"])
    rep = json.loads(capsys.readouterr().out)
    assert rc == 0 and rep["usable"] is True
    assert rep["devices"] == ["cpu"] and rep["device_smoke"] == "ok" and rep["devices_error"] is None
    assert rep["torch"] == torch.__version__ and rep["device"] == "cpu"
    kb = rep["kernel_build"]
    assert kb["dir"] == str(BUILD_DIR) and kb["entries"] == len(kb["libraries"])
    j_rc = j_doctor.main(["--timeout", "60"])
    want = json.loads(capsys.readouterr().out)
    assert j_rc == 0
    for k in ("python", "native_stage", "ffmpeg", "bpe_vocab", "usable"):
        assert rep[k] == want[k], k
    # each package's own probe: the optional wheels are looked up when its data/video.py is
    # first imported, and another test file may have stubbed one in sys.modules by then
    assert rep["decode_backends"] == t_video.available_backends()
    assert want["decode_backends"] == j_video.available_backends()
    assert set(want) - set(rep) == {"jax", "jax_platforms_env", "compile_cache"}


def test_doctor_without_cuda_reports_and_fails(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    rc = doctor.main(["--timeout", "60"])
    rep = json.loads(capsys.readouterr().out)
    assert rc == 1 and rep["usable"] is False and rep["devices"] is None
    assert "no CUDA device" in rep["devices_error"] and rep["device_smoke"] == "skipped (no devices)"


def test_doctor_reports_a_native_library_that_cannot_load(tmp_path, capsys, monkeypatch):
    """A decode library that cannot load (built on another machine, its
    libjpeg missing here) counts as unavailable, as a failed build does:
    the doctor reports it and the gated backends go without it."""
    bad = tmp_path / "libhh_dataio.so"
    bad.write_bytes(b"not a shared library")
    monkeypatch.setattr(t_native, "_LIB_PATH", str(bad))
    t_native.get_lib.cache_clear()
    try:
        rc = doctor.main(["--device", "cpu"])
    finally:
        t_native.get_lib.cache_clear()
    rep = json.loads(capsys.readouterr().out)
    assert rc == 0 and rep["native_stage"].startswith("cannot load") and rep["ffmpeg"] is False
    assert "native-jpeg" not in rep["decode_backends"] and "npy" in rep["decode_backends"]


@pytest.mark.parametrize("case", ["hung", "value", "error"])
def test_with_timeout_cases_as_jax(case):
    fn, seconds = {"hung": (lambda: time.sleep(30), 0.2), "value": (lambda: 7, 5),
                   "error": (lambda: 1 / 0, 5)}[case]
    ok, val = doctor._with_timeout(fn, seconds)
    j_ok, j_val = j_doctor._with_timeout(fn, seconds)
    assert ok == j_ok
    if case == "hung":
        assert not ok and "no response" in val
    elif case == "value":
        assert ok and val == j_val == 7
    else:
        assert not ok and "ZeroDivisionError" in val and val == j_val


def test_released_weights_report_absent_and_present_as_jax(tmp_path, monkeypatch):
    monkeypatch.setenv("HOME", str(tmp_path / "home"))  # JAX's md5 sidecar lives under ~/.cache
    monkeypatch.setenv("HH_WEIGHTS", str(tmp_path / "w"))
    monkeypatch.delenv("HH_CLIP_CACHE", raising=False)
    sidecar = tmp_path / "build" / "doctor_md5.json"
    assert doctor.MD5_CACHE == BUILD_DIR.parent / "doctor_md5.json"
    monkeypatch.setattr(doctor, "MD5_CACHE", sidecar)
    (tmp_path / "w").mkdir()

    rep, want = doctor.released_weights_report(), j_doctor.released_weights_report()
    assert rep == want and rep["parity_gate_ready"] is False
    assert "helping-hand-ckpt-nq12.pth.tar" in rep["blocked_on"]

    for spec in doctor.RELEASED_WEIGHTS[:2]:
        (tmp_path / "w" / spec["file"]).write_bytes(b"stub-weights")
    rep, want = doctor.released_weights_report(), j_doctor.released_weights_report()
    assert rep["parity_gate_ready"] is True
    assert rep["run"] == want["run"].replace("videos_tpu.", "videos_torch.")
    assert {k: v for k, v in rep.items() if k != "run"} == {k: v for k, v in want.items() if k != "run"}
    lavila = rep["found"][doctor.RELEASED_WEIGHTS[0]["file"]]
    assert lavila["bytes"] > 0 and len(lavila["md5"]) == 32 and lavila["md5_matches_name"] is False
    assert lavila["md5"] in json.loads(sidecar.read_text()).values()


# ---------------------------------------------------------- extract_clips


def _extract_both(tmp_path, *extra):
    for name, mod in (("jax", j_extract), ("torch", extract_clips)):
        mod.main(["--src", str(tmp_path / name), "--fps", "30", "--height", "4", "--width", "6", *extra])


def test_extract_clips_ffmpeg_branch_matches_jax(fake_ffmpeg, capsys):  # noqa: F811
    """The native ffmpeg pipe of both packages on the same sources: the
    same stores, the same skip / overwrite behaviour, and no store for a
    source that decodes to nothing."""
    tmp_path, log, make_chunk = fake_ffmpeg
    assert t_native.has_ffmpeg()
    for name in ("jax", "torch"):
        (tmp_path / name / "v1").mkdir(parents=True)
        make_chunk(f"{name}/v1/0.mp4", frames=10, base=50)
        (tmp_path / name / "v1" / "bad.mp4").write_bytes(b"\x00\x00\x00 ftypisom")
    _extract_both(tmp_path)
    out = capsys.readouterr().out
    assert out.count("extracted 1/2 videos") == 2 and out.count("FAILED") == 2
    got, want = (np.load(tmp_path / n / "v1" / "0.mp4.npy") for n in ("torch", "jax"))
    assert got.shape == (10, 4, 6, 3) and _frame_values(got) == list(range(50, 60))
    np.testing.assert_array_equal(got, want)
    assert not (tmp_path / "torch" / "v1" / "bad.mp4.npy").exists()

    n_calls = len(_calls(log))
    _extract_both(tmp_path)  # existing stores are skipped
    assert len(_calls(log)) == n_calls + 2  # only bad.mp4, once a package
    store = tmp_path / "torch" / "v1" / "0.mp4.npy"
    np.save(store, np.zeros((1, 4, 6, 3), np.uint8))
    extract_clips.main(["--src", str(tmp_path / "torch"), "--fps", "30", "--height", "4", "--width", "6",
                        "--overwrite"])
    np.testing.assert_array_equal(np.load(store), want)


def _write_mp4(path, n, w=64, h=48):
    cv2 = pytest.importorskip("cv2")
    wr = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), 30.0, (w, h))
    assert wr.isOpened(), "cv2 build lacks mp4 encoding"
    rng = np.random.default_rng(n)
    for i in range(n):
        frame = np.zeros((h, w, 3), np.uint8)
        frame[:, : (i * 3) % w] = rng.integers(0, 256, size=3, dtype=np.uint8)
        wr.write(frame)
    wr.release()


def test_extract_clips_fallback_matches_jax(tmp_path, monkeypatch):
    """Without an ffmpeg binary both packages decode with the gated
    backends (cv2) and resize to --height / --width: equal stores."""
    monkeypatch.setattr(j_native, "has_ffmpeg", lambda: False)
    monkeypatch.setattr(t_native, "has_ffmpeg", lambda: False)
    src = tmp_path / "jax" / "vid_a"
    src.mkdir(parents=True)
    _write_mp4(src / "0.mp4", 30)
    _write_mp4(src / "1.mp4", 12)
    shutil.copytree(tmp_path / "jax", tmp_path / "torch")
    for name, mod in (("jax", j_extract), ("torch", extract_clips)):
        mod.main(["--src", str(tmp_path / name), "--fps", "30", "--height", "24", "--width", "32"])
    for f in ("0.mp4.npy", "1.mp4.npy"):
        got, want = np.load(tmp_path / "torch" / "vid_a" / f), np.load(tmp_path / "jax" / "vid_a" / f)
        assert got.shape[1:] == (24, 32, 3) and got.shape[0] in (30, 12)
        np.testing.assert_array_equal(got, want)


# -------------------------------------------------------------- profiling


def test_top_ops_on_a_cpu_trace(tmp_path):
    a = torch.randn(256, 256)
    with profiling.trace(str(tmp_path), device="cpu"):
        for _ in range(3):
            b = torch.relu(a @ a)
        b.sum()
    rows = profiling.top_ops(str(tmp_path), k=5)
    assert 1 <= len(rows) <= 5
    assert all(where == "host" and ms >= 0 for ms, where, _ in rows)
    assert [r[0] for r in rows] == sorted((r[0] for r in rows), reverse=True)
    names = [r[2] for r in profiling.top_ops(str(tmp_path), k=100)]
    assert "aten::mm" in names and "aten::relu" in names


def test_trace_keeps_idle_margins_around_the_body(tmp_path):
    """The window opens and closes on ``TRACE_MARGIN_S`` of idle host time: the
    profiler's span of it reaches that far beyond the body's first and last
    operators, and the trace is still written."""
    a = torch.randn(64, 64)
    with profiling.trace(str(tmp_path), device="cpu"):
        torch.relu(a @ a)
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    ops = [e for e in events if e.get("ph") == "X" and e.get("cat") == "cpu_op"]
    (window,) = [e for e in events if e.get("ph") == "X" and e.get("cat") == "Trace"]
    assert {"aten::mm", "aten::relu"} <= {e["name"] for e in ops}
    assert min(e["ts"] for e in ops) - window["ts"] >= profiling.TRACE_MARGIN_S * 1e6
    assert window["ts"] + window["dur"] - max(e["ts"] + e["dur"] for e in ops) >= profiling.TRACE_MARGIN_S * 1e6
    assert profiling.top_ops(str(tmp_path), k=100)


def test_device_ms_reads_only_a_trace_that_holds_every_launch(monkeypatch):
    """``device_ms`` sums the named kernels' device time (a tuple of names,
    matched as substrings) over a trace that holds ``per_call * iters`` of
    their launches; a trace that lost one is taken again, and after
    ``TRACE_TRIES`` of them it raises."""
    from types import SimpleNamespace

    def trace(attention):
        return [SimpleNamespace(key="void attention_bf16_kernel<64>", count=attention, self_device_time_total=100.0),
                SimpleNamespace(key="row_int8_kernel", count=20, self_device_time_total=60.0),
                SimpleNamespace(key="gemm", count=20, self_device_time_total=1e6)]

    traces = iter([trace(19), trace(20)])
    monkeypatch.setattr(profiling, "kernel_events", lambda fn, iters: next(traces))
    assert profiling.device_ms(None, 20, ("attention_bf16", "row_int8"), per_call=2) == 160.0 / 20 / 1e3
    calls = []
    monkeypatch.setattr(profiling, "kernel_events", lambda fn, iters: calls.append(1) or trace(19))
    with pytest.raises(RuntimeError, match="lost events"):
        profiling.device_ms(None, 20, "attention_bf16_kernel")
    assert len(calls) == profiling.TRACE_TRIES


def test_top_ops_self_time_rule(tmp_path):
    ev = [
        {"ph": "X", "cat": "cpu_op", "name": "outer", "pid": 1, "tid": 1, "ts": 0, "dur": 10},
        {"ph": "X", "cat": "cpu_op", "name": "inner", "pid": 1, "tid": 1, "ts": 2, "dur": 4},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "pid": 1, "tid": 1, "ts": 3, "dur": 1},
        {"ph": "X", "cat": "cpu_op", "name": "inner", "pid": 1, "tid": 2, "ts": 2, "dur": 3},
        {"ph": "X", "cat": "kernel", "name": "gemm", "pid": 0, "tid": 7, "ts": 5, "dur": 2000},
        {"ph": "X", "cat": "kernel", "name": "gemm", "pid": 0, "tid": 7, "ts": 3000, "dur": 1000},
        {"ph": "X", "cat": "user_annotation", "name": "ProfilerStep#1", "pid": 1, "tid": 1, "ts": 0, "dur": 99},
        {"ph": "i", "cat": "cpu_op", "name": "instant", "pid": 1, "tid": 1, "ts": 1},
    ]
    (tmp_path / "trace.json").write_text(json.dumps({"traceEvents": ev}))
    rows = profiling.top_ops(str(tmp_path))
    # outer 10 - inner 4; inner (4 - 1) + 3; the kernel 2000 + 1000 us
    assert rows[0] == (3.0, "device", "gemm") and len(rows) == 4
    assert {r[2]: (r[0], r[1]) for r in rows} == {"gemm": (3.0, "device"), "outer": (0.006, "host"),
                                                  "inner": (0.006, "host"), "cudaLaunchKernel": (0.001, "host")}


def test_top_ops_without_a_trace(tmp_path):
    with pytest.raises(FileNotFoundError, match="no trace.json"):
        profiling.top_ops(str(tmp_path))
    os.makedirs(tmp_path / "empty", exist_ok=True)
    with pytest.raises(FileNotFoundError):
        profiling.top_ops(str(tmp_path / "empty"))
