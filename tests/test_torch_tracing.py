"""The port's own spans and counters, on the CPU with tiny models.

- ``utils/profiling.py::span``: with no profiler it is one shared null
  context, and no ``record_function`` is entered through a train step, an
  eval forward or a loader pass; under ``torch.profiler`` a step's Chrome
  trace holds each ``hh.step.*`` range once, in order, not overlapping,
  and an eval forward the three ``hh.eval.*`` ranges; the step's metrics
  and parameters and the eval embeddings are the same bits with the
  profiler on and off; ``spans()`` holds the latest session alone, and
  counts ``hh.data.item`` from the loader's decode threads; ``trace``
  writes it beside its trace.
- ``serve/engine.py::_Stats``: the queue wait and the device time of a
  model that sleeps, and ``/healthz`` reports them.
- Every ``span("...")`` of the package is in ``SPANS``, and every name of
  ``SPANS`` is used and named in PERF.md.
"""

import ast
import json
import threading
import time
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from helping_hand_for_egocentric_videos_torch.data.loader import PrefetchLoader, ShardedSampler
from helping_hand_for_egocentric_videos_torch.models import (
    DecoderConfig,
    Lavila,
    LavilaConfig,
    ObjDecoder,
    SpaceTimeConfig,
    TextConfig,
)
from helping_hand_for_egocentric_videos_torch.serve import ServeConfig, ServingEngine
from helping_hand_for_egocentric_videos_torch.serve.server import make_server
from helping_hand_for_egocentric_videos_torch.train import EvalModel, TrainConfig, TrainState, make_train_step
from helping_hand_for_egocentric_videos_torch.utils import profiling

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "helping_hand_for_egocentric_videos_torch"
T, RES, B, R, NOUNS = 4, 28, 2, 5, 16
STEP_PHASES = ["hh.step.backbone", "hh.step.decoder", "hh.step.losses", "hh.step.backward", "hh.step.optim"]
EVAL_PHASES = ["hh.eval.preprocess", "hh.eval.tower", "hh.eval.decoder"]


def tiny_configs():
    lcfg = LavilaConfig(
        visual=SpaceTimeConfig(img_size=RES, patch_size=14, width=32, depth=2, heads=4, num_frames=T),
        text=TextConfig(width=32, heads=4, layers=2, embed_dim=16),
        embed_dim=16,
    )
    dcfg = DecoderConfig(
        d_model=32, nhead=4, num_layers=2, dim_feedforward=64, num_queries=13, num_classes=8,
        feature_dim=32, text_width=32, embed_dim=16, num_frames=T,
        patches_per_frame=lcfg.visual.patches_per_frame,
    )
    return lcfg, dcfg


def tiny_models(seed=0):
    lcfg, dcfg = tiny_configs()
    g = torch.Generator().manual_seed(seed)
    backbone, decoder = Lavila(lcfg, generator=g), ObjDecoder(dcfg, generator=g)
    with torch.no_grad():  # non-zero time attention
        for blk in backbone.visual.blocks:
            blk.timeattn.qkv.weight.normal_(0.0, 0.1, generator=g)
            blk.timeattn.proj.weight.normal_(0.0, 0.1, generator=g)
    return backbone.requires_grad_(False), decoder


def clips(n, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.random((n, T, RES, RES, 3)) * 255).astype(np.uint8)


def train_batch(seed=0):
    rng = np.random.default_rng(seed)
    tokens = np.zeros((B * R, 77), np.int64)
    for i in range(B * R):
        w = int(rng.integers(2, 6))
        tokens[i, 0], tokens[i, 1:1 + w], tokens[i, 1 + w] = 49406, rng.integers(1, 49406, size=w), 49407
    xy = rng.uniform(0, 150, size=(B, T, 4, 2))
    return {"video": clips(B, seed), "tokens": tokens,
            "noun_vec": (rng.random((B, NOUNS)) < 0.3).astype(np.float32),
            "verb_vec": (rng.random((B, 8)) < 0.3).astype(np.float32),
            "boxes": np.concatenate([xy, xy + 30.0], -1).astype(np.float32),
            "nouns": rng.integers(1, NOUNS, size=(B, 3))}


def make_trainer():
    """(state, step, backbone, noun dictionary) of a tiny f32 step."""
    lcfg, dcfg = tiny_configs()
    backbone, decoder = tiny_models()
    cfg = TrainConfig(input_res=RES, rephrase_factor=R, backbone_dtype=torch.float32)
    noun_dict = torch.randn(NOUNS, 32, generator=torch.Generator().manual_seed(5))
    return TrainState.create(decoder, cfg, device="cpu"), make_train_step(dcfg, lcfg, cfg), backbone, noun_dict


def run_steps(n=2):
    state, step, backbone, noun_dict = make_trainer()
    gen = torch.Generator().manual_seed(11)
    for k in range(n):
        state, metrics = step(state, backbone, train_batch(k), noun_dict, gen)
    return state, metrics


def eval_model():
    lcfg, dcfg = tiny_configs()
    backbone, decoder = tiny_models()
    return EvalModel(backbone, lcfg, decoder, dcfg, None, input_res=RES, dtype=torch.float32, device="cpu")


class Clips:
    """``n`` uint8 clips; records the thread that read each."""

    def __init__(self, n):
        self.n, self.threads, self.lock = n, [], threading.Lock()

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        with self.lock:
            self.threads.append(threading.current_thread())
        return {"video": clips(1, seed=i)[0], "index": np.int64(i)}


def drain(n=8, threads=2):
    data = Clips(n)
    loader = PrefetchLoader(data, ShardedSampler(n, 2, shuffle=False), num_threads=threads, depth=1)
    batches = list(loader)
    assert sum(len(b["index"]) for b in batches) == n
    return data


def ranges(prof, tmp_path, prefix):
    """The Chrome trace's ``user_annotation`` ranges named ``prefix*``, by start."""
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    ev = [e for e in json.loads(path.read_text())["traceEvents"]
          if e.get("ph") == "X" and e.get("cat") == "user_annotation" and e["name"].startswith(prefix)]
    return sorted(ev, key=lambda e: e["ts"])


# ----------------------------------------------------------------- off


def test_span_without_profiler_is_one_shared_null_context():
    a, b = profiling.span("hh.step.backbone"), profiling.span("hh.eval.tower", "cpu")
    assert a is b
    with a as got:
        assert got is None


def test_no_record_function_on_the_hot_paths_without_profiler(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered with no profiler")

    monkeypatch.setattr(profiling, "record_function", refuse)
    run_steps(1)
    eval_model().embed_video(clips(2))
    drain()


# ------------------------------------------------------------------ on


def test_step_trace_holds_each_phase_once_in_order(tmp_path):
    state, step, backbone, noun_dict = make_trainer()
    batch = train_batch()
    state, _ = step(state, backbone, batch, noun_dict)  # untraced: the session before this one ends
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(state, backbone, batch, noun_dict)
    ev = ranges(prof, tmp_path, "hh.step.")
    assert [e["name"] for e in ev] == STEP_PHASES
    assert all(a["ts"] + a["dur"] <= b["ts"] for a, b in zip(ev, ev[1:]))
    got = profiling.spans()
    assert sorted(got) == sorted(STEP_PHASES)
    assert all(got[n]["count"] == 1 and got[n]["host_s"] > 0 and got[n]["device_s"] is None for n in STEP_PHASES)


def test_eval_forward_trace_holds_its_three_ranges(tmp_path):
    model = eval_model()
    video = torch.as_tensor(clips(2))
    model.embed_clips(model.preprocess_video(video))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        model.embed_clips(model.preprocess_video(video))
    ev = ranges(prof, tmp_path, "hh.eval.")
    assert [e["name"] for e in ev] == EVAL_PHASES
    assert all(a["ts"] + a["dur"] <= b["ts"] for a, b in zip(ev, ev[1:]))
    got = profiling.spans()
    assert all(got[n]["count"] == 1 and got[n]["device_s"] == got[n]["host_s"] > 0 for n in EVAL_PHASES)


def test_profiler_changes_no_number_of_the_step():
    off_state, off_metrics = run_steps(2)
    with profile(activities=[ProfilerActivity.CPU]):
        on_state, on_metrics = run_steps(2)
    assert profiling.spans()["hh.step.optim"]["count"] == 2
    assert off_metrics.keys() == on_metrics.keys()
    assert all(torch.equal(off_metrics[k], on_metrics[k]) for k in off_metrics)
    for (name, a), (_, b) in zip(off_state.decoder.named_parameters(), on_state.decoder.named_parameters()):
        assert torch.equal(a, b), name


def test_profiler_changes_no_embedding():
    model, video = eval_model(), clips(3, seed=4)
    emb, boxes = model.embed_video(video)
    with profile(activities=[ProfilerActivity.CPU]):
        emb_on, boxes_on = model.embed_video(video)
    assert profiling.spans()["hh.eval.tower"]["count"] == 1
    np.testing.assert_array_equal(emb, emb_on)
    np.testing.assert_array_equal(boxes, boxes_on)


def test_spans_hold_the_latest_session_only():
    """A session's table starts at its first span that records after a
    span ran with no profiler: the program running between sessions."""
    model, video = eval_model(), clips(2)
    model.embed_video(video)
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(3):
            model.embed_video(video)
        drain(6)
    first = profiling.spans()
    assert first["hh.eval.tower"]["count"] == 3 and first["hh.data.item"]["count"] == 6
    model.embed_video(video)  # the program runs on between the sessions
    with profile(activities=[ProfilerActivity.CPU]):
        drain(4)
    second = profiling.spans()
    assert set(second) == {"hh.data.item"} and second["hh.data.item"]["count"] == 4
    assert profiling.spans() == second  # reading leaves the table as it was


def test_loader_items_are_counted_from_the_decode_threads():
    drain(2)
    with profile(activities=[ProfilerActivity.CPU]):
        data = drain(10, threads=3)
    got = profiling.spans()["hh.data.item"]
    assert got["count"] == 10 == len(data.threads) and got["host_s"] > 0
    assert threading.main_thread() not in data.threads


def test_trace_writes_the_spans_beside_the_trace(tmp_path):
    model, video = eval_model(), clips(2)
    model.embed_video(video)
    with profiling.trace(str(tmp_path), device="cpu"):
        model.embed_video(video)
    assert (tmp_path / "trace.json").is_file()
    written = json.loads((tmp_path / "spans.json").read_text())
    assert written == profiling.spans() and sorted(written) == sorted(EVAL_PHASES)


# --------------------------------------------------------------- engine


class GatedModel:
    """A model whose device calls take ``NAP`` seconds, the first only
    once ``release`` is set."""

    NAP = 0.1
    device = "cpu"

    def __init__(self):
        self.entered, self.release = threading.Event(), threading.Event()

    @staticmethod
    def tokenizer(texts):
        return np.zeros((len(texts), 77), np.int64)

    def embed_tokens(self, tokens):
        self.entered.set()
        self.release.wait(10.0)
        time.sleep(self.NAP)
        return np.zeros((len(tokens), 4), np.float32)


def test_engine_counts_queue_wait_and_device_time_and_healthz_reports_them():
    model, held = GatedModel(), 0.2
    engine = ServingEngine(model, video_shape=(T, RES, RES, 3), cfg=ServeConfig(buckets=(1, 2), max_wait_ms=1.0))
    srv = make_server(engine, "127.0.0.1", 0)
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    took = {}

    def submit(name, texts):
        t0 = time.perf_counter()
        engine.submit_text(texts)
        took[name] = time.perf_counter() - t0

    try:
        first = threading.Thread(target=submit, args=("first", ["a", "b"]))
        first.start()
        assert model.entered.wait(10.0)  # the first call is on the device
        second = threading.Thread(target=submit, args=("second", ["c"]))
        second.start()
        time.sleep(held)  # the second request waits in the queue
        model.release.set()
        for t in (first, second):
            t.join(timeout=10)
            assert not t.is_alive()
        st = engine.stats["text"].snapshot()
        assert st["device_calls"] == 2 and st["requests"] == 2
        assert held + 2 * model.NAP <= st["device_s"] <= took["first"] + took["second"]
        assert held <= st["queue_wait_max_s"] <= took["second"] - model.NAP
        assert st["queue_wait_max_s"] <= st["queue_wait_s"] <= took["first"] - held - model.NAP + st["queue_wait_max_s"]
        with urllib.request.urlopen(f"http://127.0.0.1:{srv.server_address[1]}/healthz", timeout=30) as r:
            health = json.loads(r.read())
        assert health["stats"]["text"] == st
        assert health["stats"]["video"]["queue_wait_s"] == health["stats"]["video"]["device_s"] == 0.0
    finally:
        model.release.set()
        srv.shutdown()
        srv.server_close()
        engine.close()
        th.join(timeout=30)
    assert not th.is_alive()


# ------------------------------------------------------------ catalogue


def _span_literals():
    for path in sorted(PORT.rglob("*.py")):
        for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
            if (isinstance(node, ast.Call) and getattr(node.func, "id", getattr(node.func, "attr", None)) == "span"
                    and node.args):
                arg = node.args[0]
                yield path.relative_to(ROOT), arg.value if isinstance(arg, ast.Constant) else None


def test_every_span_of_the_package_is_in_the_catalogue():
    used = list(_span_literals())
    assert used and all(isinstance(name, str) for _, name in used), used
    assert {name for _, name in used} <= set(profiling.SPANS), used


def test_every_catalogued_span_is_used_and_named_in_perf_md():
    used = {name for _, name in _span_literals()}
    assert set(profiling.SPANS) == used
    perf = (ROOT / "PERF.md").read_text()
    assert [n for n in profiling.SPANS if f"`{n}`" not in perf] == []
