"""Serving layer of the PyTorch port, on the CPU: bucketed micro-batching
engine + HTTP front end. Mirrors tests/test_serve.py: results equal direct
EvalModel calls (padding is masked out), concurrent requests coalesce,
oversized requests chunk at the largest bucket, every route round-trips,
and health() stays device-free."""

import io
import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from helping_hand_for_egocentric_videos_torch.data import ClipTokenizer
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
from helping_hand_for_egocentric_videos_torch.train import EvalModel

T, RES = 4, 28
CLIP = (T, RES, RES, 3)


def tiny_eval_model(**kw):
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
    g = torch.Generator().manual_seed(0)
    backbone, decoder = Lavila(lcfg, generator=g), ObjDecoder(dcfg, generator=g)
    with torch.no_grad():  # non-zero time attention
        for blk in backbone.visual.blocks:
            blk.timeattn.qkv.weight.normal_(0.0, 0.1, generator=g)
            blk.timeattn.proj.weight.normal_(0.0, 0.1, generator=g)
    return EvalModel(backbone, lcfg, decoder, dcfg, ClipTokenizer(), input_res=RES,
                     dtype=torch.float32, device="cpu", **kw)


def _clips(n, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.random((n, *CLIP)) * 255).astype(np.uint8)


@pytest.fixture(scope="module")
def model():
    return tiny_eval_model()


@pytest.fixture(scope="module")
def engine(model):
    eng = ServingEngine(model, video_shape=CLIP, cfg=ServeConfig(buckets=(1, 2, 4), max_wait_ms=2.0))
    yield eng
    eng.close()


def test_engine_matches_direct_calls_with_padding(engine):
    texts = ["wash hands", "cut onion", "open fridge"]  # 3 -> bucket 4
    video = _clips(3)
    emb_t = engine.submit_text(texts)
    emb_v, boxes = engine.submit_video(video)
    want_v, want_b = engine.model.embed_video(video)
    np.testing.assert_allclose(emb_t, engine.model.embed_text(texts), atol=1e-5)
    np.testing.assert_allclose(emb_v, want_v, atol=1e-5)
    np.testing.assert_allclose(boxes, want_b, atol=1e-5)
    assert boxes.shape == (3 * T, 13, 4)  # pred_traj: per-frame rows
    assert engine.stats["video"].snapshot()["padded_items"] >= 1


def test_engine_rejects_bad_payloads(engine):
    with pytest.raises(ValueError, match="deployment shape"):
        engine.submit_video(np.zeros((1, T, RES + 14, RES, 3), np.uint8))
    with pytest.raises(ValueError, match="empty"):
        engine.submit_text([])
    with pytest.raises(ValueError, match="empty"):
        engine.submit_video(np.zeros((0, *CLIP), np.uint8))
    with pytest.raises(ValueError, match="uint8"):
        engine.submit_video(np.zeros((1, *CLIP), np.float32))


def test_engine_coalesces_concurrent_requests(engine):
    n = 6
    video = _clips(n, seed=1)
    want, _ = engine.model.embed_video(video)
    calls_before = engine.stats["video"].snapshot()["device_calls"]
    results = [None] * n
    barrier = threading.Barrier(n)

    def worker(i):
        barrier.wait()
        results[i] = engine.submit_video(video[i : i + 1])[0][0]

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(n)]
    for t_ in threads:
        t_.start()
    for t_ in threads:
        t_.join(timeout=60)
        assert not t_.is_alive()
    for i in range(n):
        np.testing.assert_allclose(results[i], want[i], atol=1e-5)
    # 6 one-clip requests over buckets (1, 2, 4): coalescing beats per-request dispatch
    assert engine.stats["video"].snapshot()["device_calls"] - calls_before < n


def test_engine_chunks_oversized_request(engine):
    video = _clips(9, seed=2)  # > largest bucket (4): 4 + 4 + 1
    calls_before = engine.stats["video"].snapshot()["device_calls"]
    emb, _ = engine.submit_video(video)
    np.testing.assert_allclose(emb, engine.model.embed_video(video)[0], atol=1e-5)
    assert engine.stats["video"].snapshot()["device_calls"] - calls_before == 3


def _post(url, body, content_type="application/json"):
    req = urllib.request.Request(url, data=body, headers={"Content-Type": content_type})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_http_server_end_to_end(model):
    """Warmup, all four routes, and the shape/route/engine error paths."""
    engine = ServingEngine(model, video_shape=CLIP,
                           cfg=ServeConfig(buckets=(1, 2, 4), warmup_buckets=(1,)))
    engine.warmup()
    srv = make_server(engine, "127.0.0.1", 0)
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    try:
        with urllib.request.urlopen(base + "/healthz", timeout=30) as r:
            health = json.loads(r.read())
        assert health["status"] == "ok" and health["backend"] == "cpu"
        assert health["video_shape"] == list(CLIP)
        assert health["stats"]["video"]["requests"] >= 1  # warmup counted

        texts = ["pour water", "close drawer"]
        code, out = _post(base + "/embed_text", json.dumps({"texts": texts}).encode())
        assert code == 200
        want_t = model.embed_text(texts)
        np.testing.assert_allclose(np.asarray(out["embeddings"]), want_t, atol=1e-5)

        video = _clips(2, seed=3)
        buf = io.BytesIO()
        np.save(buf, video)
        code, out = _post(base + "/embed_video?boxes=1", buf.getvalue(), "application/x-npy")
        assert code == 200
        want_v, want_b = model.embed_video(video)
        np.testing.assert_allclose(np.asarray(out["embeddings"]), want_v, atol=1e-5)
        np.testing.assert_allclose(np.asarray(out["boxes"]), want_b, atol=1e-5)

        buf = io.BytesIO()
        np.savez(buf, video=video, texts=np.asarray(texts))
        code, out = _post(base + "/similarity", buf.getvalue(), "application/x-npz")
        assert code == 200
        a = want_t / np.linalg.norm(want_t, axis=-1, keepdims=True)
        b = want_v / np.linalg.norm(want_v, axis=-1, keepdims=True)
        np.testing.assert_allclose(np.asarray(out["sim"]), a @ b.T, atol=1e-5)

        assert _post(base + "/nope", b"{}")[0] == 404
        code, out = _post(base + "/embed_text", b"not json")
        assert code == 400 and "error" in out
        code, out = _post(base + "/embed_text", b'{"texts": []}')
        assert code == 400 and "empty" in out["error"]
        buf = io.BytesIO()
        np.save(buf, np.zeros((1, T, RES, RES + 14, 3), np.uint8))
        code, out = _post(base + "/embed_video", buf.getvalue(), "application/x-npy")
        assert code == 400 and "deployment shape" in out["error"]
        code, out = _post(base + "/embed_text", b'{"texts": "wash hands"}')
        assert code == 400 and "list of strings" in out["error"]
        engine.close()  # engine failure -> structured 500, never a dropped socket
        code, out = _post(base + "/embed_text", json.dumps({"texts": texts}).encode())
        assert code == 500 and "engine closed" in out["error"]
    finally:
        srv.shutdown()
        srv.server_close()
        engine.close()
        th.join(timeout=30)
    assert not th.is_alive()


def test_http_healthz_reports_int8_and_serves_it():
    """An int8 EvalModel behind the engine: /healthz says so, and a video
    request returns what the model computes."""
    model = tiny_eval_model(int8=True)
    engine = ServingEngine(model, video_shape=CLIP, cfg=ServeConfig(buckets=(1, 2)))
    srv = make_server(engine, "127.0.0.1", 0)
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    try:
        with urllib.request.urlopen(base + "/healthz", timeout=30) as r:
            health = json.loads(r.read())
        assert health["status"] == "ok" and health["int8"] is True
        video = _clips(2, seed=4)
        buf = io.BytesIO()
        np.save(buf, video)
        code, out = _post(base + "/embed_video", buf.getvalue(), "application/x-npy")
        assert code == 200
        np.testing.assert_allclose(np.asarray(out["embeddings"]), model.embed_video(video)[0], atol=1e-5)
    finally:
        srv.shutdown()
        srv.server_close()
        engine.close()
        th.join(timeout=30)
    assert not th.is_alive()


def test_health_is_device_free_and_detects_stall(model, monkeypatch):
    eng = ServingEngine(model, video_shape=CLIP,
                        cfg=ServeConfig(buckets=(1, 2), max_wait_ms=2.0, stall_threshold_s=0.05))
    release = threading.Event()
    try:
        h = eng.health()
        assert h["status"] == "ok" and h["devices"] == 1 and h["device_busy_s"] == 0.0
        orig = model.embed_tokens

        def hanging(tokens):
            release.wait(10.0)
            return orig(tokens)

        monkeypatch.setattr(model, "embed_tokens", hanging)
        t = threading.Thread(target=lambda: eng.submit_text(["stuck"]), daemon=True)
        t.start()
        deadline = time.time() + 5.0
        stalled = eng.health()
        while time.time() < deadline and stalled["status"] != "device_stalled":
            stalled = eng.health()
        assert stalled["status"] == "device_stalled" and stalled["device_busy_s"] >= 0.05
        release.set()
        t.join(timeout=10)
        assert not t.is_alive()
        monkeypatch.undo()
        assert eng.health()["status"] == "ok"  # recovers after completion
    finally:
        release.set()
        eng.close()


def test_engine_without_device_needs_cuda(model):
    class NoDevice:
        tokenizer = model.tokenizer

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServingEngine(NoDevice(), video_shape=CLIP)
