"""The port's serving entry point against the JAX package's.

Two checkpoint files in the reference's layout (a 4-frame tiny backbone,
a 4-frame decoder with 13 queries) go through both packages'
``cli.common.build_eval_model`` at ``--num_frames 8``, so both temporal
embeddings are inflated on the way; in f32 the two models give the same
text and video embeddings within 1e-4 x max|embedding|. Then the port's
``cli.serve.main`` serves the same files on the CPU through its
``ready``/``stop`` hooks.
"""

import argparse
import dataclasses
import io
import json
import threading
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helping_hand_for_egocentric_videos_tpu.cli import common as jax_common
from helping_hand_for_egocentric_videos_torch.cli import common, serve
from helping_hand_for_egocentric_videos_torch.train import EvalModel
from test_weights import make_decoder_sd, make_lavila_sd

T0, T, RES = 4, 8, 224
TEXTS = ["#C C cuts the onion", "wash hands"]


def _ckpts(tmp_path):
    """timesformer_tiny (width 128, heads 4, patch 32: 49 patches; text
    width 64, 2 layers) and the default decoder (d_model 512, 6 layers),
    with the CLIP vocabulary and 256-wide projections, saved as the
    reference saves them: the backbone with a ``module.`` prefix, the
    decoder inside ``state_dict``."""
    rng = np.random.default_rng(7)

    def r(*shape):
        return (rng.normal(size=shape) * 0.05).astype(np.float32)

    lsd = make_lavila_sd(depth=2, d=128, heads=4, patch=32, frames=T0, tw=64, tl=2, ppf=49)
    lsd.update({"token_embedding.weight": r(49408, 64), "positional_embedding": r(77, 64),
                "text_projection": r(64, 256), "image_projection": r(128, 256)})
    dsd = make_decoder_sd(d=512, nl=6, q=13, nf=T0, ppf=49, fdim=128, ncls=22047)
    for i in range(6):
        p = f"transformer.decoder.layers.{i}"
        dsd.update({f"{p}.linear1.weight": r(2048, 512), f"{p}.linear1.bias": r(2048),
                    f"{p}.linear2.weight": r(512, 2048)})
    dsd.update({"txt_proj.1.weight": r(256, 64), "txt_proj.1.bias": r(256),
                "vid_proj.0.weight": r(256, 64), "vid_proj.0.bias": r(256),
                "obj_proj.2.weight": r(256, 512), "obj_proj.2.bias": r(256)})
    bpath, dpath = tmp_path / "lavila_tiny.pth", tmp_path / "decoder.pth.tar"
    torch.save({f"module.{k}": torch.from_numpy(np.asarray(v)) for k, v in lsd.items()}, bpath)
    torch.save({"state_dict": {k: torch.from_numpy(v) for k, v in dsd.items()}}, dpath)
    return str(bpath), str(dpath)


def _argv(bpath, dpath):
    return ["--backbone", "timesformer_tiny", "--backbone_ckpt", bpath, "--decoder_ckpt", dpath,
            "--num_frames", str(T), "--device", "cpu"]


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    return _ckpts(tmp_path_factory.mktemp("ckpt"))


def test_build_eval_model_matches_jax(ckpts):
    args = common.add_eval_args(argparse.ArgumentParser()).parse_args(_argv(*ckpts))
    model, lcfg, dcfg = common.build_eval_model(args)
    assert model.backbone.visual.temporal_embed.shape == (1, T, 128)
    assert model.decoder.temporal_embed.shape == (1, T, 512)
    port = EvalModel(model.backbone, lcfg, model.decoder, dcfg, model.tokenizer,
                     dtype=torch.float32, device="cpu")
    jmodel, _, _ = jax_common.build_eval_model(args)
    jmodel = dataclasses.replace(jmodel, dtype=jnp.float32)

    video = (np.random.default_rng(8).random((2, T, RES, RES, 3)) * 255).astype(np.uint8)
    got, boxes = port.embed_video(video)
    want, want_boxes = jmodel.embed_video(video)
    assert got.shape == (2, 256) and boxes.shape == (2, 13, 4)
    np.testing.assert_allclose(got, want, atol=1e-4 * np.abs(want).max())
    np.testing.assert_allclose(boxes, want_boxes, atol=1e-4)
    want_t = jmodel.embed_text(TEXTS)
    np.testing.assert_allclose(port.embed_text(TEXTS), want_t, atol=1e-4 * np.abs(want_t).max())


def test_eval_args_default_to_the_card():
    args = common.add_eval_args(argparse.ArgumentParser()).parse_args([])
    assert args.device == "cuda" and args.num_frames == 16 and not args.int8


def _post(base, path, body, ctype):
    req = urllib.request.Request(base + path, data=body, headers={"Content-Type": ctype})
    with urllib.request.urlopen(req, timeout=120) as r:
        return r.status, json.loads(r.read())


def test_serve_main_answers_on_the_cpu(ckpts):
    started, stop, box = threading.Event(), threading.Event(), {}

    def ready(srv, engine):
        box["base"] = f"http://127.0.0.1:{srv.server_address[1]}"
        box["engine"] = engine
        started.set()

    argv = [*_argv(*ckpts), "--buckets", "1", "2", "--port", "0"]
    th = threading.Thread(target=serve.main, args=(argv,), kwargs={"ready": ready, "stop": stop},
                          daemon=True)
    th.start()
    try:
        assert started.wait(timeout=300), "the server did not come up"
        base = box["base"]
        clips = (np.random.default_rng(9).random((2, T, RES, RES, 3)) * 255).astype(np.uint8)
        buf = io.BytesIO()
        np.save(buf, clips)
        code, out = _post(base, "/embed_video", buf.getvalue(), "application/x-npy")
        emb = np.asarray(out["embeddings"])
        assert code == 200 and emb.shape == (2, 256) and np.isfinite(emb).all()
        with urllib.request.urlopen(base + "/healthz", timeout=60) as r:
            health = json.loads(r.read())
        assert health["status"] == "ok" and health["backend"] == "cpu"
        assert health["video_shape"] == [T, RES, RES, 3] and health["buckets"] == [1, 2]
        assert health["stats"]["video"]["device_calls"] >= 3  # 2 warmup buckets + the request
    finally:
        stop.set()
        th.join(timeout=60)
    assert not th.is_alive()
