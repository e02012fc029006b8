"""The port's zero-shot harnesses against the JAX package's, on the CPU in f32.

- ``spatial_crops`` (1, 3 or 6 crops, wide and tall clips) and the
  ``center_plus_*`` crop helpers against JAX's.
- A tiny ``EvalModel`` (timesformer_tiny, the weights carried across by
  ``from_jax_params``) with the multi-crop TTA: its crop-major (k*B, E)
  rows equal JAX's row by row within 1e-4 x max|embedding|. The JAX tower
  runs its plain XLA attention (its CPU default), the port the kernel
  wrapper's plain version.
- ``run_egomcq``, ``run_epic_mir`` and ``run_egtea`` on in-memory items
  (as tests/test_harness.py builds them): the similarity matrices within
  1e-5, then the metrics. The ranking metrics sort the similarities, so
  two values closer than the cross-framework error could swap ranks: the
  metrics are compared exactly only where no ranked row holds a gap below
  10x that tolerance; otherwise the test warns with the gap and holds the
  similarities alone.
- The multi-crop refusals: both retrieval harnesses and the serving
  engine, with JAX's messages.
"""

import warnings

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from helping_hand_for_egocentric_videos_tpu.data.tokenizer import ClipTokenizer as JaxTokenizer
from helping_hand_for_egocentric_videos_tpu.models import obj_decoder as jod
from helping_hand_for_egocentric_videos_tpu.ops import preprocess as jpp
from helping_hand_for_egocentric_videos_tpu.serve.engine import ServingEngine as JaxServingEngine
from helping_hand_for_egocentric_videos_tpu.train import evaluate as jev
from helping_hand_for_egocentric_videos_torch.data import ClipTokenizer
from helping_hand_for_egocentric_videos_torch.models import DecoderConfig, from_jax_params
from helping_hand_for_egocentric_videos_torch.models.lavila import timesformer_tiny_config
from helping_hand_for_egocentric_videos_torch.ops import preprocess as tpp
from helping_hand_for_egocentric_videos_torch.serve import ServeConfig, ServingEngine
from helping_hand_for_egocentric_videos_torch.train import evaluate as tev
from test_torch_eval_model import DEC, T, _jax_trees

SIM_TOL = 1e-5
EMB_RTOL = 1e-4
PREPS = ("resize", "shortside", "crops3", "crops6")


# ---------------------------------------------------------------- crops

@pytest.mark.parametrize("hw, atol", [((32, 57), 1e-6), ((57, 32), 1e-6), ((40, 72), 1e-5), ((72, 40), 1e-5)],
                         ids=["wide", "tall", "wide-resized", "tall-resized"])
@pytest.mark.parametrize("k", [1, 3, 6])
def test_spatial_crops_match_jax(hw, atol, k):
    """Where the short side is already ``short`` the resize is exact on both
    sides, and the crops (their places, the flip, the crop-major stack)
    agree within 1e-6. Where it resizes, torch's bilinear lerp and JAX's
    normalised-weight contraction differ by up to ~5e-7 before the
    normalisation (~2e-6 after it): 1e-5, the tolerance of
    test_torch_preprocess.py for the same resize."""
    clip = (np.random.default_rng(k).random((2, 3, *hw, 3)) * 255).astype(np.uint8)
    want = np.asarray(jpp.spatial_crops(jnp.asarray(clip), crop=28, num_crops=k, short=32))
    got = tpp.spatial_crops(torch.from_numpy(clip), crop=28, num_crops=k, short=32).numpy()
    assert got.shape == (k, 2, 3, 28, 28, 3)
    np.testing.assert_allclose(got, want, atol=atol)


def test_spatial_crops_refuse_other_counts():
    clip = np.zeros((1, 2, 32, 40, 3), np.uint8)
    with pytest.raises(ValueError) as want:
        jpp.spatial_crops(jnp.asarray(clip), crop=28, num_crops=2, short=32)
    with pytest.raises(ValueError) as got:
        tpp.spatial_crops(torch.from_numpy(clip), crop=28, num_crops=2, short=32)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("size", [16, (12, 20)])
def test_center_plus_crops_match_jax(size):
    img = np.random.default_rng(3).random((2, 30, 40, 3)).astype(np.float32)
    for name, args in (("center_plus_four_crops", (size, 4, 6)), ("center_plus_twohori_crops", (size, 6))):
        want = getattr(jpp, name)(jnp.asarray(img), *args)
        got = getattr(tpp, name)(torch.from_numpy(img), *args)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("name, args", [
    ("center_plus_four_crops", (50, 2, 2)),  # crop larger than the image
    ("center_plus_four_crops", (20, 12, 4)),  # margin + crop beyond the height
    ("center_plus_twohori_crops", (20, 30)),  # margin + crop beyond the width
])
def test_center_plus_crops_refuse_like_jax(name, args):
    img = np.zeros((30, 40, 3), np.float32)
    with pytest.raises(ValueError) as want:
        getattr(jpp, name)(jnp.asarray(img), *args)
    with pytest.raises(ValueError) as got:
        getattr(tpp, name)(torch.from_numpy(img), *args)
    assert str(got.value) == str(want.value)


# ---------------------------------------------------------------- models

@pytest.fixture(scope="module")
def models():
    """{preprocess: (JAX EvalModel, the port's)}, f32, the same weights."""
    jcfg, backbone, decoder = _jax_trees()
    cfg, dcfg = timesformer_tiny_config(num_frames=T), DecoderConfig(**DEC)
    bb, dec = from_jax_params(backbone, decoder, cfg, dcfg)
    out = {}
    for prep in PREPS:
        jax_model = jev.EvalModel(backbone_params=backbone, lavila_cfg=jcfg, decoder_params=decoder,
                                  dec_cfg=jod.DecoderConfig(**DEC), tokenizer=JaxTokenizer(), preprocess=prep,
                                  dtype=jnp.float32)
        port = tev.EvalModel(bb, cfg, dec, dcfg, ClipTokenizer(), preprocess=prep, dtype=torch.float32,
                             device="cpu")
        out[prep] = (jax_model, port)
    return out


@pytest.mark.parametrize("hw", [(240, 320), (320, 240)], ids=["wide", "tall"])
@pytest.mark.parametrize("prep", ["crops3", "crops6"])
def test_multicrop_embeddings_match_jax_row_by_row(models, prep, hw):
    jax_model, port = models[prep]
    k = int(prep[5:])
    video = (np.random.default_rng(6).random((2, T, *hw, 3)) * 255).astype(np.uint8)
    emb, boxes = port.embed_video(video)
    want, want_boxes = jax_model.embed_video(video)
    assert emb.shape == (2 * k, 32) and boxes.shape == (2 * k, 13, 4)
    for row in range(2 * k):  # crop-major, as JAX stacks them: row c * B + i is crop c of clip i
        np.testing.assert_allclose(emb[row], want[row], atol=EMB_RTOL * np.abs(want).max(), err_msg=f"row {row}")
    np.testing.assert_allclose(boxes, want_boxes, atol=EMB_RTOL)


# ---------------------------------------------------------------- harnesses

class _Items:
    """A dataset over a fixed list of items."""

    def __init__(self, items):
        self.items = items

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]


def _min_gap(mat: np.ndarray) -> float:
    """The smallest gap between two values of one row of ``mat``."""
    s = np.sort(mat, axis=-1)
    return float(np.diff(s, axis=-1).min()) if s.shape[-1] > 1 else np.inf


def _metrics_if_no_near_tie(got: dict, want: dict, gap: float, tol: float):
    assert set(got) == set(want)
    if gap >= 10 * tol:
        assert got == want
    else:
        warnings.warn(f"a ranked row holds a gap of {gap:.3g} < 10 x {tol}: only the similarities are held")


def test_run_egomcq_matches_jax(models, tmp_path):
    jax_model, port = models["resize"]
    rng = np.random.default_rng(21)
    items = [{"video": (rng.random((5, T, 32, 48, 3)) * 255).astype(np.uint8), "text": f"#C C opens drawer {i}",
              "correct": i % 5, "type": 1 + i % 2} for i in range(5)]
    got = tev.run_egomcq(port, _Items(items), items_per_batch=2, out_sims=str(tmp_path / "t.npz"))
    want = jev.run_egomcq(jax_model, _Items(items), items_per_batch=2, out_sims=str(tmp_path / "j.npz"))
    g, w = np.load(tmp_path / "t.npz"), np.load(tmp_path / "j.npz")
    np.testing.assert_allclose(g["sims"], w["sims"], atol=SIM_TOL)
    np.testing.assert_array_equal(g["gt"], w["gt"])
    np.testing.assert_array_equal(g["types"], w["types"])
    _metrics_if_no_near_tie(got, want, _min_gap(w["sims"]), SIM_TOL)


def _epic_items(n):
    rng = np.random.default_rng(22)
    return [{"video": (rng.random((T, 32, 48, 3)) * 255).astype(np.uint8), "text": f"take the plate {i}"}
            for i in range(n)]


def test_run_epic_mir_matches_jax(models, tmp_path):
    jax_model, port = models["resize"]
    n = 6
    rng = np.random.default_rng(23)
    relevancy = np.round(rng.random((n, n)), 2) * (rng.random((n, n)) < 0.5)
    relevancy[np.arange(n), rng.permutation(n)] = 1.0  # graded, a 1 in every row and column
    indexes = rng.permutation(n)
    items = _epic_items(n)
    got = tev.run_epic_mir(port, _Items(items), relevancy, indexes, batch_size=4, out_sims=str(tmp_path / "t.npz"))
    want = jev.run_epic_mir(jax_model, _Items(items), relevancy, indexes, batch_size=4,
                            out_sims=str(tmp_path / "j.npz"))
    g, w = np.load(tmp_path / "t.npz"), np.load(tmp_path / "j.npz")
    assert g["pred"].shape == (n, n) and g["processed"].shape == (n, n)
    np.testing.assert_allclose(g["pred"], w["pred"], atol=SIM_TOL)
    np.testing.assert_allclose(g["processed"], w["processed"], atol=SIM_TOL)
    for k, v in got.items():
        assert np.isfinite(v) and 0 <= v <= 1.0001, k
    gap = min(_min_gap(w["processed"]), _min_gap(w["processed"].T))
    _metrics_if_no_near_tie(got, want, gap, SIM_TOL)


@pytest.mark.parametrize("prep", ["shortside", "crops3", "crops6"])
def test_run_egtea_matches_jax(models, prep):
    jax_model, port = models[prep]
    labels = ["open drawer", "cut onion", "wash plate"]
    rng = np.random.default_rng(24)
    items = [{"video": (rng.random((2 * T, 32, 48, 3)) * 255).astype(np.uint8),  # 2 windows of T frames
              "label_text": labels[i % 3]} for i in range(4)]
    got = tev.run_egtea(port, _Items(items), labels)
    want = jev.run_egtea(jax_model, _Items(items), labels)
    # the harness's logits, max-pooled over windows x crops, held item by item
    k = 1 if prep == "shortside" else int(prep[5:])
    lab_t, lab_j = port.embed_text(labels), jax_model.embed_text(labels)
    gaps = []
    for it in items:
        clips = it["video"].reshape(-1, T, *it["video"].shape[1:])
        emb_t, emb_j = port.embed_video(clips)[0], jax_model.embed_video(clips)[0]
        assert emb_t.shape == (2 * k, 32)
        lt, lj = tev._cos(emb_t, lab_t).max(0), jev._cos(emb_j, lab_j).max(0)
        np.testing.assert_allclose(lt, lj, atol=SIM_TOL)
        top = np.sort(lj)
        gaps.append(top[-1] - top[-2])
    _metrics_if_no_near_tie(got, want, min(gaps), SIM_TOL)


# ---------------------------------------------------------------- refusals

def _error(fn, *args):
    with pytest.raises(ValueError) as e:
        fn(*args)
    return str(e.value)


@pytest.mark.parametrize("harness", ["run_egomcq", "run_epic_mir"])
def test_retrieval_harnesses_refuse_multicrop_like_jax(models, harness):
    jax_model, port = models["crops3"]
    extra = (np.eye(2), np.arange(2)) if harness == "run_epic_mir" else ()
    got = _error(getattr(tev, harness), port, _Items(_epic_items(2)), *extra)
    assert got == _error(getattr(jev, harness), jax_model, _Items(_epic_items(2)), *extra)
    assert "crop-major" in got


def test_serving_engine_refuses_multicrop_like_jax(models):
    jax_model, port = models["crops6"]
    shape = (T, 224, 224, 3)
    got = _error(ServingEngine, port, shape, ServeConfig(buckets=(1,)))
    assert got == _error(JaxServingEngine, jax_model, shape) == "multi-crop TTA preprocess is not servable"
