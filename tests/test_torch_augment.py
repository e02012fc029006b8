"""The port's train-time augmentation against the JAX package's, on the CPU.

The two packages draw their parameters from different random streams
(``jax.random`` keys against one ``torch.Generator``), so parity is held
on the application: the JAX function returns its crop and flip draws,
this file recomputes its jitter factors and op orders from the same key
(as ``random_resized_crop_flip_jitter`` splits it), and the port applies
exactly those to the same uint8 clips. The clips agree within 1e-5 in f32,
the hue's RGB -> HSV -> RGB round trip included (largest difference
3.3e-6, with all three ops on); each jitter op alone within 1e-6.
``transform_boxes`` agrees within 1e-4 pixels.

The draws are held by distribution, as ``tests/test_augment.py`` holds
the JAX package's: crop scale, aspect and position bounds, the fallback
crop of an extreme frame, the flip rate, the factor ranges, the op
orders, and determinism for a seeded generator. An identity crop equals
``resize_normalize``. A ``cuda`` case applies the same parameters on the
card.
"""

import itertools
import types

import numpy as np
import pytest
import torch

from helping_hand_for_egocentric_videos_torch.ops import preprocess as tp

JITTERS = {
    "none": (0.0, 0.0, 0.0),
    "brightness": (0.4, 0.0, 0.0),
    "saturation": (0.0, 0.4, 0.0),
    "hue": (0.0, 0.0, 0.2),
    "all": (0.4, 0.3, 0.2),
}


@pytest.fixture(scope="module")
def jx():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from helping_hand_for_egocentric_videos_tpu.ops import preprocess as jp

    return types.SimpleNamespace(jax=jax, jnp=jnp, pre=jp)


def _jax_augment(jx, key, video, res, scale, jitter):
    """JAX's augmentation of ``video`` -> (output, the port's params for
    the same draws)."""
    jax = jx.jax
    bj, sj, hj = jitter
    out, aug = jx.pre.random_resized_crop_flip_jitter(key, jx.jnp.asarray(video), res, scale=scale, brightness=bj,
                                                      saturation=sj, hue=hj)
    b = video.shape[0]
    _, _, k_fac, k_ord = jax.random.split(key, 4)
    kb, ks, kh = jax.random.split(k_fac, 3)
    factors = {
        "brightness": jax.random.uniform(kb, (b,), minval=max(0.0, 1.0 - bj), maxval=1.0 + bj),
        "saturation": jax.random.uniform(ks, (b,), minval=max(0.0, 1.0 - sj), maxval=1.0 + sj),
        "hue": jax.random.uniform(kh, (b,), minval=-hj, maxval=hj),
    }
    ops = tuple(op for op, f in zip(("brightness", "saturation", "hue"), jitter) if f > 0)
    params = {k: torch.from_numpy(np.array(aug[k])).long() for k in ("top", "left", "crop_h", "crop_w")}
    params.update(flip=torch.from_numpy(np.array(aug["flip"])), src_h=aug["src_h"], src_w=aug["src_w"], ops=ops)
    params.update({op: torch.from_numpy(np.array(factors[op], np.float32)) for op in ops})
    if len(ops) > 1:
        perms = jax.vmap(lambda k: jax.random.permutation(k, len(ops)))(jax.random.split(k_ord, b))
        params["order"] = torch.from_numpy(np.array(perms)).long()
    else:
        params["order"] = torch.zeros(b, len(ops), dtype=torch.long)
    return np.asarray(out), params, aug


@pytest.mark.parametrize("jitter", list(JITTERS), ids=list(JITTERS))
@pytest.mark.parametrize("seed", [0, 1])
def test_application_of_jax_draws_matches_jax(jx, jitter, seed):
    rng = np.random.default_rng(seed)
    video = rng.integers(0, 256, size=(6, 2, 40, 56, 3), dtype=np.uint8)
    want, params, _ = _jax_augment(jx, jx.jax.random.PRNGKey(seed), video, 28, (0.3, 1.0), JITTERS[jitter])
    got = tp.apply_augment(torch.from_numpy(video), params, 28).numpy()
    assert got.shape == want.shape == (6, 2, 28, 28, 3)
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_all_op_orders_of_jax_applied_alike(jx):
    """With all three jitter ops on, 64 clips cover all 6 orders; each
    clip's output follows its own order."""
    rng = np.random.default_rng(2)
    video = rng.integers(0, 256, size=(64, 1, 12, 12, 3), dtype=np.uint8)
    want, params, _ = _jax_augment(jx, jx.jax.random.PRNGKey(5), video, 12, (0.5, 1.0), JITTERS["all"])
    assert len({tuple(o) for o in params["order"].tolist()}) == 6
    got = tp.apply_augment(torch.from_numpy(video), params, 12).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize("name", ["_adjust_brightness", "_adjust_saturation", "_adjust_hue"])
def test_jitter_ops_match_jax(jx, name):
    rng = np.random.default_rng(3)
    img = rng.random((5, 7, 9, 3)).astype(np.float32)
    img[0, 0, 0] = [0.5, 0.5, 0.5]  # grey: no hue
    img[0, 0, 1] = [0.0, 0.0, 0.0]
    fs = np.array([0.6, 1.0, 1.4, 0.9, 1.2], np.float32) if name != "_adjust_hue" else \
        np.array([-0.4, -0.1, 0.0, 0.25, 0.5], np.float32)
    want = np.stack([np.asarray(getattr(jx.pre, name)(jx.jnp.asarray(img[i]), fs[i])) for i in range(5)])
    got = getattr(tp, name)(torch.from_numpy(img), torch.from_numpy(fs)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_transform_boxes_matches_jax(jx, seed):
    """Boxes with zero (absent) rows, flips, and crops that cut some boxes
    away, through JAX's drawn parameters."""
    rng = np.random.default_rng(seed)
    video = rng.integers(0, 256, size=(8, 2, 40, 56, 3), dtype=np.uint8)
    _, params, aug = _jax_augment(jx, jx.jax.random.PRNGKey(seed + 10), video, 28, (0.2, 0.6), JITTERS["none"])
    boxes = np.concatenate([rng.random((8, 2, 4, 2)) * 20, np.zeros((8, 2, 4, 2))], -1).astype(np.float32)
    boxes[..., 2:] = boxes[..., :2] + 2 + rng.random((8, 2, 4, 2)) * 8
    boxes[rng.random((8, 2, 4)) < 0.3] = 0.0
    want = np.asarray(jx.pre.transform_boxes(jx.jnp.asarray(boxes), aug, res=28, coords_res=28))
    got = tp.transform_boxes(torch.from_numpy(boxes), params, res=28, coords_res=28).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4)
    assert (got[boxes.sum(-1) == 0] == 0).all() and aug["flip"].any() and (want == 0).all(-1).sum() > (
        boxes == 0).all(-1).sum()


def _draw(n, h, w, seed=0, **kw):
    return tp.sample_augment_params(torch.Generator().manual_seed(seed), n, h, w, **kw)


def test_crop_params_scale_aspect_and_position_bounds():
    h, w = 100, 160
    p = _draw(512, h, w)
    tops, lefts, chs, cws = (p[k].numpy() for k in ("top", "left", "crop_h", "crop_w"))
    assert (chs >= 1).all() and (chs <= h).all() and (cws >= 1).all() and (cws <= w).all()
    assert (tops >= 0).all() and (tops + chs <= h).all() and (lefts >= 0).all() and (lefts + cws <= w).all()
    frac = chs.astype(np.float64) * cws / (h * w)
    assert frac.min() > 0.5 - 0.03 and frac.max() < 1.0 + 0.03
    aspect = cws.astype(np.float64) / chs
    assert aspect.min() > 3 / 4 - 0.05 and aspect.max() < 4 / 3 + 0.05
    assert len(np.unique(tops)) > 10 and len(np.unique(lefts)) > 10
    assert frac.std() > 0.05


def test_crop_fallback_extreme_aspect_frame():
    p = _draw(16, 16, 128)
    assert (p["crop_h"] == 16).all() and (p["crop_w"] == round(16 * 4 / 3)).all()
    assert (p["top"] == 0).all() and (p["left"] == (128 - round(16 * 4 / 3)) // 2).all()


def test_flip_rate_factor_ranges_and_orders():
    p = _draw(4096, 20, 20, brightness=0.4, saturation=0.3, hue=0.2)
    assert 0.45 < p["flip"].float().mean() < 0.55
    for op, lo, hi in (("brightness", 0.6, 1.4), ("saturation", 0.7, 1.3), ("hue", -0.2, 0.2)):
        f = p[op].numpy()
        assert f.min() >= lo and f.max() <= hi and f.min() < lo + 0.01 and f.max() > hi - 0.01, op
        assert abs(f.mean() - (lo + hi) / 2) < 0.02, op
    assert p["ops"] == ("brightness", "saturation", "hue")
    orders = {tuple(o): 0 for o in itertools.permutations(range(3))}
    for o in p["order"].tolist():
        orders[tuple(o)] += 1
    assert len(orders) == 6 and min(orders.values()) > 4096 / 6 * 0.8
    off = _draw(8, 20, 20)
    assert off["ops"] == () and off["order"].shape == (8, 0)
    # the same draws whatever is enabled: turning hue on leaves the crops as they were
    only_hue = _draw(4096, 20, 20, hue=0.2)
    for k in ("top", "left", "crop_h", "crop_w", "flip", "hue"):
        assert torch.equal(only_hue[k], p[k]), k


def test_seeded_generator_is_deterministic():
    video = torch.from_numpy(np.random.default_rng(4).integers(0, 256, (4, 2, 20, 28, 3), dtype=np.uint8))
    kw = dict(res=16, brightness=0.3, saturation=0.3, hue=0.1)
    a, pa = tp.random_resized_crop_flip_jitter(torch.Generator().manual_seed(7), video, **kw)
    b, pb = tp.random_resized_crop_flip_jitter(torch.Generator().manual_seed(7), video, **kw)
    assert torch.equal(a, b) and all(torch.equal(pa[k], pb[k]) for k in ("top", "left", "crop_h", "crop_w", "flip"))
    c, _ = tp.random_resized_crop_flip_jitter(torch.Generator().manual_seed(8), video, **kw)
    assert (a - c).abs().max() > 1e-3


def test_identity_crop_equals_resize_normalize():
    video = torch.from_numpy(np.random.default_rng(5).integers(0, 256, (1, 2, 20, 24, 3), dtype=np.uint8))
    params = {"top": torch.tensor([0]), "left": torch.tensor([0]), "crop_h": torch.tensor([20]),
              "crop_w": torch.tensor([24]), "flip": torch.tensor([False]), "src_h": 20, "src_w": 24, "ops": (),
              "order": torch.zeros(1, 0, dtype=torch.long)}
    np.testing.assert_allclose(tp.apply_augment(video, params, 16).numpy(),
                               tp.resize_normalize(video, 16).numpy(), atol=1e-5)


def test_augment_rows_keeps_a_ranks_share():
    p = _draw(8, 20, 20, hue=0.1)
    half = tp.augment_rows(p, slice(4, 8))
    assert torch.equal(half["top"], p["top"][4:]) and torch.equal(half["hue"], p["hue"][4:])
    assert half["ops"] == p["ops"] and half["src_h"] == 20


@pytest.mark.cuda
def test_cuda_draws_and_application_match_the_cpu():
    """The draws of a generator on the card obey the bounds, and applying
    them on the card gives the CPU's clip within 1e-5 (1e-4 with hue)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (python -m pytest --noconftest -m cuda tests/test_torch_augment.py)")
    dev = torch.device("cuda")
    video = torch.from_numpy(np.random.default_rng(6).integers(0, 256, (16, 4, 64, 80, 3), dtype=np.uint8))
    p = tp.sample_augment_params(torch.Generator(device=dev).manual_seed(0), 16, 64, 80, brightness=0.4,
                                 saturation=0.4, hue=0.1)
    assert p["top"].device.type == "cuda"
    assert ((p["top"] + p["crop_h"]) <= 64).all() and ((p["left"] + p["crop_w"]) <= 80).all()
    got = tp.apply_augment(video.to(dev), p, 32).cpu()
    want = tp.apply_augment(video, {k: v.cpu() if isinstance(v, torch.Tensor) else v for k, v in p.items()}, 32)
    torch.testing.assert_close(got, want, atol=1e-4, rtol=0)
