"""The port's losses and similarity helpers against the JAX package, in
f32: each on its value (atol 1e-5) and on its gradient with respect to
the predictions (atol 1e-5) against ``jax.grad``, on seeded inputs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helping_hand_for_egocentric_videos_tpu import losses as jloss
from helping_hand_for_egocentric_videos_tpu.metrics import sim as jsim
from helping_hand_for_egocentric_videos_torch import losses as tloss
from helping_hand_for_egocentric_videos_torch.metrics import sim as tsim

ATOL = 1e-5


def _t(x, grad=False):
    t = torch.from_numpy(np.array(x))
    return t.requires_grad_() if grad else t


def _value_and_grad_both(jfn, tfn, x, *rest):
    """(value, d value / d x) of jfn(x, *rest) and tfn(x, *rest); the
    non-scalar outputs are reduced with fixed weights first."""
    jv, jg = jax.value_and_grad(jfn)(jnp.asarray(x), *map(jnp.asarray, rest))
    tx = _t(x, grad=True)
    tv = tfn(tx, *map(_t, rest))
    tv.backward()
    return (float(tv.detach()), tx.grad.numpy()), (float(jv), np.asarray(jg))


def _assert_pair(got, want):
    assert got[0] == pytest.approx(want[0], abs=ATOL)
    np.testing.assert_allclose(got[1], want[1], atol=ATOL)


@pytest.mark.parametrize("batched", [False, True])
def test_sim_matrix_matches_jax(batched):
    rng = np.random.default_rng(0)
    shape_a, shape_b = ((3, 5, 8), (3, 4, 8)) if batched else ((5, 8), (4, 8))
    a = rng.normal(size=shape_a).astype(np.float32)
    b = rng.normal(size=shape_b).astype(np.float32)
    w = rng.normal(size=shape_a[:-1] + shape_b[-2:-1]).astype(np.float32)
    np.testing.assert_allclose(tsim.sim_matrix(_t(a), _t(b)).numpy(), np.asarray(jsim.sim_matrix(a, b)), atol=ATOL)
    np.testing.assert_allclose(tsim.sim_matrix(_t(a), _t(b), norm=False).numpy(),
                               np.asarray(jsim.sim_matrix(a, b, norm=False)), atol=1e-4)
    _assert_pair(*_value_and_grad_both(lambda x, y: jnp.sum(jsim.sim_matrix(x, y) * w),
                                       lambda x, y: (tsim.sim_matrix(x, y) * _t(w)).sum(), a, b))


def test_compute_tv_accuracy_matches_jax():
    rng = np.random.default_rng(1)
    n, r = 8, 5
    sim = rng.normal(size=(n, n)).astype(np.float32)
    text = rng.normal(size=(n * r, 16)).astype(np.float32)
    text[r] = text[0]  # two equal primary captions: same_neg positives
    sim_v = (rng.random((n, n)) < 0.3).astype(np.float32)
    sim_n = (rng.random((n, n)) < 0.5).astype(np.float32)
    want = jsim.compute_tv_accuracy(sim, text, sim_v, sim_n, n, rephrase_factor=r)
    got = tsim.compute_tv_accuracy(_t(sim), _t(text), _t(sim_v), _t(sim_n), n, rephrase_factor=r)
    for g, w in zip(got, want):
        assert float(g) == float(w)


MASKS = ["none", "verb", "noun", "both"]


def _masks(rng, n, case):
    mv = (rng.random((n, n)) < 0.4).astype(np.float32)
    mn = (rng.random((n, n)) < 0.4).astype(np.float32)
    return (mv if case in ("verb", "both") else None), (mn if case in ("noun", "both") else None)


@pytest.mark.parametrize("case", MASKS)
def test_egonce_loss_matches_jax(case):
    rng = np.random.default_rng(2)
    n = 6
    sim = rng.normal(size=(n, n)).astype(np.float32) * 0.5
    mv, mn = _masks(rng, n, case)
    got = _value_and_grad_both(
        lambda s: jloss.egonce_loss(s, None if mv is None else jnp.asarray(mv),
                                    None if mn is None else jnp.asarray(mn))[0],
        lambda s: tloss.egonce_loss(s, None if mv is None else _t(mv), None if mn is None else _t(mn))[0],
        sim,
    )
    _assert_pair(*got)


@pytest.mark.parametrize("case", MASKS)
@pytest.mark.parametrize("pad_dims", [1, 2])
def test_egonce_multi_positive_loss_matches_jax(case, pad_dims):
    rng = np.random.default_rng(3)
    n, r = 5, 3
    sim = rng.normal(size=(n * r, n)).astype(np.float32) * 0.5
    mv, mn = _masks(rng, n, case)
    pad = np.ones(n * r, np.float32)
    pad[[2, 4, 5, 13]] = 0.0  # padded captions, one video with two of them
    if pad_dims == 2:
        pad = np.repeat(pad[:, None], n, axis=1)

    def jfn(s):
        return jloss.egonce_multi_positive_loss(
            s, None if mv is None else jnp.asarray(mv), None if mn is None else jnp.asarray(mn), jnp.asarray(pad))[0]

    def tfn(s):
        return tloss.egonce_multi_positive_loss(
            s, None if mv is None else _t(mv), None if mn is None else _t(mn), _t(pad))[0]

    _assert_pair(*_value_and_grad_both(jfn, tfn, sim))
    want_mask = jloss.egonce_multi_positive_loss(jnp.asarray(sim), mv, mn, jnp.asarray(pad))[1]
    got_mask = tloss.egonce_multi_positive_loss(_t(sim), None if mv is None else _t(mv),
                                                None if mn is None else _t(mn), _t(pad))[1]
    np.testing.assert_array_equal(got_mask.numpy(), np.asarray(want_mask))


def _pixel_boxes(rng, b, m, empty_rows=()):
    lo = rng.random((b, m, 2)) * 150
    boxes = np.concatenate([lo, lo + 10 + rng.random((b, m, 2)) * 60], -1).astype(np.float32)
    boxes[:, :, 2:] = np.minimum(boxes[:, :, 2:], 250.0)  # some boxes cross the 224 frame
    for i in empty_rows:
        boxes[i] = 0.0
    return boxes


@pytest.mark.parametrize("box_type, m", [("hand_boxes", 2), ("obj_boxes", 2), ("all_boxes", 3)])
@pytest.mark.parametrize("empty", ["some", "all"])
def test_compute_box_loss_matches_jax(box_type, m, empty):
    rng = np.random.default_rng(4)
    b, q = 6, 13
    logits = rng.normal(size=(b, q, 4)).astype(np.float32)
    boxes = _pixel_boxes(rng, b, m, empty_rows=range(b) if empty == "all" else (1, 4))
    if empty == "some":
        boxes[2, 0] = [50, 50, 40, 80]  # degenerate: x1 < x0

    def jfn(x):
        return jloss.compute_box_loss(box_type, jax.nn.sigmoid(x), jnp.asarray(boxes))[0]

    def tfn(x):
        return tloss.compute_box_loss(box_type, torch.sigmoid(x), _t(boxes))[0]

    _assert_pair(*_value_and_grad_both(jfn, tfn, logits))
    want = jloss.compute_box_loss(box_type, jax.nn.sigmoid(jnp.asarray(logits)), jnp.asarray(boxes))[1]
    got = tloss.compute_box_loss(box_type, torch.sigmoid(_t(logits)), _t(boxes))[1]
    np.testing.assert_array_equal(got["target_to_pred"].numpy(), np.asarray(want["target_to_pred"]))
    assert float(got["num_boxes"]) == float(want["num_boxes"])


def test_compute_box_loss_rejects_unknown_type():
    with pytest.raises(ValueError, match="box_type"):
        tloss.compute_box_loss("heads", torch.zeros(1, 13, 4), torch.zeros(1, 2, 4))


@pytest.mark.parametrize("wrt", ["pred", "nouns"])
def test_word_contrastive_loss_matches_jax(wrt):
    rng = np.random.default_rng(5)
    v, e, b, q, m = 30, 16, 4, 12, 4
    nouns = rng.normal(size=(v, e)).astype(np.float32)
    nouns[7] = nouns[3] + 0.1 * rng.normal(size=e)  # a near-duplicate noun: masked to -1
    pred = rng.normal(size=(b, q, e)).astype(np.float32)
    inds = rng.integers(1, v, size=(b, m)).astype(np.int32)
    inds[0, 2:] = 0  # padding nouns
    inds[1, 0] = 3
    inds[3] = 0  # a sample with no noun

    if wrt == "pred":
        got = _value_and_grad_both(lambda x: jloss.word_contrastive_loss(jnp.asarray(nouns), x, jnp.asarray(inds)),
                                   lambda x: tloss.word_contrastive_loss(_t(nouns), x, _t(inds)), pred)
    else:
        got = _value_and_grad_both(lambda x: jloss.word_contrastive_loss(x, jnp.asarray(pred), jnp.asarray(inds)),
                                   lambda x: tloss.word_contrastive_loss(x, _t(pred), _t(inds)), nouns)
    _assert_pair(*got)
