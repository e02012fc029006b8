"""The port's box math against the JAX package, in f32: every function on
seeded boxes with degenerate, disjoint, touching and identical pairs
(atol 1e-6), and the gradients of the two functions the box loss
differentiates against ``jax.grad`` on boxes in general position."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helping_hand_for_egocentric_videos_tpu.ops import boxes as jb
from helping_hand_for_egocentric_videos_torch.ops import boxes as tb

ATOL = 1e-6


def _xyxy(rng, n):
    lo = rng.random((n, 2)).astype(np.float32) * 0.7
    wh = rng.random((n, 2)).astype(np.float32) * 0.3 + 0.01
    return np.concatenate([lo, lo + wh], axis=-1)


def _edge_sets(rng):
    """Two (9, 4) xyxy sets whose pairs include the edge cases."""
    a, b = _xyxy(rng, 9), _xyxy(rng, 9)
    a[0] = b[0]  # identical
    a[1] = [0.3, 0.3, 0.3, 0.5]  # zero width
    b[2] = [0.2, 0.2, 0.2, 0.2]  # a point
    a[3], b[3] = [0.0, 0.0, 0.1, 0.1], [0.5, 0.5, 0.6, 0.6]  # disjoint
    a[4], b[4] = [0.0, 0.0, 0.2, 0.2], [0.2, 0.0, 0.4, 0.2]  # touching on an edge
    a[5], b[5] = [0.1, 0.1, 0.3, 0.3], [0.3, 0.3, 0.5, 0.5]  # touching at a corner
    a[6], b[6] = [0.0, 0.0, 0.0, 0.0], [0.0, 0.0, 0.0, 0.0]  # both empty: enclosing area 0
    return a, b


def _t(x):
    return torch.from_numpy(np.asarray(x))


PAIRWISE = ["box_iou", "generalized_box_iou", "l1_cost_matrix"]
ELEMENTWISE = ["generalized_box_iou_elementwise"]
UNARY = ["box_cxcywh_to_xyxy", "box_xyxy_to_cxcywh", "box_area"]


@pytest.mark.parametrize("name", PAIRWISE + ELEMENTWISE + UNARY)
@pytest.mark.parametrize("batched", [False, True])
def test_box_functions_match_jax(name, batched):
    rng = np.random.default_rng(0)
    a, b = _edge_sets(rng)
    if batched:  # leading batch dims: (2, 9, 4)
        a = np.stack([a, _xyxy(rng, 9)])
        b = np.stack([b, _xyxy(rng, 9)])
    args = (a,) if name in UNARY else (a, b)
    want = getattr(jb, name)(*map(jnp.asarray, args))
    got = getattr(tb, name)(*map(_t, args))
    for g, w in zip(*((got, want) if name == "box_iou" else ((got,), (want,)))):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL)


def test_masks_to_boxes_matches_jax():
    rng = np.random.default_rng(1)
    masks = rng.random((5, 12, 9)) < 0.1
    masks[0] = False  # empty -> zero box
    masks[1] = False
    masks[1, 3, 4] = True  # one pixel
    want = jb.masks_to_boxes(jnp.asarray(masks))
    got = tb.masks_to_boxes(_t(masks))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=0)


@pytest.mark.parametrize("name", ["generalized_box_iou_elementwise", "l1_cost_matrix"])
def test_box_gradients_match_jax(name):
    """d/d(boxes) of sum(w * f(a, b)) in both packages, boxes in general
    position (no ties in any max or min)."""
    rng = np.random.default_rng(2)
    a, b = _xyxy(rng, 7), _xyxy(rng, 5 if name == "l1_cost_matrix" else 7)
    out_shape = (7, 5) if name == "l1_cost_matrix" else (7,)
    w = rng.normal(size=out_shape).astype(np.float32)
    jfn, tfn = getattr(jb, name), getattr(tb, name)
    ga, gb = jax.grad(lambda x, y: jnp.sum(jfn(x, y) * w), argnums=(0, 1))(jnp.asarray(a), jnp.asarray(b))
    ta, tbb = _t(a).requires_grad_(), _t(b).requires_grad_()
    (tfn(ta, tbb) * _t(w)).sum().backward()
    np.testing.assert_allclose(ta.grad.numpy(), np.asarray(ga), atol=1e-5)
    np.testing.assert_allclose(tbb.grad.numpy(), np.asarray(gb), atol=1e-5)


def test_tie_gradient_is_split_as_in_jax():
    """Touching boxes: the clip of the overlap sits at its tie (0), where
    JAX splits the gradient; the port's torch.maximum does the same."""
    a = np.array([[0.0, 0.0, 0.2, 0.2], [0.1, 0.1, 0.3, 0.3]], np.float32)
    b = np.array([[0.2, 0.0, 0.4, 0.2], [0.3, 0.3, 0.5, 0.5]], np.float32)
    ga = jax.grad(lambda x: jnp.sum(jb.generalized_box_iou_elementwise(x, jnp.asarray(b))))(jnp.asarray(a))
    ta = _t(a).requires_grad_()
    tb.generalized_box_iou_elementwise(ta, _t(b)).sum().backward()
    np.testing.assert_allclose(ta.grad.numpy(), np.asarray(ga), atol=1e-5)
