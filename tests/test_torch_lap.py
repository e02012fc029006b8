"""The port's on-device LAP against the JAX package's and against scipy.

For each problem the port must return the JAX package's very matches
(``target_to_pred``, ties included: both take a target only when it is
strictly better and the first index among equals), and a total equal to
scipy's ``linear_sum_assignment`` optimum (atol 1e-4 x max(1, |cost|)).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.optimize import linear_sum_assignment

from helping_hand_for_egocentric_videos_tpu.ops import lap as jlap
from helping_hand_for_egocentric_videos_torch.ops import lap as tlap


def _scipy_total(cost, valid):
    c = cost[:, valid]
    if c.shape[1] == 0:
        return 0.0
    rows, cols = linear_sum_assignment(c.T)
    return float(c.T[rows, cols].sum())


def _check_batch(cost, valid):
    want_t2p, want_total = jlap.solve_lap_batch(jnp.asarray(cost), jnp.asarray(valid))
    got_t2p, got_total = tlap.solve_lap_batch(torch.from_numpy(cost), torch.from_numpy(valid))
    assert got_t2p.dtype == torch.int32 and got_total.dtype == torch.float32
    np.testing.assert_array_equal(got_t2p.numpy(), np.asarray(want_t2p))
    np.testing.assert_allclose(got_total.numpy(), np.asarray(want_total), atol=0)
    for b in range(cost.shape[0]):
        ref = _scipy_total(cost[b], valid[b])
        assert abs(float(got_total[b]) - ref) < 1e-4 * max(1.0, abs(ref))
        t2p = got_t2p[b].numpy()
        assert (t2p[~valid[b]] == -1).all()
        matched = t2p[valid[b]]
        assert (matched >= 0).all() and len(set(matched.tolist())) == len(matched)
        achieved = sum(cost[b, p, t] for t, p in enumerate(t2p) if p >= 0)
        assert abs(achieved - ref) < 1e-4 * max(1.0, abs(ref))


# (N predictions, M targets): the hand (2x2), object (10x2) and noun (12x4)
# matchings of the train step, M = 1..4, and the widest the DP takes (12)
SHAPES = [(2, 1), (2, 2), (3, 3), (5, 4), (10, 2), (12, 4), (13, 4), (12, 12), (13, 12)]


@pytest.mark.parametrize("n, m", SHAPES)
def test_random_problems_match_jax_and_scipy(n, m):
    rng = np.random.default_rng(n * 100 + m)
    b = 6
    cost = rng.normal(size=(b, n, m)).astype(np.float32)
    valid = rng.random((b, m)) < 0.7
    valid[0] = True  # all valid
    valid[1] = False  # none valid
    if m > 1:
        valid[2] = False
        valid[2, m - 1] = True  # one valid, the last
    _check_batch(cost, valid)


@pytest.mark.parametrize("n, m", [(2, 2), (10, 2), (12, 4), (13, 12)])
def test_integer_costs_with_ties_match_jax(n, m):
    """Small integer costs tie often: the matches must still be JAX's."""
    rng = np.random.default_rng(7 + n + m)
    cost = rng.integers(-2, 3, size=(5, n, m)).astype(np.float32)
    _check_batch(cost, rng.random((5, m)) < 0.8)


@pytest.mark.parametrize("n, m", [(6, 3), (13, 4)])
def test_tied_costs_identity_and_constant(n, m):
    ident = np.stack([1.0 - np.eye(n, m, dtype=np.float32), np.ones((n, m), np.float32)])
    valid = np.ones((2, m), bool)
    _check_batch(ident, valid)
    t2p, total = tlap.solve_lap(torch.from_numpy(ident[0]), torch.from_numpy(valid[0]))
    np.testing.assert_array_equal(t2p.numpy(), np.arange(m))
    assert float(total) == 0.0


def test_greedy_trap():
    """Per-target argmin would give both targets prediction 0; the optimum
    swaps (the JAX package's tests/test_lap.py case)."""
    cost = torch.tensor([[1.0, 2.0], [10.0, 4.0]])
    t2p, total = tlap.solve_lap(cost, torch.ones(2, dtype=torch.bool))
    np.testing.assert_array_equal(t2p.numpy(), [0, 1])
    assert abs(float(total) - 5.0) < 1e-6
    want = jlap.solve_lap(jnp.asarray(cost.numpy()), jnp.ones(2, bool))[0]
    np.testing.assert_array_equal(t2p.numpy(), np.asarray(want))


def test_no_valid_target_and_too_many_targets():
    t2p, total = tlap.solve_lap(torch.ones(5, 4), torch.zeros(4, dtype=torch.bool))
    assert (t2p == -1).all() and float(total) == 0.0
    with pytest.raises(ValueError, match="at most 12 targets"):
        tlap.solve_lap_batch(torch.zeros(1, 13, 13), torch.ones(1, 13, dtype=torch.bool))
