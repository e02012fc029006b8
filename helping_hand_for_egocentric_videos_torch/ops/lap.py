"""Exact linear assignment (Hungarian matching) on the device.

Counterpart of ``helping_hand_for_egocentric_videos_tpu/ops/lap.py``. The
reference solves its matchings with scipy on the host, one sample at a
time, which makes every train step wait for the device. Every matching
here is narrow (at most 2 hand boxes, 2 object boxes or 4 nouns against
2..13 predictions), so an exact dynamic program over subsets of targets
solves it with tensor operations: a loop over the N predictions, each
step a (B, 2^M, M) minimum, then a backtrack with ``torch.where``. No
value goes to the host and no Python branch reads a tensor.

Ties follow the JAX package: prediction i takes a target only where that
is strictly better (``<``) than leaving it unmatched, and among equal
targets the first index (``torch.argmin``, as ``jnp.argmin``). So both
return the same matches, and the losses the same gradients, when costs
tie.
"""

from __future__ import annotations

import torch

__all__ = ["solve_lap", "solve_lap_batch"]

_INF = 1e9
MAX_TARGETS = 12  # the DP has 2^M states


def solve_lap_batch(cost, target_valid):
    """Min-cost assignment of targets to predictions, for a batch.

    Args:
        cost: (B, N, M) cost of assigning target j to prediction i.
        target_valid: (B, M) bool; invalid targets are ignored.
    Returns:
        target_to_pred (B, M) int32: each target's prediction, -1 for an
        invalid target; total_cost (B,) f32 over the valid targets (0 if
        none is valid). Needs (#valid targets) <= N.
    """
    b, n_preds, m = cost.shape
    if m > MAX_TARGETS:
        raise ValueError(f"the subset DP takes at most {MAX_TARGETS} targets, got {m}")
    dev = cost.device
    cost = cost.float()
    valid = target_valid.bool()

    states = torch.arange(1 << m, dtype=torch.int32, device=dev)  # (S,)
    t_bits = torch.ones((), dtype=torch.int32, device=dev) << torch.arange(m, dtype=torch.int32, device=dev)
    contains = (states[:, None] & t_bits[None, :]) != 0  # (S, M)
    prev_state = (states[:, None] ^ torch.where(contains, t_bits[None, :], 0)).long().reshape(-1)
    allowed = contains[None] & valid[:, None, :]  # (B, S, M)

    # f[b, S]: least cost covering subset S with the predictions seen so far
    f = torch.where(states == 0, 0.0, _INF).expand(b, -1)
    choices = []
    for i in range(n_preds):
        gathered = f.index_select(1, prev_state).reshape(b, 1 << m, m)
        cand = torch.where(allowed, gathered + cost[:, i, None, :], _INF)
        best_cost = cand.amin(dim=2)
        best_t = cand.argmin(dim=2).int()
        take = best_cost < f  # strictly better than leaving prediction i free
        f = torch.where(take, best_cost, f)
        choices.append(torch.where(take, best_t, -1))

    full_state = torch.where(valid, t_bits, 0).sum(-1, dtype=torch.int32)  # (B,)
    total_cost = f.gather(1, full_state.long()[:, None])[:, 0]

    # backtrack from the full valid subset, last prediction first
    state = full_state
    t2p = torch.full((b, m), -1, dtype=torch.int32, device=dev)
    for i in range(n_preds - 1, -1, -1):
        t = choices[i].gather(1, state.long()[:, None])[:, 0]  # (B,)
        taken = t >= 0
        tc = t.clamp_min(0).long()[:, None]
        t2p = t2p.scatter(1, tc, torch.where(taken[:, None], i, t2p.gather(1, tc)))
        state = torch.where(taken, state ^ (torch.ones_like(state) << tc[:, 0].int()), state)

    return t2p, torch.where(full_state == 0, 0.0, total_cost)


def solve_lap(cost, target_valid):
    """One problem: cost (N, M), target_valid (M,) -> (target_to_pred (M,)
    int32, total_cost () f32)."""
    t2p, total = solve_lap_batch(cost[None], target_valid[None])
    return t2p[0], total[0]
