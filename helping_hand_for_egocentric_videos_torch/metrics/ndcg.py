"""Normalised Discounted Cumulative Gain for cross-modal retrieval.

Host-side (numpy) eval metric used by the Epic-Kitchens MIR harness.
Semantics match the reference (``utils/nDCG.py:3-133``), validated by the
same golden value (0.9371789900735429) the reference asserts in its inline
self-test (utils/nDCG.py:136-164).

A copy of ``helping_hand_for_egocentric_videos_tpu/metrics/ndcg.py`` (the port imports
nothing of the JAX package); it runs on the host without JAX, so the same inputs give
the same result in both packages.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "calculate_k_counts",
    "calculate_DCG",
    "calculate_IDCG",
    "calculate_nDCG",
]


def calculate_k_counts(relevancy_matrix: np.ndarray) -> np.ndarray:
    """Per-query mask of how many retrievals count toward the DCG.

    Row i of the result has a 1 in the first k positions, where k is the
    number of strictly-positive relevancies for query i.
    """
    return (np.sort(relevancy_matrix)[:, ::-1] > 0).astype(int)


def calculate_DCG(
    similarity_matrix: np.ndarray,
    relevancy_matrix: np.ndarray,
    k_counts: np.ndarray,
) -> np.ndarray:
    """DCG_i = sum_{rank r <= k_i} rel(item at rank r) / log2(r + 2)."""
    n_q, n_d = similarity_matrix.shape
    ranks = np.argsort(similarity_matrix)[:, ::-1]
    divisors = np.log2(np.arange(n_d) + 2)[None, :]
    rows = np.arange(n_q)[:, None]
    gains = relevancy_matrix[rows, ranks] * k_counts
    return np.sum(gains / divisors, axis=1)


def calculate_IDCG(relevancy_matrix: np.ndarray, k_counts: np.ndarray) -> np.ndarray:
    """Ideal DCG: score of retrieving items in descending-relevancy order."""
    return calculate_DCG(relevancy_matrix, relevancy_matrix, k_counts)


def calculate_nDCG(
    similarity_matrix: np.ndarray,
    relevancy_matrix: np.ndarray,
    k_counts: np.ndarray | None = None,
    IDCG: np.ndarray | None = None,
    reduction: str | None = "mean",
):
    """nDCG = DCG / IDCG, optionally mean-reduced over queries."""
    if k_counts is None:
        k_counts = calculate_k_counts(relevancy_matrix)
    dcg = calculate_DCG(similarity_matrix, relevancy_matrix, k_counts)
    if IDCG is None:
        IDCG = calculate_IDCG(relevancy_matrix, k_counts)
    scores = dcg / IDCG
    if reduction == "mean":
        return np.mean(scores)
    return scores
