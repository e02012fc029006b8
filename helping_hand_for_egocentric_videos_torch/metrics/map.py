"""Mean Average Precision for multi-instance retrieval (Epic-Kitchens MIR).

Host-side numpy metric; semantics match the reference ``utils/mAP.py:4-43``:
AP_i = sum_k p(k) * rel(k) / (#relevant docs for query i), relevance is the
binary indicator ``relevancy == 1``.

A copy of ``helping_hand_for_egocentric_videos_tpu/metrics/map.py`` (the port imports
nothing of the JAX package); it runs on the host without JAX, so the same inputs give
the same result in both packages.
"""

from __future__ import annotations

import numpy as np

__all__ = ["calculate_mAP"]


def calculate_mAP(sim_mat: np.ndarray, relevancy_matrix: np.ndarray) -> float:
    ranked_order = (-sim_mat).argsort()
    rows = np.arange(sim_mat.shape[0])[:, None]
    ranked_rel = relevancy_matrix[rows, ranked_order]

    cumulative = np.cumsum(ranked_rel, axis=1)
    # p(k) only counts at positions where the retrieved item is fully
    # relevant (rel == 1), mirroring the reference's masking.
    cumulative = np.where(ranked_rel == 1, cumulative, 0)
    divisor = np.arange(ranked_rel.shape[1]) + 1

    n_rel = np.sum(ranked_rel == 1, axis=1)
    avg_precision = np.sum(cumulative / divisor, axis=1) / n_rel
    return float(np.mean(avg_precision))
