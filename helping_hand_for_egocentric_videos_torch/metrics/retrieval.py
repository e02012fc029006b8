"""Rank-based retrieval metrics (R@k / median rank) and EgoMCQ accuracy.

Host-side numpy metrics. Semantics follow the reference ``model/metric.py``:

- ``t2v_metrics`` (metric.py:11-115): ranks of ground-truth videos in the
  text->video similarity matrix, ties broken *optimistically*.
- ``v2t_metrics`` (metric.py:118-207): per-video minimum rank over its
  captions, ties broken by *averaging*.
- ``egomcq_accuracy_metrics`` (metric.py:209-225): argmax accuracy split by
  question type. NOTE: the reference zips sorted types with
  ``["Intra-video", "Inter-video"]`` so type 1 -> "Intra-video", even though
  the EgoMCQ dataset documents type 1 as inter-video
  (EgoClip_EgoMCQ_dataset.py:328). We replicate the reference mapping for
  output parity; ``egomcq_accuracy_by_type`` exposes the raw per-type
  accuracies.
- ``cols2metrics`` is referenced but undefined upstream (dead EgoVLP
  import); we provide the standard EgoVLP implementation (R@1/5/10/50,
  MedR, MeanR, geometric mean).

A copy of ``helping_hand_for_egocentric_videos_tpu/metrics/retrieval.py`` (the port imports
nothing of the JAX package); it runs on the host without JAX, so the same inputs and seed give
the same result in both packages.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "cols2metrics",
    "t2v_metrics",
    "v2t_metrics",
    "egomcq_accuracy_metrics",
    "egomcq_accuracy_by_type",
]


def cols2metrics(cols: np.ndarray, num_queries: int) -> dict:
    """Convert 0-indexed ranks into retrieval metrics."""
    cols = np.asarray(cols)
    metrics = {}
    metrics["R1"] = 100 * float(np.sum(cols == 0)) / num_queries
    metrics["R5"] = 100 * float(np.sum(cols < 5)) / num_queries
    metrics["R10"] = 100 * float(np.sum(cols < 10)) / num_queries
    metrics["R50"] = 100 * float(np.sum(cols < 50)) / num_queries
    metrics["MedR"] = float(np.median(cols)) + 1
    metrics["MeanR"] = float(np.mean(cols)) + 1
    stats = [metrics[x] for x in ("R1", "R5", "R10")]
    metrics["geometric_mean_R1-R5-R10"] = float(
        np.exp(np.mean(np.log(np.maximum(stats, 1e-12))))
    )
    return metrics


def t2v_metrics(sims: np.ndarray, query_masks: np.ndarray | None = None) -> dict:
    """Text->video retrieval metrics from an (num_texts, num_vids) matrix.

    Supports ``queries_per_video = num_texts // num_vids`` grouped captions;
    ties are broken optimistically (first matching rank).
    """
    sims = np.asarray(sims)
    assert sims.ndim == 2, "expected a matrix"
    num_queries, num_vids = sims.shape
    dists = -sims
    sorted_dists = np.sort(dists, axis=1)

    queries_per_video = num_queries // num_vids
    # Ground-truth distance for caption i of video j is dists[i, j].
    gt = np.empty(num_queries)
    for jj in range(num_vids):
        for ii in range(jj * queries_per_video, (jj + 1) * queries_per_video):
            gt[ii] = dists[ii, jj]
    rows, cols = np.where((sorted_dists - gt[:, None]) == 0)

    if rows.size > num_queries:  # ties: keep the first (best) rank per row
        assert np.unique(rows).size == num_queries, "issue in metric evaluation"
        _, idx = np.unique(rows, return_index=True)
        cols = cols[idx]

    assert cols.size == num_queries, "expected ranks to match queries"

    if query_masks is not None:
        keep = query_masks.reshape(-1).astype(bool)
        cols = cols[keep]
        num_queries = int(keep.sum())

    return cols2metrics(cols, num_queries)


def v2t_metrics(sims: np.ndarray, query_masks: np.ndarray | None = None) -> dict:
    """Video->text retrieval metrics.

    For each video, the rank of its closest ground-truth caption (VSE
    style); tied distances contribute their average rank.
    """
    sims = np.asarray(sims).T  # (num_vids, num_caps)
    num_queries, num_caps = sims.shape
    dists = -sims
    caps_per_video = num_caps // num_queries
    missing_val = 1e8

    query_ranks = []
    for ii in range(num_queries):
        row = dists[ii, :].copy()
        if query_masks is not None:
            row[np.logical_not(query_masks.reshape(-1))] = missing_val
        sorted_row = np.sort(row)
        min_rank = np.inf
        for jj in range(ii * caps_per_video, (ii + 1) * caps_per_video):
            if row[jj] == missing_val:
                continue
            ranks = np.where((sorted_row - row[jj]) == 0)[0]
            rank = ranks.mean()
            if rank < min_rank:
                min_rank = rank
        query_ranks.append(min_rank)

    return cols2metrics(np.array(query_ranks), num_queries)


def egomcq_accuracy_by_type(
    preds: np.ndarray, labels: np.ndarray, types: np.ndarray
) -> dict:
    """Argmax accuracy (%) per MCQ type id."""
    preds = np.asarray(preds)
    labels = np.asarray(labels).reshape(-1)
    types = np.asarray(types).reshape(-1)
    out = {}
    for t in np.unique(types):
        sel = types == t
        correct = np.argmax(preds[sel], axis=-1) == labels[sel]
        out[int(t)] = 100.0 * float(np.mean(correct))
    return out


def egomcq_accuracy_metrics(
    preds: np.ndarray, labels: np.ndarray, types: np.ndarray
) -> dict:
    """Reference-parity output (model/metric.py:209-225): the reference
    zips sorted unique types with ["Intra-video", "Inter-video"], which
    — given the data's actual encoding (1 = inter, 2 = intra,
    data/egoclip.py) — reports the two groups under swapped names. We
    replicate that misnaming as a FIXED mapping {1: "Intra-video",
    2: "Inter-video"}: identical output whenever both types are present,
    but stable when a subset (e.g. a limited online eval) contains only
    one type — the reference's positional zip would then label type 2
    "Intra-video" and the best-model criterion res["Inter-video"] would
    silently read 0. Unknown ids become "type<t>"."""
    by_type = egomcq_accuracy_by_type(preds, labels, types)
    names = {1: "Intra-video", 2: "Inter-video"}
    return {names.get(t, f"type{t}"): acc for t, acc in sorted(by_type.items())}
