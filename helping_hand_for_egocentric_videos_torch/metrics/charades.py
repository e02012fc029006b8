"""Charades-style multi-label mAP, OSCC accuracy, PNR keyframe distance.

Parity with the reference's auxiliary metrics (model/metric.py:267-362):
``charades_map`` masks videos with no labels to -inf before the official
approximate AP computation; ``oscc_accuracy`` is plain argmax accuracy;
``pnr_keyframe_distance`` is the Ego4D point-of-no-return temporal
localisation error in seconds. These back the additional downstream evals
LaviLa-style codebases run.

A copy of ``helping_hand_for_egocentric_videos_tpu/metrics/charades.py`` (the port imports
nothing of the JAX package); it runs on the host without JAX, so the same inputs give
the same result in both packages.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "multi_label_map",
    "charades_map",
    "oscc_accuracy",
    "pnr_keyframe_distance",
]


def multi_label_map(submission: np.ndarray, gt: np.ndarray):
    """Returns (mAP, weighted AP, per-class AP); nan for empty classes."""
    m_aps = []
    n_classes = submission.shape[1]
    for c in range(n_classes):
        order = np.argsort(-submission[:, c])
        tp = gt[:, c][order] == 1
        n_pos = tp.sum()
        if n_pos < 0.1:
            m_aps.append(float("nan"))
            continue
        fp = np.invert(tp)
        precision = np.cumsum(tp) / (np.cumsum(fp) + np.cumsum(tp)).astype(float)
        m_aps.append(float(precision[tp].sum() / n_pos))
    m_aps = np.array(m_aps)
    m_ap = float(np.nanmean(m_aps)) if np.isfinite(m_aps).any() else float("nan")
    w_ap = m_aps * gt.sum(axis=0) / max(gt.sum(), 1)
    return m_ap, w_ap, m_aps


def charades_map(submission: np.ndarray, gt: np.ndarray) -> float:
    fix = submission.copy()
    empty = np.sum(gt, axis=1) == 0
    fix[empty, :] = -np.inf
    return multi_label_map(fix, gt)[0]


def oscc_accuracy(preds: np.ndarray, labels: np.ndarray) -> float:
    """Object-state-change classification accuracy (%)."""
    preds = np.asarray(preds)
    labels = np.asarray(labels).reshape(-1)
    return 100.0 * float(np.mean(np.argmax(preds, axis=-1) == labels))


def pnr_keyframe_distance(
    preds,
    sc_labels,
    fps,
    parent_start_frames,
    parent_end_frames,
    parent_pnr_frames,
    num_frames: int = 16,
) -> float:
    """Ego4D PNR keyframe-localisation error in seconds
    (pnr_metrics, model/metric.py:319-362): for clips with a state change
    (sc_label == 1), the argmax over ``num_frames`` per-frame scores is
    mapped back to the parent-video frame axis and compared to the
    annotated PNR frame. Returns the mean |error| in seconds (0.0 when no
    clip has a state change, the reference's fallback)."""
    preds = np.asarray(preds)
    dists = []
    for pred, sc, f, start, end, pnr in zip(
        preds, sc_labels, fps, parent_start_frames, parent_end_frames, parent_pnr_frames
    ):
        if int(sc) != 1:
            continue
        loc = int(np.argmax(pred))
        mapped = (float(end) - float(start)) / num_frames * loc
        gt = float(pnr) - float(start)
        dists.append(abs(mapped - gt) / float(f))
    return float(np.mean(dists)) if dists else 0.0
