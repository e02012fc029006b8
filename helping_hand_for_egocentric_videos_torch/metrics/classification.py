"""Classification metrics for the EGTEA harness.

Mean-class accuracy via confusion matrix + top-1, matching the reference
harness math (run/test_egtea.py:254-258), plus top-k accuracy
(model/box_utils.py:284-299).

A copy of ``helping_hand_for_egocentric_videos_tpu/metrics/classification.py`` (the port imports
nothing of the JAX package); it runs on the host without JAX, so the same inputs give
the same result in both packages.
"""

from __future__ import annotations

import numpy as np

__all__ = ["confusion_matrix", "mean_class_accuracy", "topk_accuracy"]


def confusion_matrix(preds: np.ndarray, labels: np.ndarray, num_classes: int) -> np.ndarray:
    cm = np.zeros((num_classes, num_classes), dtype=np.int64)
    for p, t in zip(np.asarray(preds).reshape(-1), np.asarray(labels).reshape(-1)):
        cm[int(t), int(p)] += 1
    return cm


def mean_class_accuracy(preds: np.ndarray, labels: np.ndarray, num_classes: int):
    """Returns (mean_class_acc, top1_acc), both in percent."""
    cm = confusion_matrix(preds, labels, num_classes)
    per_class = np.diag(cm) / np.maximum(cm.sum(axis=1), 1)
    valid = cm.sum(axis=1) > 0
    mean_acc = 100.0 * float(per_class[valid].mean())
    top1 = 100.0 * float(np.diag(cm).sum() / max(cm.sum(), 1))
    return mean_acc, top1


def topk_accuracy(scores: np.ndarray, labels: np.ndarray, ks=(1,)):
    """Top-k accuracies (%) from a (N, C) score matrix."""
    scores = np.asarray(scores)
    labels = np.asarray(labels).reshape(-1)
    order = np.argsort(-scores, axis=1)
    out = []
    for k in ks:
        hit = (order[:, :k] == labels[:, None]).any(axis=1)
        out.append(100.0 * float(hit.mean()))
    return out
