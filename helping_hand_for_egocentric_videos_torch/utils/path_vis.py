"""Alignment-path visualisation grids (DTW-style pred/target overlays).

A copy of ``helping_hand_for_egocentric_videos_tpu/utils/path_vis.py``
(numpy only), after the reference's utils/visualisation.py:8-51: renders a
(3, T, W) RGB grid showing ground-truth cells (blue), true-positive
predictions (green) and false-positive predictions (red) on top of a
validity window (NaN cells shaded grey). Used for inspecting temporal
alignment predictions; kept framework-free (plain uint8-ish float arrays,
no torch/matplotlib)."""

from __future__ import annotations

import numpy as np

__all__ = ["visualise_path", "batch_path_vis"]

_TP = np.array((64, 191, 64), np.float32)
_FP = np.array((191, 64, 64), np.float32)
_GT = np.array((102, 153, 255), np.float32)


def visualise_path(pred, target, window) -> np.ndarray:
    """pred/target: sequences of (i, j) cells; window: (H, W) float array
    whose NaN cells are rendered as invalid (grey). Rows are re-indexed to
    the unique target clip ids, like the reference. Returns (3, H', W) in
    [0, 1]."""
    window = np.asarray(window, np.float32)
    grid = np.ones((3,) + window.shape, np.float32) * 255.0
    grid = np.where(np.isnan(window)[None], 130.0, grid)

    local_idxs = sorted({int(t[0]) for t in target})
    for t in target:
        grid[:, local_idxs.index(int(t[0])), int(t[1])] = _GT
    for p in pred:
        if int(p[0]) not in local_idxs:
            # prediction on a clip row with no GT cell: the row has no
            # position in the target-compressed grid (the reference
            # crashes here, visualisation.py:32-37); skip it
            continue
        row = local_idxs.index(int(p[0]))
        cell = grid[:, row, int(p[1])]
        grid[:, row, int(p[1])] = _TP if np.array_equal(cell, _GT) else _FP
    return grid / 255.0


def batch_path_vis(pred_dict: dict, target, window) -> np.ndarray:
    """Stacks one path grid per prediction method; the 'min_dist' method is
    drawn without the validity window (reference visualisation.py:40-51)."""
    grids = []
    for key, pred in pred_dict.items():
        win = np.zeros_like(window) if key == "min_dist" else window
        grids.append(visualise_path(pred, target, win))
    return np.stack(grids)
