"""Checkpoint save/restore with keep-last-k pruning, in torch's format.

Counterpart of ``helping_hand_for_egocentric_videos_tpu/core/checkpoint.py``
(orbax there, ``torch.save`` here), for the reference's runtime
checkpointing (run/train.py:225-240, utils/train_utils.py:192-205): the
trainable decoder's state dict, the AdamW state, the step and the best
accuracy, saved every N steps with the last ``keep`` kept. The frozen
backbone is never saved; it is reloaded from the released weights
(run/train.py:433-441).

Layout: ``<path>/step_XXXXXXXX/state.pt``, one file a step. A write goes
to a temporary directory that is renamed into place, so a crash never
leaves half a step. ``block=False`` saves behind: the device-to-host
snapshot is taken on the calling thread (so the caller may go on
updating its tensors), and the file write and the pruning run on one
background thread in submission order; ``PendingSave.result()`` joins.
"""

from __future__ import annotations

import os
import re
import shutil

import torch

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step", "PendingSave"]

_FILE = "state.pt"


class PendingSave:
    """Handle of a ``block=False`` save-behind write.

    ``result()`` joins the background write (re-raising any write error)
    and returns the checkpoint dir. Saves submitted while another is in
    flight run in submission order on one worker thread.
    """

    def __init__(self, future, target: str):
        self._future = future
        self.target = target

    def result(self, timeout: float | None = None) -> str:
        return self._future.result(timeout)

    def done(self) -> bool:
        return self._future.done()


_SAVE_POOL = None


def _save_pool():
    global _SAVE_POOL
    if _SAVE_POOL is None:
        from concurrent.futures import ThreadPoolExecutor

        _SAVE_POOL = ThreadPoolExecutor(max_workers=1, thread_name_prefix="hh-ckpt")
    return _SAVE_POOL


def _ckpt_dir(path: str, step: int) -> str:
    return os.path.join(path, f"step_{step:08d}")


def _steps(path: str) -> list[int]:
    return sorted(int(m.group(1)) for d in os.listdir(path) if (m := re.match(r"step_(\d+)$", d)))


def latest_step(path: str) -> int | None:
    if not os.path.isdir(path):
        return None
    steps = _steps(path)
    return steps[-1] if steps else None


def _snapshot(tree):
    """A host copy of every tensor in a tree of dicts, lists and tuples;
    other leaves are kept as they are."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: _snapshot(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_snapshot(v) for v in tree)
    return tree


def save_checkpoint(path: str, step: int, tree, *, keep: int = 10, block: bool = True):
    """Save a tree of tensors and scalars (state dicts, step, best
    accuracy) at ``step`` -> the step dir, or a ``PendingSave`` with
    ``block=False``; prune all but the last ``keep`` steps."""
    os.makedirs(path, exist_ok=True)
    target = _ckpt_dir(path, step)
    tree = _snapshot(tree)

    def _write() -> str:
        tmp = f"{target}.tmp{os.getpid()}"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        torch.save(tree, os.path.join(tmp, _FILE))
        shutil.rmtree(target, ignore_errors=True)
        os.replace(tmp, target)
        for old in _steps(path)[:-keep]:
            shutil.rmtree(_ckpt_dir(path, old), ignore_errors=True)
        return target

    if block:
        return _write()
    return PendingSave(_save_pool().submit(_write), target)


def restore_checkpoint(path: str, step: int | None = None, map_location="cpu"):
    """Restore the given (or latest) step -> (tree, step); tensors land on
    ``map_location``."""
    if step is None:
        step = latest_step(path)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {path}")
    tree = torch.load(os.path.join(_ckpt_dir(path, step), _FILE), map_location=map_location, weights_only=False)
    return tree, step
