"""Small pieces the drivers share: seeds, dtypes, the scratch directory,
the sample of outputs to compare, and the numbers the comparisons read."""

from __future__ import annotations

import contextlib
import math
import os
import tempfile

import numpy as np


def tower_type(cfg: dict):
    """(int8, torch type of the visual tower's stream) for a configuration
    whose ``precision.visual`` is ``"bfloat16"``, ``"float32"`` or
    ``"int8"`` (the program's int8 tower, its stream in bf16)."""
    import torch

    name = cfg["precision"]["visual"]
    return name == "int8", getattr(torch, "bfloat16" if name == "int8" else name)


def rng(seed: int, salt: int) -> np.random.Generator:
    """A numpy generator for one use of the run's seed."""
    return np.random.default_rng([int(seed) & 0xFFFFFFFFFFFFFFFF, salt])


def torch_seed(seed: int, salt: int) -> int:
    return int(rng(seed, salt).integers(0, 2**62))


def scratch_dir(name: str) -> str:
    """A directory under this run's ``TMPDIR`` for data made from the seed."""
    path = os.path.join(tempfile.gettempdir(), "hhbench", f"{name}-{os.getpid()}")
    os.makedirs(path, exist_ok=True)
    return path


def row_gaps(prog, ref):
    """||prog_i - ref_i|| / ||ref_i|| of each row, float64."""
    prog, ref = prog.double(), ref.double()
    return (prog - ref).norm(dim=-1) / ref.norm(dim=-1)


def embed_gaps(emb, ref_emb, boxes=None, ref_boxes=None) -> dict:
    """The compared numbers of an embedding cell and their companions:
    ``embed_rel_gap`` the mean over the sampled clips of each embedding's
    relative L2 gap; ``x_*`` (not limited) the worst clip's, and the
    boxes' mean and worst absolute gaps."""
    g = row_gaps(emb, ref_emb)
    out = {"embed_rel_gap": float(g.mean()), "x_embed_rel_max": float(g.max())}
    if boxes is not None:
        b = (boxes.double() - ref_boxes.double()).abs().reshape(boxes.shape[0], -1).amax(-1)
        out.update(boxes_gap=float(b.mean()), x_boxes_max=float(b.max()))
    return out


def mean_row_gap(prog, ref) -> float:
    """The mean over rows (the first axis) of ``row_gaps`` of the rows
    flattened; infinite where the shapes differ (a row left out)."""
    if tuple(prog.shape) != tuple(ref.shape):
        return math.inf
    return float(row_gaps(prog.reshape(prog.shape[0], -1).to(ref.device), ref.reshape(ref.shape[0], -1)).mean())


@contextlib.contextmanager
def tapped(owner, name: str, keep):
    """``owner.<name>``, a function of the program, wrapped for the
    duration: each call runs unchanged and ``keep(result, *args,
    **kwargs)`` sees what it took and returned. Raises where the program
    has no such function."""
    real = getattr(owner, name)

    def tap(*args, **kwargs):
        out = real(*args, **kwargs)
        keep(out, *args, **kwargs)
        return out

    setattr(owner, name, tap)
    try:
        yield
    finally:
        setattr(owner, name, real)
