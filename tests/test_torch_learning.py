"""The port's learning proof, ``tools/torch_learning_proof.py``.

Its fixture writer gives the files and arrays of the JAX tool's
``build_fixture`` (``tools/learning_proof.py``): the same paths, the same
chunked frames, CSV and JSON text, noun dictionary and boxes. The full
proof (the port's public pretrain loop for 200 steps on that fixture, the
JAX tool's tiny towers on the CPU) is marked ``slow``, as
``tests/test_learning.py`` is, and held to the JAX tool's bars: the best
inter-video EgoMCQ accuracy at least 50% (chance 20%) and the final box
loss below 0.7 times the first.
"""

from __future__ import annotations

import os
import pickle
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tools"))

import learning_proof  # noqa: E402  (the JAX tool; its module level imports no JAX)
import torch_learning_proof  # noqa: E402


def _files(root: Path) -> list[str]:
    return sorted(str(p.relative_to(root)) for p in root.rglob("*") if p.is_file())


def _same(a, b):
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (np.ndarray, torch.Tensor)):
        return type(a) is type(b) and a.dtype == b.dtype and a.shape == b.shape and bool((a == b).all())
    return a == b


def test_fixture_writer_matches_jax_tools(tmp_path):
    ours, theirs = tmp_path / "port", tmp_path / "jax"
    ours.mkdir()
    theirs.mkdir()
    assert torch_learning_proof.build_fixture(str(ours)) == (str(ours / "meta"), str(ours / "data"))
    learning_proof.build_fixture(str(theirs))
    assert _files(ours) == _files(theirs) and len(_files(ours)) == 7
    for rel in _files(ours):
        a, b = ours / rel, theirs / rel
        if rel.endswith(".npy"):
            assert _same(np.load(a), np.load(b)), rel
        elif rel.endswith(".pth"):
            assert _same(torch.load(a), torch.load(b)), rel
        elif rel.endswith(".pkl"):
            with open(a, "rb") as fa, open(b, "rb") as fb:
                assert _same(pickle.load(fa), pickle.load(fb)), rel
        else:
            assert a.read_text() == b.read_text(), rel


def test_fixture_noun_width_follows_the_text_tower(tmp_path):
    meta, _ = torch_learning_proof.build_fixture(str(tmp_path), noun_width=768)
    nd = torch.load(os.path.join(meta, "noun_dict_lavila_embeds.pth"))
    assert {tuple(v.shape) for v in nd.values()} == {(768,)}


@pytest.mark.slow
def test_pretrain_learns_retrieval_above_chance(tmp_path):
    res = torch_learning_proof.main(steps=200, eval_freq=50, lr=1e-3, out_path=str(tmp_path / "proof.json"),
                                    towers="tiny", device="cpu")
    assert res["best_inter_video_acc"] >= 50.0  # chance = 20%
    assert res["final_box_loss"] < 0.7 * res["first_box_loss"]
    assert res["pass"]
