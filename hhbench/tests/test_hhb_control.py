"""The controls of every cell, on the card at the cell's own size
(``cuda``; skipped without a card, decided inside the fixture): the
reference in the program's place with one part's products in a lower
precision (``reference/lowp.py``) must fail the cell's check on three
seeds. The visual tower's fp8 control runs in every cell; the decoder's
TF32 and bf16 controls in the cells whose check holds the decoder alone
(the embedding and training cells); the text tower's in the training
cell, the one that runs it. Run on the card with
``python -m pytest --noconftest -m cuda hhbench/tests/test_hhb_control.py``."""

import pytest
import tiny  # noqa: F401

from hhbench import calibrate, harness

SEEDS = (2**31 + 101, 2**31 + 102, 2**31 + 103)
CELLS = [w["name"] for w in harness.read_json(harness.ROOT / "BENCHMARK.json")["workloads"]]
PARTS = {"decoder": ("embed16.store_b64", "pretrain4f.step_b16"), "text": ("pretrain4f.step_b16",)}
CASES = [(c, "ref_fp8") for c in CELLS] + [
    (c, f"ref_{kind}_{part}") for part, cells in PARTS.items() for c in cells if c in CELLS for kind in ("tf32", "bf16")]


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the controls are read at each cell's own size")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("cell,control", CASES, ids=[f"{c}-{k}" for c, k in CASES])
def test_control_is_not_correct(card, cell, control):
    c = harness.load_cell(cell)
    for seed in SEEDS:
        r = calibrate.reading(c, seed, 4.0, control, card)
        assert r["correct"] is False, r
