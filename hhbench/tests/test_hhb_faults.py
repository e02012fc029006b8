"""The timed path broken underneath a whole CPU run (``run.execute``, at
tiny widths in float32, the card's look skipped): each fault a cell can
have must make ``correct`` come out false."""

import pytest
from test_hhb_rehearsal import f32_run, run_module


FAULTS = [
    ("embed16.store_b64", "altered_answers"),
    ("serve16.open_r80", "altered_answers"),
    ("pretrain4f.step_b16", "state_unchanged"),
    ("pretrain4f.step_b16", "half_batch"),
]


@pytest.mark.parametrize("cell,fault", FAULTS, ids=[f"{c}-{f}" for c, f in FAULTS])
def test_fault_fails_the_check(cell, fault):
    run = f32_run(cell, seconds=0.5, params={"fault": fault})
    line = run_module().execute(run)
    assert line["correct"] is False, line["compared"]
