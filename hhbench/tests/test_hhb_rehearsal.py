"""A CPU rehearsal of every traffic driver at tiny widths, called as a
function: the whole run after the look for the card (``run.execute``),
with and without the traced stretch. The tower runs in float32 here, so
the reference agrees to rounding and ``correct`` must come out true."""

import importlib.util

import numpy as np
import pytest
import tiny

from hhbench import harness

CELLS = [w["name"] for w in tiny.bench()["workloads"] if w["chips"] == 1]
EXTRA = {"serve16.open_r80": {"rate": 6.0, "trace_s": 0.5}}


def run_module():
    spec = importlib.util.spec_from_file_location("hhbench_run", harness.HERE / "run.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def f32_run(cell, params=None, **kw):
    run = tiny.tiny_run(cell, params={**EXTRA.get(cell, {}), **(params or {})}, **kw)
    run.cell.cfg["precision"]["visual"] = "float32"
    return run


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("cell", CELLS)
def test_driver_rehearsal(cell, trace):
    run = f32_run(cell, seconds=1.0, trace=trace)
    line = run_module().execute(run)
    assert line["correct"] is True, line["compared"]
    assert line["failed"] == 0 and line["attempted"] > 0
    assert list(line)[-1] == "compared"
    assert set(run.cell.limits) <= set(line["compared"])
    if trace:
        assert "breakdown" in line and "busy_s" in line["device"]
        names = {m["name"] for m in run.cell.per_layer}
        assert set(line["metrics"]) <= names
    else:
        want = {m["name"] for m in run.cell.end_to_end}
        assert set(line["metrics"]) == want
        assert all(v["value"] > 0 for v in line["metrics"].values())


def test_same_seed_same_inputs():
    from hhbench import weights

    cfg = tiny.tiny_cfg(harness.read_json(harness.HERE / "configs" / "hh-tsf-l14-4f-pretrain.json"))
    a = weights.make(cfg, "decoder", 2**31 + 5, "cpu")
    b = weights.make(cfg, "decoder", 2**31 + 5, "cpu")
    c = weights.make(cfg, "decoder", 2**31 + 6, "cpu")
    assert all((a[k] == b[k]).all() for k in a)
    assert not (a["proj.weight"] == c["proj.weight"]).all()


def test_serving_schedule_orders_one_set_of_gaps_and_sizes():
    """Every seed sends the same gaps and sizes, at the traffic's mean rate
    and size proportions, in an order of its own over the whole window."""
    from hhbench.mixes import serve_load

    spec = {**harness.read_json(harness.HERE / "traffic" / "open_r80.json"), "clip_pool": 48}
    a = serve_load.schedule({**spec, "seed": 2**31 + 11}, 30.0)
    b = serve_load.schedule({**spec, "seed": 2**31 + 12}, 30.0)
    n = len(a)
    quantiles = -np.log(1.0 - (np.arange(n) + 0.5) / n) / spec["rate"]
    for s in (a, b):  # every gap a distinct quantile of the exponential distribution
        k = np.abs(np.diff([d for d, _ in s])[:, None] - quantiles[None]).argmin(1)
        assert np.allclose(np.diff([d for d, _ in s]), quantiles[k]) and len(set(k)) == n - 1
    assert sorted(len(c) for _, c in a) == sorted(len(c) for _, c in b)
    assert [len(c) for _, c in a] != [len(c) for _, c in b]
    assert len(a) == round(spec["rate"] * 30.0) and abs(a[-1][0] - 30.0) < 1.0
    counts = [sum(len(c) == s for _, c in a) for s in spec["sizes"]]
    assert counts == [round(w * len(a)) for w in spec["weights"]]
