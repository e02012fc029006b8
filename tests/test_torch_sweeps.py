"""The port's batch sweeps and host profile on the CPU, at a miniature width.

``tools/torch_eval_sweep.py`` and ``tools/torch_train_sweep.py`` at two
tiny batches and one timed step, the train sweep's traced step included,
and ``tools/torch_host_profile.py`` at two batches: every line parses and
carries the keys of the JAX tools' lines (``tools/eval_sweep.py``,
``tools/train_sweep.py``, ``tools/host_profile.py``, read from their
source, never imported), under their names; the CPU's lines carry no mfu.
"""

from __future__ import annotations

import ast
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tools"))

import torch_eval_sweep  # noqa: E402
import torch_host_profile  # noqa: E402
import torch_train_sweep  # noqa: E402

TINY = ["--device", "cpu", "--backbone", "timesformer_tiny", "--steps", "1", "--batches", "1", "2"]


def _lines(capsys):
    return [json.loads(ln) for ln in capsys.readouterr().out.strip().splitlines()]


def _dict_keys(tool: str, func: str) -> set[str]:
    """The constant keys of the dict literals of ``tools/<tool>::func``."""
    tree = ast.parse((ROOT / "tools" / tool).read_text())
    fn = next(n for n in ast.walk(tree) if isinstance(n, ast.FunctionDef) and n.name == func)
    return {k.value for n in ast.walk(fn) if isinstance(n, ast.Dict) for k in n.keys if isinstance(k, ast.Constant)}


def test_eval_sweep_lines(capsys):
    torch_eval_sweep.main(TINY)
    lines = _lines(capsys)
    assert [(ln["metric"], ln["batch"]) for ln in lines] == [("eval_sweep_16f_bf16", 1), ("eval_sweep_16f_bf16", 2)]
    want = _dict_keys("eval_sweep.py", "bench") | {"peak_memory_gb", "forward_ms", "card", "power_limit_w"}
    for ln in lines:
        assert set(ln) == want
        assert ln["clips_per_sec"] > 0 and ln["mfu"] is None and ln["card"] == "cpu"


def test_eval_sweep_int8_names_its_lines(capsys):
    torch_eval_sweep.main(TINY[:-1] + ["--int8"])
    (line,) = _lines(capsys)
    assert line["metric"] == "eval_sweep_16f_int8" and line["batch"] == 1


def test_train_sweep_lines_and_traced_step(capsys):
    torch_train_sweep.main(TINY)
    lines = _lines(capsys)
    assert [ln["metric"] for ln in lines] == ["train_clips_per_sec_per_chip_4f"] * 2 + ["train_step_top_ops_bs16"]
    assert [ln["batch_videos"] for ln in lines[:2]] == [1, 2]
    assert all(ln["value"] > 0 and ln["mfu"] is None for ln in lines[:2])
    prof = lines[-1]
    assert {"metric", "ops"} <= set(prof) and 1 <= len(prof["ops"]) <= 12
    assert all(where == "host" and ms >= 0 for ms, where, _ in prof["ops"])  # no device on the CPU
    assert prof["device_busy_ms"] == 0


def test_host_profile_stages(capsys):
    out = torch_host_profile.main(2)
    lines = _lines(capsys)
    src = (ROOT / "tools" / "host_profile.py").read_text()
    stages = ["slice", "item", "items+collate", "loader_t1", "loader_t4"]
    # the JAX tool's stage names: three literals and loader_t{nt} for nt in (1, 4)
    assert all(f'out["{s}"]' in src for s in stages[:3])
    assert 'out[f"loader_t{nt}"]' in src and "for nt in (1, 4):" in src
    assert [ln["stage"] for ln in lines[:-1]] == stages == list(out)
    assert all(ln["clips_per_sec"] > 0 for ln in lines[:-1])
    assert lines[-1]["metric"] == "host_stage_breakdown"
    assert set(lines[-1]) == {"metric", "cpus", *stages}
