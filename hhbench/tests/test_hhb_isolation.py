"""What the benchmark may touch: no JAX in the measuring process, a
reference that imports nothing of the program, no old bench files read,
writes only under the checkout and TMPDIR, and no result without a card."""

import ast
import json
import os
import subprocess
import sys

import pytest
import tiny  # noqa: F401

from hhbench import harness

HERE = harness.HERE
ROOT = harness.ROOT
PORT = "helping_hand_for_egocentric_videos_torch"
PY = sorted(p for p in HERE.rglob("*.py") if "tests" not in p.parts)


def imported(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_forbidden_names_compare_whole_top_level_names(monkeypatch):
    for name in (PORT, PORT + ".models", "helping_hand_for_egocentric_videos_tpux", "jaxtyping", "flaxen"):
        monkeypatch.setitem(sys.modules, name, type(sys)(name))
    found = harness.forbidden_modules()
    assert not {PORT, PORT + ".models", "helping_hand_for_egocentric_videos_tpux", "jaxtyping", "flaxen"} & set(found)
    monkeypatch.setitem(sys.modules, "helping_hand_for_egocentric_videos_tpu.ops", type(sys)("x"))
    monkeypatch.setitem(sys.modules, "jax.numpy", type(sys)("x"))
    assert {"helping_hand_for_egocentric_videos_tpu.ops", "jax.numpy"} <= set(harness.forbidden_modules())


@pytest.mark.parametrize("path", PY, ids=[str(p.relative_to(HERE)) for p in PY])
def test_no_jax_imports(path):
    tops = {m.split(".")[0] for m in imported(path)}
    assert not tops & set(harness.FORBIDDEN), path


@pytest.mark.parametrize("path", sorted((HERE / "reference").glob("*.py")), ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    tops = {m.split(".")[0] for m in imported(path)}
    assert tops <= {"__future__", "contextlib", "numpy", "scipy", "torch"}, tops


def test_reference_process_loads_no_program_module():
    code = ("import sys; sys.path.insert(0, %r); import hhbench.reference.model, hhbench.reference.losses, "
            "hhbench.reference.optim, hhbench.reference.preprocess, hhbench.reference.lowp; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))") % str(ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, check=True).stdout
    tops = set(json.loads(out.replace("'", '"')))
    assert PORT not in tops and not tops & set(harness.FORBIDDEN)


def test_a_whole_run_loads_no_jax():
    code = ("import sys; sys.path.insert(0, %r); sys.path.insert(0, %r); import tiny, importlib.util; "
            "spec = importlib.util.spec_from_file_location('r', %r); m = importlib.util.module_from_spec(spec); "
            "spec.loader.exec_module(m); run = tiny.tiny_run('pretrain4f.step_b16', seconds=0.3); "
            "run.cell.cfg['precision']['visual'] = 'float32'; line = m.execute(run); "
            "from hhbench import harness; print(line['correct'], harness.forbidden_modules())") % (
        str(ROOT), str(HERE / "tests"), str(HERE / "run.py"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, check=True).stdout
    assert out.strip().splitlines()[-1] == "True []"


def test_old_bench_files_are_not_read():
    for path in PY + sorted(HERE.rglob("*.json")):
        text = path.read_text()
        for old in ("bench.py", "tools/", "chip_smoke", "BENCH_", "MULTICHIP_", "BASELINE"):
            assert old not in text or path.name == "test_hhb_isolation.py", (path, old)


def test_no_result_without_a_card():
    proc = subprocess.run([sys.executable, str(HERE / "run.py"), "--workload", "embed16.store_b64", "--seed",
                           str(2**31 + 11), "--seconds", "1", "--trace", "0"],
                          capture_output=True, text=True, cwd=ROOT, env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "CUDA device" in proc.stderr


def test_no_result_without_the_program(tmp_path):
    """In a directory that holds only BENCHMARK.json and the benchmark."""
    import shutil

    shutil.copytree(HERE, tmp_path / "hhbench", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    proc = subprocess.run([sys.executable, "hhbench/run.py", "--workload", "embed16.store_b64", "--seed", "5",
                           "--seconds", "1", "--trace", "0"], capture_output=True, text=True, cwd=tmp_path)
    assert proc.returncode != 0 and proc.stdout.strip() == ""
    assert "program" in proc.stderr


def test_writes_stay_in_tmpdir(tmp_path):
    code = ("import sys; sys.path.insert(0, %r); sys.path.insert(0, %r); import tiny, os; "
            "from hhbench import harness; run = tiny.tiny_run('embed16.store_b64', seconds=0.3); "
            "run.cell.cfg['precision']['visual'] = 'float32'; "
            "res = harness.load_driver('embed_store').run(run); print(sorted(os.listdir(%r))); res.check(); "
            "print(sorted(os.listdir(os.path.join(%r, 'hhbench'))))") % (
        str(ROOT), str(HERE / "tests"), str(tmp_path), str(tmp_path))
    env = dict(os.environ, TMPDIR=str(tmp_path))
    before = set(os.listdir(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, check=True, env=env,
                         cwd=tmp_path).stdout.splitlines()
    assert "hhbench" in out[0]  # the store went under TMPDIR
    assert out[1] == "[]"  # and is gone after the check
    assert set(os.listdir(ROOT)) == before
