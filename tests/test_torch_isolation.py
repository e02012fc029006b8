"""The PyTorch port stands alone and fails loudly without a card.

- Every module of the port imports with JAX made unimportable, and loads
  nothing of the JAX package; no source of the port, nor chip_smoke.py
  or the port's tools (``tools/torch_*.py``), names either in an import
  statement (lazy imports included).
- The kernel wrappers, and the int8 model code that calls them, have no
  ``try`` to fall back from a kernel.
- Without CUDA, the default entry points raise and chip_smoke.py exits
  non-zero, in the repo and in a directory that holds only the script.
"""

import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "helping_hand_for_egocentric_videos_torch"
FORBIDDEN = ("jax", "jaxlib", "helping_hand_for_egocentric_videos_tpu")


def _imported_names(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def _port_sources():
    return sorted(PORT.rglob("*.py"))


@pytest.mark.parametrize(
    "path", [*_port_sources(), ROOT / "chip_smoke.py", *sorted((ROOT / "tools").glob("torch_*.py"))],
    ids=lambda p: str(p.relative_to(ROOT)),
)
def test_no_source_imports_jax_or_the_jax_package(path):
    bad = [m for m in _imported_names(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_every_port_module_imports_without_jax():
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['jaxlib'] = None\n"
        "import helping_hand_for_egocentric_videos_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "bad = [m for m in sys.modules if m.startswith('helping_hand_for_egocentric_videos_tpu')]\n"
        "assert not bad, bad\n"
        "print(len(names))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    # every module was walked: each source but the top-level __init__
    assert int(out.stdout.split()[-1]) == len(_port_sources()) - 1


def test_kernel_wrapper_has_no_fallback():
    tree = ast.parse((PORT / "ops" / "divided_attention.py").read_text())
    assert not [n for n in ast.walk(tree) if isinstance(n, ast.Try)]


def test_act_quant_wrappers_and_int8_model_code_have_no_fallback():
    for rel in ("ops/act_quant.py", "models/quant.py", "models/spacetime_vit.py"):
        tree = ast.parse((PORT / rel).read_text())
        assert not [n for n in ast.walk(tree) if isinstance(n, ast.Try)], rel


@pytest.fixture
def no_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")


def test_default_device_raises_without_cuda(no_cuda):
    from helping_hand_for_egocentric_videos_torch import resolve_device
    from helping_hand_for_egocentric_videos_torch.data import ClipTokenizer
    from helping_hand_for_egocentric_videos_torch.models import (
        DecoderConfig,
        Lavila,
        ObjDecoder,
        timesformer_tiny_config,
    )
    from helping_hand_for_egocentric_videos_torch.train import EvalModel

    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    lcfg = timesformer_tiny_config()
    dcfg = DecoderConfig(d_model=32, nhead=4, num_layers=1, dim_feedforward=32, num_classes=2,
                         feature_dim=128, text_width=64, num_frames=4, patches_per_frame=49)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        EvalModel(Lavila(lcfg), lcfg, ObjDecoder(dcfg), dcfg, ClipTokenizer())


@pytest.mark.parametrize("alone", [False, True], ids=["in-repo", "alone"])
def test_chip_smoke_fails_without_cuda(no_cuda, tmp_path, alone):
    cwd = ROOT
    if alone:
        shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
        cwd = tmp_path
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, capture_output=True,
                         text=True, timeout=300, env=env)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
