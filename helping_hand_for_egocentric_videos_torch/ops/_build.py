"""Build the CUDA kernels in ``csrc/`` with ``nvcc`` and load them with ctypes.

Each ``csrc/<name>.cu`` compiles on its own into a shared library with a
plain C interface (no PyTorch headers, so a build takes seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -o build/torch_kernels/lib<name>_<hash>.so csrc/<name>.cu

The library is named by a hash of its source, the shared headers
(``csrc/*.cuh``) and the flags, so it is built at first use and rebuilt
only when one of them changes. The build
directory sits in the checkout's ``build/``, which git ignores. Nothing
is built or loaded when this module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

__all__ = ["SOURCES", "NVCC_FLAGS", "BUILD_DIR", "build", "build_all", "library"]

SOURCES = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _target(name: str) -> tuple[Path, Path]:
    src = SOURCES / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes())
    for hdr in sorted(SOURCES.glob("*.cuh")):
        h.update(hdr.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return src, BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def _start(name: str, verbose: bool):
    """-> (library path, running nvcc process or None if already built)."""
    src, out = _target(name)
    if out.exists():
        return out, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, *(("-Xptxas", "-v") if verbose else ()),
           "-o", str(tmp), str(src)]
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )
    return out, (proc, tmp)


def _finish(name: str, out: Path, job) -> str:
    if job is None:
        return ""
    proc, tmp = job
    log, _ = proc.communicate()
    if proc.returncode:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed on csrc/{name}.cu:\n{log}")
    os.replace(tmp, out)  # atomic: another process never loads half a file
    return log


def build(name: str, verbose: bool = False) -> tuple[Path, str]:
    """Build ``csrc/<name>.cu`` if needed -> (library path, compiler log)."""
    out, job = _start(name, verbose)
    return out, _finish(name, out, job)


def build_all(verbose: bool = False) -> dict[str, dict]:
    """Build every ``csrc/*.cu`` at once, one ``nvcc`` per source, all
    started together -> {name: {"path", "seconds", "log"}}. ``verbose``
    adds ``-Xptxas -v`` (registers, shared memory and spills per kernel)."""
    t0 = time.perf_counter()
    jobs = {
        src.stem: _start(src.stem, verbose) for src in sorted(SOURCES.glob("*.cu"))
    }
    res = {}
    for name, (out, job) in jobs.items():
        log = _finish(name, out, job)
        res[name] = {"path": str(out), "seconds": time.perf_counter() - t0, "log": log}
    return res


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built at first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path, _ = build(name)
            lib = _libs[name] = ctypes.CDLL(str(path))
        return lib
