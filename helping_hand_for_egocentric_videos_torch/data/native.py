"""ctypes bindings for the native decode stage (native/hh_dataio.cpp).

A copy of ``helping_hand_for_egocentric_videos_tpu/data/native.py`` (the
port imports nothing of the JAX package), with one change: the library
and the ``hh_ffmpeg`` tool build from the checkout's root ``native/``
into the checkout's ``build/native/`` (git ignores ``build/``), as the
CUDA kernels build into ``build/torch_kernels/`` (``ops/_build.py``);
nothing is written inside either package; and a library that cannot load
(built on another machine, a library it links missing here) raises
``NativeUnavailable`` like a failed build.

Builds the shared library on first use if a toolchain is available; a
missing toolchain or ``libjpeg`` raises ``NativeUnavailable``, and
callers take the PIL/pure-Python paths on it (every host decode backend
is gated so — see data/video.py). This is host-side decoding only.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from functools import lru_cache

import numpy as np

__all__ = [
    "NativeUnavailable",
    "get_lib",
    "decode_jpeg",
    "decode_jpeg_batch",
    "decode_clip_ffmpeg",
    "has_ffmpeg",
    "build_hh_ffmpeg",
    "install_hh_ffmpeg",
]

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_BUILD = os.path.join(_ROOT, "build", "native")
_LIB_PATH = os.path.join(_BUILD, "libhh_dataio.so")
_SRC = os.path.join(_ROOT, "native", "hh_dataio.cpp")
_FFTOOL_PATH = os.path.join(_BUILD, "hh_ffmpeg")
_FF_SRC = os.path.join(_ROOT, "native", "hh_ffmpeg.c")


class NativeUnavailable(RuntimeError):
    pass


def _build():
    os.makedirs(os.path.dirname(_LIB_PATH), exist_ok=True)
    cmd = [
        os.environ.get("CXX", "g++"),
        "-O3",
        "-fPIC",
        "-std=c++17",
        "-shared",
        "-o",
        _LIB_PATH,
        _SRC,
        "-ljpeg",
        "-lpthread",
    ]
    subprocess.run(cmd, check=True, capture_output=True)


@lru_cache()
def get_lib():
    if not os.path.exists(_LIB_PATH):
        if not os.path.exists(_SRC):
            raise NativeUnavailable(f"native source missing: {_SRC}")
        try:
            _build()
        except Exception as e:  # toolchain missing / libjpeg absent
            raise NativeUnavailable(f"failed to build hh_dataio: {e}") from e
    try:
        lib = ctypes.CDLL(_LIB_PATH)
    except OSError as e:  # built on another machine: a library it links is missing here
        raise NativeUnavailable(f"cannot load {_LIB_PATH}: {e}") from e
    lib.hh_jpeg_dims.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
    lib.hh_decode_jpeg.argtypes = [ctypes.c_char_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
    lib.hh_decode_jpeg_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p),
        ctypes.c_int,
        ctypes.c_void_p,
        ctypes.c_int,
        ctypes.c_int,
        ctypes.c_int,
    ]
    lib.hh_decode_clip_ffmpeg.argtypes = [
        ctypes.c_char_p,
        ctypes.c_double,
        ctypes.c_double,
        ctypes.c_double,
        ctypes.c_int,
        ctypes.c_int,
        ctypes.c_int,
        ctypes.c_void_p,
    ]
    lib.hh_has_ffmpeg.restype = ctypes.c_int
    return lib


def jpeg_dims(path: str):
    lib = get_lib()
    h, w = ctypes.c_int(), ctypes.c_int()
    rc = lib.hh_jpeg_dims(path.encode(), ctypes.byref(h), ctypes.byref(w))
    if rc != 0:
        raise IOError(f"jpeg_dims failed ({rc}) for {path}")
    return h.value, w.value


def decode_jpeg(path: str, out_h: int = 0, out_w: int = 0) -> np.ndarray:
    lib = get_lib()
    if out_h <= 0 or out_w <= 0:
        out_h, out_w = jpeg_dims(path)
    out = np.empty((out_h, out_w, 3), np.uint8)
    rc = lib.hh_decode_jpeg(path.encode(), out.ctypes.data_as(ctypes.c_void_p), out_h, out_w)
    if rc != 0:
        raise IOError(f"decode_jpeg failed ({rc}) for {path}")
    return out


def decode_jpeg_batch(paths, out_h: int, out_w: int, num_threads: int | None = None) -> np.ndarray:
    lib = get_lib()
    n = len(paths)
    arr = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    out = np.empty((n, out_h, out_w, 3), np.uint8)
    threads = num_threads or min(8, os.cpu_count() or 1)
    failures = lib.hh_decode_jpeg_batch(
        arr, n, out.ctypes.data_as(ctypes.c_void_p), out_h, out_w, threads
    )
    if failures:
        # failed slots are zero-filled (lax-loading semantics, matching the
        # reference's black-frame fallback, base/base_dataset.py:124-140)
        pass
    return out


def has_ffmpeg() -> bool:
    try:
        return bool(get_lib().hh_has_ffmpeg())
    except NativeUnavailable:
        return False


def _av_flags() -> tuple[list[str], list[str]]:
    """(cflags, libs) for the libav* link, via pkg-config when present."""
    pkgs = ["libavformat", "libavcodec", "libswscale", "libavutil"]
    try:
        cf = subprocess.run(
            ["pkg-config", "--cflags"] + pkgs, capture_output=True, text=True, check=True
        ).stdout.split()
        ld = subprocess.run(
            ["pkg-config", "--libs"] + pkgs, capture_output=True, text=True, check=True
        ).stdout.split()
        return cf, ld
    except Exception:
        return [], ["-lavformat", "-lavcodec", "-lswscale", "-lavutil"]


def build_hh_ffmpeg(force: bool = False) -> str:
    """Build the genuine-libav CLI decoder (native/hh_ffmpeg.c) and return
    its path. Needs a C toolchain plus the libavformat/libavcodec/
    libswscale dev headers; raises ``NativeUnavailable`` otherwise."""
    if os.path.exists(_FFTOOL_PATH) and not force:
        return _FFTOOL_PATH
    if not os.path.exists(_FF_SRC):
        raise NativeUnavailable(f"native source missing: {_FF_SRC}")
    os.makedirs(os.path.dirname(_FFTOOL_PATH), exist_ok=True)
    cflags, libs = _av_flags()
    cmd = (
        [os.environ.get("CC", "cc"), "-O3", "-std=c11"]
        + cflags
        + ["-o", _FFTOOL_PATH, _FF_SRC]
        + libs
    )
    try:
        subprocess.run(cmd, check=True, capture_output=True)
    except Exception as e:  # toolchain or libav dev headers absent
        raise NativeUnavailable(f"failed to build hh_ffmpeg: {e}") from e
    return _FFTOOL_PATH


def install_hh_ffmpeg(target_dir: str) -> str:
    """Build hh_ffmpeg and install it as an executable ``ffmpeg`` wrapper
    in ``target_dir``; putting that dir on PATH routes the C++ popen pipe
    (hh_decode_clip_ffmpeg) through the genuine-libav decoder with zero
    Python in the decode path (docs/DATA.md deploy checklist)."""
    tool = build_hh_ffmpeg()
    os.makedirs(target_dir, exist_ok=True)
    path = os.path.join(target_dir, "ffmpeg")
    with open(path, "w") as f:
        f.write(f'#!/bin/sh\nexec "{tool}" "$@"\n')
    os.chmod(path, os.stat(path).st_mode | 0o111)
    return path


def decode_clip_ffmpeg(
    path: str, start_sec: float, duration: float, fps: float, w: int, h: int, max_frames: int
) -> np.ndarray:
    lib = get_lib()
    out = np.zeros((max_frames, h, w, 3), np.uint8)
    n = lib.hh_decode_clip_ffmpeg(
        path.encode(), start_sec, duration, fps, w, h, max_frames, out.ctypes.data_as(ctypes.c_void_p)
    )
    if n == -2:
        raise NativeUnavailable("ffmpeg binary not available")
    if n < 0:
        raise IOError(f"ffmpeg decode failed ({n}) for {path}")
    return out[:n]
