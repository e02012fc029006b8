#!/usr/bin/env python
"""Real-decode ``ffmpeg`` CLI emulator for hosts without an ffmpeg binary.

A copy of ``helping_hand_for_egocentric_videos_tpu/data/ffmpeg_shim.py``
(the port imports nothing of the JAX package).

Implements exactly the command-line subset the native pipe invokes
(native/hh_dataio.cpp:173-175)::

    ffmpeg -nostdin -loglevel error -ss S -t T -i PATH \
        -vf 'fps=F,scale=W:H' -f rawvideo -pix_fmt rgb24 -

and decodes with cv2's bundled FFmpeg build — i.e. real libavcodec
decode of real containers; only the CLI front-end is emulated. Any
argument outside the supported subset is an error (exit 2), so the
emulator never silently accepts a command line it does not implement.

Usage (installed package or repo checkout):
    python -m helping_hand_for_egocentric_videos_torch.data.ffmpeg_shim <ffmpeg args>
    python -m helping_hand_for_egocentric_videos_torch.data.ffmpeg_shim --install DIR

``--install`` writes an executable ``ffmpeg`` shell wrapper into DIR;
putting DIR on PATH makes `data.native.has_ffmpeg()` true and routes the
production C++ popen pipe through this decoder. Intended for dev/CI
images where no
ffmpeg binary exists and none can be provisioned (docs/DATA.md); on a
real deploy host, install genuine ffmpeg instead.

Frame timing follows ffmpeg semantics for this subset: input-side ``-ss``
is an accurate seek (frames strictly before S are dropped, timestamps
rebased to 0), the ``fps=F`` filter emits one frame per output tick
``n/F`` choosing the latest input frame at or before the tick, and
``scale=W:H`` is a squash resize (bilinear, like ffmpeg's default
scaler).
"""

from __future__ import annotations

import os
import stat
import sys


def _die(msg: str, code: int = 2) -> "NoReturn":  # noqa: F821
    print(f"ffmpeg_shim: {msg}", file=sys.stderr)
    raise SystemExit(code)


def parse_args(argv: list[str]) -> dict:
    """Parse the supported ffmpeg CLI subset; _die on anything else."""
    opt = {"ss": 0.0, "t": None, "input": None, "fps": None, "scale": None}
    saw = {"rawvideo": False, "rgb24": False, "out": False}
    i = 0
    while i < len(argv):
        a = argv[i]
        if a == "-nostdin":
            i += 1
        elif a == "-loglevel":
            i += 2
        elif a == "-ss":
            opt["ss"] = float(argv[i + 1])
            i += 2
        elif a == "-t":
            opt["t"] = float(argv[i + 1])
            i += 2
        elif a == "-i":
            opt["input"] = argv[i + 1]
            i += 2
        elif a == "-vf":
            for f in argv[i + 1].split(","):
                name, _, val = f.partition("=")
                if name == "fps":
                    opt["fps"] = float(val)
                elif name == "scale":
                    w, _, h = val.partition(":")
                    opt["scale"] = (int(w), int(h))
                else:
                    _die(f"unsupported filter {f!r}")
            i += 2
        elif a == "-f":
            if argv[i + 1] != "rawvideo":
                _die(f"unsupported muxer {argv[i + 1]!r}")
            saw["rawvideo"] = True
            i += 2
        elif a == "-pix_fmt":
            if argv[i + 1] != "rgb24":
                _die(f"unsupported pix_fmt {argv[i + 1]!r}")
            saw["rgb24"] = True
            i += 2
        elif a == "-" and i == len(argv) - 1:
            saw["out"] = True
            i += 1
        else:
            _die(f"unsupported argument {a!r}")
    if opt["input"] is None:
        _die("no -i input")
    if not (saw["rawvideo"] and saw["rgb24"] and saw["out"]):
        _die("only `-f rawvideo -pix_fmt rgb24 -` output is supported")
    return opt


def run(argv: list[str]) -> int:
    opt = parse_args(argv)
    try:
        import cv2
    except ImportError:
        _die("cv2 (the bundled decoder) is not importable", 1)
    cap = cv2.VideoCapture(opt["input"])
    if not cap.isOpened():
        _die(f"cannot open {opt['input']!r}", 1)
    fps_in = cap.get(cv2.CAP_PROP_FPS) or 30.0
    fps_out = opt["fps"] or fps_in
    # accurate-seek semantics: the first kept frame is the first with
    # pts >= S (ffmpeg drops frames strictly before S), i.e. ceil(S*fps)
    import math

    start = math.ceil(opt["ss"] * fps_in - 1e-6)
    if start:
        cap.set(cv2.CAP_PROP_POS_FRAMES, start)
    # decode the [ss, ss+t) window (all of it: clip requests are seconds
    # long, so the window is small)
    frames = []
    k = start
    while True:
        if opt["t"] is not None and (k - start) / fps_in >= opt["t"] - 1e-9:
            break
        ok, bgr = cap.read()
        if not ok:
            break
        frames.append(bgr)
        k += 1
    cap.release()
    out = sys.stdout.buffer
    n = 0
    while frames:
        # fps filter: tick n at rel time n/fps_out -> latest frame <= tick
        src = int(n * fps_in / fps_out + 1e-6)
        if src >= len(frames):
            break
        img = frames[src]
        if opt["scale"] is not None and (img.shape[1], img.shape[0]) != opt["scale"]:
            img = cv2.resize(img, opt["scale"], interpolation=cv2.INTER_LINEAR)
        try:
            out.write(img[:, :, ::-1].tobytes())  # BGR -> RGB
        except BrokenPipeError:
            return 0  # reader closed early (max_frames reached): not an error
        n += 1
    try:
        out.flush()
    except BrokenPipeError:
        pass
    return 0


def install(target_dir: str) -> str:
    """Write an executable ``ffmpeg`` wrapper into ``target_dir``."""
    os.makedirs(target_dir, exist_ok=True)
    path = os.path.join(target_dir, "ffmpeg")
    me = os.path.abspath(__file__)
    with open(path, "w") as f:
        f.write(f'#!/bin/sh\nexec "{sys.executable}" "{me}" "$@"\n')
    os.chmod(path, os.stat(path).st_mode | stat.S_IXUSR | stat.S_IXGRP | stat.S_IXOTH)
    return path


def main() -> int:
    argv = sys.argv[1:]
    if len(argv) == 2 and argv[0] == "--install":
        print(install(argv[1]))
        return 0
    return run(argv)


if __name__ == "__main__":
    raise SystemExit(main())
