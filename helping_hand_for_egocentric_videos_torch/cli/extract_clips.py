"""CLI: offline video -> uint8 .npy clip extraction.

A copy of ``helping_hand_for_egocentric_videos_tpu/cli/extract_clips.py``
on the port's ``data/native.py`` (which builds into the checkout's
``build/native/``) and ``data/video.py``. Pre-extracts chunked mp4s (or
any video the gated backends can decode) into `<chunk>.mp4.npy` uint8
tensors that every reader in data/video.py picks up transparently — the
fast path for keeping the device fed when the training host has few cores
(decode happens once, offline).

Example:
    python -m helping_hand_for_egocentric_videos_torch.cli.extract_clips \
        --src /data/ego4d/videos_256_chunked --fps 30 --height 256 --width 342
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def extract_one(path: str, out_path: str, fps: float, height: int, width: int) -> bool:
    from ..data import native
    from ..data.video import _video_num_frames, read_frames_at, resize_frames

    try:
        if native.has_ffmpeg():
            # decode the full chunk via the native ffmpeg pipe
            frames = native.decode_clip_ffmpeg(
                path, 0.0, 24 * 3600.0, fps, width, height, max_frames=1000000
            )
        else:
            n = _video_num_frames(path)
            if n is None:
                return False
            frames = read_frames_at(path, list(range(n)), fps)
            # the native branch scales in the decoder; scale the gated
            # backends' native-resolution output to match
            frames = resize_frames(frames, (height, width))
    except Exception as e:
        print(f"  FAILED {path}: {e}")
        return False
    if len(frames) == 0:
        # a failed/corrupt decode must not leave an empty .npy behind:
        # readers treat an existing store as authoritative (_maybe_npy)
        print(f"  FAILED {path}: decoded 0 frames")
        return False
    np.save(out_path, frames)
    return True


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--src", help="directory tree of video files")
    p.add_argument("--fps", type=float, default=30.0)
    p.add_argument("--height", type=int, default=256)
    p.add_argument("--width", type=int, default=342)
    p.add_argument("--ext", default=".mp4")
    p.add_argument("--overwrite", action="store_true")
    p.add_argument(
        "--install-hh-ffmpeg",
        metavar="DIR",
        dest="install_hh_ffmpeg",
        help="build the genuine-libav CLI decoder (native/hh_ffmpeg.c) and "
        "install it as `ffmpeg` in DIR for the popen pipe, then exit "
        "(needs libav* dev headers; docs/DATA.md)",
    )
    args = p.parse_args(argv)

    if args.install_hh_ffmpeg:
        from ..data.native import install_hh_ffmpeg

        print(install_hh_ffmpeg(args.install_hh_ffmpeg))
        return
    if not args.src:
        p.error("--src is required (unless --install-hh-ffmpeg)")

    total = done = 0
    for root, _, files in os.walk(args.src):
        for f in sorted(files):
            if not f.endswith(args.ext):
                continue
            total += 1
            src = os.path.join(root, f)
            dst = src + ".npy"
            if os.path.exists(dst):
                if not args.overwrite:
                    done += 1
                    continue
                # remove the stale store BEFORE decoding: the fallback
                # readers' _maybe_npy fast path would otherwise re-read
                # it instead of re-decoding the mp4
                os.remove(dst)
            if extract_one(src, dst, args.fps, args.height, args.width):
                done += 1
                print(f"  {dst}")
    print(f"extracted {done}/{total} videos")


if __name__ == "__main__":
    main()
