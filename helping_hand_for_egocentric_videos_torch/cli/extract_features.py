"""CLI: sliding-window video feature extraction (Ego4D MQ/NLQ-style).

Counterpart of ``helping_hand_for_egocentric_videos_tpu/cli/extract_features.py``.
The reference ships feature-extraction configs (configs/eval/{mq,nlq}.json)
for the downstream Ego4D Moment Query / Natural Language Query challenges
but no in-tree entry point; this CLI provides one: every video is covered
by uniform ``num_frames``-frame windows at ``stride_sec`` spacing, each
window is embedded through the frozen backbone + object decoder (the
summary-query embedding, the vector the retrieval harnesses use), and the
per-video feature sequence is written to one ``.npz``:

    features (W, E) f32, starts (W,) window start seconds, fps, path.

Videos are any files the readers of ``data/video.py`` decode (mp4 through
cv2 / pyav / ffmpeg, or pre-extracted ``.mp4.npy`` frame arrays).

Example:
    python -m helping_hand_for_egocentric_videos_torch.cli.extract_features \\
        --data_dir /data/clips --out_dir /data/features \\
        --backbone_ckpt ... --decoder_ckpt ... --num_frames 16 --stride_sec 2
"""

from __future__ import annotations

import argparse
import glob
import os

import numpy as np

from . import common


def iter_windows(n_frames_total: int, fps: float, num_frames: int, stride_sec: float):
    """Uniform window starts (in frames) covering the whole video."""
    stride_f = max(int(round(stride_sec * fps)), 1)
    span = max(n_frames_total - num_frames, 0)
    return list(range(0, span + 1, stride_f)) or [0]


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    common.add_eval_args(p)
    p.add_argument("--out_dir", required=True)
    p.add_argument("--pattern", default="**/*.mp4*", help="glob under --data_dir")
    p.add_argument("--stride_sec", type=float, default=2.0)
    p.add_argument("--fps", type=float, default=30.0)
    p.add_argument("--batch_windows", type=int, default=8)
    p.set_defaults(num_frames=16)
    args = p.parse_args(argv)
    common.print_env(args.device)

    from ..data.video import _maybe_npy, _video_num_frames, read_frames_at

    model, _, _ = common.build_eval_model(args)
    os.makedirs(args.out_dir, exist_ok=True)

    files = sorted(
        f for f in glob.glob(os.path.join(args.data_dir, args.pattern), recursive=True) if not f.endswith(".npz")
    )
    # .npy sidecars alias their mp4; extract each logical video once
    logical = sorted({f[: -len(".npy")] if f.endswith(".npy") else f for f in files})
    print(f"{len(logical)} videos")

    for vi, path in enumerate(logical):
        npy = _maybe_npy(path)
        vlen = len(npy) if npy is not None else _video_num_frames(path)
        if not vlen:
            print(f"  skip (unreadable): {path}")
            continue
        starts = iter_windows(vlen, args.fps, args.num_frames, args.stride_sec)
        feats = []
        for i in range(0, len(starts), args.batch_windows):
            chunk = starts[i : i + args.batch_windows]
            clips = np.stack(
                [read_frames_at(path, [min(s + j, vlen - 1) for j in range(args.num_frames)], args.fps)
                 for s in chunk]
            )
            emb, _ = model.embed_video(clips)
            feats.append(emb)
        feats = np.concatenate(feats)
        rel = os.path.relpath(path, args.data_dir).replace(os.sep, "__")
        out = os.path.join(args.out_dir, rel + ".features.npz")
        np.savez(
            out,
            features=feats.astype(np.float32),
            starts=np.asarray(starts, np.float32) / args.fps,
            fps=np.float32(args.fps),
            path=np.asarray(path),
        )
        print(f"  [{vi + 1}/{len(logical)}] {rel}: {feats.shape}")


if __name__ == "__main__":
    main()
