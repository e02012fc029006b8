"""CLI: narrate video clips with LaViLa's narrator (``models/narrator.py``).

Every video under ``--data_dir`` (``--pattern``) is one clip:
``--num_frames`` frames spread evenly over it, read by the package's
loader (``PrefetchLoader``, ``--threads`` decode threads, copied to the
device a batch at a time), narrated ``--num_return_sequences`` times each
by ``NarratorModel.narrate`` with a generator seeded from ``--seed`` and
the batch's index. The token ids go to one ``.npz``:

    ids (clips, R, max_text_length) int64, BOS first and EOS-padded;
    paths (clips,) the videos.

No tokenizer turns ids into text here: GPT-2's vocabulary and merges are
not in the repository. ``--weights`` takes a state dict in the model's own
layout (``NarratorModel.state_dict()``); the released narrator checkpoint
waits for its file and a converter (PERF.md, section 7). Without it the
weights are seeded random ones, so the ids are noise.

Example:
    python -m helping_hand_for_egocentric_videos_torch.cli.narrate \\
        --data_dir /data/clips --out /data/narrations.npz --batch 64
"""

from __future__ import annotations

import argparse
import glob
import os

import numpy as np

from . import common


class VideoClips:
    """Video ``i`` of ``paths`` as one clip of ``frames`` frames, each frame
    resized to ``res`` x ``res`` when it is not already that size."""

    def __init__(self, paths, frames: int, res: int, fps: float):
        self.paths, self.frames, self.res, self.fps = paths, frames, res, fps

    def __len__(self):
        return len(self.paths)

    def __getitem__(self, i):
        from ..data.video import _maybe_npy, _video_num_frames, read_frames_at, resize_frames

        path = self.paths[i]
        npy = _maybe_npy(path)
        n = len(npy) if npy is not None else (_video_num_frames(path) or self.frames)
        ids = np.linspace(0, n - 1, self.frames).round().astype(int).tolist()
        clip = read_frames_at(path, ids, self.fps)
        if clip.shape[1:3] != (self.res, self.res):
            clip = resize_frames(clip, (self.res, self.res))
        return {"video": np.ascontiguousarray(clip, dtype=np.uint8), "index": np.int64(i)}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--data_dir", required=True)
    p.add_argument("--pattern", default="**/*.mp4*", help="glob under --data_dir")
    p.add_argument("--out", required=True, help="the .npz of token ids")
    p.add_argument("--model", default="vclm_openai_timesformer_large_336px_gpt2_xl",
                   choices=["vclm_openai_timesformer_large_336px_gpt2_xl", "vclm_tiny"])
    p.add_argument("--weights", default="",
                   help="a state dict in NarratorModel's layout; default: seeded random weights")
    p.add_argument("--batch", type=int, default=64, help="clips a narrated batch")
    p.add_argument("--num_return_sequences", type=int, default=10)
    p.add_argument("--max_text_length", type=int, default=77)
    p.add_argument("--temperature", type=float, default=0.7)
    p.add_argument("--top_p", type=float, default=0.95)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--fps", type=float, default=30.0)
    p.add_argument("--threads", type=int, default=4)
    p.add_argument("--dtype", default="bfloat16", choices=["bfloat16", "float32"],
                   help="the model's type; float32 on the CPU only (the card's decode attention takes bf16)")
    p.add_argument("--device", default="cuda",
                   help="torch device of the model (default: the CUDA device; 'cpu' runs the kernels' plain "
                   "versions)")
    args = p.parse_args(argv)
    if args.dtype == "float32" and not args.device.startswith("cpu"):
        p.error("--dtype float32 runs on the CPU only: the decode-attention kernel takes bfloat16")
    common.print_env(args.device)

    import torch

    from ..core.config import NarratorCfg
    from ..data.loader import PrefetchLoader, ShardedSampler, pinned_put
    from ..train.pretrain import build_narrator

    ncfg = NarratorCfg(model=args.model, num_return_sequences=args.num_return_sequences,
                       max_text_length=args.max_text_length, temperature=args.temperature, top_p=args.top_p,
                       weights=args.weights, dtype=args.dtype)
    model = build_narrator(ncfg, rng_seed=args.seed, device=args.device)
    dev = torch.device(args.device)
    files = sorted(f for f in glob.glob(os.path.join(args.data_dir, args.pattern), recursive=True)
                   if not f.endswith(".npz"))
    # .npy sidecars alias their mp4; narrate each logical video once
    paths = sorted({f[: -len(".npy")] if f.endswith(".npy") else f for f in files})
    print(f"{len(paths)} videos")
    vis = model.cfg.visual
    loader = PrefetchLoader(VideoClips(paths, vis.num_frames, vis.img_size, args.fps),
                            ShardedSampler(len(paths), args.batch, shuffle=False, drop_last=False),
                            num_threads=args.threads)
    ids = []
    for k, batch in enumerate(loader):
        video, _ = pinned_put(batch, dev)
        gen = torch.Generator(dev).manual_seed(args.seed * 1_000_003 + k)
        ids.append(model.narrate(video["video"], gen).cpu().numpy())
        common.progress(sum(len(x) for x in ids), len(paths))
    r, length = model.cfg.num_return_sequences, model.cfg.max_text_length
    out = np.concatenate(ids) if ids else np.zeros((0, r, length), np.int64)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    np.savez(args.out, ids=out, paths=np.asarray(paths))
    print(f"wrote {out.shape} ids to {args.out}")


if __name__ == "__main__":
    main()
