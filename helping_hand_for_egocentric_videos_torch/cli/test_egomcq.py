"""CLI: zero-shot EgoMCQ evaluation (the reference's run/test_EgoMCQ.py).

Counterpart of ``helping_hand_for_egocentric_videos_tpu/cli/test_egomcq.py``.
Prints Inter-/Intra-video accuracy. Protocol: 4-frame clips by default
(README.md:26-28 runs this with the pretraining frame count).

Example:
    python -m helping_hand_for_egocentric_videos_torch.cli.test_egomcq \\
        --meta_dir meta/egoclip --data_dir /data/ego4d \\
        --backbone_ckpt lavila_large.pth --decoder_ckpt nq12.pth.tar --out egomcq.json
"""

from __future__ import annotations

import argparse

from . import common


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    common.add_eval_args(p)
    p.add_argument("--limit", type=int, default=0, help="0 = all items")
    p.add_argument(
        "--subsample",
        type=int,
        default=0,
        help="keep the first K items of each type (balanced inter/intra fast-eval subset); 0 = full set",
    )
    p.add_argument(
        "--out_sims",
        default="",
        help="optional .npz path for the raw similarity rows + gt + types "
        "(the reference's EgoMCQ_results .pth dump, run/test_EgoMCQ.py:119)",
    )
    p.set_defaults(num_frames=4)
    args = p.parse_args(argv)
    common.print_env(args.device)

    from ..data.egoclip import EgoClipConfig, EgoClipDataset
    from ..train.evaluate import run_egomcq

    model, _, _ = common.build_eval_model(args)
    ds = EgoClipDataset(
        EgoClipConfig(
            meta_dir=args.meta_dir,
            data_dir=args.data_dir,
            split="val",
            num_frames=args.num_frames,
            val_subsample=args.subsample,
        )
    )
    res = run_egomcq(model, ds, limit=args.limit or None, progress=common.progress, out_sims=args.out_sims or None)
    common.dump(res, args.out)


if __name__ == "__main__":
    main()
