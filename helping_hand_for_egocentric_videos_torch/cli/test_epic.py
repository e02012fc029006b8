"""CLI: Epic-Kitchens-100 MIR zero-shot retrieval (run/test_epic.py).

Counterpart of ``helping_hand_for_egocentric_videos_tpu/cli/test_epic.py``.
Prints mAP and nDCG (VT / TV / AVG). Needs the EPIC retrieval
annotations, the relevancy pickle and indexes.pkl (test_epic.py:99-101).
Protocol: 16 frames, temporal embeds inflated from the 4-frame training
length.

Example:
    python -m helping_hand_for_egocentric_videos_torch.cli.test_epic \\
        --meta_dir meta/epic --data_dir /data/epic \\
        --backbone_ckpt lavila_large.pth --decoder_ckpt nq12.pth.tar --out epic.json
"""

from __future__ import annotations

import argparse
import os
import pickle

import numpy as np

from . import common


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    common.add_eval_args(p)
    p.add_argument("--split", default="test")
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument(
        "--out_sims",
        default="",
        help="optional .npz path for the raw + re-indexed similarity matrices "
        "(the reference's torch.save, run/test_epic.py:263-265)",
    )
    p.set_defaults(num_frames=16)
    args = p.parse_args(argv)
    common.print_env(args.device)

    from ..data.epic import EpicConfig, EpicMIRDataset
    from ..train.evaluate import run_epic_mir

    with open(os.path.join(args.meta_dir, "relevancy/caption_relevancy_EPIC_100_retrieval_test.pkl"), "rb") as f:
        relevancy = pickle.load(f)
    with open(os.path.join(args.meta_dir, "indexes.pkl"), "rb") as f:
        indexes = np.asarray(pickle.load(f))

    model, _, _ = common.build_eval_model(args)
    ds = EpicMIRDataset(
        EpicConfig(meta_dir=args.meta_dir, data_dir=args.data_dir, split=args.split, num_frames=args.num_frames)
    )
    res = run_epic_mir(model, ds, relevancy, indexes, batch_size=args.batch_size, progress=common.progress,
                       out_sims=args.out_sims or None)
    print("nDCG: VT:{nDCG_VT:.3f} TV:{nDCG_TV:.3f} AVG:{nDCG_AVG:.3f}".format(**res))
    print("mAP: VT:{mAP_VT:.3f} TV:{mAP_TV:.3f} AVG:{mAP_AVG:.3f}".format(**res))
    common.dump(res, args.out)


if __name__ == "__main__":
    main()
