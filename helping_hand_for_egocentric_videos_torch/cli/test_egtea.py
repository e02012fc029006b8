"""CLI: EGTEA zero-shot action classification (run/test_egtea.py).

Counterpart of ``helping_hand_for_egocentric_videos_tpu/cli/test_egtea.py``.
Averages mean-class accuracy and top-1 over the three test splits.
Protocol: num_clips temporal windows (default 10), 1 spatial crop,
max-pooled logits over clips (test_egtea.py:236-258); ``--spatial_crops
3|6`` adds the multi-crop TTA, the logits then max-pooled over clips x
crops.

Example:
    python -m helping_hand_for_egocentric_videos_torch.cli.test_egtea \\
        --meta_dir meta/egtea --data_dir /data/egtea/cropped_clips \\
        --backbone_ckpt lavila_large.pth --decoder_ckpt nq12.pth.tar --out egtea.json
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from . import common


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    common.add_eval_args(p)
    p.add_argument("--num_clips", type=int, default=10)
    p.add_argument("--clip_stride", type=int, default=2)
    p.add_argument("--splits", nargs="*", default=["1", "2", "3"])
    p.add_argument(
        "--spatial_crops",
        type=int,
        default=1,
        choices=(1, 3, 6),
        help="spatial TTA crops per clip (lavila_transforms SpatialCrop); logits are max-pooled over "
        "clips x crops",
    )
    p.set_defaults(num_frames=16, preprocess="shortside")
    args = p.parse_args(argv)
    if args.spatial_crops > 1:
        args.preprocess = f"crops{args.spatial_crops}"
    common.print_env(args.device)

    from ..data.egtea import EgteaConfig, EgteaDataset, generate_label_map
    from ..train.evaluate import run_egtea

    labels, _ = generate_label_map(os.path.join(args.meta_dir, "action_idx.txt"))
    model, _, _ = common.build_eval_model(args)

    all_res = []
    for split in args.splits:
        ds = EgteaDataset(
            EgteaConfig(
                root=args.data_dir,
                metadata=os.path.join(args.meta_dir, f"test_split{split}.txt"),
                anno_dir=args.meta_dir,
                num_clips=args.num_clips,
                clip_length=args.num_frames,
                clip_stride=args.clip_stride,
            )
        )
        res = run_egtea(model, ds, labels, progress=common.progress)
        print(f"split {split}: mean-class {res['mean_class_acc']:.2f} top1 {res['top1']:.2f}")
        all_res.append(res)

    avg = {
        "mean_class_acc": float(np.mean([r["mean_class_acc"] for r in all_res])),
        "top1": float(np.mean([r["top1"] for r in all_res])),
    }
    print(f"AVG over {len(all_res)} splits: mean-class {avg['mean_class_acc']:.2f} top1 {avg['top1']:.2f}")
    common.dump(avg, args.out)


if __name__ == "__main__":
    main()
