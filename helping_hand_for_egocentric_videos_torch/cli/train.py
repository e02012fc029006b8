"""CLI: EgoClip pretraining (the reference's run/train.py).

Counterpart of ``helping_hand_for_egocentric_videos_tpu/cli/train.py``,
with the same flags and ``--device``. One GPU:

    python -m helping_hand_for_egocentric_videos_torch.cli.train \\
        --meta_dir data/EgoClip --data_dir /datasets/ego4d \\
        --backbone_ckpt lavila_large.pth --batch_size 128 --set optim.lr=3e-5

Several GPUs, one rank each (``--batch_size`` is the global batch):

    torchrun --nproc_per_node 4 -m helping_hand_for_egocentric_videos_torch.cli.train ...

On the CPU (the kernels' plain versions): ``--device cpu``.
"""

from __future__ import annotations

import argparse

from ..core.config import ExperimentConfig, apply_overrides
from . import common


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--name", default="egoclip_pretrain")
    p.add_argument("--output_dir", default="runs")
    p.add_argument("--meta_dir", default="data/EgoClip")
    p.add_argument("--data_dir", default="./")
    p.add_argument("--batch_size", type=int, default=128, help="the global batch, over every rank")
    p.add_argument("--num_frames", type=int, default=4)
    p.add_argument("--num_queries", type=int, default=12)
    p.add_argument("--lr", type=float, default=3e-5)
    p.add_argument("--wd", type=float, default=1e-5)
    p.add_argument("--epochs", type=int, default=10)
    p.add_argument("--seed", type=int, default=111)
    p.add_argument("--eval_freq", type=int, default=2500)
    p.add_argument("--runtime_save_iter", type=int, default=2500)
    p.add_argument("--num_workers", type=int, default=8)
    p.add_argument("--backbone", default="timesformer_large")
    p.add_argument("--backbone_ckpt", default="")
    p.add_argument(
        "--int8_backbone",
        action="store_true",
        help="int8-quantize the frozen backbone's training forward (models/quant.py; gradients never "
        "reach it, only the constant features shift)",
    )
    p.add_argument("--decoder_ckpt", default="")
    p.add_argument("--model_parallel", type=int, default=1,
                   help="tensor-parallel backbone; only 1 is ported (ROADMAP.md queue A item 6)")
    p.add_argument(
        "--augment",
        action="store_true",
        help="enable the train-time random-aug pipeline (the reference's force_centercrop=False, "
        "transforms.py:64-69); tune via --set data.randcrop_scale=a,b data.color_jitter=b,s,h",
    )
    p.add_argument("--max_steps", type=int, default=0, help="0 = unlimited")
    p.add_argument("--set", nargs="*", default=[], help="extra a.b=c overrides")
    p.add_argument("--device", default="cuda",
                   help="torch device (default: the CUDA device, cuda:LOCAL_RANK under torchrun; 'cpu' runs "
                   "the kernels' plain versions)")
    p.add_argument("--sync_debug", choices=("warn", "error"), default=None,
                   help="check that the steps between two flushes never wait for the device "
                   "(torch.cuda.set_sync_debug_mode over those steps)")
    return p.parse_args(argv)


def build_config(args) -> ExperimentConfig:
    cfg = ExperimentConfig(name=args.name, output_dir=args.output_dir)
    cfg.data.meta_dir = args.meta_dir
    cfg.data.data_dir = args.data_dir
    cfg.data.batch_size = args.batch_size
    cfg.data.num_frames = args.num_frames
    cfg.data.num_workers = args.num_workers
    cfg.data.augment = args.augment
    cfg.model.backbone = args.backbone
    cfg.model.backbone_ckpt = args.backbone_ckpt
    cfg.model.int8_backbone = args.int8_backbone
    cfg.model.decoder_ckpt = args.decoder_ckpt
    cfg.model.num_queries = args.num_queries
    cfg.optim.lr = args.lr
    cfg.optim.wd = args.wd
    cfg.optim.epochs = args.epochs
    cfg.optim.seed = args.seed
    cfg.optim.eval_freq = args.eval_freq
    cfg.optim.runtime_save_iter = args.runtime_save_iter
    cfg.parallel.model_parallel = args.model_parallel
    return apply_overrides(cfg, args.set)


def main(argv=None):
    """-> (final TrainState, best EgoMCQ Inter-video accuracy)."""
    import torch.distributed as dist

    args = parse_args(argv)
    cfg = build_config(args)
    started = dist.is_available() and dist.is_initialized()
    dp = common.maybe_init_distributed(args.device)
    common.print_env(str(dp.device) if dp is not None else args.device, dp)
    from ..train.pretrain import pretrain

    try:
        state, best = pretrain(cfg, max_steps=args.max_steps or None, device=args.device,
                               sync_debug=args.sync_debug)
    finally:
        if dp is not None and not started:
            dist.destroy_process_group()
    print(f"done. best EgoMCQ Inter-video acc: {best:.3f}", flush=True)
    return state, best


if __name__ == "__main__":
    main()
