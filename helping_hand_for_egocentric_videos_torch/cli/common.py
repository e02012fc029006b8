"""Shared CLI helpers.

Counterpart of ``helping_hand_for_egocentric_videos_tpu/cli/common.py``:
the eval CLIs' arguments and the model they build, their progress and
results lines, the process group of a ``torchrun`` launch, the
environment line, and the bounded probe of the card that a benchmark
runs before it touches CUDA. The port's CLIs run on the CUDA device
unless given ``--device cpu``.
"""

from __future__ import annotations

import json
import subprocess
import sys

import torch

__all__ = ["add_eval_args", "bounded_device_probe", "build_eval_model", "dump", "maybe_init_distributed",
           "print_env", "progress"]

# The probe's child: one op on cuda:0, waited for, then the card as
# nvidia-smi names it and its power limit.
_PROBE = (
    "import json, subprocess, torch\n"
    "torch.ones((), device='cuda:0').add_(1).item()\n"
    "smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],\n"
    "                     capture_output=True, text=True, timeout=60).stdout.strip().splitlines()\n"
    "print(json.dumps({'platform': 'gpu', 'device_kind': torch.cuda.get_device_name(0),\n"
    "                  'n': torch.cuda.device_count(), 'card': smi[0] if smi else None}))\n"
)


def bounded_device_probe(timeout: float) -> dict | None:
    """Check that the CUDA device answers, in a subprocess under ``timeout``
    seconds.

    A wedged card can block the first CUDA call of a process for
    good, so a benchmark asks a child first and initialises CUDA in its
    own process only once the child has answered. The child imports
    torch, runs one op on ``cuda:0`` and waits for it. Returns
    ``{"platform": "gpu", "device_kind": <torch's device name>, "n":
    <device count>, "card": <nvidia-smi's "name, power limit" line or
    None>}``, or None on a timeout or any failure. Counterpart of the JAX
    package's ``cli/common.py::bounded_device_probe``."""
    try:
        proc = subprocess.run([sys.executable, "-c", _PROBE], capture_output=True, text=True, timeout=timeout)
    except subprocess.TimeoutExpired:
        return None
    if proc.returncode != 0 or not proc.stdout.strip():
        return None
    try:
        return json.loads(proc.stdout.strip().splitlines()[-1])
    except ValueError:
        return None


def maybe_init_distributed(device="cuda"):
    """Join the process group of a ``torchrun`` launch (its ``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and ``MASTER_PORT``):
    ``nccl`` on the CUDA device ``LOCAL_RANK``, ``gloo`` with ``--device
    cpu``. -> ``parallel.DataParallel``, or None for a run of one process
    (no ``RANK`` set). Replaces torch.distributed.init_process_group in
    the reference (run/train.py:374-381); the JAX package reads its own
    coordinator variables instead."""
    from ..parallel import init_from_env

    return init_from_env(device)


def print_env(device: str, dp=None):
    """One line: torch, its CUDA, the device the CLI runs on, and the rank
    and world size (``dp``, a ``parallel.DataParallel``, or None)."""
    dev = torch.device(device)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    rank, world = (dp.rank, dp.world) if dp is not None else (0, 1)
    print(f"torch {torch.__version__} | cuda {torch.version.cuda} | device={device} ({name}) | "
          f"rank {rank} of {world}", flush=True)


def build_eval_model(args):
    """Construct (EvalModel, lavila_cfg, dec_cfg) from eval-CLI args: the
    checkpoints converted, both temporal embeddings (the backbone's and
    the decoder's) inflated to ``--num_frames`` (run/test_egtea.py:46-96,
    test_epic.py:128-132,168-173), the model on ``--device``."""
    from ..core.config import ExperimentConfig
    from ..data import ClipTokenizer
    from ..models.weights import inflate_temporal_embed
    from ..train.evaluate import EvalModel
    from ..train.pretrain import build_models

    cfg = ExperimentConfig()
    cfg.data.num_frames = args.num_frames
    cfg.model.backbone = args.backbone
    cfg.model.backbone_ckpt = args.backbone_ckpt
    cfg.model.decoder_ckpt = args.decoder_ckpt
    cfg.model.num_queries = args.num_queries
    cfg.model.pred_traj = getattr(args, "pred_traj", False)
    lavila_cfg, backbone, dec_cfg, decoder = build_models(cfg)

    with torch.no_grad():
        for owner in (backbone.visual, decoder):
            owner.temporal_embed = torch.nn.Parameter(
                inflate_temporal_embed(owner.temporal_embed.detach(), args.num_frames)
            )

    model = EvalModel(
        backbone,
        lavila_cfg,
        decoder,
        dec_cfg,
        ClipTokenizer(),
        preprocess=getattr(args, "preprocess", "resize"),
        device=args.device,
        int8=getattr(args, "int8", False),
        int8_fallback=getattr(args, "int8_fallback", None),
    )
    return model, lavila_cfg, dec_cfg


def add_eval_args(p):
    """The data, model and results options of the eval CLIs, and the
    device they run on."""
    p.add_argument("--meta_dir", required=False, default="data")
    p.add_argument("--data_dir", required=False, default="./")
    p.add_argument("--backbone", default="timesformer_large")
    p.add_argument("--backbone_ckpt", default="")
    p.add_argument("--decoder_ckpt", default="")
    p.add_argument("--num_frames", type=int, default=16)
    p.add_argument("--num_queries", type=int, default=12)
    p.add_argument("--out", default="", help="optional path to dump results json")
    p.add_argument("--device", default="cuda",
                   help="torch device of the model (default: the CUDA device; 'cpu' runs the "
                   "kernels' plain versions)")
    p.add_argument(
        "--int8",
        action="store_true",
        help="int8-quantize the frozen visual tower (models/quant.py); compare its embeddings "
        "against a float run before trusting new weights",
    )
    p.add_argument(
        "--int8_fallback",
        type=float,
        default=None,
        metavar="THRESHOLD",
        help="with --int8: per-block float fallback for blocks whose LayerNorm-gamma spread "
        "exceeds the threshold (models/quant.py)",
    )
    return p


def progress(i: int, n: int):
    print(f"  {i}/{n}", flush=True)


def dump(results: dict, out: str):
    print(json.dumps(results, indent=2))
    if out:
        with open(out, "w") as f:
            json.dump(results, f, indent=2)
