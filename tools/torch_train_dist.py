"""Data parallel over the cards of one host: the pretraining step and loop
under ``torchrun``.

    python3 tools/torch_train_dist.py --nproc 4 [--model_parallel 2]

On a machine with ``--nproc`` CUDA cards (``--device cpu`` rehearses it
with ``gloo`` processes and ``--backbone timesformer_tiny``). With
``--model_parallel M`` the ranks form nproc / M data groups of M ranks
that split the frozen backbone (``parallel/tensor.py``); a data group's
share of the batch is what a rank's is without it:

1. "dist-step": ``--nproc`` ranks build ``chip_smoke.py``'s train inputs
   (the full-width TimeSformer-L at 4 frames and the 13-query decoder from
   one seed, a seeded batch of 8 clips a data group) and take one step of
   ``train.make_train_step(dist=..., mp=...)`` on their data group's rows
   of the global batch and their shard of the backbone, in f32 (TF32 off).
   Rank 0 first takes the one-process step on the whole global batch. The
   check, set before the first run: each loss term and metric within rtol
   1e-4 of the one-process step's, every decoder gradient within 1e-4 x
   max(1, grad_norm), and the parameters after the update identical on
   every rank.
2. "dist-loop": ``python -m torch.distributed.run -m
   helping_hand_for_egocentric_videos_torch.cli.train`` on
   ``chip_smoke.py``'s synthetic EgoClip layout with 16 items (32 clips) a
   data group a step, once on one rank, once on ``--nproc`` ranks of data
   parallel and, with ``--model_parallel M``, once on ``--nproc`` ranks
   as nproc / M x M: 12 steps with eval and checkpoints at 6 and 12. It
   reads rank 0's steady window (steps 7-12): steps/s, clips/s over all
   ranks, the data share; the checks are finite losses and a checkpoint at
   step 12.

One JSON line a phase; any failed check exits non-zero. Written under
``build/torch_train_dist/``.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402

OUT = ROOT / "build" / "torch_train_dist"
CLIPS_A_RANK, ITEMS_A_RANK, STEPS = 8, 16, 12


def _step_worker(args):
    """One rank of "dist-step"; rank 0 writes the comparison to ``OUT``."""
    import copy

    import torch
    import torch.distributed as dist

    from helping_hand_for_egocentric_videos_torch.parallel import init_from_env, make_groups, shard_lavila
    from helping_hand_for_egocentric_videos_torch.train import TrainConfig, TrainState, make_train_step

    dp = init_from_env(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    device, rank, world = dp.device, dp.rank, dp.world
    mp = None
    if args.model_parallel > 1:  # dp becomes this rank's data group
        dp, mp = make_groups(world, args.model_parallel, device)
    b = CLIPS_A_RANK * dp.world
    lcfg, backbone, dcfg, decoder, batch, noun_dict = chip_smoke.build_train_inputs(
        device, args.backbone, b=b)
    shard = backbone if mp is None else shard_lavila(backbone, lcfg, mp)
    tcfg = TrainConfig(lr=chip_smoke.TRAIN_LR, backbone_dtype=torch.float32)

    def one(d, m=None):
        """The step of one process (``d`` None) or of this rank, whose rows
        of each tensor (clips, or their captions) ``d.rows`` gives, on its
        shard of the backbone (``m``)."""
        state = TrainState.create(copy.deepcopy(decoder), tcfg, device=device)
        part = batch if d is None else {k: v[d.rows(v.shape[0])] for k, v in batch.items()}
        state, met = make_train_step(dcfg, lcfg, tcfg, dist=d, mp=m)(state, shard if m else backbone, part,
                                                                      noun_dict)
        grads = {n: p.grad.clone() for n, p in state.decoder.named_parameters() if p.grad is not None}
        return state, {k: float(v) for k, v in met.items()}, grads

    want = one(None) if rank == 0 else None
    if device.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, got, grads = one(dp, mp)
    if device.type == "cuda":
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    # the updated parameters must be the same on every rank
    flat = torch.cat([p.detach().reshape(-1) for p in state.decoder.parameters()])
    copies = [torch.empty_like(flat) for _ in range(world)]
    dist.all_gather(copies, flat)
    same = all(torch.equal(c, copies[0]) for c in copies)
    if rank == 0:
        _, wm, wg = want
        rel = {k: abs(got[k] - wm[k]) / max(abs(wm[k]), 1e-12) for k in wm}
        tol = 1e-4 * max(1.0, wm["grad_norm"])
        grad_err = max(float((grads[n] - g).abs().max()) for n, g in wg.items())
        res = {"world": world, "model_parallel": args.model_parallel, "data_groups": dp.world, "global_clips": b,
               "clips_a_data_group": CLIPS_A_RANK, "metrics": got,
               "one_process_metrics": wm, "rel_err": rel, "rtol": 1e-4, "grad_max_abs_err": grad_err,
               "grad_tol": tol, "same_grad_names": set(grads) == set(wg), "params_equal_on_every_rank": same,
               "dist_step_seconds_with_first_calls": seconds}
        res["ok"] = (max(rel.values()) <= 1e-4 and grad_err <= tol and res["same_grad_names"] and same)
        (OUT / "step.json").write_text(json.dumps(res, default=list))
    dist.destroy_process_group()


def _torchrun(nproc: int, *argv) -> None:
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", f"--nproc_per_node={nproc}", *argv]
    subprocess.run(cmd, cwd=ROOT, check=True, timeout=1800)


def phase_step(args, card) -> dict:
    _torchrun(args.nproc, str(Path(__file__).resolve()), "--worker", "step", "--device", args.device,
              "--backbone", args.backbone, "--model_parallel", str(args.model_parallel))
    res = json.loads((OUT / "step.json").read_text())
    chip_smoke.say("dist-step", card=card, **res)
    if not res["ok"]:
        raise AssertionError("the multi-rank step disagrees with the one-process step (dist-step line)")
    return res


def phase_loop(args, card, nproc: int, model_parallel: int = 1) -> dict:
    from helping_hand_for_egocentric_videos_torch.models import lavila

    name = f"loop_{nproc}x{model_parallel}"
    groups = nproc // model_parallel  # data groups, each with its share of the batch
    # an epoch of STEPS steps at this many data groups
    width = getattr(lavila, f"{args.backbone}_config")().text.width
    meta, data = chip_smoke.write_egoclip_fixture(OUT / f"egoclip_{groups}", rows=ITEMS_A_RANK * groups * STEPS,
                                                  noun_width=width)
    _torchrun(nproc, "-m", "helping_hand_for_egocentric_videos_torch.cli.train", "--device", args.device,
              "--backbone", args.backbone, "--meta_dir", meta, "--data_dir", data, "--output_dir",
              str(OUT / "runs"), "--name", name, "--batch_size", str(ITEMS_A_RANK * groups), "--epochs", "1",
              "--eval_freq", "6", "--runtime_save_iter", "6", "--lr", str(chip_smoke.TRAIN_LR),
              "--model_parallel", str(model_parallel), "--set", "optim.log_flush_iter=6", "data.loading=strict")
    exp = OUT / "runs" / name
    rows = [json.loads(line) for line in open(exp / "train_metrics.jsonl")]
    windows = [r for r in rows if "loop/steps_per_s" in r]
    losses = [r["local/total_loss"] for r in rows if "local/total_loss" in r]
    steady = windows[-1]
    res = {"card": card, "ranks": nproc, "model_parallel": model_parallel, "data_groups": groups,
           "items_a_data_group": ITEMS_A_RANK, "clips_a_step": 2 * ITEMS_A_RANK * groups,
           "steps": STEPS, "steps_per_s": steady["loop/steps_per_s"],
           "clips_per_s": steady["loop/steps_per_s"] * 2 * ITEMS_A_RANK * groups,
           "step_ms": 1e3 / steady["loop/steps_per_s"], "data_share": steady["loop/data_share"],
           "windows": windows, "total_loss": losses,
           "checkpoints": sorted(os.listdir(exp / "checkpoints"))}
    chip_smoke.say("dist-loop", **res)
    if not (losses and all(map(lambda x: x == x and abs(x) < float("inf"), losses))
            and f"step_{STEPS:08d}" in res["checkpoints"]):
        raise AssertionError(f"the {nproc}-rank loop (model_parallel {model_parallel}) did not train or save "
                             "(dist-loop line)")
    return res


def main():
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--nproc", type=int, default=4)
    p.add_argument("--device", default="cuda", help="cuda (nccl, one card a rank) or cpu (gloo)")
    p.add_argument("--backbone", default="timesformer_large")
    p.add_argument("--model_parallel", type=int, default=1,
                   help="ranks a backbone is split over, in the step and in a third loop")
    p.add_argument("--worker", choices=("step",), default=None, help=argparse.SUPPRESS)
    args = p.parse_args()
    if args.worker == "step":
        return _step_worker(args)

    import torch

    if args.device == "cuda":
        name, card = chip_smoke.phase_device()
        if torch.cuda.device_count() < args.nproc:
            raise SystemExit(f"--nproc {args.nproc} needs as many cards; found {torch.cuda.device_count()}")
        from helping_hand_for_egocentric_videos_torch.ops import _build

        _build.build_all()  # once, before the ranks start
    else:
        name, card = "cpu", "cpu (rehearsal)"
    shutil.rmtree(OUT, ignore_errors=True)
    OUT.mkdir(parents=True)
    phase_step(args, card)
    loops = [phase_loop(args, card, n) for n in sorted({1, args.nproc})]
    if len(loops) == 2:
        one, many = loops
        chip_smoke.say("dist-scaling", card=card, ranks=many["ranks"],
                       clips_per_s=[one["clips_per_s"], many["clips_per_s"]],
                       speedup=many["clips_per_s"] / one["clips_per_s"],
                       step_ms=[one["step_ms"], many["step_ms"]])
    if args.model_parallel > 1:  # the same ranks as data x model against data parallel alone
        split = phase_loop(args, card, args.nproc, args.model_parallel)
        chip_smoke.say("dist-model-parallel", card=card, ranks=args.nproc, model_parallel=args.model_parallel,
                       clips_per_s={"data_parallel": loops[-1]["clips_per_s"], "split": split["clips_per_s"]},
                       ratio=split["clips_per_s"] / loops[-1]["clips_per_s"],
                       step_ms={"data_parallel": loops[-1]["step_ms"], "split": split["step_ms"]})
    print(json.dumps({"ok": True, "device": {"kind": name, "ranks": args.nproc}}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
