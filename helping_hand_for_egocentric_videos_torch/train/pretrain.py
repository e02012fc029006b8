"""EgoClip pretraining: the train-and-eval loop.

Counterpart of ``helping_hand_for_egocentric_videos_tpu/train/pretrain.py``
(the reference's run/train.py:79-270,421-575): build the backbone and the
decoder, stream EgoClip batches, run the train step, evaluate EgoMCQ
every ``eval_freq`` steps, keep runtime checkpoints (the last k) and the
best model by EgoMCQ Inter-video accuracy.

One process runs on one device. Under ``torchrun`` each data group's
rank runs this loop on its share of the global batch
(``data.batch_size // data_world`` items, its own dataset seed
``optim.seed + data_rank``), and the step averages over the data group
(``parallel/dist.py``). With ``parallel.model_parallel`` = M > 1 the ranks
form (world / M) data groups x M model ranks, in the JAX mesh's order
(``parallel/tensor.py``): the M ranks of a model group hold one frozen
backbone split between them (its heads and hidden units), feed it the
same rows and draw the same dropout, so their replicated decoders stay
one. (JAX's loop puts the backbone replicated whatever the mesh; the port
splits it, since M replicas would repeat the same work M times. Both
compute the same function.) Rank 0 writes the logs and the checkpoints;
the online eval runs on every rank of data group 0's model group (its
forwards need all the backbone's shards) and rank 0 logs it; every rank
reads a checkpoint to resume.

Metric scalars stay device tensors between flushes (``log_flush_iter``):
nothing in the steps between two flushes waits for the device. At a
flush the loop waits for the device once, converts the sampled metrics,
and logs the window since the last flush (``loop/`` in
``train_metrics.jsonl``): its steps, its training seconds (wall time less
the online eval and the checkpoint snapshots), steps/s over them, and
the share of them spent waiting for data.

Everything on the device lives in train/step.py; this module is host glue.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time

import numpy as np
import torch

from ..core.checkpoint import latest_step, restore_checkpoint, save_checkpoint
from ..core.config import ExperimentConfig
from ..data import ClipTokenizer, PrefetchLoader, ShardedSampler, prepare_train_batch
from ..data.egoclip import EgoClipConfig, EgoClipDataset, load_noun_dict
from ..data.loader import device_prefetch, pinned_put
from ..device import resolve_device
from ..models import (
    DecoderConfig,
    Lavila,
    ObjDecoder,
    timesformer_base_config,
    timesformer_large_config,
    timesformer_tiny_config,
)
from ..models.weights import (
    convert_decoder_checkpoint,
    convert_lavila_checkpoint,
    convert_openai_clip_checkpoint,
    load_torch_state_dict,
)
from ..parallel import init_from_env, make_groups, shard_lavila
from ..utils.logging import AverageMeter, MetricLogger, ProgressMeter
from .evaluate import EvalModel, run_egomcq
from .step import TrainConfig, TrainState, make_train_step

__all__ = ["build_models", "build_train_config", "pretrain"]


def build_models(cfg: ExperimentConfig, rng_seed: int = 0):
    """-> (lavila_cfg, backbone ``Lavila``, dec_cfg, decoder ``ObjDecoder``),
    on the CPU. A checkpoint keeps its own temporal-embedding length. A
    stock OpenAI CLIP ``backbone_ckpt`` (``visual.class_embedding`` among
    its keys) bootstraps the TimeSformer (``convert_openai_clip_checkpoint``:
    zero time attention, a zero temporal embedding of ``data.num_frames``);
    its towers must have ``model.backbone``'s shapes. With
    ``model.int8_backbone`` the backbone's visual block matmuls are
    quantized (``models/quant.py``): its training forward then takes the
    int8 route (K3, K4, K5 and ``torch._int_mm`` on the card)."""
    factory = {
        "timesformer_large": timesformer_large_config,
        "timesformer_base": timesformer_base_config,
        "timesformer_tiny": timesformer_tiny_config,
    }[cfg.model.backbone]
    lavila_cfg = factory(num_frames=cfg.data.num_frames, project_embed_dim=cfg.model.project_embed_dim)
    dec_cfg = DecoderConfig(
        num_queries=cfg.model.num_queries + 1,
        feature_dim=lavila_cfg.visual.width,
        text_width=lavila_cfg.text.width,
        embed_dim=cfg.model.project_embed_dim,
        num_frames=cfg.data.num_frames,
        patches_per_frame=lavila_cfg.visual.patches_per_frame,
        pred_traj=cfg.model.pred_traj,
    )
    if cfg.model.backbone_ckpt:
        sd = load_torch_state_dict(cfg.model.backbone_ckpt)
        if "visual.class_embedding" in sd:
            # stock OpenAI CLIP weights -> the TimeSformer bootstrap, as the
            # reference's factory does on from-scratch runs (run/train.py:425-431)
            backbone = convert_openai_clip_checkpoint(sd, num_frames=cfg.data.num_frames,
                                                      project_embed_dim=cfg.model.project_embed_dim, cfg=lavila_cfg)
        else:
            backbone = convert_lavila_checkpoint(sd, lavila_cfg)
    else:
        backbone = Lavila(lavila_cfg, generator=torch.Generator().manual_seed(rng_seed))
    if cfg.model.decoder_ckpt:
        decoder = convert_decoder_checkpoint(load_torch_state_dict(cfg.model.decoder_ckpt), dec_cfg)
    else:
        decoder = ObjDecoder(dec_cfg, generator=torch.Generator().manual_seed(rng_seed + 1))
    if cfg.model.int8_backbone:
        from ..models.quant import quantize_lavila_params

        backbone = quantize_lavila_params(backbone)
    return lavila_cfg, backbone, dec_cfg, decoder


def build_train_config(cfg: ExperimentConfig) -> TrainConfig:
    """ExperimentConfig -> the train step's TrainConfig. ``resize`` (the
    box targets' pixel normaliser) tracks ``data.input_res``: the dataset
    scales box targets to input_res coordinates."""
    return TrainConfig(
        lr=cfg.optim.lr,
        wd=cfg.optim.wd,
        num_queries=cfg.model.num_queries,
        input_res=cfg.data.input_res,
        resize=float(cfg.data.input_res),
        backbone_dtype=torch.bfloat16 if cfg.parallel.backbone_dtype == "bfloat16" else torch.float32,
        augment=cfg.data.augment,
        randcrop_scale=tuple(cfg.data.randcrop_scale),
        color_jitter=tuple(cfg.data.color_jitter),
    )


def _seed(*parts: int) -> int:
    """A 63-bit generator seed from integers (run seed, step, rank)."""
    return int(np.random.SeedSequence(list(parts)).generate_state(2, np.uint64)[0] >> np.uint64(1))


@contextlib.contextmanager
def _sync_mode(mode):
    """``torch.cuda.set_sync_debug_mode(mode)`` for the body (None: as is)."""
    if mode is None:
        yield
        return
    torch.cuda.set_sync_debug_mode(mode)
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode("default")


def _tree(state: TrainState, best_acc: float) -> dict:
    return {"decoder": state.decoder.state_dict(), "optimizer": state.optimizer.state_dict(), "step": state.step,
            "best_acc": float(best_acc)}


def pretrain(cfg: ExperimentConfig, *, max_steps: int | None = None, eval_limit: int | None = None, models=None,
             device=None, sync_debug: str | None = None):
    """Run pretraining. Returns (final TrainState, best Inter-video acc);
    under ``torchrun`` every rank returns rank 0's best, as every JAX
    process returns its own run's.

    ``models``: optional prebuilt (lavila_cfg, backbone, dec_cfg, decoder)
    on the CPU, as ``build_models`` returns them (tests run the loop on
    tiny ones). ``device``: None is the CUDA device (raising without one;
    a ``torchrun`` rank takes ``cuda:LOCAL_RANK``), ``"cpu"`` runs on the
    CPU. ``sync_debug`` ("warn" or "error", CUDA only): the host-sync
    check of ``torch.cuda.set_sync_debug_mode`` over every step that
    neither flushes, evaluates, saves nor traces (and is not the
    process's first): those steps must not wait for the device.
    """
    dp = init_from_env(torch.device("cuda" if device is None else device).type)
    device = dp.device if dp is not None else resolve_device(device)
    rank, world = (dp.rank, dp.world) if dp is not None else (0, 1)
    if cfg.parallel.num_devices and cfg.parallel.num_devices != world:
        raise ValueError(f"parallel.num_devices={cfg.parallel.num_devices}, but the run has {world} ranks "
                         "(torchrun --nproc_per_node sets them; 0 takes the run's)")
    model_parallel, mp = cfg.parallel.model_parallel, None
    if dp is None and model_parallel != 1:
        raise ValueError(f"parallel.model_parallel={model_parallel} does not divide the run's {world} ranks")
    if model_parallel != 1:  # the data group and the model group of this rank
        dp, mp = make_groups(world, model_parallel, device)
    data_rank, data_world = (dp.rank, dp.world) if dp is not None else (0, 1)
    if cfg.data.batch_size % data_world:
        raise ValueError(f"data.batch_size={cfg.data.batch_size} (the global batch) does not split over "
                         f"{data_world} data groups")
    if sync_debug is not None and device.type != "cuda":
        raise ValueError("sync_debug checks CUDA host syncs; it needs a CUDA device")
    lead = rank == 0
    evaluates = data_rank == 0  # data group 0's model group: every shard of one backbone
    exp_dir = os.path.join(cfg.output_dir, cfg.name)
    os.makedirs(exp_dir, exist_ok=True)
    logger = val_logger = None
    if lead:
        with open(os.path.join(exp_dir, "running_config.json"), "w") as f:
            f.write(cfg.to_json())
        logger = MetricLogger(exp_dir, "train")
        val_logger = MetricLogger(exp_dir, "val")

    if models is None:
        models = build_models(cfg, cfg.optim.seed)
    lavila_cfg, backbone, dec_cfg, decoder = models
    if mp is not None:  # this rank's shard of the frozen backbone
        backbone = shard_lavila(backbone, lavila_cfg, mp)
    backbone = backbone.to(device).requires_grad_(False)
    tcfg = build_train_config(cfg)

    tokenizer = ClipTokenizer()
    train_ds = EgoClipDataset(EgoClipConfig(
        meta_dir=cfg.data.meta_dir, data_dir=cfg.data.data_dir, split="train", num_frames=cfg.data.num_frames,
        input_res=cfg.data.input_res, frame_sample=cfg.data.frame_sample, loading=cfg.data.loading,
        seed=cfg.optim.seed + data_rank,
    ))
    val_ds = EgoClipDataset(EgoClipConfig(
        meta_dir=cfg.data.meta_dir, data_dir=cfg.data.data_dir, split="val", num_frames=cfg.data.num_frames,
        input_res=cfg.data.input_res,
    ))
    _, noun_embeds_raw = load_noun_dict(cfg.data.meta_dir)
    noun_dict = torch.as_tensor(noun_embeds_raw, device=device)

    # the ranks of a model group read the same rows: the data rank picks them
    local_batch = cfg.data.batch_size // data_world
    sampler = ShardedSampler(len(train_ds), local_batch, shuffle=True, host_id=data_rank, num_hosts=data_world,
                             seed=cfg.optim.seed)
    # every rank takes as many steps an epoch as the rank with the fewest
    # batches (the last: its share of the permutation is the shortest)
    spe = len(ShardedSampler(len(train_ds), local_batch, host_id=data_world - 1, num_hosts=data_world))
    loader = PrefetchLoader(train_ds, sampler, num_threads=cfg.data.num_workers,
                            transform=lambda b: prepare_train_batch(b, tokenizer))

    if cfg.optim.schedule != "constant":
        # epoch-denominated schedule knobs -> steps, now that the steps of an
        # epoch are known
        warm = cfg.optim.warmup_epochs
        if warm <= 0:
            warm = cfg.optim.epochs / 20  # the reference's own formula
        tcfg = dataclasses.replace(tcfg, schedule=cfg.optim.schedule, warmup_steps=int(warm * max(spe, 1)),
                                   total_steps=max(cfg.optim.epochs * max(spe, 1), 1))

    state = TrainState.create(decoder, tcfg, device=device)
    best_acc = 0.0
    ckpt_dir = os.path.join(exp_dir, "checkpoints")
    if latest_step(ckpt_dir) is not None:
        tree, step0 = restore_checkpoint(ckpt_dir, map_location=device)
        state.decoder.load_state_dict(tree["decoder"])
        state.optimizer.load_state_dict(tree["optimizer"])
        state = state._replace(step=int(tree["step"]))
        best_acc = float(tree["best_acc"])
        print(f"resumed from step {step0} (best_acc={best_acc:.3f})", flush=True)

    step_fn = make_train_step(dec_cfg, lavila_cfg, tcfg, dist=dp, mp=mp)
    step = first = state.step
    batch_time = AverageMeter("Time", ":.2f")
    data_time = AverageMeter("Data", ":.2f")
    losses = AverageMeter("Loss", ":.4f")
    progress = ProgressMeter(spe, [batch_time, data_time, losses], prefix="Train")
    # dropout draws differ by data rank (a model group's ranks draw the
    # same); the augmentation draws for the global batch, the same on every
    # rank (train/step.py::augment_batch)
    drop_gen = torch.Generator(device=device)
    aug_gen = torch.Generator(device=device)

    def flush(window):
        if device.type == "cuda":
            torch.cuda.synchronize(device)  # the window's steps are done
        now = time.time()
        for s, dev_m, sps in pending_metrics:
            m = {k: float(v) for k, v in dev_m.items()}
            losses.update(m["total_loss"])
            if logger is not None:
                logger.log(s, m, prefix="local/")
                logger.log(s, {"sps": sps}, prefix="device/")
        pending_metrics.clear()
        train_s = now - window["t0"] - window["paused"]
        if logger is not None and window["steps"]:
            logger.log(step, {"steps_per_s": window["steps"] / train_s, "data_share": window["data"] / train_s,
                              "steps": window["steps"], "seconds": train_s}, prefix="loop/")
        window.update(t0=now, steps=0, data=0.0, paused=0.0)

    stop = False
    pending_save = None  # in-flight save-behind write (optim.async_save)
    pending_metrics = []  # sampled device scalars awaiting the flush cadence
    eval_model = None
    if evaluates:  # one EvalModel for the run; each eval swaps in the current decoder
        eval_model = EvalModel(backbone, lavila_cfg, state.decoder, dec_cfg, tokenizer,
                               input_res=cfg.data.input_res, device=device, mp=mp)
    # epoch-granular resume, like the reference's checkpoint['epoch']
    # (run/train.py:523-546): restart at the epoch of the restored step (a
    # partial epoch replays from its start; the step counter and the
    # save/eval cadence continue from the restored value)
    start_epoch = min(step // max(spe, 1), cfg.optim.epochs)
    window = {"t0": time.time(), "steps": 0, "data": 0.0, "paused": 0.0}
    for epoch in range(start_epoch, cfg.optim.epochs):
        sampler.set_epoch(epoch)
        # the next batches' host-to-device copies run under the current step
        batches = device_prefetch(
            loader, lambda b: pinned_put({k: v for k, v in b.items() if k != "text_str"}, device), depth=2)
        end = time.time()
        try:
            for _ in range(spe):
                s = step + 1
                flushes = bool(max_steps) or s % max(cfg.optim.log_flush_iter, 1) == 0
                quiet = not (s == first + 1 or flushes or s % cfg.optim.eval_freq == 0
                             or s % cfg.optim.runtime_save_iter == 0 or s == cfg.optim.profile_step)
                with _sync_mode(sync_debug if quiet else None):
                    batch = next(batches, None)
                    if batch is None:
                        break
                    waited = time.time() - end
                    data_time.update(waited)
                    window["data"] += waited
                    drop_gen.manual_seed(_seed(cfg.optim.seed, s, data_rank))
                    aug_gen.manual_seed(_seed(cfg.optim.seed, s))
                    if s == cfg.optim.profile_step:
                        # one-step device trace (utils/profiling.py)
                        from ..utils.profiling import trace

                        with trace(os.path.join(exp_dir, "profile"), device):
                            state, metrics = step_fn(state, backbone, batch, noun_dict, drop_gen,
                                                     aug_generator=aug_gen)
                    else:
                        state, metrics = step_fn(state, backbone, batch, noun_dict, drop_gen,
                                                 aug_generator=aug_gen)
                    del batch
                    step = state.step
                    window["steps"] += 1
                    if step % 5 == 0 or max_steps:
                        # keep the device scalars; they are read at the flush
                        pending_metrics.append((step, metrics, 1.0 / max(time.time() - end, 1e-6)))
                if pending_metrics and flushes:
                    flush(window)
                batch_time.update(time.time() - end)
                if step % 100 == 0:
                    progress.display(step % max(spe, 1))

                paused = time.time()
                if step % cfg.optim.runtime_save_iter == 0 and lead:
                    if pending_save is not None:
                        pending_save.result()  # writes go in order
                        pending_save = None
                    saved = save_checkpoint(ckpt_dir, step, _tree(state, best_acc), keep=cfg.optim.keep_checkpoints,
                                            block=not cfg.optim.async_save)
                    if not isinstance(saved, str):
                        pending_save = saved

                if evaluates and (step % cfg.optim.eval_freq == 0 or (max_steps and step >= max_steps)):
                    eval_model.decoder = state.decoder
                    res = run_egomcq(eval_model, val_ds, limit=eval_limit or 1000)
                    inter = res.get("Inter-video", 0.0)
                    if inter > best_acc:
                        best_acc = inter
                        if lead:
                            save_checkpoint(os.path.join(exp_dir, "best"), step, _tree(state, best_acc), keep=1)
                    if lead:
                        val_logger.log(step, dict(res), prefix="egomcq/")
                end = time.time()
                window["paused"] += end - paused
                if max_steps and step >= max_steps:
                    stop = True
                    break
        finally:
            batches.close()
        if stop:
            break

    if pending_save is not None:
        pending_save.result()
    if pending_metrics:  # the tail
        flush(window)
    if logger is not None:
        logger.close()
        val_logger.close()
    if dp is not None:  # only data group 0 evaluates: every rank returns rank 0's best
        best = torch.tensor([best_acc], dtype=torch.float64, device=device)
        torch.distributed.broadcast(best, src=0)
        best_acc = best.item()
    return state, best_acc
