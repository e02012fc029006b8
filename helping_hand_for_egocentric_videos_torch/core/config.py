"""Unified experiment configuration.

Counterpart of ``helping_hand_for_egocentric_videos_tpu/core/config.py``
(the port imports nothing of the JAX package): the same dataclass tree,
names and defaults, with CLI overrides. ``apply_overrides`` takes
``section.field=value`` strings; ``to_json`` / ``from_json`` round-trip
the tree.

Two fields read differently on the torch backend: ``data.batch_size`` is
the global batch over every rank (a torch rank is one device, and each
samples ``batch_size // data_world``), and ``parallel.num_devices`` /
``model_parallel`` are the JAX mesh's knobs (the torch world is
``torchrun``'s; ``model_parallel`` = M splits it into world / M data
groups of M ranks that split one backbone, ``parallel/tensor.py``).
"""

from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import dataclass, field
from typing import Any

__all__ = ["ExperimentConfig", "apply_overrides"]


@dataclass
class DataCfg:
    meta_dir: str = "data/EgoClip"
    data_dir: str = "./"
    num_frames: int = 4
    input_res: int = 224
    batch_size: int = 128  # the global batch, over every rank
    num_workers: int = 8
    frame_sample: str = "uniform"
    loading: str = "lax"  # 'lax': black frames on a failed read; 'strict': raise
    # train-time random augmentation; off in the reference's shipped
    # command (force_centercrop=True, run/train.py:443)
    augment: bool = False
    randcrop_scale: tuple = (0.5, 1.0)
    color_jitter: tuple = (0.0, 0.0, 0.0)  # brightness, saturation, hue


@dataclass
class ModelCfg:
    backbone: str = "timesformer_large"  # | timesformer_base | timesformer_tiny
    project_embed_dim: int = 256
    num_queries: int = 12  # object/hand queries; +1 summary appended
    pred_traj: bool = True
    backbone_ckpt: str = ""
    decoder_ckpt: str = ""
    # int8-quantize the frozen backbone for the training forward (gradients
    # never reach it, so only the constant features shift)
    int8_backbone: bool = False


@dataclass
class OptimCfg:
    lr: float = 3e-5
    wd: float = 1e-5
    epochs: int = 10
    seed: int = 111
    eval_freq: int = 2500
    runtime_save_iter: int = 2500
    # "constant" (the reference's behaviour) or "warmup_cosine" (linear
    # warmup, then cosine decay to 0 over the whole run); warmup_epochs <= 0
    # uses the reference's own epochs / 20
    schedule: str = "constant"
    warmup_epochs: float = 0.0
    keep_checkpoints: int = 10
    # save-behind: the snapshot is taken on the loop's thread, the write
    # runs on a background thread
    async_save: bool = True
    # trace the device around this global step (utils/profiling.py); 0: off
    profile_step: int = 0
    # sampled metrics stay device tensors until this cadence (in steps)
    log_flush_iter: int = 50


@dataclass
class ParallelCfg:
    model_parallel: int = 1
    num_devices: int = 0  # the JAX mesh's device count; 0 = all
    backbone_dtype: str = "bfloat16"  # or "float32"


@dataclass
class ExperimentConfig:
    name: str = "helping_hands_tpu"
    output_dir: str = "runs"
    data: DataCfg = field(default_factory=DataCfg)
    model: ModelCfg = field(default_factory=ModelCfg)
    optim: OptimCfg = field(default_factory=OptimCfg)
    parallel: ParallelCfg = field(default_factory=ParallelCfg)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @classmethod
    def from_json(cls, path_or_str: str) -> "ExperimentConfig":
        """Load from a JSON file path or a JSON string."""
        if os.path.exists(path_or_str):
            with open(path_or_str) as f:
                d = json.load(f)
        else:
            d = json.loads(path_or_str)
        cfg = cls()
        for section, sub in d.items():
            if isinstance(sub, dict) and hasattr(cfg, section):
                obj = getattr(cfg, section)
                for k, v in sub.items():
                    if hasattr(obj, k):
                        setattr(obj, k, v)
            elif hasattr(cfg, section):
                setattr(cfg, section, sub)
        return cfg


def _coerce(val: str, current: Any):
    if isinstance(current, bool):
        return val.lower() in ("1", "true", "yes")
    if isinstance(current, int):
        return int(val)
    if isinstance(current, float):
        return float(val)
    if isinstance(current, (tuple, list)):  # e.g. data.randcrop_scale=0.4,1.0
        parts = [p for p in val.replace("(", "").replace(")", "").split(",") if p]
        elem = current[0] if len(current) else 0.0
        return type(current)(_coerce(p.strip(), elem) for p in parts)
    return val


def apply_overrides(cfg: ExperimentConfig, overrides: list[str]) -> ExperimentConfig:
    """Apply ['data.batch_size=64', 'optim.lr=1e-4', 'name=run1'] style
    overrides in place."""
    for ov in overrides:
        key, _, val = ov.partition("=")
        parts = key.strip().split(".")
        obj = cfg
        for p in parts[:-1]:
            obj = getattr(obj, p)
        cur = getattr(obj, parts[-1])
        setattr(obj, parts[-1], _coerce(val.strip(), cur))
    return cfg
