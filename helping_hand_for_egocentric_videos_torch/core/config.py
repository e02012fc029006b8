"""Experiment configuration, the part the model builder and the train
step read.

Counterpart of ``helping_hand_for_egocentric_videos_tpu/core/config.py``
(the port imports nothing of the JAX package): the fields of its
``ExperimentConfig`` that ``train.pretrain.build_models`` and
``build_train_config`` read, with the same names and defaults. The loop's
fields (data paths, checkpointing, logging) and the override helpers come
with the training loop.
"""

from __future__ import annotations

from dataclasses import dataclass, field

__all__ = ["ExperimentConfig"]


@dataclass
class DataCfg:
    num_frames: int = 4
    input_res: int = 224
    batch_size: int = 128  # the global batch, over every rank
    # train-time random augmentation; off in the reference's shipped
    # command (force_centercrop=True)
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


@dataclass
class OptimCfg:
    lr: float = 3e-5
    wd: float = 1e-5
    # "constant" (the reference's behaviour) or "warmup_cosine" (linear
    # warmup, then cosine decay to 0 over the whole run)
    schedule: str = "constant"
    warmup_epochs: float = 0.0


@dataclass
class ParallelCfg:
    backbone_dtype: str = "bfloat16"  # or "float32"


@dataclass
class ExperimentConfig:
    data: DataCfg = field(default_factory=DataCfg)
    model: ModelCfg = field(default_factory=ModelCfg)
    optim: OptimCfg = field(default_factory=OptimCfg)
    parallel: ParallelCfg = field(default_factory=ParallelCfg)
