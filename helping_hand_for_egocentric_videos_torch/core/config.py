"""Experiment configuration, the part the eval and serving path reads.

Counterpart of ``helping_hand_for_egocentric_videos_tpu/core/config.py``
(the port imports nothing of the JAX package): the fields of its
``ExperimentConfig`` that ``train.pretrain.build_models`` reads, with the
same names and defaults. The optimizer, parallelism, augmentation and
override helpers come with the train slice.
"""

from __future__ import annotations

from dataclasses import dataclass, field

__all__ = ["ExperimentConfig"]


@dataclass
class DataCfg:
    num_frames: int = 4


@dataclass
class ModelCfg:
    backbone: str = "timesformer_large"  # | timesformer_base | timesformer_tiny
    project_embed_dim: int = 256
    num_queries: int = 12  # object/hand queries; +1 summary appended
    pred_traj: bool = True
    backbone_ckpt: str = ""
    decoder_ckpt: str = ""


@dataclass
class ExperimentConfig:
    data: DataCfg = field(default_factory=DataCfg)
    model: ModelCfg = field(default_factory=ModelCfg)
