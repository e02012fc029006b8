from .evaluate import EvalModel
from .step import (
    TrainConfig,
    TrainState,
    backbone_features,
    make_optimizer,
    make_train_step,
    pretrain_loss_and_metrics,
)

__all__ = [
    "EvalModel",
    "TrainConfig",
    "TrainState",
    "backbone_features",
    "make_optimizer",
    "make_train_step",
    "pretrain_loss_and_metrics",
]
