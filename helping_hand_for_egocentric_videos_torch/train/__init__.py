from .evaluate import EvalModel, run_egomcq, run_egtea, run_epic_mir
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
    "run_egomcq",
    "run_egtea",
    "run_epic_mir",
]
