from .egonce import egonce_loss, egonce_multi_positive_loss
from .set_criterion import (
    MatchCosts,
    box_set_loss,
    compute_box_loss,
    prepare_targets,
)
from .word_contrastive import word_contrastive_loss

__all__ = [
    "egonce_loss",
    "egonce_multi_positive_loss",
    "MatchCosts",
    "box_set_loss",
    "compute_box_loss",
    "prepare_targets",
    "word_contrastive_loss",
]
