from .retrieval import (
    cols2metrics,
    egomcq_accuracy_by_type,
    egomcq_accuracy_metrics,
    t2v_metrics,
    v2t_metrics,
)
from .sim import compute_tv_accuracy, sim_matrix

__all__ = [
    "cols2metrics",
    "compute_tv_accuracy",
    "egomcq_accuracy_by_type",
    "egomcq_accuracy_metrics",
    "sim_matrix",
    "t2v_metrics",
    "v2t_metrics",
]
