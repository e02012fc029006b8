from .ndcg import calculate_DCG, calculate_IDCG, calculate_k_counts, calculate_nDCG
from .map import calculate_mAP
from .retrieval import (
    cols2metrics,
    egomcq_accuracy_by_type,
    egomcq_accuracy_metrics,
    t2v_metrics,
    v2t_metrics,
)
from .sim import compute_tv_accuracy, sim_matrix
from .classification import confusion_matrix, mean_class_accuracy, topk_accuracy
from .charades import charades_map, multi_label_map, oscc_accuracy

__all__ = [
    "calculate_DCG",
    "calculate_IDCG",
    "calculate_k_counts",
    "calculate_nDCG",
    "calculate_mAP",
    "cols2metrics",
    "egomcq_accuracy_by_type",
    "egomcq_accuracy_metrics",
    "t2v_metrics",
    "v2t_metrics",
    "compute_tv_accuracy",
    "sim_matrix",
    "confusion_matrix",
    "mean_class_accuracy",
    "topk_accuracy",
    "charades_map",
    "multi_label_map",
    "oscc_accuracy",
]
