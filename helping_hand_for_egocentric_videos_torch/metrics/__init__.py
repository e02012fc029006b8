from .sim import compute_tv_accuracy, sim_matrix

__all__ = ["compute_tv_accuracy", "sim_matrix"]
