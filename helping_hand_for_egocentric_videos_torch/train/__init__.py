from .evaluate import EvalModel

__all__ = ["EvalModel"]
