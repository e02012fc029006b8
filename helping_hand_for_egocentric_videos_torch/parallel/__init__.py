from .dist import DataParallel, init_from_env
from .tensor import ModelParallel, make_groups, shard_lavila, spec_for_param

__all__ = ["DataParallel", "ModelParallel", "init_from_env", "make_groups", "shard_lavila", "spec_for_param"]
