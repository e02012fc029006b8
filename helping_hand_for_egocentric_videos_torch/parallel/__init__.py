from .dist import DataParallel, init_from_env

__all__ = ["DataParallel", "init_from_env"]
