"""Online serving of the dual encoder: power-of-two batch bucketing, a
cross-request micro-batcher (``ServingEngine``) and a zero-dependency HTTP
front end (``server.make_server``)."""

from .engine import ServeConfig, ServingEngine

__all__ = ["ServeConfig", "ServingEngine"]
