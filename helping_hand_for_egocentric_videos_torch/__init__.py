"""PyTorch and CUDA port of Helping Hands, for NVIDIA Hopper (H100).

A second package beside ``helping_hand_for_egocentric_videos_tpu`` (the
JAX reference). Module names mirror the reference so each counterpart is
easy to find. It covers the zero-shot serving path: uint8 clip ->
preprocess -> frozen TimeSformer-L tower (divided space-time attention in
hand-written CUDA kernels, ``csrc/``) -> object decoder -> embeddings,
served by ``serve.ServingEngine`` and ``cli.serve`` from the reference's
checkpoints (``models/weights.py``), in bf16 or int8, up to 128-frame
clips.

Entry points run on the CUDA device unless the caller passes
``device="cpu"``; the CUDA kernels are built with ``nvcc`` at first use
(``ops/_build.py``).
"""

from .device import resolve_device

__all__ = ["resolve_device"]
