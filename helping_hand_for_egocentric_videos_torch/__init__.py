"""PyTorch and CUDA port of Helping Hands, for NVIDIA Hopper (H100).

A second package beside ``helping_hand_for_egocentric_videos_tpu`` (the
JAX reference). Module names mirror the reference so each counterpart is
easy to find. This slice covers the zero-shot serving path: uint8 clip ->
preprocess -> frozen TimeSformer-L tower (divided space-time attention in
a hand-written CUDA kernel, ``csrc/divided_attention.cu``) -> object
decoder -> embeddings, served by ``serve.ServingEngine``.

Entry points run on the CUDA device unless the caller passes
``device="cpu"``; the CUDA kernels are built with ``nvcc`` at first use
(``ops/_build.py``).
"""

from .device import resolve_device

__all__ = ["resolve_device"]
