"""The plain reference that decides ``correct``: plain PyTorch in float32
with TF32 off, written from the published descriptions of LaViLa's
TimeSformer-L (frozen-in-time divided space-time attention), OpenAI CLIP's
text tower and the Helping Hands object decoder and losses. It imports
neither JAX nor anything of the program: it reads the weights that the
benchmark made (``hhbench/weights.py``) by their checkpoint names, the
inputs the benchmark made, and the program's outputs only to judge them.
"""

import contextlib

import torch


@contextlib.contextmanager
def full_f32():
    """Matrix products in full float32: TF32 off for cuBLAS and cuDNN,
    restored afterwards."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32, torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old[0], old[1]
        torch.set_float32_matmul_precision(old[2])
