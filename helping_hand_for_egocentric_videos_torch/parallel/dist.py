"""Data parallelism over ``torch.distributed``, one rank a device.

Counterpart of ``helping_hand_for_egocentric_videos_tpu/parallel/mesh.py``,
the mesh's ``data`` axis. The JAX package runs one SPMD program over a
device mesh and lets XLA insert the collectives; here each rank runs the
step on its rows of the global batch and the collectives are explicit,
as in the reference (a differentiable all_gather of the contrastive
embeddings, run/train.py:31-47, and an all_reduce of ``num_boxes``,
model/box_utils.py:218-222), plus the gradient averaging that the
reference skips for its box and word losses (it has no DDP wrapper).

The contract is the JAX package's: a step of W ranks on a global batch
equals the one-process step on that batch (the JAX
``tests/test_sharding_equivalence.py``; ``train/step.py`` sets each
loss term's scale so that the averaged gradient is the one-process
gradient).

``init_from_env`` reads ``torchrun``'s variables (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``/``MASTER_PORT``) and
starts ``nccl`` on a CUDA device, ``gloo`` on the CPU. The mesh's
``model`` axis (tensor-parallel rules for the frozen backbone,
``lavila_param_sharding``) is not ported: ROADMAP.md queue A item 6.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import torch
import torch.distributed as dist

__all__ = ["DataParallel", "init_from_env"]


def init_from_env(device=None) -> "DataParallel | None":
    """Join the process group that ``torchrun``'s environment describes
    -> a ``DataParallel``, or None when no ``RANK`` is set (one process).

    ``device``: the run's device type; ``cuda`` (the default) binds the
    process to ``cuda:LOCAL_RANK`` and uses ``nccl``, ``cpu`` uses
    ``gloo``. A group already started is reused."""
    if "RANK" not in os.environ:
        return None
    kind = torch.device("cuda" if device is None else device).type
    rank, world = int(os.environ["RANK"]), int(os.environ.get("WORLD_SIZE", "1"))
    local = int(os.environ.get("LOCAL_RANK", "0"))
    if kind == "cuda":
        torch.cuda.set_device(local)
    if not dist.is_initialized():
        addr = os.environ.get("MASTER_ADDR", "127.0.0.1")
        port = os.environ.get("MASTER_PORT", "29500")
        kw = {"device_id": torch.device("cuda", local)} if kind == "cuda" else {}
        dist.init_process_group("nccl" if kind == "cuda" else "gloo", init_method=f"tcp://{addr}:{port}",
                                rank=rank, world_size=world, **kw)
    return DataParallel(rank=dist.get_rank(), world=dist.get_world_size(),
                        device=torch.device("cuda", local) if kind == "cuda" else torch.device("cpu"))


class _GatherRows(torch.autograd.Function):
    """All-gather along dim 0; the backward sums the incoming gradient over
    ranks and keeps this rank's rows (every rank's loss reads every row)."""

    @staticmethod
    def forward(ctx, x, rank: int, world: int):
        parts = [torch.empty_like(x) for _ in range(world)]
        dist.all_gather(parts, x.contiguous())
        ctx.rank, ctx.rows = rank, x.shape[0]
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad)
        return grad[ctx.rank * ctx.rows:(ctx.rank + 1) * ctx.rows], None, None


@dataclass(frozen=True)
class DataParallel:
    """This process's place in the default process group."""

    rank: int
    world: int
    device: torch.device

    def rows(self, n_global: int) -> slice:
        """This rank's rows of a global batch of ``n_global`` rows."""
        if n_global % self.world:
            raise ValueError(f"a global batch of {n_global} rows does not split over {self.world} ranks")
        n = n_global // self.world
        return slice(self.rank * n, (self.rank + 1) * n)

    def gather(self, x):
        """The global batch of a per-rank tensor, in rank order, with its
        gradient routed back to the rank that owns each row."""
        return _GatherRows.apply(x, self.rank, self.world)

    def gather_const(self, x):
        """The global batch of a per-rank tensor that needs no gradient."""
        parts = [torch.empty_like(x) for _ in range(self.world)]
        dist.all_gather(parts, x.contiguous())
        return torch.cat(parts)

    def sum(self, x):
        """The sum over ranks of a tensor, outside autograd."""
        x = x.detach().clone()
        dist.all_reduce(x)
        return x

    def average_grads(self, params):
        """Average the ``.grad`` of ``params`` over ranks in place, in one
        all_reduce of a flat buffer. Every rank must hold gradients for the
        same parameters."""
        grads = [p.grad for p in params if p.grad is not None]
        if not grads:
            return
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat)
        flat /= self.world
        offset = 0
        for g in grads:
            g.copy_(flat[offset:offset + g.numel()].view_as(g))
            offset += g.numel()
