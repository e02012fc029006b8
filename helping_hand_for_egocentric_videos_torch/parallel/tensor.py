"""Tensor parallelism of the frozen backbone: the mesh's ``model`` axis.

Counterpart of the ``model`` axis of
``helping_hand_for_egocentric_videos_tpu/parallel/mesh.py``:
``make_mesh(model_parallel=M)`` lays the devices out as a (n/M, M) grid
over ``('data', 'model')`` (device index = data index * M + model index),
and ``lavila_param_sharding`` / ``_spec_for_path`` split the backbone's
large block matrices over ``model``. JAX leaves the layout to GSPMD; here
each rank holds its shard of the weights (``shard_lavila``) and the
forward writes its collectives out, as Megatron's pair does: a
column-split matmul (this rank's output features, so its own heads or its
own hidden units), then a row-split matmul of those (this rank's input
features), whose partial products are summed over the model group by one
all-reduce. The function computed is the one-card forward's.

The backbone is frozen and its kernels have no backward, so the
collectives here are inference-only: they run outside autograd and raise
on an input that requires grad.

Each rank builds the whole module (from the seed or the checkpoint) and
slices its shard from it, so no weight converter changes.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import Any

import torch
import torch.distributed as dist
from torch import nn

from ..models.quant import QuantLinear
from .dist import DataParallel, average_grads

__all__ = ["ModelParallel", "make_groups", "spec_for_param", "shard_lavila"]

# the block matrices that split their output features (column) and their
# input features (row), by the name of the Linear in the block
_COLUMN = ("qkv", "mlp_fc1", "mlp_fc", "wq", "wk", "wv")
_ROW = ("proj", "mlp_fc2", "mlp_proj", "wo")


@dataclass(frozen=True)
class ModelParallel:
    """This process's place in its model group: ``rank`` of ``size``
    ranks that hold one backbone between them; ``group`` the process group
    (None: the default group)."""

    rank: int
    size: int
    group: Any = None

    def all_reduce(self, x):
        """Sum ``x`` over the model group, in place; returns ``x``. Outside
        autograd: ``x`` must not require grad."""
        if x.requires_grad and torch.is_grad_enabled():
            raise RuntimeError("the model group's all-reduce has no backward: run the backbone under no_grad")
        dist.all_reduce(x, group=self.group)
        return x

    def average_grads(self, params):
        """Average the ``.grad`` of ``params`` over the model group. Its
        ranks compute the same gradients of the replicated decoder; the
        average makes them the same bits where a kernel sums in another
        order on one rank (atomics)."""
        average_grads(params, self.size, self.group)


def make_groups(world: int, model_parallel: int, device) -> tuple[DataParallel, ModelParallel]:
    """The data group and the model group of this rank, in JAX's device
    order: model index = rank % M, data index = rank // M, so the ranks
    r // M = d form data index d's model group and the ranks r % M = m
    model index m's data group. Every rank of the default group must call
    it (``dist.new_group`` is collective). -> (DataParallel over the data
    group, ModelParallel over the model group)."""
    m = model_parallel
    if m < 1 or world % m:
        raise ValueError(f"parallel.model_parallel={m} does not divide the run's {world} ranks")
    rank = dist.get_rank()
    data_group = model_group = None
    for i in range(m):  # every rank creates every group, in the same order
        g = dist.new_group(list(range(i, world, m)))
        if rank % m == i:
            data_group = g
    for d in range(world // m):
        g = dist.new_group(list(range(d * m, (d + 1) * m)))
        if rank // m == d:
            model_group = g
    return (DataParallel(rank=rank // m, world=world // m, device=torch.device(device), group=data_group),
            ModelParallel(rank=rank % m, size=m, group=model_group))


def spec_for_param(name: str):
    """The dim of a ``Lavila`` parameter (torch's (out, in) layout) that the
    model axis splits: 0, 1, or None (replicated). A copy of JAX's
    ``_spec_for_path`` (mesh.py:85-101) on the port's names, with three
    deliberate departures:

    1. ``mlp_fc2`` splits its input (1), as the row half of the MLP pair.
       JAX's rule gives it the column split: ``"mlp_fc"`` is a substring of
       ``"mlp_fc2"`` and that test (mesh.py:97) comes before the row rule.
    2. ``qkv`` splits its output by heads (``shard_lavila``): rank r holds
       its heads of q, k and v, not JAX's r-th contiguous slice of the
       packed [q | k | v] columns.
    3. The bias of a column-split weight splits with it (0); JAX replicates
       it and XLA slices it.

    ``token_embedding`` splits its vocabulary (0); biases of row-split
    weights, LayerNorms, ``patch_embed``, the positional embeddings and the
    projections stay whole."""
    parts = name.split(".")
    if parts[-1] == "token_embedding":
        return 0
    if "blocks" not in parts:
        return None
    layer, param = parts[-2], parts[-1]
    if layer in _COLUMN and param in ("weight", "bias"):
        return 0
    if layer in _ROW and param == "weight":
        return 1
    return None


def _span(n: int, rank: int, size: int) -> slice:
    """Rank ``rank``'s part of ``n`` rows cut in ``size`` (the first
    ``n % size`` parts one longer, as ``torch.tensor_split``)."""
    base, extra = divmod(n, size)
    lo = rank * base + min(rank, extra)
    return slice(lo, lo + base + (rank < extra))


def _shard(name: str, t: torch.Tensor, dim, mp: ModelParallel) -> torch.Tensor:
    if dim is None:
        return t
    n = t.shape[dim]
    if name.endswith((".qkv.weight", ".qkv.bias")):  # departure 2: this rank's heads of each of q, k and v
        d = n // 3
        if d % mp.size:
            raise ValueError(f"{name}: width {d} does not split over {mp.size} ranks")
        return torch.cat([t.narrow(0, i * d + mp.rank * (d // mp.size), d // mp.size) for i in range(3)])
    if name.split(".")[-1] != "token_embedding" and n % mp.size:
        raise ValueError(f"{name}: {n} features do not split over {mp.size} ranks")
    s = _span(n, mp.rank, mp.size)
    return t.narrow(dim, s.start, s.stop - s.start)


def shard_lavila(lavila: nn.Module, lavila_cfg, mp: ModelParallel) -> nn.Module:
    """This rank's shard of a ``Lavila`` built from ``lavila_cfg``: a copy
    whose split parameters (``spec_for_param``) hold this rank's slice;
    ``lavila`` is unchanged. Raises where a tower's heads do not split over
    the ``mp.size`` ranks (each rank runs whole heads, and the weights do
    not say how many heads they hold), and for an int8 visual tower
    (``QuantLinear`` blocks): K3 and K5 scale each row over all D (or 4D)
    features, so on a rank's columns the scale would need a max over the
    model group first, a change to their row pass rather than a slice of
    it."""
    for tower, heads in (("visual", lavila_cfg.visual.heads), ("text", lavila_cfg.text.heads)):
        if heads % mp.size:
            raise ValueError(f"model_parallel={mp.size}: the {tower} tower's {heads} heads do not split over "
                             f"{mp.size} ranks")
    if any(isinstance(m, QuantLinear) for m in lavila.modules()):
        raise ValueError(
            f"model_parallel={mp.size} with an int8 backbone: K3 and K5 quantize each row with one scale "
            "over all of its features, which a rank's columns cannot give without a max over the model group; "
            "the int8 backbone runs with model_parallel=1"
        )
    # a deep copy whose split parameters are the slices: no second full
    # copy of the split weights is made
    memo = {}
    for name, p in lavila.named_parameters():
        dim = spec_for_param(name)
        if dim is not None:
            memo[id(p)] = nn.Parameter(_shard(name, p.detach(), dim, mp).clone(), requires_grad=p.requires_grad)
    return copy.deepcopy(lavila, memo)
