"""The train step's frozen backbone, replayed from a CUDA graph.

The step's backbone forward runs under ``torch.no_grad`` on frozen
weights, with no dropout, at one shape step after step, and every kernel
it runs launches on the current stream: the bf16 GEMMs, the elementwise
passes and the hand-written K1/K2 (K3/K4/K5 and ``torch._int_mm`` on the
int8 route). Its ~3100 launches are recorded once into a CUDA graph, and
each later step copies its inputs into the graph's input buffers and
replays it with one ``cudaGraphLaunch``: the same kernels on the same
inputs, so the same bits.

``BackboneGraphs`` is one step function's cache of such graphs, by the
key of what a recording depends on: the backbone object and the storage
of its parameters and buffers, the video's and tokens' shapes, dtypes and
device, and the forward's configuration and working type. Weights
updated in place (``load_state_dict``) are read by the next replay;
weights replaced or moved (new storage) miss, and the stale graph is
dropped. The first call of a key runs the forward on a side stream (the
warm-up: kernel builds, cuBLAS's workspace for that stream) and returns
its outputs, then records the graph on that stream. At most
``MAX_GRAPHS`` keys are kept (an epoch's shorter last batch may take the
second); beyond that a new key runs eagerly, and so it does while a torch
profiler runs, whose trace should hold steps, not a one-time recording.
A replay returns copies of the graph's outputs, which the caller owns:
the next replay cannot overwrite them.

The kernels' launch counts (``ops/counts.py``) stay what the device runs:
the recording calls the wrappers without running their kernels, so its
counts are taken back, and each replay adds them.
"""

from __future__ import annotations

import itertools
import weakref

import torch
from torch.autograd import profiler as _autograd_profiler

from ..ops.counts import add_counts, read_counts
from ..utils.profiling import span

__all__ = ["BackboneGraphs", "MAX_GRAPHS"]

MAX_GRAPHS = 2


def _storage(module) -> tuple:
    return tuple(t.data_ptr() for t in itertools.chain(module.parameters(), module.buffers()))


def _spec(t) -> tuple:
    return tuple(t.shape), t.dtype, t.device


class _Graph:
    """One recorded forward: its static inputs and outputs, and the
    kernels' launch counts of one forward."""

    def __init__(self, owner, storage, graph, inputs, outputs, launches):
        self.owner = weakref.ref(owner)
        self.storage = storage
        self.graph, self.inputs, self.outputs, self.launches = graph, inputs, outputs, launches

    def replay(self, *inputs):
        for static, x in zip(self.inputs, inputs):
            static.copy_(x)
        self.graph.replay()
        add_counts(self.launches)
        return tuple(t.clone() for t in self.outputs)


def _capture(forward, owner, storage, video, tokens):
    """Warm up ``forward`` on a side stream, then record it there ->
    (the ``_Graph``, the warm-up's outputs for the caller)."""
    device = video.device
    current = torch.cuda.current_stream(device)
    inputs = (video.clone(), tokens.clone())
    side = torch.cuda.Stream(device)
    side.wait_stream(current)
    with torch.cuda.stream(side):
        first = forward(*inputs)
        counted = read_counts()
        graph = torch.cuda.CUDAGraph()
        # thread_local: the loader's threads may allocate while this one records
        graph.capture_begin(capture_error_mode="thread_local")
        try:
            outputs = forward(*inputs)
        finally:
            graph.capture_end()
    current.wait_stream(side)
    for t in first:
        t.record_stream(current)
    launches = {k: v - counted[k] for k, v in read_counts().items()}
    add_counts({k: -v for k, v in launches.items()})  # recorded, not run
    return _Graph(owner, storage, graph, inputs, outputs, launches), first


class BackboneGraphs:
    """A cache of recorded backbone forwards (module docstring). Call it
    as ``graphs(forward, backbone, video, tokens, *config)``, where
    ``forward(video, tokens)`` runs ``backbone`` and ``config`` is what
    else the forward depends on (hashable); the result is ``forward``'s.
    The caller decides that the forward may be recorded (a CUDA device,
    no collectives, no host sync)."""

    def __init__(self):
        self._graphs: dict = {}

    def __len__(self) -> int:
        return len(self._graphs)

    def __call__(self, forward, backbone, video, tokens, *config):
        storage = _storage(backbone)
        for k, g in list(self._graphs.items()):  # the dead backbones' graphs, and this one's stale ones
            owner = g.owner()
            if owner is None or (owner is backbone and g.storage != storage):
                del self._graphs[k]
        key = (id(backbone), storage, _spec(video), _spec(tokens), *config)
        g = self._graphs.get(key)
        if g is not None:
            with span("hh.step.backbone.replay"):
                return g.replay(video, tokens)
        if len(self._graphs) >= MAX_GRAPHS or _autograd_profiler._is_profiler_enabled:
            return forward(video, tokens)
        self._graphs[key], first = _capture(forward, backbone, storage, video, tokens)
        return first
