"""A narrator's decode steps over one batch shape's cache, replayed as CUDA
graphs: the one ``Decoder`` both language models' narrators use
(``models/narrator.py``: ``gpt2.decode_step``, ``kimi_lm.decode_step``).

A decoder holds one batch shape's cache. Its first batch runs every step
eagerly (the warm-up: cuBLAS's plans and the kernels' first launches);
``Decoder.capture`` then records each position's step into its own CUDA
graph over the same cache, and every later batch replays them, one launch
a step in place of about a thousand (a step's shapes never change: ``pos``
is the graph's). The recording is skipped while a torch profiler runs;
the replays are not. A graph replays the same kernels on the same inputs,
so the same logits.
"""

from __future__ import annotations

import torch

from ..utils.profiling import active

__all__ = ["Decoder", "storage"]


def storage(module) -> tuple:
    """The data pointers of ``module``'s parameters: a graph recorded over
    them is valid while they are the same."""
    return tuple(t.data_ptr() for t in module.parameters())


class Decoder:
    """The decode steps of batches of one ``shape`` over one ``cache``:
    ``step(ids, pos)`` runs ``step_fn(ids, pos) -> (rows, vocab) f32
    logits`` eagerly, or replays position ``pos``'s graph once ``capture``
    has recorded them; the logits a replay returns live in the decoder's
    own buffer, overwritten by the next step. ``launches``, where given, is
    a running count of some kernel's launches: ``kernel_calls[pos]`` keeps
    how many position ``pos``'s graph holds."""

    def __init__(self, lm, cache, step_fn, *, shape: tuple, rows: int, vocab: int, device, launches=None):
        self.lm, self.cache, self.step_fn, self.shape = lm, cache, step_fn, shape
        self.rows, self.vocab, self.device, self.launches = rows, vocab, torch.device(device), launches
        self.storage = storage(lm)
        self.graphs: list = []
        self.kernel_calls: list = []
        self._ids = self._logits = None

    def matches(self, lm, shape: tuple, device) -> bool:
        """Whether batches of ``shape`` on ``device`` can use this cache and
        its graphs: the same model, weights and shape."""
        device = torch.device(device)
        same_device = self.device.type == device.type and device.index in (None, self.device.index)
        return lm is self.lm and self.storage == storage(lm) and same_device and shape == self.shape

    def step(self, ids, pos: int):
        if pos < len(self.graphs):
            self._ids.copy_(ids)
            self.graphs[pos].replay()
            return self._logits
        return self.step_fn(ids, pos)

    def can_capture(self) -> bool:
        """Whether a batch that ran its steps eagerly should record them now:
        on a CUDA device, once, and not under a profiler."""
        return self.device.type == "cuda" and not self.graphs and not active()

    def capture(self, steps: int):
        """Record positions ``0 .. steps - 1`` on a side stream, one graph
        each, sharing one memory pool (they replay in the order recorded)."""
        self._ids = torch.zeros(self.rows, dtype=torch.long, device=self.device)
        self._logits = torch.empty(self.rows, self.vocab, dtype=torch.float32, device=self.device)
        pool = torch.cuda.graph_pool_handle()
        current = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(current)
        graphs, calls = [], []
        with torch.cuda.stream(side):
            for pos in range(steps):
                start = self.launches() if self.launches else 0
                g = torch.cuda.CUDAGraph()
                # thread_local: a loader's threads may allocate while this one records
                with torch.cuda.graph(g, pool=pool, stream=side, capture_error_mode="thread_local"):
                    self._logits.copy_(self.step_fn(self._ids, pos))
                graphs.append(g)
                calls.append(self.launches() - start if self.launches else 0)
        current.wait_stream(side)
        self.graphs, self.kernel_calls = graphs, calls
