"""Host-side data loading: per-rank sharding + threaded prefetch + collate.

Counterpart of ``helping_hand_for_egocentric_videos_tpu/data/loader.py``:
``ShardedSampler``, ``collate``, ``PrefetchLoader``,
``prepare_train_batch`` and ``RoundRobinLoader`` are copies (numpy only,
so the same seed gives the same batches); ``device_prefetch`` moves
batches to a torch device. They replace the reference's torch DataLoader
/ DistributedSampler stack (base/base_data_loader.py:114-135,
data_loader/data_loader.py:132-168):

- ``ShardedSampler``: every consumer takes indices ``host_id::num_hosts``
  of a (optionally shuffled) permutation, DistributedSampler's
  partition. A torch rank is one device, so the training loop gives each
  rank its share of the global batch (``host_id`` = rank, ``num_hosts`` =
  world size).
- ``PrefetchLoader``: a thread pool decodes ahead of the step; decode is
  C/PIL-bound and releases the GIL. Depth-2 prefetch of collated batches
  overlaps host decode with device compute (the reference's
  num_workers=8 processes, run/train.py:614).
- ``prepare_train_batch``: the reference's ``prepare_data``
  (run/train.py:50-76): flattens the 5 rephrased texts, concatenates
  positive+negative streams, tokenizes, zeroes hand/person/background
  noun-tag dims, and emits fixed-shape numpy arrays.
- ``device_prefetch``: the next batches' host-to-device copies run
  under the current step (``pinned_put`` is the copy).
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterable

import numpy as np

from ..utils.profiling import span
from .egoclip import STOPWORD_NOUN_IDS

__all__ = [
    "ShardedSampler",
    "PrefetchLoader",
    "RoundRobinLoader",
    "collate",
    "prepare_train_batch",
    "device_prefetch",
    "pinned_put",
]


class ShardedSampler:
    def __init__(
        self,
        n: int,
        batch_size: int,
        *,
        shuffle: bool = True,
        host_id: int = 0,
        num_hosts: int = 1,
        drop_last: bool = True,
        seed: int = 0,
    ):
        self.n, self.batch_size = n, batch_size
        self.shuffle, self.seed = shuffle, seed
        self.host_id, self.num_hosts = host_id, num_hosts
        self.drop_last = drop_last
        self.epoch = 0

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def __iter__(self):
        idx = np.arange(self.n)
        if self.shuffle:
            idx = np.random.default_rng(self.seed + self.epoch).permutation(idx)
        local = idx[self.host_id :: self.num_hosts]
        nb = len(local) // self.batch_size
        for b in range(nb):
            yield local[b * self.batch_size : (b + 1) * self.batch_size]
        if not self.drop_last and len(local) % self.batch_size:
            yield local[nb * self.batch_size :]

    def __len__(self):
        local = (self.n - self.host_id + self.num_hosts - 1) // self.num_hosts
        if self.drop_last:
            return local // self.batch_size
        return (local + self.batch_size - 1) // self.batch_size


def collate(items: list[dict]) -> dict:
    """Stack numpy leaves; gather strings/lists (custom_collate semantics,
    EgoClip_EgoMCQ_dataset.py:352-369 minus its string-replication bug)."""
    out = {}
    for k in items[0]:
        v0 = items[0][k]
        if isinstance(v0, np.ndarray):
            out[k] = np.stack([it[k] for it in items])
        elif isinstance(v0, (int, np.integer)):
            out[k] = np.asarray([it[k] for it in items])
        else:
            out[k] = [it[k] for it in items]
    return out


class PrefetchLoader:
    """Iterates (dataset[i] for batches from sampler), decoding with a
    thread pool and prefetching ``depth`` collated batches."""

    def __init__(
        self,
        dataset,
        sampler: Iterable,
        *,
        num_threads: int = 4,
        depth: int = 2,
        transform: Callable[[dict], dict] | None = None,
    ):
        self.dataset = dataset
        self.sampler = sampler
        self.num_threads = max(1, num_threads)
        self.depth = depth
        self.transform = transform

    def __len__(self):
        return len(self.sampler)

    def __iter__(self):
        q: queue.Queue = queue.Queue(maxsize=self.depth)
        stop = object()
        cancelled = threading.Event()

        def _put(item) -> bool:
            # bounded put so an abandoned iterator (consumer raised /
            # stopped early) can't leave the producer blocked forever
            # holding `depth` collated batches
            while not cancelled.is_set():
                try:
                    q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        def produce():
            try:
                _produce_batches()
            except BaseException as e:  # surface worker errors to the consumer
                _put(e)
            finally:
                _put(stop)

        def _item(i):
            with span("hh.data.item"):
                return self.dataset[int(i)]

        def _produce_batches():
            from concurrent.futures import ThreadPoolExecutor

            if self.num_threads > 1:
                pool = ThreadPoolExecutor(max_workers=self.num_threads)
            else:
                pool = None
            try:
                for batch_idx in self.sampler:
                    if cancelled.is_set():
                        return
                    if pool is not None:
                        items = list(pool.map(_item, batch_idx))
                    else:
                        items = [_item(di) for di in batch_idx]
                    batch = collate(items)
                    if self.transform is not None:
                        batch = self.transform(batch)
                    if not _put(batch):
                        return
            finally:
                if pool is not None:
                    pool.shutdown(wait=False)

        producer = threading.Thread(target=produce, daemon=True)
        producer.start()
        try:
            while True:
                batch = q.get()
                if batch is stop:
                    break
                if isinstance(batch, BaseException):
                    raise batch
                yield batch
        finally:
            cancelled.set()


def prepare_train_batch(batch: dict, tokenizer, rephrase_factor: int = 5) -> dict:
    """Collated EgoClip train batch -> fixed-shape model inputs.

    Matches prepare_data (run/train.py:50-76): with negatives, streams are
    concatenated [positives; negatives]; texts are the flattened rephrased
    captions (R per video); noun-tag stopword dims are zeroed.
    Returns: video u8 (2B,T,H,W,C), tokens (2B*R,77) i32, noun_vec,
    verb_vec, boxes (2B,T,4,4), nouns (2B,M) i32, plus 'text_str'.
    """
    has_neg = "video_neg" in batch
    texts = [t for sub in batch["rephrased_text"] for t in sub]
    if has_neg:
        texts += [t for sub in batch["rephrased_text_neg"] for t in sub]
        video = np.concatenate([batch["video"], batch["video_neg"]], 0)
        noun_vec = np.concatenate([batch["noun_vec"], batch["noun_vec_neg"]], 0)
        verb_vec = np.concatenate([batch["verb_vec"], batch["verb_vec_neg"]], 0)
        boxes = np.concatenate([batch["boxes"], batch["boxes_neg"]], 0)
        nouns = np.concatenate([batch["nouns"], batch["nouns_neg"]], 0)
    else:
        video = batch["video"]
        noun_vec, verb_vec = batch["noun_vec"], batch["verb_vec"]
        boxes, nouns = batch["boxes"], batch["nouns"]

    noun_vec = noun_vec.copy()
    if noun_vec.shape[1] > max(STOPWORD_NOUN_IDS):
        noun_vec[:, list(STOPWORD_NOUN_IDS)] = 0

    return {
        "video": video,
        "tokens": tokenizer(texts).astype(np.int32),
        "noun_vec": noun_vec.astype(np.float32),
        "verb_vec": verb_vec.astype(np.float32),
        "boxes": boxes.astype(np.float32),
        "nouns": nouns.astype(np.int32),
        "text_str": texts,
    }


class RoundRobinLoader:
    """Alternate batches across several loaders (the reference's
    BaseMultiDataLoader / TextVideoMultiDataLoader, base/base_data_loader.py:
    137-153 + data_loader/data_loader.py:170-180): batch i comes from loader
    i % k, and one epoch undersamples every loader to the shortest one."""

    def __init__(self, loaders):
        if not loaders:
            raise ValueError("need at least one loader")
        self.loaders = list(loaders)

    def __iter__(self):
        iters = [iter(l) for l in self.loaders]
        for _ in range(min(len(l) for l in self.loaders)):
            for it in iters:
                yield next(it)

    def __len__(self):
        return min(len(l) for l in self.loaders) * len(self.loaders)

    def num_samples(self) -> int:
        return sum(getattr(l, "num_samples", lambda: len(l))() for l in self.loaders)


def pinned_put(batch: dict, device) -> tuple[dict, dict]:
    """Copy a batch of numpy arrays to ``device`` -> (device batch, the
    pinned host copies).

    On a CUDA device each array goes through page-locked host memory and
    is copied with ``non_blocking=True``, so the copy never waits for the
    device and runs under the step already queued. The caller keeps the
    pinned copies until the step that reads the batch is queued (as
    ``device_prefetch`` does); torch's pinned-memory allocator also
    records the copy on the stream, so a freed buffer is not reused before
    its copy has finished. Non-array values are left out. On the CPU the
    arrays become tensors that share their memory.
    """
    import torch

    device = torch.device(device)
    out, pinned = {}, {}
    for k, v in batch.items():
        if not isinstance(v, np.ndarray):
            continue
        t = torch.from_numpy(np.ascontiguousarray(v))
        if device.type == "cuda":
            pinned[k] = t = t.pin_memory()
            t = t.to(device, non_blocking=True)
        out[k] = t
    return out, pinned


def device_prefetch(batches: Iterable, put: Callable, depth: int = 2):
    """Keep ``depth`` batches already on the device ahead of consumption.

    ``put`` moves one host batch and returns (device batch, anything that
    must live until that batch is consumed), typically
    ``lambda b: pinned_put(b, device)``. The copies are asynchronous, so
    queueing the NEXT batch before the step consumes the current one
    overlaps the host-to-device copy with the device's compute. The second
    value of a batch's ``put`` is held until the caller asks for the next
    batch, that is until the step that reads the batch has been queued.
    The reference's CUDA analogue is
    utils/data_utils.data_prefetcher (stream-overlapped
    ``.cuda(non_blocking=True)``), unused in its main path.
    """
    from collections import deque

    q: deque = deque()
    held = None  # the batch being consumed, with its host buffers
    for item in batches:
        q.append(put(item))
        if len(q) > depth:
            held = q.popleft()
            yield held[0]
    while q:
        held = q.popleft()
        yield held[0]
    del held
