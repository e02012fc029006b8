"""LaViLa's narrator over an offline job's batches: every clip embedded by
the tower and the pooler and narrated ``num_return_sequences`` times.

Set-up builds the program's ``NarratorModel`` on the seeded weights
(``narrator_weights.py``, in the configuration's type) and a pool of
``pool`` batches of ``batch`` uint8 clips at the tower's input size, made
from the seed on the device (the data layer is bypassed), then narrates
warm-up batches (``warm_up``): the first runs eagerly and records the
decode steps' CUDA graphs. A new model's replayed batches then run about
1.1% slower for a while and drop to their lasting time at once (on an H100
80GB HBM3 at 700 W: 1925-1936 ms a batch, then 1911-1916 ms for good,
after 0-14 batches and once after ~30; clocks, power and temperature
alike, cuDNN's attention off too; cause unknown). The slow stretch is as
flat as the lasting one, so batches agreeing with each other says nothing;
the warm-up ends once the last ``settle`` batches (CUDA-event times) each
ran ``drop`` faster than the slowest replayed batch before them, the first
replay excepted, but not before ``warmup_min_s`` seconds of replayed
batches, or after ``warmup_s`` seconds of them (a run that starts fast
sees no drop; the eager batch, with a checkout's first build of the
kernels, is not counted). The floor bounds how far ``setup_s`` moves
with the drop's time: ``warmup_s - warmup_min_s`` seconds at most. The window cycles the pool, each batch through
``NarratorModel.narrate`` (the program's preprocess, tower, pooler, cross
keys, decoding and sampling) with a generator seeded from the seed and the
batch's index, until ``--seconds`` have passed, and waits for the device:
``embed_clips_per_s`` is every clip narrated over all that time. One batch
more is traced.

``correct``: while the first ``keep_batches`` batches of the window run,
one clip of each, drawn from the seed, is kept as the program made it:
its tower tokens (``encode_video``), its latents (``attention_pool``), the
logits of its R sequences at every decode step (as ``sample_next`` takes
them) and its sampled ids. ``check_batches`` of those, drawn from the seed, go through
the float32 reference (``reference/narrator.py``):

- ``vis_gap``: the mean over the clips of the tower tokens' relative L2
  gap to the reference tower on the same uint8 clip;
- ``pool_gap``: the same of the latents against the reference pooler run
  on the program's tower tokens;
- ``logit_gap``: the mean over clips, steps and sequences of the logits'
  relative L2 gap to the reference language model fed the program's
  latents and teacher-forced on the program's ids (so a decode error does
  not compound through sampling);
- ``logit_bf16_share``: the share of those logits that bfloat16 holds
  exactly: the configuration states float32 logits, whose low 16 bits are
  all zero about once in 65536; logits computed or stored in bf16 read 1.
  No gap can tell them apart: bf16 logits move ``logit_gap`` by ~2e-3,
  under the bf16 model's own rounding;
- ``nucleus_miss``: the share of sampled tokens (up to a sequence's first
  EOS) outside the reference's nucleus of those logits at the sampling
  temperature, widened from ``top_p`` to ``top_p + NUCLEUS_MARGIN``: the
  program's logits differ from the reference's by rounding, which moves
  the tokens at the edge of a nucleus of tens of thousands of tokens
  across it; a token drawn beyond the widened edge is a sampler's fault
  (no top-p, another temperature), not rounding.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np

from .. import common, narrator_weights
from ..harness import Result, Run

NUCLEUS_MARGIN = 0.02


def make_pool(cfg: dict, p: dict, seed: int, device) -> list:
    """``pool`` batches of (batch, T, H, W, 3) uint8 clips from the seed."""
    import torch

    v = cfg["visual"]
    gen = torch.Generator(device=device).manual_seed(common.torch_seed(seed, 41))
    shape = (p["batch"], v["num_frames"], v["img_size"], v["img_size"], 3)
    return [torch.randint(0, 256, shape, generator=gen, device=device, dtype=torch.uint8) for _ in range(p["pool"])]


def batch_generator(seed: int, k: int, device):
    """The sampling generator of the window's batch ``k`` (negative: the warm-up's)."""
    import torch

    return torch.Generator(device=device).manual_seed(common.torch_seed(seed, 1000 + k))


def settled(ms: list, settle: int, drop: float) -> bool:
    """Whether the last ``settle`` of the replayed batches' times ``ms``
    each ran ``drop`` (a fraction) faster than the slowest batch before
    them, the first replay (which carries the graphs' first launches) left
    out."""
    before = ms[1:-settle]
    return bool(before) and all(t <= (1.0 - drop) * max(before) for t in ms[-settle:])


def warm_up(model, pool: list, seed: int, dev, p: dict) -> dict:
    """The eager batch, then replayed batches until ``settled`` (after
    ``warmup_min_s`` seconds of them at the least) or for ``warmup_s``
    seconds -> {"batch_ms": each replayed batch's time, "settled",
    "eager_s", "s"}. A batch's time is read while the next one runs, so
    the queue never drains."""
    import torch

    cuda = torch.device(dev).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    t0 = time.perf_counter()
    model.narrate(pool[0], batch_generator(seed, -1, dev))  # the window's one shape, its graphs recorded
    sync()
    t1 = time.perf_counter()
    ms, pending, k, done = [], [], 1, False
    while True:
        elapsed = time.perf_counter() - t1
        if elapsed >= p["warmup_s"] or (done and elapsed >= p["warmup_min_s"]):
            break
        if cuda:
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            model.narrate(pool[k % len(pool)], batch_generator(seed, -1 - k, dev))
            b.record()
            pending.append((a, b))
            if len(pending) > 1:
                a, b = pending.pop(0)
                b.synchronize()
                ms.append(a.elapsed_time(b))
        else:
            a = time.perf_counter()
            model.narrate(pool[k % len(pool)], batch_generator(seed, -1 - k, dev))
            ms.append(1e3 * (time.perf_counter() - a))
        k += 1
        done = done or settled(ms, p["settle"], p["drop"])
    for a, b in pending:
        b.synchronize()
        ms.append(a.elapsed_time(b))
    return {"batch_ms": [round(t, 1) for t in ms], "settled": done, "eager_s": round(t1 - t0, 2),
            "s": round(time.perf_counter() - t0, 2)}


class _Keeper:
    """Taps on the program's functions that keep one clip of a batch: its
    tower tokens, latents and every decode step's logits of its R rows."""

    def __init__(self, r: int):
        self.r, self.cur, self.kept = r, None, []

    def start(self, row: int, clip):
        self.cur = {"row": row, "clip": clip, "logits": []}

    def finish(self, ids):
        if self.cur is not None:
            self.cur["ids"] = ids[self.cur["row"]].clone()
            self.kept.append(self.cur)
        self.cur = None

    def tokens(self, out, *args, **kwargs):
        if self.cur is not None:
            self.cur["tokens"] = out[self.cur["row"]].clone()

    def latents(self, out, *args, **kwargs):
        if self.cur is not None:
            self.cur["latents"] = out[self.cur["row"]].clone()

    def logits(self, out, logits, *args, **kwargs):
        if self.cur is not None:
            lo = self.cur["row"] * self.r
            self.cur["logits"].append(logits[lo:lo + self.r].clone())


def run(run: Run) -> Result:
    import torch
    import helping_hand_for_egocentric_videos_torch.models.narrator as narrator_module

    p, cfg, dev = run.params, run.cfg, run.device
    model = narrator_weights.port_model(cfg, run.seed, dev)
    pool = make_pool(cfg, p, run.seed, dev)
    b = p["batch"]
    r, length = cfg["generation"]["num_return_sequences"], cfg["generation"]["max_text_length"]
    sync = torch.cuda.synchronize if torch.device(dev).type == "cuda" else (lambda: None)
    print(f"hhbench: warm-up {json.dumps(warm_up(model, pool, run.seed, dev, p))}", file=sys.stderr)

    keeper = _Keeper(r)
    rows = common.rng(run.seed, 43)
    with common.tapped(narrator_module, "encode_video", keeper.tokens), \
            common.tapped(narrator_module, "attention_pool", keeper.latents), \
            common.tapped(narrator_module, "sample_next", keeper.logits):
        run.open_window()
        done = 0
        while True:
            batch = pool[done % len(pool)]
            if done < p["keep_batches"]:
                row = int(rows.integers(b))
                keeper.start(row, batch[row].clone())
            keeper.finish(model.narrate(batch, batch_generator(run.seed, done, dev)))
            done += 1
            if run.elapsed() >= run.seconds:
                break
        sync()
        run.close_window(done * b)
    with run.traced(items=b, steps=length - 1):
        model.narrate(pool[done % len(pool)], batch_generator(run.seed, done, dev))
    run.read_memory()
    kept = keeper.kept
    del model, pool, keeper
    if torch.device(dev).type == "cuda":
        torch.cuda.empty_cache()

    def check() -> dict:
        pick = np.sort(common.rng(run.seed, 44).choice(len(kept), size=min(p["check_batches"], len(kept)),
                                                       replace=False))
        return compare([kept[k] for k in pick], cfg, narrator_weights.make(cfg, run.seed, dev), dev)

    return Result(e2e={"embed_clips_per_s": done * b / run.window_s}, attempted=done * b, failed=0, check=check)


def sampled_mask(ids, eos: int):
    """(R, L) ids -> (R, L - 1) bool: the drawn tokens up to and including
    each sequence's first EOS (the rest is padding)."""
    hit = (ids[:, 1:] == eos).int()
    return hit.cumsum(dim=1) - hit == 0


def compare(clips: list, cfg: dict, w: dict, device) -> dict:
    """The compared numbers (module docstring) of the kept clips, each
    {"clip" (T, H, W, 3) uint8, "tokens", "latents", "logits" (L - 1 steps
    of (R, V)), "ids" (R, L)}, against the reference on the float32
    weights ``w``; ``x_*`` companions are printed, not limited."""
    import torch

    from ..reference import full_f32, narrator as ref, preprocess

    g = cfg["generation"]
    vis, pool, logit, worst, miss, exact, drawn, held, seen = [], [], [], [], 0, 0, 0, 0, 0
    with torch.no_grad(), full_f32():
        for c in clips:
            video = preprocess.resize_normalize(c["clip"][None].to(device), cfg["visual"]["img_size"])
            vis.append(common.mean_row_gap(c["tokens"][None].float(), ref.tower(w, cfg, video)))
            pool.append(common.mean_row_gap(c["latents"][None].float(),
                                            ref.pool(w, cfg, c["tokens"][None].float().to(device))))
            ids = c["ids"].to(device)
            lat = c["latents"].float().to(device)[None].expand(ids.shape[0], -1, -1)
            want = ref.lm_logits(w, cfg, ids, lat)[:, :-1].transpose(0, 1)  # (L - 1, R, V)
            got = torch.stack(c["logits"]).float().to(device) if c["logits"] else want[:0]
            if got.shape != want.shape:  # a step or a sequence left out
                logit.append(float("inf"))
                continue
            gaps = common.row_gaps(got.reshape(-1, got.shape[-1]), want.reshape(-1, want.shape[-1]))
            logit.append(float(gaps.mean()))
            held += int((got == got.to(torch.bfloat16).float()).sum())
            seen += got.numel()
            worst.append(float(gaps.max()))
            out = ref.nucleus(want.reshape(-1, want.shape[-1]), g["temperature"], g["top_p"] + NUCLEUS_MARGIN)
            out_exact = ref.nucleus(want.reshape(-1, want.shape[-1]), g["temperature"], g["top_p"])
            tok = ids[:, 1:].transpose(0, 1).reshape(-1)
            keep = sampled_mask(ids, g["eos_token_id"]).transpose(0, 1).reshape(-1)
            rows = torch.arange(tok.numel(), device=device)
            miss += int((out[rows, tok] & keep).sum())
            exact += int((out_exact[rows, tok] & keep).sum())
            drawn += int(keep.sum())
    return {"vis_gap": float(np.mean(vis)), "pool_gap": float(np.mean(pool)), "logit_gap": float(np.mean(logit)),
            "logit_bf16_share": held / seen if seen else float("inf"), "nucleus_miss": miss / max(drawn, 1),
            "x_logit_gap_max": max(worst, default=float("inf")),
            "x_nucleus_miss_exact": exact / max(drawn, 1), "x_tokens_drawn": drawn, "x_clips": len(clips)}
