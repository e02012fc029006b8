"""Kimi-VL-A3B's language model as a narrator over an offline job's
batches: every clip through the tower and the projector, its prefix into
the latent cache, and narrated ``num_return_sequences`` times.

Set-up builds the program's ``KimiNarratorModel`` on the seeded weights
(``kimivl_weights.py``: bf16, the router in f32) and the run's prompt ids,
and ``narrate.py``'s pool of ``pool`` batches of ``batch`` uint8 clips on
the device, then its warm-up (the first batch eager, recording the decode
steps' CUDA graphs; replayed batches until the drop or the cap). The window
cycles the pool through ``KimiNarratorModel.narrate`` with a generator
seeded from the seed and the batch's index until ``--seconds`` have
passed, and waits for the device: ``embed_clips_per_s`` is every clip
narrated over all that time. One batch more is traced. The program is
imported before anything is made, so a checkout without it fails at once.

``correct``: while the first ``keep_batches`` batches of the window run,
one clip of each, drawn from the seed, is kept as the program made it: its
tower tokens (``encode_video``), its visual tokens (``project_visual``),
the prefill's expert sets of its prefix, the logits of its R sequences at
every decode step (as ``sample_next`` takes them) with each step's expert
sets, and its ids. ``check_batches`` of those go through the float32
reference (``reference/kimivl.py``), one layer's weights at a time:

- ``vis_gap``: the mean over the clips of the tower tokens' relative L2
  gap to the reference tower on the same uint8 clip;
- ``proj_gap``: the same of the visual tokens against the reference
  projector on the program's tower tokens;
- ``logit_gap``: the mean over clips, steps and sequences of the logits'
  relative L2 gap to the reference language model's full forward over the
  program's visual tokens, the prompt and the program's ids (no cache:
  prefill plus cached decoding against one forward), its routing
  teacher-forced where the program's expert set of a (token, layer) lies
  within ``ROUTE_MARGIN`` of the reference's own top 6 by selection score;
- ``route_miss``: the share of (token, layer) pairs whose set lies outside
  that margin (the reference then keeps its own);
- ``cache_gap``: the mean over the clips' cached rows (each layer's prefix
  positions and the tail slots the steps wrote) of the relative L2 gap of
  the latent cache, as the program left it after the batch, to the
  normalised latents and rotated keys of the reference's forward at the
  same positions: what the program cached, and where. With the prefix's
  600 positions under every step's softmax, a tail slot misplaced moves
  the logits by less than bf16 rounding does, but not its cache;
- ``logit_bf16_share``: the share of the logits that bfloat16 holds
  exactly (the configuration states f32 logits);
- ``nucleus_miss``: the share of drawn tokens outside the reference's
  nucleus widened to ``top_p + NUCLEUS_MARGIN`` (``narrate.py``).
"""

from __future__ import annotations

import json
import sys

import numpy as np

from .. import common, kimivl_weights
from ..harness import Result, Run
from .narrate import NUCLEUS_MARGIN, batch_generator, make_pool, sampled_mask, warm_up

# A (token, layer)'s expert set is the program's where every expert of it
# scores at least the reference's 6th less this (sigmoid + bias, f32):
# bf16 rounding of the stream moves a score by ~1e-3
ROUTE_MARGIN = 0.02


class _Keeper:
    """Taps on the program's functions that keep one clip of a batch: its
    tower tokens, visual tokens, the prefix's expert sets, every decode
    step's logits and expert sets of its R rows, and its prefix's and
    sequences' latent cache after the batch."""

    def __init__(self, r: int, prefix: int):
        self.r, self.prefix, self.cur, self.kept = r, prefix, None, []

    def start(self, row: int, clip, prompt):
        self.cur = {"row": row, "clip": clip, "prompt": prompt.clone(), "logits": [], "routes": []}

    def finish(self, ids):
        if self.cur is not None:
            row, r, cache = self.cur["row"], self.r, self.cur.pop("cache")
            self.cur["ids"] = ids[row].clone()
            self.cur["prefix_cache"] = cache.prefix[:, row].clone()
            self.cur["tail_cache"] = cache.tail[:, row * r:(row + 1) * r, :ids.shape[-1] - 1].clone()
            self.kept.append(self.cur)
        self.cur = None

    def tokens(self, out, *args, **kwargs):
        if self.cur is not None:
            self.cur["tokens"] = out[self.cur["row"]].clone()

    def vis(self, out, *args, **kwargs):
        if self.cur is not None:
            self.cur["vis"] = out[self.cur["row"]].clone()

    def prefill(self, out, model, vis, prompt, cache):
        if self.cur is not None:
            lo = self.cur["row"] * self.prefix
            self.cur["prefix_routes"] = cache.prefix_routes[:, lo:lo + self.prefix].clone()
            self.cur["cache"] = cache

    def logits(self, out, logits, *args, **kwargs):
        if self.cur is not None:
            lo = self.cur["row"] * self.r
            self.cur["logits"].append(logits[lo:lo + self.r].clone())
            self.cur["routes"].append(self.cur["cache"].routes[:, lo:lo + self.r].clone())


def run(run: Run) -> Result:
    import torch
    import helping_hand_for_egocentric_videos_torch.models.narrator as narrator_module

    p, cfg, dev = run.params, run.cfg, run.device
    model = kimivl_weights.port_model(cfg, run.seed, dev)  # imports the program's model before making anything
    pool = make_pool(cfg, p, run.seed, dev)
    b = p["batch"]
    g = cfg["generation"]
    r, length = g["num_return_sequences"], g["max_text_length"]
    sync = torch.cuda.synchronize if torch.device(dev).type == "cuda" else (lambda: None)
    print(f"hhbench: warm-up {json.dumps(warm_up(model, pool, run.seed, dev, p))}", file=sys.stderr)

    keeper = _Keeper(r, model.cfg.prefix_len)
    rows = common.rng(run.seed, 43)
    with common.tapped(narrator_module, "encode_video", keeper.tokens), \
            common.tapped(narrator_module, "project_visual", keeper.vis), \
            common.tapped(narrator_module, "prefill_prefix", keeper.prefill), \
            common.tapped(narrator_module, "sample_next", keeper.logits):
        run.open_window()
        done = 0
        while True:
            batch = pool[done % len(pool)]
            if done < p["keep_batches"]:
                row = int(rows.integers(b))
                keeper.start(row, batch[row].clone(), model.prompt_ids)
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
    run.kept = kept  # for calibrate_kimivl.py's controls
    del model, pool, keeper
    if torch.device(dev).type == "cuda":
        torch.cuda.empty_cache()

    def check() -> dict:
        pick = np.sort(common.rng(run.seed, 44).choice(len(kept), size=min(p["check_batches"], len(kept)),
                                                       replace=False))
        return compare([kept[k] for k in pick], cfg, kimivl_weights.LayerWeights(cfg, run.seed, dev), dev)

    return Result(e2e={"embed_clips_per_s": done * b / run.window_s}, attempted=done * b, failed=0, check=check)


def forced_routes(clips: list, cfg: dict, device):
    """The kept clips' expert sets as the reference takes them: (MoE
    layers, clips * R, P + L - 1, k), -1 where the program made none (the
    prefix's last MoE layer)."""
    import torch

    k, n_moe = cfg["num_experts_per_tok"], cfg["num_hidden_layers"] - cfg["first_k_dense_replace"]
    out = []
    for c in clips:
        r = c["ids"].shape[0]
        pre = c["prefix_routes"].to(device)  # (MoE layers - 1, P, k)
        prefix = torch.full((n_moe, r, pre.shape[1], k), -1, dtype=torch.long, device=device)
        prefix[:-1] = pre[:, None].expand(-1, r, -1, -1)
        steps = torch.stack([s.to(device) for s in c["routes"]], dim=2)  # (MoE layers, R, L - 1, k)
        out.append(torch.cat([prefix, steps], dim=2))
    return torch.cat(out, dim=1)


def compare(clips: list, cfg: dict, w, device) -> dict:
    """The compared numbers (module docstring) of the kept clips, each
    {"clip" (T, H, W, 3) uint8, "prompt", "tokens", "vis", "prefix_routes",
    "logits" (L - 1 steps of (R, V)), "routes" (L - 1 steps of (MoE layers,
    R, k)), "ids" (R, L), "prefix_cache" (layers, P, 576), "tail_cache"
    (layers, R, L - 1, 576)}, against the reference on the float32 weights
    ``w`` (a mapping; ``kimivl_weights.LayerWeights`` on the card); ``x_*``
    companions are printed, not limited."""
    import torch

    from ..reference import full_f32, kimivl as ref, preprocess

    g = cfg["generation"]
    vis, proj, logit, worst, cached, miss, exact, drawn, held, seen = [], [], [], [], [], 0, 0, 0, 0, 0
    stats = {"route_miss": 0, "routed": 0}
    with torch.no_grad(), full_f32():
        for c in clips:
            video = preprocess.resize_normalize(c["clip"][None].to(device), cfg["visual"]["img_size"])
            vis.append(common.mean_row_gap(c["tokens"][None].float(), ref.tower(w, cfg, video)))
            proj.append(common.mean_row_gap(c["vis"][None].float(),
                                            ref.project(w, cfg, c["tokens"][None].float().to(device))))
        if any(len(c["logits"]) != g["max_text_length"] - 1 for c in clips):  # a step left out
            logit.append(float("inf"))
        else:
            ids = torch.cat([c["ids"][:, :-1] for c in clips]).to(device)
            prefix = torch.cat([ref.prefix_embeds(w, c["vis"][None].float().to(device), c["prompt"].to(device))
                                .expand(c["ids"].shape[0], -1, -1) for c in clips])
            latents: list = []
            want_all = ref.lm_logits(w, cfg, prefix, ids, force=forced_routes(clips, cfg, device),
                                     margin=ROUTE_MARGIN, stats=stats, latents=latents)
            latents = torch.stack(latents)  # (layers, S, P + L - 1, 576)
            lo = 0
            for c in clips:
                r, p = c["ids"].shape[0], c["prefix_cache"].shape[1]
                want = want_all[lo:lo + r].transpose(0, 1)  # (L - 1, R, V)
                lat = latents[:, lo:lo + r]
                got_rows = torch.cat([c["prefix_cache"].to(device).reshape(-1, lat.shape[-1]),
                                      c["tail_cache"].to(device).reshape(-1, lat.shape[-1])])
                want_rows = torch.cat([lat[:, 0, :p].reshape(-1, lat.shape[-1]), lat[:, :, p:].reshape(-1, lat.shape[-1])])
                cached.append(float(common.row_gaps(got_rows.float(), want_rows).mean()))
                lo += r
                got = torch.stack(c["logits"]).float().to(device)
                gaps = common.row_gaps(got.reshape(-1, got.shape[-1]), want.reshape(-1, want.shape[-1]))
                logit.append(float(gaps.mean()))
                worst.append(float(gaps.max()))
                held += int((got == got.to(torch.bfloat16).float()).sum())
                seen += got.numel()
                ids_c = c["ids"].to(device)
                flat = want.reshape(-1, want.shape[-1])
                out = ref.nucleus(flat, g["temperature"], g["top_p"] + NUCLEUS_MARGIN)
                out_exact = ref.nucleus(flat, g["temperature"], g["top_p"])
                tok = ids_c[:, 1:].transpose(0, 1).reshape(-1)
                keep = sampled_mask(ids_c, g["eos_token_id"]).transpose(0, 1).reshape(-1)
                rows = torch.arange(tok.numel(), device=device)
                miss += int((out[rows, tok] & keep).sum())
                exact += int((out_exact[rows, tok] & keep).sum())
                drawn += int(keep.sum())
                del got, want, flat, out, out_exact
    return {"vis_gap": float(np.mean(vis)), "proj_gap": float(np.mean(proj)),
            "logit_gap": float(np.mean(logit)) if logit else float("inf"),
            "route_miss": stats["route_miss"] / stats["routed"] if stats["routed"] else float("inf"),
            "cache_gap": float(np.mean(cached)) if cached else float("inf"),
            "logit_bf16_share": held / seen if seen else float("inf"), "nucleus_miss": miss / max(drawn, 1),
            "x_logit_gap_max": max(worst, default=float("inf")), "x_routed": stats["routed"],
            "x_nucleus_miss_exact": exact / max(drawn, 1), "x_tokens_drawn": drawn, "x_clips": len(clips)}
