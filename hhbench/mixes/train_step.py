"""The pretraining step on device-resident batches, one rank's step as
users run it.

Set-up makes a pool of ``pool`` distinct batches of ``batch`` clips from
the seed on the device: uint8 clips at the tower's input size (the step
normalises them), ``rephrase_factor`` captions a clip of 2 to 16 words
(some empty, as padded captions are), verb and noun tag vectors, per-frame
hand and object boxes (some absent) and up to 4 nouns a clip, and the
noun dictionary. It builds one ``TrainState`` and one
``make_train_step`` step over the frozen backbone and drives them through
their first ``CHECK_STEPS`` steps on batches 0, 1, 2 with dropout drawn
from a generator seeded from the seed, reading each step's loss, the first
gradient from the optimizer's state after one step and the parameters'
change after the last; the window then cycles the pool with that same
state and step until ``--seconds`` have passed, and waits for the device.
``train_clips_per_s`` is every clip stepped over all that time.

``correct``: the reference replays the three steps from the same inputs
and dropout masks (the same generator seed, drawn in the same order),
twice. Once whole, from its own float32 towers: ``loss1_gap`` (the
relative gap of the first step's total loss), ``loss_gap`` (the largest of
the three steps'), ``grad_gap`` (the worst leaf's gap between the norms of
the first gradient, over the larger of the reference leaf's norm and the
median leaf's) and ``update_gap`` (the same of the change after three
steps, leaving out leaves whose reference gradient is under a thousandth
of the median leaf's). Once from the features that the program's towers
handed its decoder in those steps (``backbone_features``, read as the
step returns them): ``head_loss_gap``, ``head_grad_gap`` and
``head_update_gap``, the same numbers of the decoder, the losses and the
update alone, which no rounding of the bf16 tower blurs; the towers
themselves against the reference's: ``vis_gap`` (the mean over the clips
of the patch grid's relative gap) and ``text_gap`` (the same over the
captions' feature maps).
"""

from __future__ import annotations

import numpy as np

from .. import common, weights
from ..harness import Result, Run

CHECK_STEPS = 3
BLOCK = 16  # clips a block of the reference's backbone forward
SOT, EOT = 49406, 49407


def make_pool(cfg: dict, p: dict, seed: int, device) -> tuple[list, object]:
    """The pool of batches and the noun dictionary, from the seed; batch
    ``k`` is the same whatever the pool's size."""
    import torch

    tr, v = cfg["train"], cfg["visual"]
    n, r, t, res = p["batch"], tr["rephrase_factor"], v["num_frames"], v["img_size"]
    gen = torch.Generator(device=device).manual_seed(common.torch_seed(seed, 11))
    noun_dict = torch.randn(tr["nouns"], cfg["text"]["width"], generator=gen, device=device)
    rng = common.rng(seed, 12)
    pool = []
    for k in range(p["pool"]):
        tokens = np.zeros((n * r, cfg["text"]["context_length"]), np.int64)
        words = rng.integers(2, 17, size=n * r)
        words[rng.random(n * r) < 0.05] = 0  # padded (empty) captions
        words[::r] = np.maximum(words[::r], 2)  # each clip's first caption is real
        for i, w in enumerate(words):
            tokens[i, 0] = SOT
            tokens[i, 1:1 + w] = rng.integers(1, SOT, size=w)
            tokens[i, 1 + w] = EOT
        xy = rng.uniform(0, 150, size=(n, t, 4, 2))
        wh = rng.uniform(16, 72, size=(n, t, 4, 2))
        boxes = np.concatenate([xy, xy + wh], -1)
        boxes[rng.random((n, t, 4)) < 0.15] = 0.0  # absent boxes
        nouns = rng.integers(1, tr["nouns"], size=(n, 4))
        nouns[:, 1:][rng.random((n, 3)) < 0.3] = 0  # padding slots
        arrays = {
            "tokens": tokens,
            "noun_vec": (rng.random((n, tr["nouns"])) < 0.02).astype(np.float32),
            "verb_vec": (rng.random((n, tr["verbs"])) < 0.05).astype(np.float32),
            "boxes": boxes.astype(np.float32),
            "nouns": nouns,
        }
        batch = {k2: torch.as_tensor(a, device=device) for k2, a in arrays.items()}
        batch["video"] = torch.randint(0, 256, (n, t, res, res, 3), generator=gen, device=device,
                                       dtype=torch.uint8)
        pool.append(batch)
    return pool, noun_dict


def train_config(cfg: dict):
    import torch
    from helping_hand_for_egocentric_videos_torch.train import TrainConfig

    tr = cfg["train"]
    return TrainConfig(lr=tr["lr"], wd=tr["wd"], b1=tr["b1"], b2=tr["b2"], temperature=tr["temperature"],
                       word_loss_weight=tr["word_loss_weight"], rephrase_factor=tr["rephrase_factor"],
                       resize=tr["resize"], input_res=cfg["visual"]["img_size"], num_queries=tr["num_queries"],
                       backbone_dtype=common.tower_type(cfg)[1], augment=False)


def decays(name: str) -> bool:
    """The published optimizer policy: parameters named ``.bias`` take no
    weight decay, except the q/k/v in-projection biases."""
    parts = name.split(".")
    return parts[-1] != "bias" or any(k in ("wq", "wk", "wv") for k in parts)


def norms(tensors: dict) -> dict:
    return {k: float(v.double().norm()) for k, v in tensors.items()}


def dropout_generator(seed: int, device):
    """The generator the step draws its dropout masks from."""
    import torch

    return torch.Generator(device=device).manual_seed(common.torch_seed(seed, 1300))


def run(run: Run) -> Result:
    """Set-up, the checked steps, the window and the traced steps."""
    import torch
    import helping_hand_for_egocentric_videos_torch.train.step as step_module
    from helping_hand_for_egocentric_videos_torch.models import quantize_lavila_params
    from helping_hand_for_egocentric_videos_torch.train import TrainState, make_train_step

    p, cfg, dev = run.params, run.cfg, run.device
    tcfg = train_config(cfg)
    lcfg, dcfg = weights.port_configs(cfg)
    backbone, decoder = weights.port_models(cfg, weights.make(cfg, "backbone", run.seed, dev),
                                            weights.make(cfg, "decoder", run.seed, dev), dev)
    backbone.requires_grad_(False)
    if common.tower_type(cfg)[0]:
        backbone = quantize_lavila_params(backbone)
    pool, noun_dict = make_pool(cfg, p, run.seed, dev)
    state = TrainState.create(decoder, tcfg, device=dev)
    step = make_train_step(dcfg, lcfg, tcfg)
    gen = dropout_generator(run.seed, dev)
    cuda = torch.device(dev).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)

    named = {n: q for g in state.optimizer.param_groups for n, q in zip(g["names"], g["params"])}
    p0 = {n: q.detach().clone() for n, q in named.items()}
    losses, grad1, feats = [], {}, []

    def keep(out, *args, **kwargs):
        feats.append(tuple(t.detach().float().cpu() for t in out))

    with common.tapped(step_module, "backbone_features", keep):
        for k in range(CHECK_STEPS):
            with run.spans("hhb.train_step"):
                state, metrics = step(state, backbone, pool[k], noun_dict, gen)
            losses.append(float(metrics["total_loss"]))
            if k == 0:
                grad1 = norms({n: state.optimizer.state.get(q, {}).get("exp_avg", torch.zeros_like(q)) / (1 - tcfg.b1)
                               for n, q in named.items()})
    update = norms({n: q.detach() - p0[n] for n, q in named.items()})
    del p0
    sync()

    run.open_window()
    done = 0
    while True:
        with run.spans("hhb.train_step"):
            state, metrics = step(state, backbone, pool[(CHECK_STEPS + done) % len(pool)], noun_dict, gen)
        done += 1
        if run.elapsed() >= run.seconds:
            break
    sync()
    run.close_window(done * p["batch"])
    with run.traced(items=CHECK_STEPS * p["batch"], steps=CHECK_STEPS):
        for k in range(CHECK_STEPS):
            with run.spans("hhb.train_step"):
                state, metrics = step(state, backbone, pool[k % len(pool)], noun_dict, gen)
    run.read_memory()
    del state, step, backbone, decoder, pool, noun_dict, named, metrics
    if cuda:
        torch.cuda.empty_cache()

    def check() -> dict:
        ref = reference_steps(cfg, p, run.seed, dev, features=feats)
        return compare({"losses": losses, "grad1": grad1, "update": update}, ref)

    return Result(e2e={"train_clips_per_s": run.items / run.window_s}, attempted=done, failed=0, check=check)


class _Replay:
    """One replay of the checked steps by the reference: the decoder's
    weights (the trained ones require grad), AdamW over them, and a dropout
    generator seeded as the program's."""

    def __init__(self, cfg: dict, wd: dict, seed: int, device):
        from ..reference import optim

        tr = cfg["train"]
        self.cfg = cfg
        self.wd = {k: v.clone() for k, v in wd.items()}
        frozen = tuple(tr["frozen"])
        self.trained = {k: v.requires_grad_(True) for k, v in self.wd.items() if k.split(".")[0] not in frozen}
        self.p0 = {k: v.detach().clone() for k, v in self.trained.items()}
        self.opt = optim.AdamW(self.trained, {k: tr["wd"] if decays(k) else 0.0 for k in self.trained}, tr["lr"],
                               tr["b1"], tr["b2"])
        self.gen = dropout_generator(seed, device)
        self.losses, self.grad1 = [], {}

    def step(self, grid, text_fmap, batch, noun_dict, mm):
        import torch

        from ..reference import losses as rl

        loss, _ = rl.pretrain_loss(self.wd, self.cfg["decoder"], self.cfg["train"], grid, text_fmap, batch, noun_dict,
                                   gen=self.gen, mm=mm)
        grads = dict(zip(self.trained, torch.autograd.grad(loss, list(self.trained.values()), allow_unused=True)))
        grads = {k: torch.zeros_like(self.trained[k]) if g is None else g for k, g in grads.items()}
        self.losses.append(float(loss.detach()))
        if not self.grad1:
            self.grad1 = norms(grads)
        self.opt.step(grads)

    def result(self) -> dict:
        return {"losses": self.losses, "grad1": self.grad1,
                "update": norms({k: v.detach() - self.p0[k] for k, v in self.trained.items()})}


def towers(wb: dict, cfg: dict, batch: dict, mm_visual, mm_text):
    """The reference's frozen towers on one step's batch, in blocks of
    ``BLOCK`` clips -> (patch grid (N, T, P, C), text feature map)."""
    import torch

    from ..reference import model as rm, preprocess

    r = cfg["train"]["rephrase_factor"]
    grids, fmaps = [], []
    with torch.no_grad():
        for lo in range(0, batch["video"].shape[0], BLOCK):
            video = preprocess.resize_normalize(batch["video"][lo:lo + BLOCK], cfg["visual"]["img_size"])
            grids.append(rm.tower_grid(wb, cfg["visual"], video, mm_visual))
            fmaps.append(rm.clip_text(wb, cfg["text"], batch["tokens"][lo * r:(lo + BLOCK) * r], mm=mm_text))
    return torch.cat(grids), torch.cat(fmaps)


def reference_steps(cfg: dict, p: dict, seed: int, device, prec=None, features=None) -> dict:
    """The reference's three steps on the whole batch -> {"losses",
    "grad1", "update"} (the latter two by leaf) and "feats", each step's
    (patch grid, text feature map) on the host. ``prec``: the matrix
    product of each part, {"visual"|"text"|"decoder": fn} (a control's
    lower precision; ``F.linear`` where a part is not named).
    ``features``: each step's (grid, text feature map) that the program's
    towers gave; then also "head", the same replay of the decoder, losses
    and AdamW on those features, and "vis_gap" and "text_gap", the mean
    relative gap of those features' clips and captions to the reference's."""
    import torch.nn.functional as F

    from ..reference import full_f32

    prec = prec or {}
    pool, noun_dict = make_pool(cfg, dict(p, pool=CHECK_STEPS), seed, device)
    wb = weights.make(cfg, "backbone", seed, device)
    wd = weights.make(cfg, "decoder", seed, device)
    own = _Replay(cfg, wd, seed, device)
    head = _Replay(cfg, wd, seed, device) if features is not None else None
    out = {"feats": [], "vis_gaps": [], "text_gaps": []}
    with full_f32():
        for k in range(CHECK_STEPS):
            b = pool[k]
            grid, text_fmap = towers(wb, cfg, b, prec.get("visual", F.linear), prec.get("text", F.linear))
            own.step(grid, text_fmap, b, noun_dict, prec.get("decoder", F.linear))
            if features is None:
                out["feats"].append((grid.cpu(), text_fmap.cpu()))
                continue
            pg, pt = features[k] if k < len(features) else (grid[:0], text_fmap[:0])
            out["vis_gaps"].append(common.mean_row_gap(pg, grid))
            out["text_gaps"].append(common.mean_row_gap(pt, text_fmap))
            if head is not None and pg.shape == grid.shape and pt.shape == text_fmap.shape:
                head.step(pg.to(device), pt.to(device), b, noun_dict, F.linear)
            else:  # a clip or caption left out: no replay on the program's features
                head = None
    out.update(own.result())
    if features is not None:
        out["head"] = head.result() if head is not None else None
        out["vis_gap"], out["text_gap"] = float(np.mean(out["vis_gaps"])), float(np.mean(out["text_gaps"]))
    return out


def step_gaps(prog: dict, ref: dict) -> dict:
    """The gaps of one replay: each step's loss gap, and the leaves'
    first-gradient and change gaps by name (the change without the leaves
    whose reference gradient is under a thousandth of the median leaf's)."""
    loss_gaps = [abs(a - b) / abs(b) for a, b in zip(prog["losses"], ref["losses"])]
    g_med = float(np.median(list(ref["grad1"].values())))
    g_gap = {k: abs(prog["grad1"][k] - g) / max(g, g_med) for k, g in ref["grad1"].items()}
    counted = [k for k, g in ref["grad1"].items() if g >= 1e-3 * g_med]
    u_med = float(np.median([ref["update"][k] for k in counted]))
    u_gap = {k: abs(prog["update"][k] - ref["update"][k]) / max(ref["update"][k], u_med) for k in counted}
    return {"loss": loss_gaps, "grad": g_gap, "update": u_gap, "left_out": sorted(set(ref["grad1"]) - set(counted))}


def compare(prog: dict, ref: dict) -> dict:
    """The compared numbers of a training cell (module docstring), with
    companions (``x_*``, not limited): each step's loss gap, the median
    leaf's gradient and change gaps, and the worst leaves' names. ``prog``:
    {"losses", "grad1", "update"}; ``ref``: ``reference_steps`` given the
    program's features."""
    whole = step_gaps(prog, ref)
    g, u = whole["grad"], whole["update"]
    out = {"loss1_gap": whole["loss"][0], "loss_gap": max(whole["loss"]), "grad_gap": max(g.values()),
           "update_gap": max(u.values()), "vis_gap": ref["vis_gap"], "text_gap": ref["text_gap"]}
    if ref["head"] is not None:
        head = step_gaps(prog, ref["head"])
        hg, hu = head["grad"], head["update"]
        out.update(head_loss_gap=max(head["loss"]), head_grad_gap=max(hg.values()), head_update_gap=max(hu.values()),
                   x_head_grad_worst=max(hg, key=hg.get), x_head_update_worst=max(hu, key=hu.get),
                   x_head_grad_median=float(np.median(list(hg.values()))))
    out.update(x_loss_gaps=whole["loss"], x_grad_median=float(np.median(list(g.values()))),
               x_update_median=float(np.median(list(u.values()))), x_grad_worst=max(g, key=g.get),
               x_update_worst=max(u, key=u.get), x_left_out=whole["left_out"])
    return out
