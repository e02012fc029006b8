"""Forward passes of the three towers in plain float32.

Weights are a dict of tensors under checkpoint names (``visual.*``,
``text.*`` of the LaViLa backbone; the decoder's own names), read with
``w[name]``; linear weights are (out, in).

- ``timesformer``: LaViLa's TimeSformer-L (frozen-in-time ``SpaceTimeBlock``):
  patchify (a bias-free (P*P*C, D) matmul of channel-last patches), CLS +
  spatial and temporal position embeddings, ``ln_pre`` (eps 1e-5); each
  block: time attention on norm3(x), time_residual = x + out; space
  attention on norm1(time_residual); space_residual = x + out (from x);
  QuickGELU MLP on norm2. Divided attention over the full (1 + T*N)
  sequence: the CLS query attends every token; a patch query attends the
  CLS token and the patches of its frame (space) or of its tube (time).
  One qkv/proj pair per attention kind; block norms eps 1e-6; final norm.
- ``clip_text``: token + positional embedding, pre-norm blocks with a
  causal mask and QuickGELU MLPs, ln_final.
- ``decoder``: the pre-norm, self-attention-first object decoder over the
  LayerNormed projected patch grid with learned 3-D position embeddings;
  normed states of every layer; per-frame boxes through the frame-index
  conditioning when ``pred_traj``. Dropout, when a generator is given,
  draws its keep masks as ``torch.rand(shape) < 1 - rate`` from it, six a
  layer in the order self-attention weights, self-attention residual,
  cross-attention weights, cross-attention residual, FFN hidden, FFN
  residual: the order and shapes in which the program draws them, so one
  generator seeded alike gives both the same masks.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _lin(w, name, x, bias=True, mm=F.linear):
    b = w.get(f"{name}.bias") if bias else None
    return mm(x, w[f"{name}.weight"], b)


def _ln(w, name, x, eps):
    return F.layer_norm(x, x.shape[-1:], w[f"{name}.weight"], w[f"{name}.bias"], eps)


def _quick_gelu(x):
    return x * torch.sigmoid(1.702 * x)


def _softmax_attend(q, k, v):
    return torch.softmax(q @ k.transpose(-1, -2), dim=-1) @ v


def _divided_attention(w, name, x, t, n, heads, mode, mm):
    """x (B, 1+T*N, D) -> the attention's projected output, same shape."""
    b, s, d = x.shape
    dh = d // heads
    q, k, v = (z.reshape(b, s, heads, dh).transpose(1, 2) for z in _lin(w, f"{name}.qkv", x, mm=mm).chunk(3, dim=-1))
    q = q * dh**-0.5
    cls_out = _softmax_attend(q[:, :, :1], k, v)  # (B, H, 1, dh)
    qp, kp, vp = q[:, :, 1:], k[:, :, 1:], v[:, :, 1:]
    if mode == "space":  # groups: frames of N patches
        grp = lambda z: z.reshape(b, heads, t, n, dh)  # noqa: E731
        ungrp = lambda z: z.reshape(b, heads, t * n, dh)  # noqa: E731
        g = t
    else:  # groups: tubes of T patches
        grp = lambda z: z.reshape(b, heads, t, n, dh).transpose(2, 3)  # noqa: E731
        ungrp = lambda z: z.transpose(2, 3).reshape(b, heads, t * n, dh)  # noqa: E731
        g = n
    ck = k[:, :, None, :1].expand(b, heads, g, 1, dh)
    cv = v[:, :, None, :1].expand(b, heads, g, 1, dh)
    out = ungrp(_softmax_attend(grp(qp), torch.cat([ck, grp(kp)], dim=3), torch.cat([cv, grp(vp)], dim=3)))
    out = torch.cat([cls_out, out], dim=2).transpose(1, 2).reshape(b, s, d)
    return _lin(w, f"{name}.proj", out, mm=mm)


def timesformer(w: dict, visual: dict, video: torch.Tensor, prefix: str = "visual.", mm=F.linear) -> torch.Tensor:
    """video (B, T, H, W, C) normalised float32 -> the final-normed token
    map (B, 1 + T*N, D). ``mm``: the tower's matrix product (``F.linear``;
    ``lowp.fp8_linear`` for the control)."""
    vw = {k[len(prefix):]: v for k, v in w.items() if k.startswith(prefix)}
    b, t, h, wd, c = video.shape
    p, d = visual["patch_size"], visual["width"]
    gh, gw = h // p, wd // p
    n = gh * gw
    x = video.reshape(b, t, gh, p, gw, p, c).permute(0, 1, 2, 4, 3, 5, 6).reshape(b, t * n, p * p * c)
    x = mm(x, vw["patch_embed.weight"], None)
    pos = vw["pos_embed"][0]  # (1 + N, D)
    x = x + pos[1:].repeat(t, 1) + vw["temporal_embed"][0, :t].repeat_interleave(n, dim=0)
    cls = vw["cls_token"].expand(b, 1, d) + pos[:1]
    x = torch.cat([cls, x], dim=1)
    x = _ln(vw, "ln_pre", x, 1e-5)
    eps = visual["ln_eps"]
    for i in range(visual["depth"]):
        blk = f"blocks.{i}"
        heads = visual["heads"]
        tr = x + _divided_attention(vw, f"{blk}.timeattn", _ln(vw, f"{blk}.norm3", x, eps), t, n, heads, "time", mm)
        sr = x + _divided_attention(vw, f"{blk}.attn", _ln(vw, f"{blk}.norm1", tr, eps), t, n, heads, "space", mm)
        hdn = _quick_gelu(_lin(vw, f"{blk}.mlp_fc1", _ln(vw, f"{blk}.norm2", sr, eps), mm=mm))
        x = sr + _lin(vw, f"{blk}.mlp_fc2", hdn, mm=mm)
    return _ln(vw, "norm", x, eps)


def _mha(w, name, q_in, k_in, v_in, heads, mask=None, gen=None, rate=0.0, mm=F.linear):
    b, nq, d = q_in.shape
    nk = k_in.shape[1]
    dh = d // heads
    q = _lin(w, f"{name}.wq", q_in, mm=mm).reshape(b, nq, heads, dh).transpose(1, 2)
    k = _lin(w, f"{name}.wk", k_in, mm=mm).reshape(b, nk, heads, dh).transpose(1, 2)
    v = _lin(w, f"{name}.wv", v_in, mm=mm).reshape(b, nk, heads, dh).transpose(1, 2)
    logits = (q @ k.transpose(-1, -2)) * dh**-0.5
    if mask is not None:
        logits = logits + mask
    probs = _dropout(gen, torch.softmax(logits, dim=-1), rate)
    return _lin(w, f"{name}.wo", (probs @ v).transpose(1, 2).reshape(b, nq, d), mm=mm)


def _dropout(gen, x, rate):
    if gen is None or rate == 0.0:
        return x
    keep = torch.rand(x.shape, generator=gen, device=x.device) < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), 0.0)


def clip_text(w: dict, text: dict, tokens: torch.Tensor, prefix: str = "text.", mm=F.linear) -> torch.Tensor:
    """tokens (B, L) -> the ln_final feature map (B, L, width); ``mm``: the
    tower's matrix product."""
    tw = {k[len(prefix):]: v for k, v in w.items() if k.startswith(prefix)}
    n = tokens.shape[1]
    x = tw["token_embedding"][tokens] + tw["positional_embedding"][:n]
    mask = torch.full((n, n), float("-inf"), device=x.device).triu(1)
    eps = text.get("ln_eps", 1e-5)
    for i in range(text["layers"]):
        blk = f"blocks.{i}"
        h = _ln(tw, f"{blk}.ln_1", x, eps)
        x = x + _mha(tw, f"{blk}.attn", h, h, h, text["heads"], mask=mask, mm=mm)
        hdn = _quick_gelu(_lin(tw, f"{blk}.mlp_fc", _ln(tw, f"{blk}.ln_2", x, eps), mm=mm))
        x = x + _lin(tw, f"{blk}.mlp_proj", hdn, mm=mm)
    return _ln(tw, "ln_final", x, eps)


def decoder(w: dict, dec: dict, grid: torch.Tensor, gen=None, mm=F.linear):
    """grid (B, T, N, feature_dim) -> (hs (L, B, Q, D), boxes): boxes are
    (B*T, Q, 4) per frame when ``pred_traj`` and T is the configured frame
    count, else (B, Q, 4); sigmoid cxcywh. ``mm``: the product of every
    linear layer (the attention's own products stay in float32)."""
    b, t, n, _ = grid.shape
    d, q, eps = dec["d_model"], dec["num_queries"], dec.get("ln_eps", 1e-5)
    rate = dec["dropout"] if gen is not None else 0.0
    mem = mm(grid.reshape(b, t * n, -1), w["proj.weight"], None)
    pos = w["pos_embed"][:, 1:].repeat(1, t, 1) + w["temporal_embed"][:, :t].repeat_interleave(n, dim=1)
    memory = _ln(w, "pre_norm", mem, eps)
    qpos = w["query_embed"].expand(b, q, d)
    tgt = torch.zeros(b, q, d, device=grid.device)
    hs = []
    for i in range(dec["num_layers"]):
        ly = f"layers.{i}"
        t2 = _ln(w, f"{ly}.norm1", tgt, eps)
        sa = _mha(w, f"{ly}.self_attn", t2 + qpos, t2 + qpos, t2, dec["nhead"], gen=gen, rate=rate, mm=mm)
        tgt = tgt + _dropout(gen, sa, rate)
        t2 = _ln(w, f"{ly}.norm2", tgt, eps)
        ca = _mha(w, f"{ly}.cross_attn", t2 + qpos, memory + pos, memory, dec["nhead"], gen=gen, rate=rate, mm=mm)
        tgt = tgt + _dropout(gen, ca, rate)
        t2 = _ln(w, f"{ly}.norm3", tgt, eps)
        hidden = _dropout(gen, torch.relu(_lin(w, f"{ly}.linear1", t2, mm=mm)), rate)
        tgt = tgt + _dropout(gen, _lin(w, f"{ly}.linear2", hidden, mm=mm), rate)
        hs.append(_ln(w, "decoder_norm", tgt, eps))
    hs = torch.stack(hs)
    last = hs[-1]
    if dec["pred_traj"] and t == dec["num_frames"]:
        fi = w["frame_index"][None, :, None, :].expand(b, t, q, d)
        cond = torch.cat([last[:, None].expand(b, t, q, d), fi], dim=-1)
        last = _lin(w, "frame_proj", cond, mm=mm).reshape(b * t, q, d)
    h = torch.relu(_lin(w, "bbox_mlp.0", last, mm=mm))
    h = torch.relu(_lin(w, "bbox_mlp.1", h, mm=mm))
    return hs, torch.sigmoid(_lin(w, "bbox_mlp.2", h, mm=mm))


def obj_proj(w: dict, x, mm=F.linear):
    return _lin(w, "obj_proj.1", torch.relu(_lin(w, "obj_proj.0", x, mm=mm)), mm=mm)


def txt_proj(w: dict, x, mm=F.linear):
    return _lin(w, "txt_proj", torch.relu(x), mm=mm)


def tower_grid(wb: dict, visual: dict, video: torch.Tensor, mm=F.linear) -> torch.Tensor:
    """Normalised clips (B, T, H, W, C) -> the tower's patch grid (B, T, N, C)
    that the decoder reads (the CLS token left out)."""
    n = (visual["img_size"] // visual["patch_size"]) ** 2
    return timesformer(wb, visual, video, mm=mm)[:, 1:].reshape(video.shape[0], video.shape[1], n, -1)


def embed_head(wd: dict, cfg: dict, grid: torch.Tensor, mm=F.linear):
    """A patch grid -> (embeddings (B, E), boxes): the decoder, ``obj_proj``
    of the summary (last) query."""
    hs, boxes = decoder(wd, cfg["decoder"], grid, mm=mm)
    return obj_proj(wd, hs[-1], mm=mm)[:, -1], boxes


def embed_clips(wb: dict, wd: dict, cfg: dict, video: torch.Tensor, block: int = 4, prec=None,
                keep_grid: bool = False):
    """Normalised clips (B, T, H, W, C) -> (embeddings (B, E), boxes, patch
    grids or None), in blocks of ``block`` clips. ``prec``: the matrix
    product of each part, {"visual": ..., "decoder": ...} (``F.linear``
    where a part is not named)."""
    prec = prec or {}
    embs, boxes, grids = [], [], []
    for lo in range(0, video.shape[0], block):
        grid = tower_grid(wb, cfg["visual"], video[lo:lo + block], prec.get("visual", F.linear))
        e, bx = embed_head(wd, cfg, grid, prec.get("decoder", F.linear))
        embs.append(e)
        boxes.append(bx)
        if keep_grid:
            grids.append(grid)
    return torch.cat(embs), torch.cat(boxes), (torch.cat(grids) if keep_grid else None)
