"""Object decoder: DETR-style transformer over frozen backbone features.

Counterpart of ``helping_hand_for_egocentric_videos_tpu/models/obj_decoder.py``.
Given the backbone's patch-token grid of a
T-frame clip and a set of learned queries, a pre-norm decoder
(self-attention first) cross-attends into the LayerNormed memory and emits
per-query boxes (per frame under trajectory conditioning), class logits,
the normed intermediate states of every layer, and the projection heads
``txt_proj``, ``vid_proj`` and ``obj_proj``.

Query layout: queries 0:2 predict hand boxes, 2:num_queries-1 object
boxes, and the last query is the video summary embedding for retrieval.
With ``num_queries == 1`` one query decodes ``n_decode`` boxes through a
query-index embedding.

Train mode (``deterministic=False`` with a ``torch.Generator``) draws six
dropouts a layer, in this order: the self-attention weights, the
self-attention residual, the cross-attention weights, the cross-attention
residual, the FFN hidden activation and the FFN residual. Eval mode (the
default) draws none. ``return_attn`` adds each layer's head-averaged
cross- and self-attention maps to the output (``cli/visualize.py`` draws
the last layer's).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
from torch import nn

from .layers import (
    MultiheadAttention,
    dropout,
    layer_norm,
    layer_norm_init,
    linear,
    linear_init,
    multi_head_attention,
)

__all__ = [
    "DecoderConfig",
    "ObjDecoder",
    "DecoderOutput",
    "decoder_forward",
    "position_embedding_sine",
    "txt_proj",
    "vid_proj",
    "obj_proj",
]


@dataclass(frozen=True)
class DecoderConfig:
    d_model: int = 512
    nhead: int = 8
    num_layers: int = 6
    dim_feedforward: int = 2048
    dropout: float = 0.1
    num_queries: int = 13  # 12 object/hand queries + 1 summary
    num_classes: int = 22047  # the reference keeps an (unused) class head
    feature_dim: int = 1024  # backbone width
    text_width: int = 768
    embed_dim: int = 256
    num_frames: int = 4
    patches_per_frame: int = 256
    pred_traj: bool = True
    n_decode: int = 10  # boxes per query in the num_queries == 1 mode
    ln_eps: float = 1e-5


def _xavier_(w, fans, generator):
    """xavier_uniform on a torch (out, in) weight; ``fans`` = (fan_in,
    fan_out). torch computes them on the PACKED (3d, d) in_proj_weight, so
    per-matrix q/k/v draws use the packed fans."""
    bound = (6.0 / (fans[0] + fans[1])) ** 0.5
    w.uniform_(-bound, bound, generator=generator)


class DecoderLayer(nn.Module):
    def __init__(self, cfg: DecoderConfig, *, generator=None, device=None):
        super().__init__()
        kw = {"generator": generator, "device": device}
        d, f = cfg.d_model, cfg.dim_feedforward
        self.norm1 = layer_norm_init(d, device)
        self.self_attn = MultiheadAttention(d, **kw)
        self.norm2 = layer_norm_init(d, device)
        self.cross_attn = MultiheadAttention(d, **kw)
        self.norm3 = layer_norm_init(d, device)
        self.linear1 = linear_init(d, f, **kw)
        self.linear2 = linear_init(f, d, **kw)
        with torch.no_grad():
            for attn in (self.self_attn, self.cross_attn):
                for name in ("wq", "wk", "wv", "wo"):
                    lin = getattr(attn, name)
                    _xavier_(lin.weight, (3 * d, d) if name != "wo" else (d, d), generator)
                    lin.bias.zero_()
            _xavier_(self.linear1.weight, (d, f), generator)
            _xavier_(self.linear2.weight, (f, d), generator)


class ObjDecoder(nn.Module):
    """Parameters of the object decoder (mirrors ``init_decoder_params``);
    the forward is ``decoder_forward``."""

    def __init__(self, cfg: DecoderConfig, *, generator=None, device=None):
        super().__init__()
        kw = {"generator": generator, "device": device}
        d = cfg.d_model

        def randn(*shape):
            return torch.randn(*shape, device=device, generator=generator)

        self.pre_norm = layer_norm_init(d, device)  # memory norm
        self.layers = nn.ModuleList(DecoderLayer(cfg, **kw) for _ in range(cfg.num_layers))
        self.decoder_norm = layer_norm_init(d, device)
        self.query_embed = nn.Parameter(randn(cfg.num_queries, d))
        self.class_embed = linear_init(d, cfg.num_classes + 1, **kw)
        self.bbox_mlp = nn.ModuleList(
            [linear_init(d, d, **kw), linear_init(d, d, **kw), linear_init(d, 4, **kw)]
        )
        self.proj = linear_init(cfg.feature_dim, d, bias=False, **kw)  # no bias
        with torch.no_grad():
            _xavier_(self.proj.weight, (cfg.feature_dim, d), generator)
        self.pos_embed = nn.Parameter(randn(1, cfg.patches_per_frame + 1, d) * 0.02)
        self.temporal_embed = nn.Parameter(randn(1, cfg.num_frames, d) * 0.02)
        self.txt_proj = linear_init(cfg.text_width, cfg.embed_dim, **kw)
        self.vid_proj = linear_init(cfg.text_width, cfg.embed_dim, **kw)
        self.obj_proj = nn.ModuleList([linear_init(d, d, **kw), linear_init(d, cfg.embed_dim, **kw)])
        if cfg.pred_traj:
            self.frame_index = nn.Parameter(randn(cfg.num_frames, d))
            self.frame_proj = linear_init(2 * d, d, **kw)
        if cfg.num_queries == 1:
            self.query_index = nn.Parameter(randn(cfg.n_decode, d))


def txt_proj(params: ObjDecoder, x):
    """ReLU -> Linear(text_width, embed_dim)."""
    return linear(params.txt_proj, torch.relu(x))


def vid_proj(params: ObjDecoder, x):
    return linear(params.vid_proj, x)


def obj_proj(params: ObjDecoder, x):
    """Linear -> ReLU -> Linear(d_model, embed_dim)."""
    return linear(params.obj_proj[1], torch.relu(linear(params.obj_proj[0], x)))


def _bbox_mlp(params: ObjDecoder, x):
    h = torch.relu(linear(params.bbox_mlp[0], x))
    h = torch.relu(linear(params.bbox_mlp[1], h))
    return linear(params.bbox_mlp[2], h)


def _decoder_layer(p: DecoderLayer, tgt, memory, query_pos, pos, cfg: DecoderConfig, generator=None,
                   return_attn: bool = False):
    """Pre-norm, self-attention-first layer; dropout where ``generator``.
    With ``return_attn`` -> (output, cross-attention map, self-attention
    map), both head-averaged and taken before dropout."""
    eps, rate = cfg.ln_eps, cfg.dropout
    attn_kw = {"generator": generator, "dropout_rate": rate, "return_probs": return_attn}
    t2 = layer_norm(p.norm1, tgt, eps)
    qk = t2 + query_pos
    sa = multi_head_attention(p.self_attn, qk, qk, t2, cfg.nhead, **attn_kw)
    sa, self_attn = sa if return_attn else (sa, None)
    tgt = tgt + dropout(generator, sa, rate)
    t2 = layer_norm(p.norm2, tgt, eps)
    ca = multi_head_attention(p.cross_attn, t2 + query_pos, memory + pos, memory, cfg.nhead, **attn_kw)
    ca, cross_attn = ca if return_attn else (ca, None)
    tgt = tgt + dropout(generator, ca, rate)
    t2 = layer_norm(p.norm3, tgt, eps)
    hidden = dropout(generator, torch.relu(linear(p.linear1, t2)), rate)
    out = tgt + dropout(generator, linear(p.linear2, hidden), rate)
    return (out, cross_attn, self_attn) if return_attn else out


@dataclass
class DecoderOutput:
    pred_logits: torch.Tensor  # (B', Q', C+1) last layer
    pred_boxes: torch.Tensor  # (B', Q', 4) last layer, sigmoid cxcywh
    aux_pred_logits: torch.Tensor  # (L-1, B', Q', C+1)
    aux_pred_boxes: torch.Tensor  # (L-1, B', Q', 4)
    hs: torch.Tensor  # (L, B, Q, D) normed intermediate states
    cross_attn: torch.Tensor | None = None  # (L, B, Q, T*N) head-averaged maps
    self_attn: torch.Tensor | None = None  # (L, B, Q, Q)


def decoder_forward(params: ObjDecoder, cfg: DecoderConfig, features, *, generator=None,
                    deterministic: bool = True, return_attn: bool = False) -> DecoderOutput:
    """Run the object decoder.

    Args:
        features: (B, T, N, feature_dim) backbone patch grid (CLS removed),
            T-major token order.
        generator, deterministic: train mode (dropout at ``cfg.dropout``,
            drawn from ``generator``) where ``deterministic`` is False and a
            generator is given; otherwise eval mode.
    Returns:
        DecoderOutput. When ``pred_traj`` and T == num_frames, box tensors
        are per frame: B' = B*T; otherwise B' = B and Q' = Q.
    """
    b, t, n, _ = features.shape
    d = cfg.d_model
    mem = linear(params.proj, features.reshape(b, t * n, cfg.feature_dim))

    # 3D pos embed: spatial table tiled over T + temporal repeat-interleave
    pos_spatial = params.pos_embed[:, 1:, :].repeat(1, t, 1)
    pos_temporal = params.temporal_embed[:, :t, :].repeat_interleave(n, dim=1)
    pos = (pos_spatial + pos_temporal).to(mem.dtype)  # (1, T*N, D)

    memory = layer_norm(params.pre_norm, mem, cfg.ln_eps)
    q = cfg.num_queries
    query_pos = params.query_embed.to(mem.dtype).expand(b, q, d)
    tgt = torch.zeros((b, q, d), dtype=mem.dtype, device=mem.device)

    gen = None if deterministic else generator
    hs, cross_maps, self_maps = [], [], []
    for layer in params.layers:
        tgt = _decoder_layer(layer, tgt, memory, query_pos, pos, cfg, gen, return_attn)
        if return_attn:
            tgt, ca, sa = tgt
            cross_maps.append(ca)
            self_maps.append(sa)
        hs.append(layer_norm(params.decoder_norm, tgt, cfg.ln_eps))
    hs = torch.stack(hs)  # (L, B, Q, D)
    num_layers = hs.shape[0]

    outputs_class = linear(params.class_embed, hs)  # (L, B, Q, C+1)

    if cfg.pred_traj and t == cfg.num_frames:
        frame_embed = params.frame_index[None, None, :, None, :]  # (1, 1, T, 1, D)
        if cfg.num_queries != 1:
            nq_out = q
            cond_embed = frame_embed
        else:
            nq_out = cfg.n_decode
            cond_embed = frame_embed + params.query_index[None, None, None, :, :]
        shape = (num_layers, b, t, nq_out, d)
        expand_hs = hs[:, :, None].expand(shape)
        cond = torch.cat([expand_hs, cond_embed.expand(shape)], dim=-1)
        cond_hs = linear(params.frame_proj, cond).reshape(num_layers, b * t, nq_out, d)
        # class logits broadcast over frames (and over n_decode when nq == 1)
        outputs_class = outputs_class[:, :, None].expand(
            num_layers, b, t, nq_out, cfg.num_classes + 1
        ).reshape(num_layers, b * t, nq_out, cfg.num_classes + 1)
    else:
        cond_hs = hs

    outputs_coord = torch.sigmoid(_bbox_mlp(params, cond_hs))
    return DecoderOutput(
        pred_logits=outputs_class[-1],
        pred_boxes=outputs_coord[-1],
        aux_pred_logits=outputs_class[:-1],
        aux_pred_boxes=outputs_coord[:-1],
        hs=hs,
        cross_attn=torch.stack(cross_maps) if return_attn else None,
        self_attn=torch.stack(self_maps) if return_attn else None,
    )


def position_embedding_sine(mask, num_pos_feats: int = 64, temperature: float = 10000.0,
                            normalize: bool = False, scale: float | None = None):
    """DETR's sine positional embedding over a padding mask (the
    reference's model/tfm_decoder.py:13-47; its main path learns a 3D
    position embedding instead, so this is off that path).

    mask: (B, H, W) bool, True = padded -> (B, 2*num_pos_feats, H, W) f32,
    channel first as the reference returns it."""
    if scale is not None and not normalize:
        raise ValueError("normalize should be True if scale is passed")
    if scale is None:
        scale = 2 * math.pi
    not_mask = (~mask).float()
    y_embed = not_mask.cumsum(dim=1)
    x_embed = not_mask.cumsum(dim=2)
    if normalize:
        eps = 1e-6
        y_embed = y_embed / (y_embed[:, -1:, :] + eps) * scale
        x_embed = x_embed / (x_embed[:, :, -1:] + eps) * scale
    dim_t = torch.arange(num_pos_feats, dtype=torch.float32, device=mask.device)
    dim_t = temperature ** (2 * (dim_t // 2) / num_pos_feats)
    pos_x = x_embed[..., None] / dim_t  # (B, H, W, F)
    pos_y = y_embed[..., None] / dim_t
    pos_x = torch.stack((pos_x[..., 0::2].sin(), pos_x[..., 1::2].cos()), dim=4).flatten(3)
    pos_y = torch.stack((pos_y[..., 0::2].sin(), pos_y[..., 1::2].cos()), dim=4).flatten(3)
    return torch.cat((pos_y, pos_x), dim=3).permute(0, 3, 1, 2)
