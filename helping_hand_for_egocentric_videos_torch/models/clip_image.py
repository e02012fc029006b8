"""OpenAI CLIP image towers (ViT and ModifiedResNet) in PyTorch.

Counterpart of ``helping_hand_for_egocentric_videos_tpu/models/clip_image.py``
(the reference's model/openai_model.py:21-273). The LaviLa pipeline only
ever consumes the ViT's weights (through the TimeSformer bootstrap,
``weights.convert_openai_clip_checkpoint``); these towers complete the CLIP
model zoo (``models/zoo.py``), which builds either one from a raw OpenAI
state dict with ``build_model``'s architecture sniffing
(openai_model.py:444-464).

- ``ClipVisionTransformer`` (openai_model.py:235-273): a stride-P conv
  patchifier, the class and positional embeddings, ``ln_pre``, pre-norm
  residual attention blocks with QuickGELU (the text tower's
  ``TextBlock``), ``ln_post`` on CLS and an optional projection;
  ``cls_at_last=False`` returns the patch feature map.
- ``ClipResNet`` (openai_model.py:105-165): a 3-conv stem and an avgpool,
  anti-aliased strided bottlenecks (the avgpool before the stride-1
  ``conv3`` and in the downsample branch, openai_model.py:21-66), and
  ``AttentionPool2d`` (openai_model.py:69-102), one query over [mean |
  tokens] with separate q/k/v projections and its softmax in f32.

Images come in NHWC, as in the JAX package, so ``encode(params, cfg,
images)`` reads the same in both; the towers compute in NCHW with
``F.conv2d``. BatchNorm runs in inference mode from the running
statistics, folded to one scale and shift (these towers are frozen
weight sources). Parameter names follow the JAX trees (``models/bridge.py``
loads those); the converters map the OpenAI state dict onto them.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from .clip_text import TextBlock, TextConfig, _block_forward
from .layers import layer_norm, layer_norm_init, linear, linear_init
from .weights import _assign, _lin, _resblock

__all__ = [
    "ClipVitConfig",
    "ClipResNetConfig",
    "ClipVisionTransformer",
    "ClipResNet",
    "init_clip_vit_params",
    "init_clip_resnet_params",
    "clip_vit_encode",
    "clip_resnet_encode",
    "count_resblocks",
    "convert_openai_vit_tower",
    "convert_openai_resnet_tower",
    "clip_image_tower_from_state_dict",
]


def _randn(shape, generator, device):
    return torch.randn(*shape, generator=generator, device=device)


# ---------------------------------------------------------------- ViT ----


@dataclass(frozen=True)
class ClipVitConfig:
    input_resolution: int = 224
    patch_size: int = 14
    width: int = 1024
    layers: int = 24
    heads: int = 16
    output_dim: int = 768
    ln_eps: float = 1e-5

    @property
    def grid(self) -> int:
        return self.input_resolution // self.patch_size


class ClipVisionTransformer(nn.Module):
    """Parameters of the CLIP ViT (mirrors ``init_clip_vit_params``); the
    forward is ``clip_vit_encode``."""

    def __init__(self, cfg: ClipVitConfig, *, generator=None, device=None):
        super().__init__()
        scale = cfg.width**-0.5
        tcfg = TextConfig(width=cfg.width, heads=cfg.heads, layers=cfg.layers)
        p = cfg.patch_size
        self.conv1 = nn.Conv2d(3, cfg.width, p, stride=p, bias=False, device=device)
        with torch.no_grad():
            self.conv1.weight.normal_(0.0, scale, generator=generator)
        self.class_embedding = nn.Parameter(_randn((cfg.width,), generator, device) * scale)
        self.positional_embedding = nn.Parameter(_randn((cfg.grid**2 + 1, cfg.width), generator, device) * scale)
        self.ln_pre = layer_norm_init(cfg.width, device)
        self.blocks = nn.ModuleList(TextBlock(tcfg, generator=generator, device=device) for _ in range(cfg.layers))
        self.ln_post = layer_norm_init(cfg.width, device)
        self.proj = nn.Parameter(_randn((cfg.width, cfg.output_dim), generator, device) * scale)


def init_clip_vit_params(cfg: ClipVitConfig, *, generator=None, device=None) -> ClipVisionTransformer:
    """Seeded random ViT parameters (the JAX initialiser's distributions)."""
    return ClipVisionTransformer(cfg, generator=generator, device=device)


def clip_vit_encode(params: ClipVisionTransformer, cfg: ClipVitConfig, images, *, apply_project: bool = True,
                    cls_at_last: bool = True, dtype=torch.float32):
    """images (B, H, W, 3) -> the CLS embedding (B, output_dim), or (B,
    width) without ``apply_project``; with ``cls_at_last=False`` the patch
    feature map (B, grid^2, width) (openai_model.py:252-273)."""
    b = images.shape[0]
    x = F.conv2d(images.to(dtype).permute(0, 3, 1, 2), params.conv1.weight.to(dtype), stride=cfg.patch_size)
    x = x.flatten(2).transpose(1, 2)  # (B, grid^2, width)
    cls = params.class_embedding.to(dtype).expand(b, 1, cfg.width)
    x = torch.cat([cls, x], dim=1) + params.positional_embedding.to(dtype)
    x = layer_norm(params.ln_pre, x, cfg.ln_eps)
    for blk in params.blocks:
        x = _block_forward(blk, x, None, cfg.heads, cfg.ln_eps)
    if not cls_at_last:
        return x[:, 1:, :]
    x = layer_norm(params.ln_post, x[:, 0, :], cfg.ln_eps)
    if apply_project:
        x = x @ params.proj.to(dtype)
    return x


# ---------------------------------------------------------- ResNet ----


@dataclass(frozen=True)
class ClipResNetConfig:
    layers: tuple = (3, 4, 6, 3)  # RN50
    output_dim: int = 1024
    heads: int = 32
    input_resolution: int = 224
    width: int = 64


def _conv_init(cin: int, cout: int, k: int, generator, device) -> nn.Conv2d:
    """A bias-free conv container, He-normal: N(0, 2 / fan_in)."""
    conv = nn.Conv2d(cin, cout, k, bias=False, device=device)
    with torch.no_grad():
        conv.weight.normal_(0.0, (2.0 / (k * k * cin)) ** 0.5, generator=generator)
    return conv


class BatchNorm(nn.Module):
    """An inference-mode BatchNorm's parameters and running statistics
    (weight 1, bias 0, mean 0, var 1); the forward is ``_bn``."""

    def __init__(self, c: int, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c, device=device))
        self.bias = nn.Parameter(torch.zeros(c, device=device))
        self.register_buffer("running_mean", torch.zeros(c, device=device))
        self.register_buffer("running_var", torch.ones(c, device=device))


def _conv(p: nn.Conv2d, x, stride: int = 1):
    """torch ``Conv2d(padding=k // 2)`` geometry (the reference's)."""
    k = p.weight.shape[-1]
    return F.conv2d(x, p.weight.to(x.dtype), stride=stride, padding=k // 2)


def _bn(p: BatchNorm, x, eps: float = 1e-5):
    scale = p.weight * torch.rsqrt(p.running_var + eps)
    shift = p.bias - p.running_mean * scale
    return x * scale.to(x.dtype)[:, None, None] + shift.to(x.dtype)[:, None, None]


class Downsample(nn.Module):
    def __init__(self, cin: int, cout: int, *, generator=None, device=None):
        super().__init__()
        self.conv = _conv_init(cin, cout, 1, generator, device)
        self.bn = BatchNorm(cout, device)


class Bottleneck(nn.Module):
    """The anti-aliased bottleneck's parameters; ``stride`` is its
    avgpool's window (1: none)."""

    def __init__(self, cin: int, planes: int, stride: int, *, generator=None, device=None):
        super().__init__()
        self.stride = stride
        self.conv1 = _conv_init(cin, planes, 1, generator, device)
        self.bn1 = BatchNorm(planes, device)
        self.conv2 = _conv_init(planes, planes, 3, generator, device)
        self.bn2 = BatchNorm(planes, device)
        self.conv3 = _conv_init(planes, planes * 4, 1, generator, device)
        self.bn3 = BatchNorm(planes * 4, device)
        self.downsample = None
        if stride > 1 or cin != planes * 4:
            self.downsample = Downsample(cin, planes * 4, generator=generator, device=device)


def _bottleneck(p: Bottleneck, x):
    """The avgpool after conv2, and before the downsample conv, when
    stride > 1 (openai_model.py:24-66)."""
    out = torch.relu(_bn(p.bn1, _conv(p.conv1, x)))
    out = torch.relu(_bn(p.bn2, _conv(p.conv2, out)))
    if p.stride > 1:
        out = F.avg_pool2d(out, p.stride)
    out = _bn(p.bn3, _conv(p.conv3, out))
    identity = x
    if p.downsample is not None:
        if p.stride > 1:
            identity = F.avg_pool2d(identity, p.stride)
        identity = _bn(p.downsample.bn, _conv(p.downsample.conv, identity))
    return torch.relu(out + identity)


class AttentionPool2d(nn.Module):
    def __init__(self, spacial: int, embed_dim: int, output_dim: int, *, generator=None, device=None):
        super().__init__()
        kw = {"generator": generator, "device": device}
        self.positional_embedding = nn.Parameter(
            _randn((spacial**2 + 1, embed_dim), generator, device) * embed_dim**-0.5)
        self.q = linear_init(embed_dim, embed_dim, **kw)
        self.k = linear_init(embed_dim, embed_dim, **kw)
        self.v = linear_init(embed_dim, embed_dim, **kw)
        self.c = linear_init(embed_dim, output_dim, **kw)


class ClipResNet(nn.Module):
    """Parameters of the ModifiedResNet (mirrors ``init_clip_resnet_params``);
    the forward is ``clip_resnet_encode``."""

    def __init__(self, cfg: ClipResNetConfig, *, generator=None, device=None):
        super().__init__()
        kw = {"generator": generator, "device": device}
        w = cfg.width
        self.conv1 = _conv_init(3, w // 2, 3, generator, device)
        self.bn1 = BatchNorm(w // 2, device)
        self.conv2 = _conv_init(w // 2, w // 2, 3, generator, device)
        self.bn2 = BatchNorm(w // 2, device)
        self.conv3 = _conv_init(w // 2, w, 3, generator, device)
        self.bn3 = BatchNorm(w, device)
        cin = w
        for li, (blocks, planes) in enumerate(zip(cfg.layers, (w, w * 2, w * 4, w * 8)), start=1):
            layer = []
            for bi in range(blocks):
                layer.append(Bottleneck(cin, planes, 2 if (bi == 0 and li > 1) else 1, **kw))
                cin = planes * 4
            setattr(self, f"layer{li}", nn.ModuleList(layer))
        self.attnpool = AttentionPool2d(cfg.input_resolution // 32, w * 32, cfg.output_dim, **kw)


def init_clip_resnet_params(cfg: ClipResNetConfig, *, generator=None, device=None) -> ClipResNet:
    """Seeded random ResNet parameters (the JAX initialiser's distributions)."""
    return ClipResNet(cfg, generator=generator, device=device)


def _attention_pool(p: AttentionPool2d, x, heads: int):
    """One query over [mean | tokens] (openai_model.py:69-102).
    x: (B, HW, C) -> (B, output_dim)."""
    b, n, c = x.shape
    x = torch.cat([x.mean(dim=1, keepdim=True), x], dim=1)  # (B, 1+HW, C)
    x = x + p.positional_embedding.to(x.dtype)
    dh = c // heads
    q = linear(p.q, x[:, :1]).reshape(b, 1, heads, dh).transpose(1, 2) * dh**-0.5
    k = linear(p.k, x).reshape(b, n + 1, heads, dh).transpose(1, 2)
    v = linear(p.v, x).reshape(b, n + 1, heads, dh).transpose(1, 2)
    probs = torch.softmax((q @ k.transpose(-1, -2)).float(), dim=-1).to(x.dtype)
    out = (probs @ v).transpose(1, 2).reshape(b, 1, c)
    return linear(p.c, out)[:, 0]


def clip_resnet_encode(params: ClipResNet, cfg: ClipResNetConfig, images, *, dtype=torch.float32):
    """images (B, H, W, 3) -> the pooled embedding (B, output_dim)
    (openai_model.py:149-165)."""
    x = images.to(dtype).permute(0, 3, 1, 2)
    x = torch.relu(_bn(params.bn1, _conv(params.conv1, x, stride=2)))
    x = torch.relu(_bn(params.bn2, _conv(params.conv2, x)))
    x = torch.relu(_bn(params.bn3, _conv(params.conv3, x)))
    x = F.avg_pool2d(x, 2)
    for li in range(1, 5):
        for blk in getattr(params, f"layer{li}"):
            x = _bottleneck(blk, x)
    return _attention_pool(params.attnpool, x.flatten(2).transpose(1, 2), cfg.heads)


# ------------------------------------------------- torch converters ----


def count_resblocks(sd: dict, prefix: str = "transformer.resblocks") -> int:
    """Number of ResidualAttentionBlocks under ``prefix`` in a state dict
    (the build_model sniffing pattern, openai_model.py:449-471)."""
    depth = prefix.count(".") + 1
    return len({k.split(".")[depth] for k in sd if k.startswith(prefix + ".")})


def _f32(sd: dict, prefix: str) -> dict:
    """The entries under ``prefix`` (stripped), as f32 CPU tensors."""
    return {k[len(prefix):]: torch.as_tensor(v).float() for k, v in sd.items() if k.startswith(prefix)}


def convert_openai_vit_tower(sd: dict, prefix: str = "visual.") -> tuple[ClipVitConfig, ClipVisionTransformer]:
    """An OpenAI CLIP ViT visual state dict -> (ClipVitConfig, the tower on
    the CPU); its heads are 64 wide, as ``build_model`` assumes."""
    sd = _f32(sd, prefix)
    width, _, p, _ = sd["conv1.weight"].shape
    n_layers = count_resblocks(sd)
    grid = int(round((sd["positional_embedding"].shape[0] - 1) ** 0.5))
    cfg = ClipVitConfig(input_resolution=p * grid, patch_size=p, width=width, layers=n_layers, heads=width // 64,
                        output_dim=int(sd["proj"].shape[1]))
    out = {name: sd[name] for name in ("conv1.weight", "class_embedding", "positional_embedding", "proj")}
    _lin(sd, "ln_pre", "ln_pre", out)
    _lin(sd, "ln_post", "ln_post", out)
    for i in range(n_layers):
        _resblock(sd, f"transformer.resblocks.{i}", f"blocks.{i}", out)
    return cfg, _assign(ClipVisionTransformer(cfg, device="meta"), out)


def _bn_t(sd, src: str, dst: str, out: dict):
    for f in ("weight", "bias", "running_mean", "running_var"):
        out[f"{dst}.{f}"] = sd[f"{src}.{f}"]


def convert_openai_resnet_tower(sd: dict, prefix: str = "visual.") -> tuple[ClipResNetConfig, ClipResNet]:
    """An OpenAI CLIP ModifiedResNet visual state dict -> (ClipResNetConfig,
    the tower on the CPU)."""
    sd = _f32(sd, prefix)
    counts = tuple(len({k.split(".")[1] for k in sd if k.startswith(f"layer{b}.")}) for b in (1, 2, 3, 4))
    width = sd["layer1.0.conv1.weight"].shape[0]
    out_res = int(round((sd["attnpool.positional_embedding"].shape[0] - 1) ** 0.5))
    cfg = ClipResNetConfig(layers=counts, output_dim=int(sd["attnpool.c_proj.weight"].shape[0]),
                           heads=width * 32 // 64, input_resolution=out_res * 32, width=width)
    out = {}
    for i in (1, 2, 3):
        out[f"conv{i}.weight"] = sd[f"conv{i}.weight"]
        _bn_t(sd, f"bn{i}", f"bn{i}", out)
    for li in range(1, 5):
        for bi in range(counts[li - 1]):
            name = f"layer{li}.{bi}"
            for i in (1, 2, 3):
                out[f"{name}.conv{i}.weight"] = sd[f"{name}.conv{i}.weight"]
                _bn_t(sd, f"{name}.bn{i}", f"{name}.bn{i}", out)
            if f"{name}.downsample.0.weight" in sd:
                out[f"{name}.downsample.conv.weight"] = sd[f"{name}.downsample.0.weight"]
                _bn_t(sd, f"{name}.downsample.1", f"{name}.downsample.bn", out)
    out["attnpool.positional_embedding"] = sd["attnpool.positional_embedding"]
    for name in ("q", "k", "v", "c"):
        _lin(sd, f"attnpool.{name}_proj", f"attnpool.{name}", out)
    return cfg, _assign(ClipResNet(cfg, device="meta"), out)


def clip_image_tower_from_state_dict(sd: dict):
    """build_model-style sniffing (openai_model.py:444-464): a full CLIP
    state dict -> ('vit' | 'resnet', cfg, tower, encode function)."""
    if "visual.proj" in sd:
        cfg, tower = convert_openai_vit_tower(sd)
        return "vit", cfg, tower, clip_vit_encode
    cfg, tower = convert_openai_resnet_tower(sd)
    return "resnet", cfg, tower, clip_resnet_encode
