"""Device-side preprocessing of uint8 clips: eval transforms and the
train-time augmentation.

Counterpart of ``helping_hand_for_egocentric_videos_tpu/ops/preprocess.py``:

- ``resize_normalize``: Resize((res, res)) + Normalize.
- ``shortside_centercrop_normalize``: Resize(short side) -> CenterCrop ->
  Resize(res) -> Normalize.
- ``spatial_crops``: the multi-crop TTA of the EGTEA harness (1, 3 or 6
  crops after a shorter-side resize), and the ``center_plus_*`` crop
  helpers (slicing on a channel-last image).
- ``random_resized_crop_flip_jitter`` and ``transform_boxes``: the
  reference's train pipeline with augmentation on (section below).

Clips stay channel-last, (..., H, W, C). Resizes are bilinear with
``align_corners=False`` and no antialiasing: the reference resizes video
tensors, where torch interpolates without antialiasing.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

__all__ = [
    "LAVILA_MEAN",
    "LAVILA_STD",
    "apply_augment",
    "augment_rows",
    "center_plus_four_crops",
    "center_plus_twohori_crops",
    "random_resized_crop_flip_jitter",
    "resize_normalize",
    "sample_augment_params",
    "shortside_centercrop_normalize",
    "shortside_dims",
    "spatial_crops",
    "transform_boxes",
]

LAVILA_MEAN = (108.3272985 / 255, 116.7460125 / 255, 104.09373615 / 255)
LAVILA_STD = (68.5005327 / 255, 66.6321579 / 255, 70.32316305 / 255)


def shortside_dims(h: int, w: int, short: int) -> tuple[int, int]:
    """Target (nh, nw) for a shorter-side resize to ``short``. The long
    side truncates (torchvision Resize(int) geometry), so a fractional
    part >= 0.5 must not round up."""
    if h <= w:
        return short, max(int(w * short / h), short)
    return max(int(h * short / w), short), short


def _resize(x, size: tuple[int, int]):
    """(..., H, W, C) float -> (..., h, w, C), bilinear, no antialias."""
    *lead, h, w, c = x.shape
    y = x.reshape(-1, h, w, c).permute(0, 3, 1, 2)
    y = F.interpolate(y, size=size, mode="bilinear", align_corners=False, antialias=False)
    return y.permute(0, 2, 3, 1).reshape(*lead, *size, c)


def _channels(values, like):
    """A (C,) tensor of ``values`` made on ``like``'s device by fills, not
    by a copy from the host (which would wait for the device)."""
    return torch.stack([torch.full((), v, dtype=like.dtype, device=like.device) for v in values])


def _norm(x, mean, std):
    return (x - _channels(mean, x)) / _channels(std, x)


def resize_normalize(video_u8, res: int = 224, mean=LAVILA_MEAN, std=LAVILA_STD, dtype=torch.float32):
    """(..., H, W, C) uint8 -> (..., res, res, C) normalised float."""
    x = video_u8.to(dtype) / 255.0
    if tuple(video_u8.shape[-3:-1]) != (res, res):
        x = _resize(x, (res, res))
    return _norm(x, mean, std)


def shortside_centercrop_normalize(
    video_u8, short: int = 256, res: int = 224, mean=LAVILA_MEAN, std=LAVILA_STD, dtype=torch.float32
):
    """Resize(shorter side=short) -> CenterCrop(short) -> Resize(res) ->
    Normalize."""
    h, w = video_u8.shape[-3:-1]
    x = video_u8.to(dtype) / 255.0
    nh, nw = shortside_dims(h, w, short)
    x = _resize(x, (nh, nw))
    top, left = (nh - short) // 2, (nw - short) // 2
    x = x[..., top : top + short, left : left + short, :]
    if short != res:
        x = _resize(x, (res, res))
    return _norm(x, mean, std)


def spatial_crops(video_u8, crop: int = 224, num_crops: int = 1, short: int = 224, mean=LAVILA_MEAN,
                  std=LAVILA_STD, dtype=torch.float32):
    """LaviLa-style SpatialCrop: shorter-side resize to ``short``, then 1
    (center), 3 (left / center / right along the longer axis) or 6 (the 3
    crops, then the same 3 of the horizontally flipped clip) crops of
    ``crop`` x ``crop`` (the reference's data_loader/lavila_transforms.py:
    121-186). (..., H, W, C) uint8 -> (num_crops, ..., crop, crop, C)
    normalised float, crop-major."""
    h, w = video_u8.shape[-3:-1]
    x = video_u8.to(dtype) / 255.0
    nh, nw = shortside_dims(h, w, short)
    x = _resize(x, (nh, nw))
    if num_crops == 1:
        offs = [((nh - crop) // 2, (nw - crop) // 2)]
    elif num_crops in (3, 6):
        if nw >= nh:  # wide: left / center / right
            offs = [((nh - crop) // 2, 0), ((nh - crop) // 2, (nw - crop) // 2), ((nh - crop) // 2, nw - crop)]
        else:  # tall: top / center / bottom
            offs = [(0, (nw - crop) // 2), ((nh - crop) // 2, (nw - crop) // 2), (nh - crop, (nw - crop) // 2)]
    else:
        raise ValueError("num_crops must be 1, 3 or 6")
    sources = [x] if num_crops < 6 else [x, x.flip(-2)]
    crops = [src[..., t:t + crop, l:l + crop, :] for src in sources for t, l in offs]
    return _norm(torch.stack(crops), mean, std)


def _center_crop(x, ch: int, cw: int):
    h, w = x.shape[-3:-1]
    top, left = (h - ch) // 2, (w - cw) // 2
    return x[..., top:top + ch, left:left + cw, :]


def center_plus_four_crops(img, size, margin_h: int, margin_w: int):
    """Four tiled border crops + the center crop (the reference's
    utils/custom_transforms.py:18-83): (tl, tr, bl, br, center) of a
    channel-last (..., H, W, C) image. The borders tile the frame of
    ``margin`` thickness around the central (h, w) crop: tl and br are
    horizontal strips spanning margin + crop, tr and bl vertical ones."""
    ch, cw = (size, size) if isinstance(size, int) else tuple(size)
    h, w = img.shape[-3:-1]
    if cw > w or ch > h:
        raise ValueError(f"crop {size} larger than image {(h, w)}")
    if cw + margin_w > w or ch + margin_h > h:
        raise ValueError(f"margin {(margin_h, margin_w)} + crop {size} exceeds image {(h, w)}")
    x11 = (w - cw - 2 * margin_w) // 2
    x12 = x11 + margin_w
    x21 = x12 + cw
    y11 = (h - ch - 2 * margin_h) // 2
    y12 = y11 + margin_h
    y21 = y12 + ch

    def crop(top, left, hh, ww):
        return img[..., top:top + hh, left:left + ww, :]

    tl = crop(y11, x11, margin_h, margin_w + cw)
    tr = crop(y11, x21, margin_h + ch, margin_w)
    bl = crop(y12, x11, margin_h + ch, margin_w)
    br = crop(y21, x12, margin_h, margin_w + cw)
    return tl, tr, bl, br, _center_crop(img, ch, cw)


def center_plus_twohori_crops(img, size, margin_w: int):
    """Left / right border crops + the center crop (the reference's
    utils/custom_transforms.py:68-106): (left, right, center) of a
    channel-last image."""
    ch, cw = (size, size) if isinstance(size, int) else tuple(size)
    h, w = img.shape[-3:-1]
    if cw > w or ch > h:
        raise ValueError(f"crop {size} larger than image {(h, w)}")
    if cw + margin_w > w:
        raise ValueError(f"margin {margin_w} + crop {size} exceeds image width {w}")
    x11 = (w - cw - 2 * margin_w) // 2
    x21 = x11 + margin_w + cw
    y11 = (h - ch) // 2
    left = img[..., y11:y11 + ch, x11:x11 + margin_w, :]
    right = img[..., y11:y11 + ch, x21:x21 + margin_w, :]
    return left, right, _center_crop(img, ch, cw)


# --------------------------------------------------------------------------
# Train-time random augmentation: the reference's force_centercrop=False
# pipeline (data_loader/transforms.py:64-69): RandomResizedCropVideo(res,
# scale) -> RandomHorizontalFlipVideo() -> ColorJitter(brightness,
# saturation, hue) -> NormalizeVideo. One crop rectangle, flip and set of
# jitter factors a clip, shared by its frames. Its shipped command turns it
# off (force_centercrop=True), so the default train path stays
# ``resize_normalize``.
#
# Drawing the parameters is apart from applying them:
# ``sample_augment_params`` draws every random number of a batch from one
# ``torch.Generator`` (on the video's device, so nothing waits for the
# host), and ``apply_augment`` is a pure function of the clip and those
# parameters. The JAX package draws with ``jax.random`` keys, whose streams
# torch cannot reproduce; the two packages agree on the application (given
# the same parameters) and on the distributions of the draws.
#
# As in the JAX package, two reference quirks are handled, not copied: the
# jitter works per clip on the channel axis (upstream, ColorJitter sees
# time at dim -3 and only brightness works), and ``transform_boxes`` keeps
# the box targets on the pixels (upstream, the random crop leaves them
# stale).
# --------------------------------------------------------------------------

_JITTER_OPS = ("brightness", "saturation", "hue")


def _uniform(generator, n: int, lo: float, hi: float, device):
    return torch.rand(n, generator=generator, device=device) * (hi - lo) + lo


def sample_augment_params(generator, b: int, h: int, w: int, *, scale=(0.5, 1.0), ratio=(3.0 / 4.0, 4.0 / 3.0),
                          flip_prob: float = 0.5, brightness: float = 0.0, saturation: float = 0.0,
                          hue: float = 0.0, device=None) -> dict:
    """Draw the augmentation of ``b`` clips of ``h`` x ``w`` frames.

    The crop is torchvision's RandomResizedCrop.get_params a clip: 10
    candidates of area ``scale`` x the frame's and log-uniform aspect in
    ``ratio``, the first that fits wins, else the frame's aspect clamped
    into ``ratio``, centred; the position is uniform over the places the
    crop fits. Each jitter factor is uniform: brightness and saturation in
    [max(0, 1 - f), 1 + f], hue in [-f, f]; an op whose strength is 0 is
    off. The enabled ops run in a uniformly random order a clip.

    Returns ``top``, ``left``, ``crop_h``, ``crop_w`` (int64 (b,)), ``flip``
    (bool (b,)), ``src_h``, ``src_w`` (ints), ``ops`` (the enabled ops'
    names), a factor (f32 (b,)) for each enabled op under its name, and
    ``order`` (int64 (b, len(ops)): clip i applies ``ops[order[i, 0]]``
    first). Every draw is made whatever is enabled, so turning an op on
    leaves the other draws as they were.
    """
    dev = torch.device(device) if device is not None else generator.device
    area = float(h * w)
    ta = _uniform(generator, b * 10, scale[0], scale[1], dev).reshape(b, 10) * area
    log_r = _uniform(generator, b * 10, math.log(ratio[0]), math.log(ratio[1]), dev).reshape(b, 10)
    ar = torch.exp(log_r)
    cw = torch.round(torch.sqrt(ta * ar)).long()
    ch = torch.round(torch.sqrt(ta / ar)).long()
    valid = (cw > 0) & (cw <= w) & (ch > 0) & (ch <= h)
    first = valid.int().argmax(dim=1, keepdim=True)  # the first candidate that fits
    in_ratio = w / h  # the fallback: the whole frame, its aspect clamped into ratio
    if in_ratio < ratio[0]:
        fw, fh = w, int(round(w / ratio[0]))
    elif in_ratio > ratio[1]:
        fh, fw = h, int(round(h * ratio[1]))
    else:
        fw, fh = w, h
    any_valid = valid.any(dim=1)
    cw = torch.where(any_valid, cw.gather(1, first)[:, 0], fw)
    ch = torch.where(any_valid, ch.gather(1, first)[:, 0], fh)
    u_top = torch.rand(b, generator=generator, device=dev)
    u_left = torch.rand(b, generator=generator, device=dev)
    top = torch.where(any_valid, torch.floor(u_top * (h - ch + 1)).long(), (h - ch) // 2)
    left = torch.where(any_valid, torch.floor(u_left * (w - cw + 1)).long(), (w - cw) // 2)
    flip = torch.rand(b, generator=generator, device=dev) < flip_prob
    strength = {"brightness": brightness, "saturation": saturation, "hue": hue}
    ranges = {"brightness": (max(0.0, 1.0 - brightness), 1.0 + brightness),
              "saturation": (max(0.0, 1.0 - saturation), 1.0 + saturation), "hue": (-hue, hue)}
    factors = {op: _uniform(generator, b, *ranges[op], dev) for op in _JITTER_OPS}
    keys = torch.rand(b, len(_JITTER_OPS), generator=generator, device=dev)
    ops = tuple(op for op in _JITTER_OPS if strength[op] > 0)
    order = keys[:, : len(ops)].argsort(dim=1)  # a uniform permutation a clip
    params = {"top": top, "left": left, "crop_h": ch, "crop_w": cw, "flip": flip, "src_h": h, "src_w": w,
              "ops": ops, "order": order}
    params.update({op: factors[op] for op in ops})
    return params


def augment_rows(params: dict, rows: slice) -> dict:
    """The parameters of the clips ``rows`` of a batch (a rank's share of
    the global batch's draw)."""
    return {k: v[rows] if isinstance(v, torch.Tensor) else v for k, v in params.items()}


def _axis_coords(n_src: int, off, size, res: int):
    """Bilinear source coordinates along one axis for crops at ``off`` of
    ``size`` (b,) -> (c0, c1, frac), each (b, res). Coordinates are
    clamped to the crop's own edges, so no pixel outside it is read."""
    pos = torch.arange(res, dtype=torch.float32, device=size.device) + 0.5
    c = pos * (size.float() / res)[:, None] - 0.5
    c = torch.minimum(torch.maximum(c, torch.zeros_like(c)), (size - 1).float()[:, None]) + off.float()[:, None]
    c0 = torch.floor(c).long()
    frac = c - c0
    c1 = torch.minimum(c0 + 1, (off + size - 1)[:, None])
    return c0.clamp(0, n_src - 1), c1.clamp(0, n_src - 1), frac


def _crop_resize(x, top, left, ch, cw, res: int):
    """(B, T, H, W, C) float -> (B, T, res, res, C): each clip's crop
    rectangle resized bilinearly (align_corners=False, no antialias), as
    torch's crop then ``interpolate`` of a video tensor."""
    b, t, h, w, c = x.shape
    y0, y1, fy = _axis_coords(h, top, ch, res)

    def rows(idx):
        return x.gather(2, idx[:, None, :, None, None].expand(b, t, res, w, c))

    fy = fy[:, None, :, None, None]
    x = rows(y0) * (1.0 - fy) + rows(y1) * fy
    x0, x1, fx = _axis_coords(w, left, cw, res)

    def cols(idx):
        return x.gather(3, idx[:, None, None, :, None].expand(b, t, res, res, c))

    fx = fx[:, None, None, :, None]
    return cols(x0) * (1.0 - fx) + cols(x1) * fx


def _per_clip(f, x):
    """A (B,) factor shaped to broadcast over x's (B, ...) dims."""
    return f.to(x.dtype).reshape(-1, *([1] * (x.dim() - 1)))


def _adjust_brightness(x, f):
    return (x * _per_clip(f, x)).clamp(0.0, 1.0)


def _adjust_saturation(x, f):
    # torchvision's _blend(img, grayscale(img), f), Rec.601 luma weights
    lum = _channels((0.2989, 0.587, 0.114), x)
    gray = (x * lum).sum(-1, keepdim=True)
    return (gray + _per_clip(f, x) * (x - gray)).clamp(0.0, 1.0)


def _adjust_hue(x, f):
    """Shift the hue by ``f`` (a turn is 1): RGB -> HSV -> RGB in f32."""
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    mx = x.amax(-1)
    mn = x.amin(-1)
    d = mx - mn
    safe = torch.where(d > 0, d, 1.0)
    hue = torch.where(mx == r, torch.remainder((g - b) / safe, 6.0),
                      torch.where(mx == g, (b - r) / safe + 2.0, (r - g) / safe + 4.0))
    hue = torch.where(d > 0, hue / 6.0, 0.0)
    hue = torch.remainder(hue + _per_clip(f, hue), 1.0)
    sat = torch.where(mx > 0, d / torch.where(mx > 0, mx, 1.0), 0.0)
    k = hue * 6.0
    i = torch.floor(k)
    frac = k - i
    p = mx * (1.0 - sat)
    q = mx * (1.0 - sat * frac)
    t = mx * (1.0 - sat * (1.0 - frac))
    i6 = torch.remainder(i.long(), 6)

    def select(choices, default):
        out = default
        for sector in reversed(range(5)):
            out = torch.where(i6 == sector, choices[sector], out)
        return out

    rgb = torch.stack([select([mx, q, p, p, t], mx), select([t, mx, mx, q, p], p),
                       select([p, p, t, mx, mx], q)], dim=-1)
    return rgb.clamp(0.0, 1.0)


_ADJUST = {"brightness": _adjust_brightness, "saturation": _adjust_saturation, "hue": _adjust_hue}


def apply_augment(video, params: dict, res: int = 224, mean=LAVILA_MEAN, std=LAVILA_STD, dtype=torch.float32):
    """(B, T, H, W, C) uint8 (or [0, 1] float) and ``params`` (as
    ``sample_augment_params`` returns, for these B clips) -> (B, T, res,
    res, C) normalised float: crop and resize, flip, jitter in each clip's
    order, normalise. A pure function of its inputs."""
    x = video.to(dtype) / 255.0 if video.dtype == torch.uint8 else video.to(dtype)
    x = _crop_resize(x, params["top"], params["left"], params["crop_h"], params["crop_w"], res)
    x = torch.where(params["flip"][:, None, None, None, None], x.flip(-2), x)
    ops = params["ops"]
    if len(ops) == 1:
        x = _ADJUST[ops[0]](x, params[ops[0]])
    elif ops:
        # op ``pos`` of each clip's order: every enabled op on the whole
        # batch, each clip keeping the one its order names
        for pos in range(len(ops)):
            pick = params["order"][:, pos]
            out = x
            for i, op in enumerate(ops):
                out = torch.where((pick == i)[:, None, None, None, None], _ADJUST[op](x, params[op]), out)
            x = out
    return _norm(x, mean, std)


def random_resized_crop_flip_jitter(generator, video, res: int = 224, scale=(0.5, 1.0),
                                    ratio=(3.0 / 4.0, 4.0 / 3.0), flip_prob: float = 0.5, brightness: float = 0.0,
                                    saturation: float = 0.0, hue: float = 0.0, mean=LAVILA_MEAN, std=LAVILA_STD,
                                    dtype=torch.float32):
    """Train augmentation of (B, T, H, W, C) uint8 (or [0, 1] float) clips
    -> ((B, T, res, res, C) normalised float, params): the parameters drawn
    from ``generator`` (``sample_augment_params``), then applied
    (``apply_augment``). ``params`` feeds ``transform_boxes``. Defaults as
    data_loader/transforms.py:40-41 (scale (0.5, 1.0), jitter off)."""
    b, _, h, w, _ = video.shape
    params = sample_augment_params(generator, b, h, w, scale=scale, ratio=ratio, flip_prob=flip_prob,
                                   brightness=brightness, saturation=saturation, hue=hue, device=video.device)
    return apply_augment(video, params, res, mean, std, dtype), params


def transform_boxes(boxes, params: dict, res: int = 224, coords_res: int = 224):
    """Map xyxy boxes given in the ``coords_res`` x ``coords_res`` squashed
    full frame (the dataset's contract, data/egoclip.py::_scale_boxes) into
    the augmented frame of ``params``.

    boxes: (B, ..., 4) pixel xyxy; zero rows are absent and stay zero.
    Boxes are clipped to the crop; one left with no area is zeroed.
    """
    b = boxes.shape[0]
    lead = (b,) + (1,) * (boxes.dim() - 2)
    fh = params["crop_h"].to(boxes.dtype).reshape(lead)
    fw = params["crop_w"].to(boxes.dtype).reshape(lead)
    top = params["top"].to(boxes.dtype).reshape(lead)
    left = params["left"].to(boxes.dtype).reshape(lead)
    flip = params["flip"].reshape(lead)
    sx = params["src_w"] / coords_res
    sy = params["src_h"] / coords_res

    x0, y0, x1, y1 = (boxes[..., i] for i in range(4))
    nx0 = (x0 * sx - left) * (res / fw)
    nx1 = (x1 * sx - left) * (res / fw)
    ny0 = (y0 * sy - top) * (res / fh)
    ny1 = (y1 * sy - top) * (res / fh)
    fx0 = torch.where(flip, res - nx1, nx0)
    fx1 = torch.where(flip, res - nx0, nx1)
    out = torch.stack([fx0, ny0, fx1, ny1], dim=-1)
    out = torch.minimum(torch.maximum(out, torch.zeros_like(out)), torch.full_like(out, float(res)))
    present = (boxes != 0).any(-1, keepdim=True)
    has_area = (out[..., 2:3] - out[..., 0:1] > 1e-3) & (out[..., 3:4] - out[..., 1:2] > 1e-3)
    return torch.where(present & has_area, out, 0.0)
