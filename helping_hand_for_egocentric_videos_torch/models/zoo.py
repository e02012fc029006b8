"""OpenAI CLIP checkpoint zoo: named resolution, integrity check, load.

Counterpart of ``helping_hand_for_egocentric_videos_tpu/models/zoo.py``:
the zero-egress counterpart of the reference's downloader
(model/openai_clip.py:40-96,104-198): the known model names map to the
published URLs whose path component carries the official SHA256, so a
*locally provided* file (fetched once on any connected machine, or from a
shared artifact store) can be resolved by name and integrity-verified
exactly like the reference verifies its downloads. No network I/O happens
here by design — ``resolve`` searches the cache directories instead of
downloading; ``load_clip`` then converts the torch checkpoint into the
port's towers (models/clip_image.py + models/clip_text.py) with
``build_model``-style architecture sniffing (openai_model.py:444-485).

``clip_preprocess`` is the reference's eval transform (_transform,
openai_clip.py:89-96): an antialiased bicubic shorter-side resize, a
center crop, the CLIP channel statistics, on the input's device.
"""

from __future__ import annotations

import hashlib
import os

import numpy as np
import torch
import torch.nn.functional as F

__all__ = [
    "available_models",
    "resolve",
    "load_clip",
    "clip_preprocess",
    "CLIP_MEAN",
    "CLIP_STD",
]

# name -> published URL; the second-to-last path component is the official
# SHA256 of the file (openai_clip.py:40-51)
_MODELS = {
    "RN50": "https://openaipublic.azureedge.net/clip/models/afeb0e10f9e5a86da6080e35cf09123aca3b358a0c3e3b6c78a7b63bc04b6762/RN50.pt",
    "RN101": "https://openaipublic.azureedge.net/clip/models/8fa8567bab74a42d41c5915025a8e4538c3bdbe8804a470a72f30b0d94fab599/RN101.pt",
    "RN50x4": "https://openaipublic.azureedge.net/clip/models/7e526bd135e493cef0776de27d5f42653e6b4c8bf9e0f653bb11773263205fdd/RN50x4.pt",
    "RN50x16": "https://openaipublic.azureedge.net/clip/models/52378b407f34354e150460fe41077663dd5b39c54cd0bfd2b27167a4a06ec9aa/RN50x16.pt",
    "RN50x64": "https://openaipublic.azureedge.net/clip/models/be1cfb55d75a9666199fb2206c106743da0f6468c9d327f3e0d0a543a9919d9c/RN50x64.pt",
    "ViT-B/32": "https://openaipublic.azureedge.net/clip/models/40d365715913c9da98579312b702a82c18be219cc2a73407c4526f58eba950af/ViT-B-32.pt",
    "ViT-B/16": "https://openaipublic.azureedge.net/clip/models/5806e77cd80f8b59890b7e101eabd078d9fb84e6937f9e85e4ecb61988df416f/ViT-B-16.pt",
    "ViT-L/14": "https://openaipublic.azureedge.net/clip/models/b8cca3fd41ae0c99ba7e8951adf17d267cdb84cd88be6f7c2e0eca1737a03836/ViT-L-14.pt",
    "ViT-L/14@336px": "https://openaipublic.azureedge.net/clip/models/3035c92b350959924f9f00213499208652fc7ea050643e8b385c2dac08641f02/ViT-L-14-336px.pt",
}

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


def available_models() -> list[str]:
    """Model names this zoo knows how to resolve (openai_clip.py:99-101)."""
    return list(_MODELS)


def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def resolve(name_or_path: str, cache_dir: str | None = None, verify: bool = True) -> str:
    """Resolve a model name to a local checkpoint file, verifying SHA256.

    Search order: an explicit path as-is; ``cache_dir``; $HH_CLIP_CACHE;
    ~/.cache/clip (the reference's default root). Raises with the
    published URL if the file is absent — fetch it on a connected machine
    and drop it in any of those locations.
    """
    if os.path.isfile(name_or_path):
        return name_or_path
    if name_or_path not in _MODELS:
        raise FileNotFoundError(
            f"{name_or_path!r} is neither a file nor a known model; "
            f"known: {available_models()}"
        )
    url = _MODELS[name_or_path]
    fname = os.path.basename(url)
    expected = url.split("/")[-2]
    roots = [
        d
        for d in (
            cache_dir,
            os.environ.get("HH_CLIP_CACHE"),
            os.path.expanduser("~/.cache/clip"),
        )
        if d
    ]
    for root in roots:
        cand = os.path.join(root, fname)
        if os.path.isfile(cand):
            if verify and _sha256(cand) != expected:
                raise RuntimeError(
                    f"{cand} exists but its SHA256 does not match the "
                    f"published checksum {expected}"
                )
            return cand
    raise FileNotFoundError(
        f"checkpoint for {name_or_path!r} not found in {roots}; this "
        f"environment has no egress — fetch {url} elsewhere and place it "
        f"in one of those directories (sha256={expected})"
    )


def load_clip(name_or_path: str, cache_dir: str | None = None, verify: bool = True):
    """Load an OpenAI CLIP checkpoint into the port's towers, on the CPU.

    Returns a dict with: 'kind' ('vit'|'resnet'), 'visual_cfg',
    'visual_params' (the tower module), 'encode_image' (params, cfg,
    images NHWC -> embedding), 'text_cfg', 'text_params' (a
    ``clip_text.TextTransformer``), 'logit_scale'.
    """
    from .clip_image import clip_image_tower_from_state_dict, count_resblocks
    from .clip_text import TextConfig, TextTransformer
    from .weights import _assign, _text_tower, load_torch_state_dict

    path = resolve(name_or_path, cache_dir, verify)
    sd = load_torch_state_dict(path)
    kind, vcfg, vparams, encode = clip_image_tower_from_state_dict(sd)

    n_layers = count_resblocks(sd)
    width = int(sd["ln_final.weight"].shape[0])
    tcfg = TextConfig(
        vocab_size=int(sd["token_embedding.weight"].shape[0]),
        context_length=int(sd["positional_embedding"].shape[0]),
        width=width,
        heads=width // 64,
        layers=n_layers,
        embed_dim=int(sd["text_projection"].shape[1]),
    )
    out = {}
    _text_tower(sd, n_layers, "", out)
    return {
        "kind": kind,
        "visual_cfg": vcfg,
        "visual_params": vparams,
        "encode_image": encode,
        "text_cfg": tcfg,
        "text_params": _assign(TextTransformer(tcfg, device="meta"), out),
        "logit_scale": sd["logit_scale"].reshape(()),
    }


def clip_preprocess(images_u8, n_px: int = 224):
    """The reference CLIP eval transform (openai_clip.py:89-96) on the
    input's device: an antialiased bicubic shorter-side resize to n_px, a
    center crop, scale to [0, 1], the CLIP channel statistics. images_u8:
    (..., H, W, 3) uint8 (a tensor or an array) -> (..., n_px, n_px, 3)
    f32."""
    from ..ops.preprocess import shortside_dims

    x = images_u8 if torch.is_tensor(images_u8) else torch.from_numpy(np.asarray(images_u8))
    *lead, h, w, c = x.shape
    x = x.float() / 255.0
    nh, nw = shortside_dims(h, w, n_px)
    # antialiased bicubic on purpose: the reference CLIP transform goes
    # through PIL (openai_clip.py:92), which antialiases, unlike the LaviLa
    # tensor pipeline (ops/preprocess.py, antialias off); torch's bicubic
    # without antialias would also take a = -0.75, not PIL's -0.5
    y = F.interpolate(x.reshape(-1, h, w, c).permute(0, 3, 1, 2), size=(nh, nw), mode="bicubic",
                      align_corners=False, antialias=True)
    top, left = (nh - n_px) // 2, (nw - n_px) // 2
    y = y[..., top:top + n_px, left:left + n_px].permute(0, 2, 3, 1).reshape(*lead, n_px, n_px, c)
    mean = torch.tensor(CLIP_MEAN, dtype=torch.float32, device=y.device)
    std = torch.tensor(CLIP_STD, dtype=torch.float32, device=y.device)
    return (y - mean) / std
