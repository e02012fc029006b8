"""Zero-shot embedding model: text and video embeddings for retrieval.

Counterpart of ``EvalModel`` in
``helping_hand_for_egocentric_videos_tpu/train/evaluate.py``:
- text embed = txt_proj(text feature map at the EOT token);
- video embed = obj_proj(hs[-1])[:, -1] of the object decoder over the
  visual tower's patch grid, plus the decoder's predicted boxes.

The visual tower runs in ``dtype`` (bf16 by default) with its divided
attention in the CUDA kernel; the text tower and the decoder run in f32
on the tower's f32 output. uint8 clips are preprocessed on the device.
``int8=True`` quantizes the visual tower's block matmuls
(``models/quant.py``; the int8 kernels K3, K4 and K5 on its patch stream),
with the per-block float fallback above ``int8_fallback``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..models.clip_text import encode_text
from ..models.lavila import Lavila, LavilaConfig
from ..models.obj_decoder import DecoderConfig, ObjDecoder, decoder_forward, obj_proj, txt_proj
from ..models.quant import cast_floats, quantize_lavila_params
from ..models.spacetime_vit import spacetime_forward
from ..ops.preprocess import resize_normalize, shortside_centercrop_normalize

__all__ = ["EvalModel"]

_PREPROCESS = ("resize", "shortside")


class EvalModel:
    """Text and video embedding over a backbone and an object decoder.

    ``device=None`` means the CUDA device, and raises if there is none;
    pass ``device="cpu"`` to run on the CPU. The modules are moved to the
    device; the visual tower is copied in ``dtype`` when that is not f32.
    ``int8``: serve a copy of the backbone whose visual block matmuls are
    quantized from its f32 weights; ``int8_fallback``: the gamma-spread
    threshold above which a block keeps its float matmuls (None: every
    block is int8). The weight scales stay f32 in the ``dtype`` copy.
    """

    def __init__(
        self,
        backbone: Lavila,
        lavila_cfg: LavilaConfig,
        decoder: ObjDecoder,
        dec_cfg: DecoderConfig,
        tokenizer,
        *,
        input_res: int = 224,
        preprocess: str = "resize",  # 'resize' (squash) | 'shortside' (EGTEA 1-crop)
        dtype=torch.bfloat16,
        device=None,
        int8: bool = False,
        int8_fallback: float | None = None,
    ):
        if preprocess not in _PREPROCESS:
            raise ValueError(f"preprocess must be one of {_PREPROCESS}, got {preprocess!r}")
        self.device = resolve_device(device)
        self.lavila_cfg = lavila_cfg
        self.dec_cfg = dec_cfg
        self.tokenizer = tokenizer
        self.input_res = input_res
        self.preprocess = preprocess
        self.dtype = dtype
        self.int8 = bool(int8)
        self.int8_fallback = int8_fallback
        backbone = backbone.to(self.device)
        if self.int8:  # quantize the f32 weights, then cast
            backbone = quantize_lavila_params(backbone, act_outlier_threshold=int8_fallback)
        self.backbone = backbone.eval()
        self.decoder = decoder.to(self.device).eval()
        visual = self.backbone.visual
        self.visual = visual if dtype == torch.float32 else cast_floats(visual, dtype)

    def embed_text(self, texts: list[str]) -> np.ndarray:
        return self.embed_tokens(np.asarray(self.tokenizer(texts)))

    def embed_tokens(self, tokens: np.ndarray) -> np.ndarray:
        """(B, 77) token ids -> (B, E) f32 text embeddings."""
        with torch.inference_mode():
            tok = torch.as_tensor(np.asarray(tokens), device=self.device).long()
            _, fmap = encode_text(self.backbone.text, self.lavila_cfg.text, tok)
            eot = tok.argmax(dim=-1)
            emb = txt_proj(self.decoder, fmap[torch.arange(tok.shape[0], device=self.device), eot])
            return emb.cpu().numpy()

    def embed_video(self, video_u8: np.ndarray):
        """(B, T, H, W, C) uint8 -> ((B, E) f32 embeddings, predicted boxes)."""
        with torch.inference_mode():
            v = torch.as_tensor(np.asarray(video_u8), device=self.device)
            if self.preprocess == "resize":
                video = resize_normalize(v, self.input_res)
            else:
                video = shortside_centercrop_normalize(v, res=self.input_res)
            _, fmap = spacetime_forward(self.visual, self.lavila_cfg.visual, video, dtype=self.dtype)
            b, t = video.shape[:2]
            grid = fmap[:, 1:, :].reshape(b, t, self.lavila_cfg.visual.patches_per_frame, -1)
            out = decoder_forward(self.decoder, self.dec_cfg, grid)
            emb = obj_proj(self.decoder, out.hs[-1])[:, -1]
            return emb.cpu().numpy(), out.pred_boxes.cpu().numpy()
