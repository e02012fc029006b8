"""Zero-shot evaluation: the embedding model and the three harnesses.

Counterpart of ``helping_hand_for_egocentric_videos_tpu/train/evaluate.py``
(the reference's run/test_EgoMCQ.py, run/test_epic.py and
run/test_egtea.py):
- text embed = txt_proj(text feature map at the EOT token);
- video embed = obj_proj(hs[-1])[:, -1] of the object decoder over the
  visual tower's patch grid, plus the decoder's predicted boxes;
- EgoMCQ (test_EgoMCQ.py:25-135): a query text against 5 candidate clips
  an item, accuracy split by question type. The pretraining loop also
  runs it online.
- Epic-Kitchens MIR (test_epic.py:187-283): sim = cosine(text, video),
  post-processed to ((sim+1)/2).T[:, indexes]; nDCG and mAP in both
  directions, averaged.
- EGTEA (test_egtea.py:211-265): the 106 label narrations embedded once;
  per video ``num_clips`` windows (times the spatial crops), logits
  max-pooled over those rows; mean-class accuracy and top-1.

Clips go to the device in batches (the reference loops bs=1), uint8
frames are preprocessed on the device, and the similarity and metric
math runs on the host as the reference computes it. The visual tower
runs in ``dtype`` (bf16 by default) with its divided attention in the
CUDA kernel; the text tower and the decoder run in f32 on the tower's
f32 output. ``int8=True`` quantizes the visual tower's block matmuls
(``models/quant.py``; the int8 kernels K3, K4 and K5 on its patch
stream), with the per-block float fallback above ``int8_fallback``.
Under a torch profiler the preprocess, the tower and the decoder are the
spans ``hh.eval.*`` (``utils/profiling.py::span``), each also timed on
the device.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..metrics import calculate_mAP, calculate_nDCG, egomcq_accuracy_metrics, mean_class_accuracy
from ..metrics.ndcg import calculate_IDCG, calculate_k_counts
from ..metrics.sim import sim_matrix
from ..models.clip_text import encode_text
from ..models.lavila import Lavila, LavilaConfig
from ..models.obj_decoder import DecoderConfig, ObjDecoder, decoder_forward, obj_proj, txt_proj
from ..models.quant import cast_floats, quantize_lavila_params
from ..models.spacetime_vit import spacetime_forward
from ..ops.preprocess import resize_normalize, shortside_centercrop_normalize, spatial_crops
from ..utils.profiling import span

__all__ = ["EvalModel", "run_egomcq", "run_epic_mir", "run_egtea"]

_PREPROCESS = ("resize", "shortside", "crops3", "crops6")


class EvalModel:
    """Text and video embedding over a backbone and an object decoder.

    ``device=None`` means the CUDA device, and raises if there is none;
    pass ``device="cpu"`` to run on the CPU. The modules are moved to the
    device; the visual tower is copied in ``dtype`` when that is not f32.
    ``int8``: serve a copy of the backbone whose visual block matmuls are
    quantized from its f32 weights; ``int8_fallback``: the gamma-spread
    threshold above which a block keeps its float matmuls (None: every
    block is int8). The weight scales stay f32 in the ``dtype`` copy.

    ``preprocess``: 'resize' (squash), 'shortside' (EGTEA's one crop), or
    'crops3' / 'crops6' (LaviLa's SpatialCrop multi-crop TTA): then B clips
    embed to k*B rows, crop-major (row ``c * B + i`` is crop c of clip i),
    and only ``run_egtea``'s max-pool over rows takes them
    (run/test_egtea.py:245-246).

    ``mp``: a ``parallel.ModelParallel`` whose rank holds ``backbone`` as
    its shard (``parallel.tensor.shard_lavila``). Every rank of its group
    must then embed the same items together (the forwards' all-reduces
    pair them up), and each gets the whole embeddings. The int8 tower does
    not split: ``int8`` with ``mp`` raises.
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
        preprocess: str = "resize",
        dtype=torch.bfloat16,
        device=None,
        int8: bool = False,
        int8_fallback: float | None = None,
        mp=None,
    ):
        if preprocess not in _PREPROCESS:
            raise ValueError(f"preprocess must be one of {_PREPROCESS}, got {preprocess!r}")
        if int8 and mp is not None:
            raise ValueError("int8=True with a model-parallel backbone: the int8 tower does not split "
                             "(parallel.tensor.shard_lavila says why)")
        self.mp = mp
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
            _, fmap = encode_text(self.backbone.text, self.lavila_cfg.text, tok, mp=self.mp)
            eot = tok.argmax(dim=-1)
            emb = txt_proj(self.decoder, fmap[torch.arange(tok.shape[0], device=self.device), eot])
            return emb.cpu().numpy()

    def embed_video(self, video_u8: np.ndarray):
        """(B, T, H, W, C) uint8 -> ((B, E) f32 embeddings, predicted boxes);
        (k*B, E) and (k*B, Q, 4), crop-major, under 'crops<k>'."""
        with torch.inference_mode():
            v = torch.as_tensor(np.asarray(video_u8), device=self.device)
            emb, boxes = self.embed_clips(self.preprocess_video(v))
            return emb.cpu().numpy(), boxes.cpu().numpy()

    def preprocess_video(self, v: torch.Tensor) -> torch.Tensor:
        """(B, T, H, W, C) uint8 on the device -> the tower's normalised
        f32 clips, (k*B, ...) crop-major under 'crops<k>'."""
        with span("hh.eval.preprocess", self.device):
            if self.preprocess == "resize":
                return resize_normalize(v, self.input_res)
            if self.preprocess.startswith("crops"):
                video = spatial_crops(v, crop=self.input_res, num_crops=int(self.preprocess[5:]),
                                      short=self.input_res)
                return video.reshape((-1,) + video.shape[2:])
            return shortside_centercrop_normalize(v, res=self.input_res)

    def embed_clips(self, video: torch.Tensor):
        """(B, T, H, W, C) normalised clips on the device -> ((B, E) f32
        embeddings, (B, Q, 4) predicted boxes), on the device: the tower,
        the decoder over its patch grid, ``obj_proj`` of the last query."""
        with torch.inference_mode():
            with span("hh.eval.tower", self.device):
                _, fmap = spacetime_forward(self.visual, self.lavila_cfg.visual, video, dtype=self.dtype, mp=self.mp)
                b, t = video.shape[:2]
                grid = fmap[:, 1:, :].reshape(b, t, self.lavila_cfg.visual.patches_per_frame, -1)
            with span("hh.eval.decoder", self.device):
                out = decoder_forward(self.decoder, self.dec_cfg, grid)
                return obj_proj(self.decoder, out.hs[-1])[:, -1], out.pred_boxes


def _cos(a, b) -> np.ndarray:
    return sim_matrix(torch.as_tensor(a), torch.as_tensor(b)).numpy()


def _prefetch_items(dataset, n: int, depth: int = 16):
    """Yield dataset[0..n) in order, decoded ahead by a background thread.

    The reference harness loops a bs=1 DataLoader whose workers prefetch
    (run/test_EgoMCQ.py:56); a plain ``dataset[i]`` loop would serialise
    host decode against device compute. A dataset error surfaces in the
    consumer; a consumer that stops early releases the producer.
    """
    import queue
    import threading

    q: queue.Queue = queue.Queue(maxsize=depth)
    stop = object()
    cancelled = threading.Event()

    def _put(item) -> bool:
        # a bounded put that notices the consumer leaving, so the producer
        # never blocks forever holding `depth` decoded clips
        while not cancelled.is_set():
            try:
                q.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def produce():
        try:
            for i in range(n):
                if not _put(dataset[i]):
                    return
        except BaseException as e:
            _put(e)
        finally:
            _put(stop)

    threading.Thread(target=produce, daemon=True).start()
    try:
        while True:
            item = q.get()
            if item is stop:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        cancelled.set()


def _reject_multicrop(model):
    """crops3/6 preprocess returns crop-major (k*B, E) embeddings; only
    run_egtea's row max-pool is shape-agnostic to that."""
    if getattr(model, "preprocess", "").startswith("crops"):
        raise ValueError(
            "multi-crop preprocess returns crop-major (k*B, E) embeddings; "
            "only run_egtea's row max-pool supports it (use preprocess="
            "'resize' here)"
        )


def run_egomcq(model: EvalModel, dataset, limit: int | None = None, progress=None, items_per_batch: int = 4,
               out_sims: str | None = None):
    """-> {'Intra-video': %, 'Inter-video': %, 'n_items': n}.

    The reference iterates bs=1 (one MCQ item = 5 candidate clips a step,
    run/test_EgoMCQ.py:56-58); here ``items_per_batch`` items go to the
    device as one batch of 5*K clips. ``out_sims`` dumps an .npz of the
    raw per-item similarity rows, ground truth and types (the reference
    saves an equivalent .pth, run/test_EgoMCQ.py:119).
    """
    _reject_multicrop(model)
    preds, gts, types = [], [], []
    n = len(dataset) if limit is None else min(limit, len(dataset))
    buf = []

    def flush():
        if not buf:
            return
        videos = np.concatenate([it["video"] for it in buf])  # (5K, T, H, W, C)
        video_embeds, _ = model.embed_video(videos)
        text_embeds = model.embed_text([it["text"] for it in buf])  # (K, E)
        n_opts = buf[0]["video"].shape[0]
        for j, it in enumerate(buf):
            sim = _cos(text_embeds[j:j + 1], video_embeds[j * n_opts:(j + 1) * n_opts])
            preds.append(sim[0])
            gts.append(it["correct"])
            types.append(it["type"])
        buf.clear()

    for i, item in enumerate(_prefetch_items(dataset, n, depth=4 * items_per_batch)):
        buf.append(item)
        if len(buf) == items_per_batch:
            flush()
        if progress and i % 50 == 0:
            progress(i, n)
    flush()
    preds = np.stack(preds)
    if out_sims:
        np.savez(out_sims, sims=preds, gt=np.asarray(gts), types=np.asarray(types))
    metrics = egomcq_accuracy_metrics(preds, np.asarray(gts), np.asarray(types))
    metrics["n_items"] = n
    return metrics


def run_epic_mir(model: EvalModel, dataset, relevancy: np.ndarray, indexes: np.ndarray, batch_size: int = 8,
                 progress=None, out_sims: str | None = None):
    """-> dict of mAP/nDCG (VT/TV/AVG). ``relevancy``/``indexes`` are the
    EPIC relevancy matrix and caption column re-index (test_epic.py:99-101).
    ``out_sims`` dumps an .npz with the raw text x video cosine matrix
    (pre-postprocessing, what the reference torch.saves at
    run/test_epic.py:263-265) plus the re-indexed matrix fed to nDCG/mAP."""
    _reject_multicrop(model)
    text_embeds, vid_embeds = [], []
    n = len(dataset)
    buf_v, buf_t = [], []

    def flush():
        if not buf_v:
            return
        emb, _ = model.embed_video(np.stack(buf_v))
        vid_embeds.append(emb)
        text_embeds.append(model.embed_text(list(buf_t)))
        buf_v.clear()
        buf_t.clear()

    for i, item in enumerate(_prefetch_items(dataset, n, depth=4 * batch_size)):
        buf_v.append(item["video"])
        buf_t.append(item["text"])
        if len(buf_v) == batch_size:
            flush()
        if progress and i % 100 == 0:
            progress(i, n)
    flush()

    sim = _cos(np.concatenate(text_embeds), np.concatenate(vid_embeds))  # (n_caps, n_vids)
    raw_sim = sim
    sim = ((sim + 1) / 2).T[:, indexes]  # (n_vids, n_caps_selected)
    if out_sims:
        np.savez(out_sims, pred=raw_sim, processed=sim)
    k_v = calculate_k_counts(relevancy)
    idcg_v = calculate_IDCG(relevancy, k_v)
    k_t = calculate_k_counts(relevancy.T)
    idcg_t = calculate_IDCG(relevancy.T, k_t)
    vis_nDCG = calculate_nDCG(sim, relevancy, k_v, IDCG=idcg_v)
    txt_nDCG = calculate_nDCG(sim.T, relevancy.T, k_t, IDCG=idcg_t)
    vis_mAP = calculate_mAP(sim, relevancy)
    txt_mAP = calculate_mAP(sim.T, relevancy.T)
    return {
        "nDCG_VT": float(vis_nDCG),
        "nDCG_TV": float(txt_nDCG),
        "nDCG_AVG": float((vis_nDCG + txt_nDCG) / 2),
        "mAP_VT": float(vis_mAP),
        "mAP_TV": float(txt_mAP),
        "mAP_AVG": float((vis_mAP + txt_mAP) / 2),
    }


def run_egtea(model: EvalModel, dataset, labels: list[str], progress=None):
    """-> {'mean_class_acc': %, 'top1': %}. ``labels`` = 106 narrations.
    Each item's frames are cut into windows of the decoder's frame count;
    the logits of all its rows (windows x crops) are max-pooled before the
    argmax."""
    label_embeds = model.embed_text(labels)
    preds, gts = [], []
    label_to_idx = {l: i for i, l in enumerate(labels)}
    n = len(dataset)
    for i, item in enumerate(_prefetch_items(dataset, n, depth=4)):
        frames = item["video"]  # (num_clips*clip_length, H, W, C)
        clips = frames.reshape(-1, model.dec_cfg.num_frames, *frames.shape[1:])
        emb, _ = model.embed_video(clips)  # (k*num_clips, E)
        logits = _cos(emb, label_embeds)  # (k*num_clips, C)
        preds.append(int(np.argmax(logits.max(axis=0))))
        gts.append(label_to_idx[item["label_text"]])
        if progress and i % 50 == 0:
            progress(i, n)
    mca, top1 = mean_class_accuracy(np.asarray(preds), np.asarray(gts), len(labels))
    return {"mean_class_acc": mca, "top1": top1}
