"""EgoClip pretraining / EgoMCQ evaluation dataset.

Consumes the same metadata artifacts as the reference
(data_loader/EgoClip_EgoMCQ_dataset.py):

- ``egoclip.csv``: tab-separated narration metadata (video_uid, clip_start,
  clip_end, clip_text, tag_noun, tag_verb, narration_time).
- ``egomcq.json``: MCQ items {query, choices{0..4}, answer, types}.
- ``lavila_rephrased.pth``: {video_uid: {chunk_id: {start_sec: [[text],...]}}}
  rephrased captions (5 per clip).
- ``narration_noun_taxonomy.csv``: noun groups per taxonomy id.
- ``noun_dict_lavila_embeds.pth``: ordered {noun: 768-d embedding}.
- ``hand_object_clip_per_video_4f_lavila_narrator_640/<uid>/<chunk>.handobj.pkl``:
  100DOH detections per clip start: 4 frames x (hand_dets, obj_dets).
- ``videos_256_chunked/<uid>/<chunk>.mp4``: 600 s video chunks (or
  pre-extracted ``.npy`` clip tensors next to them, data/video.py).

Outputs are numpy/uint8; all resize/normalise runs on-device. Boxes are
emitted already scaled to the 224x224 square frame (the reference's
``crop_boxes(..., ori_im_sz, resize_target=224)`` no-crop path,
utils/box_ops.py:116-121).

Semantics preserved: rephrased-caption matching within +-0.5 s and the
primary-caption consistency check (dataset:173-196), noun extraction with
two-word-first matching and the exclude list (dataset:200-243; the
reference's dead plural-'es' branch is dropped — it compares one char to
a two-char string and never fires), scene-aware negative sampling with
<=10 resamples from the same 600 s segment (dataset:262-281), lax loading
with black frames (base/base_dataset.py:124-140), hand-box lookups at
clip_start +- 0.001 (dataset:91-101).

A copy of ``helping_hand_for_egocentric_videos_tpu/data/egoclip.py`` (the port imports
nothing of the JAX package); it runs on the host without JAX, so the same inputs and seed give
the same result in both packages.
"""

from __future__ import annotations

import json
import os
import pickle
from dataclasses import dataclass

import numpy as np

from .video import read_clip_chunked, resize_frames

__all__ = ["EgoClipConfig", "EgoClipDataset", "load_noun_dict"]

CHUNK_SEC = 600
NOUN_DIM = 582
VERB_DIM = 118
EXCLUDE_NOUNS = [
    "hand", "leg", "left hand", "right hand", "man", "woman", "person",
    "lady", "they", "ground", "camera",
]
MAX_NOUNS = 4
# noun-taxonomy ids zeroed from the tag vectors: hand/person/background
# (run/train.py:73)
STOPWORD_NOUN_IDS = (102, 504, 364, 321, 556)


def _torch_load(path):
    import torch

    return torch.load(path, map_location="cpu", weights_only=False)


def load_noun_dict(meta_dir: str):
    """-> (noun names list, (V, 768) float32 embeddings)."""
    d = _torch_load(os.path.join(meta_dir, "noun_dict_lavila_embeds.pth"))
    names = list(d.keys())
    embeds = np.stack([np.asarray(v, dtype=np.float32) for v in d.values()])
    return names, embeds


@dataclass
class EgoClipConfig:
    meta_dir: str
    data_dir: str
    split: str = "train"  # train | val | test
    num_frames: int = 4
    input_res: int = 224
    frame_sample: str = "uniform"  # 'uniform' | 'rand'
    loading: str = "lax"  # 'lax' -> black frames on failure
    neg_param: bool = True  # scene-aware hard negatives
    crop_with_boxes: bool = False  # box-union crop aug (off upstream too)
    decode_res: tuple = (256, 256)  # decoded frame size fed to the device
    seed: int = 0
    # train: iloc row range like the reference's subsample list
    # (EgoClip_EgoMCQ_dataset.py:45-46); None = all rows
    subsample: tuple | None = None
    # val: keep the first K MCQ items of each type (balanced inter/intra
    # subset for fast online eval). The reference's val-subset block
    # (dataset:57-76) computes the union of all type-1 and type-2 keys —
    # i.e. the full set — so 0 (= everything) is the parity default.
    val_subsample: int = 0


class EgoClipDataset:
    """Map-style dataset; __getitem__ returns a dict of numpy values."""

    def __init__(self, cfg: EgoClipConfig):
        import pandas as pd
        from ast import literal_eval

        self.cfg = cfg
        self.video_dir = os.path.join(cfg.data_dir, "videos_256_chunked")
        self.handobj_dir = os.path.join(
            cfg.data_dir, "hand_object_clip_per_video_4f_lavila_narrator_640"
        )
        self._rng = np.random.default_rng(cfg.seed)

        noun_tax_path = os.path.join(cfg.meta_dir, "narration_noun_taxonomy.csv")
        self.noun_groups = None
        if os.path.exists(noun_tax_path):
            df = pd.read_csv(noun_tax_path, converters={"group": literal_eval})
            self.noun_groups = list(df["group"])

        self.all_nouns = None
        noun_dict_path = os.path.join(cfg.meta_dir, "noun_dict_lavila_embeds.pth")
        if os.path.exists(noun_dict_path):
            self.all_nouns, _ = load_noun_dict(cfg.meta_dir)

        reph_path = os.path.join(cfg.meta_dir, "lavila_rephrased.pth")
        self.rephrased = _torch_load(reph_path) if os.path.exists(reph_path) else {}

        if cfg.split == "train":
            self.metadata = pd.read_csv(
                os.path.join(cfg.meta_dir, "egoclip.csv"), sep="\t", on_bad_lines="skip"
            )
            if cfg.subsample is not None:
                self.metadata = self.metadata.iloc[
                    cfg.subsample[0] : cfg.subsample[1]
                ].reset_index(drop=True)
            seg = (
                self.metadata["video_uid"]
                + "_"
                + (self.metadata["narration_time"] // CHUNK_SEC).astype(int).astype(str)
            )
            self.metadata = self.metadata.assign(segment_id=seg)
            self._by_segment = {
                k: np.asarray(v) for k, v in self.metadata.groupby("segment_id").groups.items()
            }
        else:
            with open(os.path.join(cfg.meta_dir, "egomcq.json")) as f:
                self.metadata = json.load(f)
            self.metakeys = sorted(self.metadata.keys())
            if cfg.val_subsample:
                by_type: dict[int, list] = {}
                for k in sorted(self.metakeys, key=lambda x: int(x)):
                    by_type.setdefault(int(self.metadata[k]["types"]), []).append(k)
                keep = set()
                for keys in by_type.values():
                    keep.update(keys[: cfg.val_subsample])
                self.metakeys = sorted(keep)

    # ------------------------------------------------------------- paths
    def _video_paths(self, sample):
        start = max(float(sample["clip_start"]), 0.0)
        end = max(float(sample["clip_end"]), 0.0)
        uid = sample["video_uid"]
        c0, c1 = int(start // CHUNK_SEC), int(end // CHUNK_SEC)
        p0 = os.path.join(self.video_dir, uid, f"{c0}.mp4")
        p1 = os.path.join(self.video_dir, uid, f"{c1}.mp4")
        nxt = os.path.join(self.video_dir, uid, f"{c0 + 1}.mp4")
        return (p0, p1, nxt), (start, end)

    # ------------------------------------------------------------ frames
    def _get_frames(self, paths, secs):
        cfg = self.cfg
        try:
            frames, seconds = read_clip_chunked(
                paths[0],
                secs[0],
                secs[1],
                next_path=paths[2],
                clip_length=cfg.num_frames,
                jitter=(cfg.frame_sample == "rand" and cfg.split == "train"),
                rng=self._rng,
            )
            # decoders return native sizes (256x456 chunked Ego4D, etc.);
            # squash to one static decode_res so mixed-success batches stack
            # and the device squash-to-input_res sees the full frame
            frames = resize_frames(np.ascontiguousarray(frames), cfg.decode_res)
            valid = 1
        except Exception:
            if cfg.loading == "strict":
                raise
            h, w = cfg.decode_res
            frames = np.zeros((cfg.num_frames, h, w, 3), np.uint8)
            seconds, valid = [0.0] * cfg.num_frames, 0
        if frames.shape[0] < cfg.num_frames:  # pad by repeating last frame
            pad = np.repeat(frames[-1:], cfg.num_frames - frames.shape[0], axis=0)
            frames = np.concatenate([frames, pad], 0)
        return frames[: cfg.num_frames], seconds, valid

    # ------------------------------------------------------------- boxes
    def _load_boxes(self, sample):
        """(T=4, 4, 4) raw boxes [hand0, hand1, obj0, obj1] + image size."""
        clip_start = float(sample["clip_start"])
        uid = sample["video_uid"]
        boxes = np.zeros((4, 4, 4), np.float32)
        image_size = (0, 0)
        pkl = os.path.join(self.handobj_dir, uid, f"{int(clip_start // CHUNK_SEC)}.handobj.pkl")
        if not os.path.exists(pkl):
            return boxes, image_size
        with open(pkl, "rb") as f:
            info = pickle.load(f)
        # each per-clip entry carries an 'info' dict with the original
        # video dims alongside integer frame keys (dataset:92)
        first = next(iter(info.values()))
        image_size = (first["info"]["height"], first["info"]["width"])
        for start in (clip_start, clip_start - 0.001, clip_start + 0.001):
            key = round(start, 3)
            if key not in info:
                continue
            per_clip = info[key]
            try:
                for fi in range(4):
                    fkey = fi % 600
                    if int(fkey) not in per_clip:
                        continue
                    dets = per_clip[int(fkey)]
                    for slot, det_key in ((0, "hand_dets"), (2, "obj_dets")):
                        d = dets.get(det_key)
                        if d is None:
                            continue
                        d = np.asarray(d)
                        order = np.argsort(-d[:, 4])[:2]
                        boxes[fi, slot : slot + len(order)] = d[order, :4]
                break
            except Exception:
                boxes[:] = 0
        return boxes, image_size

    @staticmethod
    def _scale_boxes(boxes, image_size, res: int):
        """Scale raw-pixel boxes to the res x res squashed frame
        (crop_boxes no-crop path, utils/box_ops.py:116-121)."""
        h, w = image_size
        if h == 0 or w == 0:
            return boxes
        out = boxes.copy()
        out[..., 0::2] *= res / w
        out[..., 1::2] *= res / h
        return out

    # ----------------------------------------------------------- caption
    def _caption(self, sample):
        noun_vec = np.zeros(NOUN_DIM, np.float32)
        verb_vec = np.zeros(VERB_DIM, np.float32)
        for i in _as_list(sample["tag_noun"]):
            noun_vec[i] = 1
        for i in _as_list(sample["tag_verb"]):
            verb_vec[i] = 1
        return str(sample["clip_text"]), noun_vec, verb_vec

    def _rephrased_caption(self, sample, start_sec, caption):
        uid = sample["video_uid"]
        clip_id = str(int(start_sec // CHUNK_SEC))
        cs = round(float(start_sec), 1)
        texts = [""] * 5
        if uid in self.rephrased and clip_id in self.rephrased[uid]:
            reph = self.rephrased[uid][clip_id]
            for s in np.arange(cs - 0.5, cs + 0.5, 0.1):
                s = round(float(s), 1)
                if s in reph:
                    for j, line in enumerate(reph[s][:5]):
                        texts[j] = line[0]
        if texts[0] != caption:  # misalignment -> fall back to caption only
            texts = [caption] + [""] * 4
        return texts

    def _extract_nouns(self, sample, caption):
        """(words, (MAX_NOUNS,) int32 noun-dictionary indices, 0 = pad)."""
        arr = np.zeros(MAX_NOUNS, np.int32)
        if self.noun_groups is None or self.all_nouns is None:
            return [], arr

        def p(word):
            word = word.replace(".", "").replace(",", "")
            if word.endswith("s"):
                word = word[:-1]
            return word

        groups = []
        for idx in _as_list(sample["tag_noun"])[:MAX_NOUNS]:
            if idx < len(self.noun_groups):
                groups += self.noun_groups[idx]
        words, counter = [], 0
        tokens = caption.split()
        for i in range(len(tokens) - 1):
            two = " ".join([p(tokens[i]), p(tokens[i + 1])])
            if two in groups and two not in EXCLUDE_NOUNS and counter < MAX_NOUNS:
                words.append(two)
                arr[counter] = self.all_nouns.index(two)
                counter += 1
        elements = [w for word in words for w in word.split()]
        for tok in tokens:
            if counter >= MAX_NOUNS:
                break
            w = p(tok)
            if w in groups and w not in elements and w not in EXCLUDE_NOUNS:
                words.append(w)
                arr[counter] = self.all_nouns.index(w)
                counter += 1
        return words, arr

    # ------------------------------------------------------------- items
    def __len__(self):
        return len(self.metadata) if self.cfg.split == "train" else len(self.metakeys)

    def _sample_item(self, sample):
        paths, secs = self._video_paths(sample)
        caption, noun_vec, verb_vec = self._caption(sample)
        rephrased = self._rephrased_caption(sample, secs[0], caption)
        _, nouns = self._extract_nouns(sample, caption)
        boxes, image_size = self._load_boxes(sample)
        frames, seconds, valid = self._get_frames(paths, secs)
        cropped = False
        if self.cfg.crop_with_boxes and boxes.sum() != 0:
            from .box_crop import apply_crop_to_boxes, box_union_crop

            # map boxes from original-video pixels into the decoded frame,
            # crop around their union, then rescale into the model square
            h_im, w_im = image_size
            dec_boxes = boxes.copy()
            if h_im and w_im:
                dec_boxes[..., 0::2] *= frames.shape[2] / w_im
                dec_boxes[..., 1::2] *= frames.shape[1] / h_im
            frames2, crop_params = box_union_crop(frames, dec_boxes)
            if crop_params.sum() >= 1:
                # host-resize back to the fixed decode shape (batch shapes
                # must stay static for the device preprocess)
                from PIL import Image

                h_d, w_d = self.cfg.decode_res
                frames = np.stack(
                    [
                        np.asarray(
                            Image.fromarray(f).resize((w_d, h_d), Image.BILINEAR)
                        )
                        for f in frames2
                    ]
                )
                boxes = apply_crop_to_boxes(
                    dec_boxes, crop_params, resize_target=self.cfg.input_res
                )
                cropped = True
        if not cropped:
            boxes = self._scale_boxes(boxes, image_size, self.cfg.input_res)
        return {
            "video": frames,
            "text": caption,
            "rephrased_text": rephrased,
            "noun_vec": noun_vec,
            "verb_vec": verb_vec,
            "nouns": nouns,
            "boxes": boxes,
            "image_size": np.asarray(image_size, np.int32),
            "valid": valid,
        }

    def _get_train_item(self, index):
        sample = self.metadata.iloc[index % len(self.metadata)]
        item = self._sample_item(sample)
        if not self.cfg.neg_param:
            return item

        # scene-aware hard negative from the same 600 s segment
        seg_rows = self._by_segment[sample["segment_id"]]
        neg = self.metadata.loc[self._rng.choice(seg_rows)]
        tries = 0
        while (
            len(seg_rows) != 1
            and neg["clip_start"] == sample["clip_start"]
            and tries < 10
        ):
            neg = self.metadata.loc[self._rng.choice(seg_rows)]
            tries += 1
        neg_item = self._sample_item(neg)
        item.update({f"{k}_neg": v for k, v in neg_item.items()})
        return item

    def _get_val_item(self, index):
        cfg = self.cfg
        mcq = self.metadata[self.metakeys[index % len(self.metakeys)]]
        query_text, _, _ = self._caption(mcq["query"])
        options = mcq["choices"]
        n = len(options)
        h, w = cfg.decode_res
        videos = np.zeros((n, cfg.num_frames, h, w, 3), np.uint8)
        texts = []
        for i in range(n):
            opt = options[str(i)]
            paths, secs = self._video_paths(opt)
            # _get_frames squash-resizes every clip to decode_res
            videos[i], _, _ = self._get_frames(paths, secs)
            texts.append(self._caption(opt)[0])
        return {
            "video": videos,
            "text": query_text,
            "text_ops": texts,
            "correct": int(mcq["answer"]),
            "type": int(mcq["types"]),  # 1 inter / 2 intra
        }

    def __getitem__(self, index):
        if self.cfg.split == "train":
            return self._get_train_item(index)
        return self._get_val_item(index)


def _as_list(x):
    if isinstance(x, str):
        from ast import literal_eval

        return list(literal_eval(x))
    if isinstance(x, (list, tuple, np.ndarray)):
        return list(x)
    return [int(x)]
