"""Epic-Kitchens-100 Multi-Instance Retrieval dataset.

Consumes the EPIC-100 retrieval annotations exactly as the reference
(data_loader/EpicKitchens_MIR_dataset.py:49-131):

- ``retrieval_annotations/EPIC_100_retrieval_{train,test}.csv`` (clips;
  column 4/5 = start/stop timestamps 'HH:MM:SS.ss', col 8 = narration),
- ``..._sentence.csv`` (caption list, column 1 = sentence),
- ``relevancy/caption_relevancy_EPIC_100_retrieval_{train,test}.pkl``
  ((n_caps, n_vids) float matrix),
- ``fps_dict_256.pth`` ({video path: fps}),
- clips decoded from ``<data_dir>/<participant>/<video_id>.MP4`` at
  uniformly-spaced frame ids (get_frame_ids jitter=False).

Train mode samples a caption among relevancy > 0.1 positives
(reference:91-100). Frames are emitted uint8; device-side preprocessing
applies Resize((224,224)) + normalise.

A copy of ``helping_hand_for_egocentric_videos_tpu/data/epic.py`` (the port imports
nothing of the JAX package); it runs on the host without JAX, so the same inputs give
the same result in both packages.
"""

from __future__ import annotations

import os
import pickle
import random
from dataclasses import dataclass

import numpy as np

from .samplers import get_frame_ids
from .video import read_frames_at

__all__ = ["EpicConfig", "EpicMIRDataset", "datetime2sec"]


def datetime2sec(s: str) -> float:
    hh, mm, ss = s.split(":")
    return int(hh) * 3600 + int(mm) * 60 + float(ss)


@dataclass
class EpicConfig:
    meta_dir: str
    data_dir: str
    split: str = "test"
    num_frames: int = 16
    decode_res: tuple = (256, 456)
    loading: str = "lax"
    relevancy_threshold: float = 0.1
    seed: int = 0


class EpicMIRDataset:
    def __init__(self, cfg: EpicConfig):
        import pandas as pd
        import torch

        self.cfg = cfg
        tag = "train" if cfg.split == "train" else "test"
        self.metadata = pd.read_csv(
            os.path.join(cfg.meta_dir, f"retrieval_annotations/EPIC_100_retrieval_{tag}.csv")
        )
        self.sentences = pd.read_csv(
            os.path.join(
                cfg.meta_dir, f"retrieval_annotations/EPIC_100_retrieval_{tag}_sentence.csv"
            )
        )
        with open(
            os.path.join(
                cfg.meta_dir, f"relevancy/caption_relevancy_EPIC_100_retrieval_{tag}.pkl"
            ),
            "rb",
        ) as f:
            self.relevancy_mat = pickle.load(f)
        self.fps_dict = torch.load(
            os.path.join(cfg.meta_dir, "fps_dict_256.pth"), map_location="cpu", weights_only=False
        )
        self._rng = random.Random(cfg.seed)

    def __len__(self):
        return len(self.metadata)

    def _caption(self, idx, sample):
        if self.cfg.split == "train":
            positives = np.where(self.relevancy_mat[idx] > self.cfg.relevancy_threshold)[0]
            if len(positives):
                pos = int(self._rng.choice(list(positives)))
                if pos < len(self.sentences) and pos < self.relevancy_mat.shape[1]:
                    return str(self.sentences.iloc[pos, 1]), float(self.relevancy_mat[idx][pos]), pos
            return str(sample.iloc[8]), 1.0, 0
        return str(sample.iloc[8]), 1.0, -1

    def __getitem__(self, item):
        cfg = self.cfg
        item = item % len(self.metadata)
        sample = self.metadata.iloc[item]
        caption, relation, cap_idx = self._caption(item, sample)

        rel = os.path.join(str(sample["participant_id"]), str(sample["video_id"]) + ".MP4")
        video_fp = os.path.join(cfg.data_dir, rel)
        fps = float(self.fps_dict[video_fp])
        start_f = int(np.round(fps * datetime2sec(str(sample.iloc[4]))))
        end_f = int(np.ceil(fps * datetime2sec(str(sample.iloc[5]))))
        frame_ids = get_frame_ids(start_f, end_f, num_segments=cfg.num_frames, jitter=False)

        try:
            frames = read_frames_at(video_fp, frame_ids, fps)
        except Exception:
            if cfg.loading == "strict":
                raise
            h, w = cfg.decode_res
            frames = np.zeros((cfg.num_frames, h, w, 3), np.uint8)
        if frames.shape[0] < cfg.num_frames:
            pad = np.repeat(frames[-1:], cfg.num_frames - frames.shape[0], axis=0)
            frames = np.concatenate([frames, pad], 0)

        return {
            "video": frames[: cfg.num_frames],
            "text": caption,
            "relation": relation,
            "item_v": item,
            "item_t": cap_idx,
        }
