"""EGTEA Gaze+ action-classification dataset (zero-shot eval).

Consumes the same artifacts as the reference (data_loader/Egtea.py:94-242):

- split files ``{train,test}_split{1,2,3}.txt``: rows 'clip_id action_idx ...'
- ``action_idx.txt``: 'verb_noun words ... idx' -> 106 label narrations
- ``egtea_video_list.pth.tar``: {'len_dict': {video path: n_frames}}
- trimmed clips ``<root>/<video_id>/<clip_id>.mp4``.

Eval protocol (run/test_egtea.py:183-204): ``num_clips`` uniformly-placed
windows of ``clip_length`` frames at ``clip_stride``; short videos are
zero-padded then strided. Frames are emitted uint8; the harness resizes
(shorter side) + center-crops on device.

A copy of ``helping_hand_for_egocentric_videos_tpu/data/egtea.py`` (the port imports
nothing of the JAX package); it runs on the host without JAX, so the same inputs give
the same result in both packages.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

from .video import read_frames_at

__all__ = ["EgteaConfig", "EgteaDataset", "generate_label_map"]


def generate_label_map(action_idx_file: str):
    """-> (labels list, {label: idx}) (Egtea.py:232-242)."""
    labels = []
    with open(action_idx_file) as f:
        for row in f:
            row = row.strip()
            narration = " ".join(row.split(" ")[:-1])
            labels.append(narration.replace("_", " ").lower())
    return labels, {label: i for i, label in enumerate(labels)}


@dataclass
class EgteaConfig:
    root: str  # cropped_clips dir
    metadata: str  # split txt file
    anno_dir: str  # dir holding egtea_video_list.pth.tar + action_idx.txt
    is_training: bool = False
    num_clips: int = 10
    clip_length: int = 16
    clip_stride: int = 2
    decode_res: tuple = (256, 342)
    seed: int = 0


class EgteaDataset:
    def __init__(self, cfg: EgteaConfig):
        import torch

        self.cfg = cfg
        video_list = torch.load(
            os.path.join(cfg.anno_dir, "egtea_video_list.pth.tar"),
            map_location="cpu",
            weights_only=False,
        )
        len_dict = video_list["len_dict"]

        action_idx = os.path.join(os.path.dirname(cfg.metadata), "action_idx.txt")
        if not os.path.exists(action_idx):
            action_idx = os.path.join(cfg.anno_dir, "action_idx.txt")
        vn2narr = {}
        for row in open(action_idx):
            row = row.strip()
            vn = int(row.split(" ")[-1])
            vn2narr[vn] = " ".join(row.split(" ")[:-1]).replace("_", " ").lower()

        self.samples = []
        with open(cfg.metadata) as f:
            for row in f:
                clip_id, action_idx_s = row.strip().split(" ")[:2]
                video_id = "-".join(clip_id.split("-")[:3])
                rel = os.path.join(video_id, f"{clip_id}.mp4")
                full = os.path.join(cfg.root, video_id, f"{clip_id}.mp4")
                self.samples.append((rel, 0, len_dict[full], vn2narr[int(action_idx_s)]))
        self._rng = np.random.default_rng(cfg.seed)

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, i):
        cfg = self.cfg
        rel, start_frame, end_frame, sentence = self.samples[i]
        path = os.path.join(cfg.root, rel)
        span = cfg.clip_length * cfg.clip_stride

        if cfg.is_training:
            if end_frame < span:
                frames = read_frames_at(path, list(range(0, end_frame)))
                pad = np.zeros((span - end_frame, *frames.shape[1:]), frames.dtype)
                frames = np.concatenate([frames, pad], 0)[:: cfg.clip_stride]
            else:
                start = int(self._rng.integers(0, end_frame - span + 1))
                ids = np.arange(start, start + span, cfg.clip_stride)
                frames = read_frames_at(path, ids)
        else:
            if end_frame < span:
                frames = read_frames_at(path, list(range(0, end_frame)))
                pad = np.zeros((span - end_frame, *frames.shape[1:]), frames.dtype)
                frames = np.concatenate([frames, pad], 0)[:: cfg.clip_stride]
                frames = np.tile(frames, (cfg.num_clips, 1, 1, 1))
            else:
                ids = []
                for start in np.linspace(0, end_frame - span, cfg.num_clips, dtype=int):
                    ids.extend(np.arange(start, start + span, cfg.clip_stride))
                frames = read_frames_at(path, ids)
        return {"video": frames, "label_text": sentence}
