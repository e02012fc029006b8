#!/usr/bin/env python3
"""Proof that the PyTorch port's training loop learns, on a synthetic fixture.

Counterpart of ``tools/learning_proof.py``. It writes the same miniature
EgoClip world (``build_fixture``, the same files and arrays): 8 clips of
distinct colour patterns in one chunked ``.npy`` store, 8 distinct captions
with distinct tagged nouns, distinct per-clip hand and object boxes, and 8
inter-video EgoMCQ questions whose right answer is the clip of the query's
caption (chance 1 in 5). Then the port's public loop
(``train.pretrain.pretrain``: EgoClip dataset, ``PrefetchLoader``, the train
step, online EgoMCQ every ``--eval_freq`` steps) runs ``--steps`` steps with
the JAX tool's settings, and the metric logs are read back.

It passes when the best inter-video accuracy reaches 50% and the final box
loss is below 0.7 times the first. The result is written as JSON to
``--out`` (by default ``build/torch_learning_proof.json``, never over the
JAX package's ``LEARNING_PROOF.json``); the exit code is 1 when it fails.

``--towers tiny`` are the JAX tool's towers (width 32, 4 heads: a head dim
of 8, which no kernel takes), for the CPU: ``--device cpu``. ``--towers
large`` is TimeSformer-L at 4 frames with the 13-query decoder at its
default widths, time attention N(0, 0.02), the backbone in bf16: on the
card its attention runs K1 and K2; the fixture's frames are resized to 224.

    python3 tools/torch_learning_proof.py --towers large
    python3 tools/torch_learning_proof.py --towers tiny --device cpu
"""

from __future__ import annotations

import argparse
import json
import os
import pickle
import sys
import tempfile

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

RES = 28  # 2x2 patches of 14
NOUNS = ["drawer", "knife", "tomato", "plate", "kettle", "chair", "bottle", "spoon"]
VERBS = ["opens", "picks", "cuts", "washes", "lifts", "moves", "holds", "grabs"]
K = 8  # clips


def build_fixture(root: str, noun_width: int = 32):
    """The JAX tool's miniature EgoClip metadata and chunked store, where
    retrieval is learnable -> (meta dir, data dir). ``noun_width``: the
    width of the noun dictionary's embeddings (the text tower's)."""
    import pandas as pd
    import torch

    meta = os.path.join(root, "meta")
    data = os.path.join(root, "data")
    os.makedirs(meta)
    uid = "vid_learn"
    vdir = os.path.join(data, "videos_256_chunked", uid)
    os.makedirs(vdir)

    # clip i = seconds [i, i+0.5) = frames [30i, 30i+15): a distinct color
    # pattern per clip (plus mild noise) so video embeddings can separate
    rng = np.random.default_rng(0)
    chunk = rng.integers(0, 40, size=(30 * K + 30, RES, 48, 3)).astype(np.uint8)
    for i in range(K):
        base = np.zeros((1, RES, 48, 3), np.uint8)
        base[..., 0] = 30 * i
        base[..., 1] = 255 - 30 * i
        base[..., 2] = (80 * i) % 255
        chunk[30 * i : 30 * i + 15] = base + rng.integers(0, 20, size=(15, RES, 48, 3)).astype(np.uint8)
    np.save(os.path.join(vdir, "0.mp4.npy"), chunk)

    def caption(i):
        return f"#C C {VERBS[i]} a {NOUNS[i]}"

    rows = ["video_uid\tclip_start\tclip_end\tclip_text\ttag_noun\ttag_verb\tnarration_time"]
    for i in range(K):
        start = float(i)
        rows.append(f"{uid}\t{start}\t{start + 0.5}\t{caption(i)}\t[{i}]\t[{i}]\t{start}")
    with open(os.path.join(meta, "egoclip.csv"), "w") as f:
        f.write("\n".join(rows))

    def choice(i):
        return {
            "video_uid": uid,
            "clip_start": float(i),
            "clip_end": float(i) + 0.5,
            "clip_text": caption(i),
            "tag_noun": f"[{i}]",
            "tag_verb": f"[{i}]",
            "narration_time": float(i),
        }

    # all inter-video (types=2; the reference maps 1 to intra, 2 to inter):
    # query caption i among 5 video choices, the right one clip i at a varying slot
    mcq = {}
    for q in range(K):
        slots = [(q + j) % K for j in range(5)]
        answer = q % 5
        slots[answer], slots[0] = slots[0], slots[answer]
        mcq[str(q)] = {
            "query": choice(q),
            "choices": {str(j): choice(slots[j]) for j in range(5)},
            "answer": answer,
            "types": 2,
        }
    with open(os.path.join(meta, "egomcq.json"), "w") as f:
        json.dump(mcq, f)

    pd.DataFrame({"group": [[n] for n in NOUNS]}).to_csv(
        os.path.join(meta, "narration_noun_taxonomy.csv"), index=False
    )
    g = torch.Generator().manual_seed(0)
    noun_dict = {"pad": torch.zeros(noun_width)}
    for n in NOUNS:
        noun_dict[n] = torch.randn(noun_width, generator=g)
    torch.save(noun_dict, os.path.join(meta, "noun_dict_lavila_embeds.pth"))
    torch.save({}, os.path.join(meta, "lavila_rephrased.pth"))

    # distinct per-clip boxes (raw pixels on a 32x48 "original")
    hdir = os.path.join(data, "hand_object_clip_per_video_4f_lavila_narrator_640", uid)
    os.makedirs(hdir)
    info = {}
    for i in range(K):
        x = 2 + 2 * i
        per_clip = {
            fi: {
                "hand_dets": np.array([[x, 4, x + 8, 14, 0.9]], np.float32),
                "obj_dets": np.array([[x + 1, 10, x + 12, 26, 0.8]], np.float32),
            }
            for fi in range(4)
        }
        per_clip["info"] = {"height": 32, "width": 48}
        info[round(float(i), 3)] = per_clip
    with open(os.path.join(hdir, "0.handobj.pkl"), "wb") as f:
        pickle.dump(info, f)
    return meta, data


def tiny_models(t=4):
    """The JAX tool's tiny towers as the port's modules, seeded -> (lavila
    config, backbone, decoder config, decoder), on the CPU."""
    import torch

    from helping_hand_for_egocentric_videos_torch.models import (
        DecoderConfig,
        Lavila,
        LavilaConfig,
        ObjDecoder,
        SpaceTimeConfig,
        TextConfig,
    )

    lavila_cfg = LavilaConfig(
        visual=SpaceTimeConfig(img_size=RES, patch_size=14, width=32, depth=2, heads=4, num_frames=t),
        text=TextConfig(width=32, heads=4, layers=2, embed_dim=16),
        embed_dim=16,
    )
    dec_cfg = DecoderConfig(
        d_model=32, nhead=4, num_layers=2, dim_feedforward=64, num_queries=13, num_classes=8, feature_dim=32,
        text_width=32, embed_dim=16, num_frames=t, patches_per_frame=lavila_cfg.visual.patches_per_frame,
    )
    backbone = Lavila(lavila_cfg, generator=torch.Generator().manual_seed(0))
    decoder = ObjDecoder(dec_cfg, generator=torch.Generator().manual_seed(1))
    return lavila_cfg, backbone, dec_cfg, decoder


def large_models(t=4):
    """TimeSformer-L at ``t`` frames and the 13-query decoder at its default
    widths over its features, from one seeded generator, time attention
    N(0, 0.02) (zero in the model, which would feed its kernel zeros) -> as
    ``tiny_models``."""
    import torch

    from helping_hand_for_egocentric_videos_torch.models import (
        DecoderConfig,
        Lavila,
        ObjDecoder,
        timesformer_large_config,
    )

    lavila_cfg = timesformer_large_config(num_frames=t)
    dec_cfg = DecoderConfig(num_frames=t, feature_dim=lavila_cfg.visual.width, text_width=lavila_cfg.text.width,
                            patches_per_frame=lavila_cfg.visual.patches_per_frame, pred_traj=True)
    gen = torch.Generator().manual_seed(0)
    backbone = Lavila(lavila_cfg, generator=gen)
    decoder = ObjDecoder(dec_cfg, generator=gen)
    with torch.no_grad():
        for blk in backbone.visual.blocks:
            blk.timeattn.qkv.weight.normal_(0.0, 0.02, generator=gen)
            blk.timeattn.proj.weight.normal_(0.0, 0.02, generator=gen)
    return lavila_cfg, backbone, dec_cfg, decoder


def main(steps: int, eval_freq: int, lr: float, out_path: str | None, towers: str = "tiny",
         device=None) -> dict:
    from helping_hand_for_egocentric_videos_torch.core.config import ExperimentConfig
    from helping_hand_for_egocentric_videos_torch.train.pretrain import pretrain

    models = tiny_models() if towers == "tiny" else large_models()
    lavila_cfg = models[0]
    with tempfile.TemporaryDirectory() as tmp:
        meta, data = build_fixture(tmp, noun_width=lavila_cfg.text.width)
        cfg = ExperimentConfig(name="learnproof", output_dir=os.path.join(tmp, "runs"))
        cfg.data.meta_dir = meta
        cfg.data.data_dir = data
        cfg.data.batch_size = 4
        cfg.data.num_frames = 4
        cfg.data.input_res = lavila_cfg.visual.img_size
        cfg.data.num_workers = 2
        cfg.model.num_queries = 12
        cfg.optim.lr = lr
        cfg.optim.epochs = 10_000  # max_steps stops the run
        cfg.optim.eval_freq = eval_freq
        cfg.optim.runtime_save_iter = 10**9
        cfg.optim.log_flush_iter = eval_freq
        cfg.parallel.backbone_dtype = "float32" if towers == "tiny" else "bfloat16"
        cfg.parallel.num_devices = 1

        _, best = pretrain(cfg, max_steps=steps, eval_limit=K, models=models, device=device)

        exp = os.path.join(tmp, "runs", "learnproof")
        with open(os.path.join(exp, "train_metrics.jsonl")) as f:
            train_lines = [json.loads(ln) for ln in f]
        with open(os.path.join(exp, "val_metrics.jsonl")) as f:
            val_lines = [json.loads(ln) for ln in f]

    def curve(lines, key):
        return [(ln["step"], round(ln[key], 4)) for ln in lines if key in ln]

    loss_curve = curve(train_lines, "local/total_loss")
    box_curve = curve(train_lines, "local/box_loss")
    acc_curve = curve(val_lines, "egomcq/Inter-video")
    result = {
        "what": "the port's pretrain loop (dataset->loader->step->EgoMCQ eval) on a learnable miniature "
                f"fixture; {towers} towers on {device or 'cuda'}",
        "towers": towers,
        "device": str(device or "cuda"),
        "steps": steps,
        "chance_acc_pct": 100.0 / 5,  # 5 choices; the accuracies are in %
        "final_inter_video_acc": acc_curve[-1][1] if acc_curve else None,
        "best_inter_video_acc": float(best),
        "first_total_loss": loss_curve[0][1] if loss_curve else None,
        "final_total_loss": loss_curve[-1][1] if loss_curve else None,
        "first_box_loss": box_curve[0][1] if box_curve else None,
        "final_box_loss": box_curve[-1][1] if box_curve else None,
        "acc_curve": acc_curve,
        "loss_curve_head": loss_curve[:3],
        "loss_curve_tail": loss_curve[-3:],
        "box_curve_head": box_curve[:3],
        "box_curve_tail": box_curve[-3:],
    }
    result["pass"] = bool(
        result["best_inter_video_acc"] >= 50.0  # chance is 20%
        and result["first_box_loss"] is not None
        and result["final_box_loss"] < 0.7 * result["first_box_loss"]
    )
    if out_path:
        os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
        with open(out_path, "w") as f:
            json.dump(result, f, indent=2)
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--eval_freq", type=int, default=50)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--towers", choices=("tiny", "large"), default="large")
    p.add_argument("--device", default=None, help="torch device (default: the CUDA device; 'cpu' for the CPU)")
    p.add_argument("--out", default=os.path.join(REPO, "build", "torch_learning_proof.json"))
    a = p.parse_args()
    res = main(a.steps, a.eval_freq, a.lr, a.out, a.towers, a.device)
    sys.exit(0 if res["pass"] else 1)
