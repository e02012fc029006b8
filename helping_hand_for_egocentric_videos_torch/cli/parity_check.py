"""CLI: one-command accuracy-parity certification against released weights.

Counterpart of ``helping_hand_for_egocentric_videos_tpu/cli/parity_check.py``;
the report also names the backend (``"torch"``) and the device.

The standing task the moment the released artifacts exist (the LaviLa
backbone ``.pth``, the helping-hands decoder ``.pth.tar``, dataset
metadata): run the complete proof chain in one command and emit a
machine-readable report —

1. every selected zero-shot harness (EgoMCQ / Epic-MIR / EGTEA) on the
   converted weights, with raw similarity dumps
   (the reference's torch.save's: run/test_EgoMCQ.py:119,
   run/test_epic.py:263-265),
2. optionally the same harnesses int8-quantized, diffing the similarity
   dumps f32-vs-int8 (per-item argmax agreement + Spearman rank
   correlation — the tests/test_quant.py release gate, on real weights),
3. every metric against a target table with the ±``--tol`` (0.5 pt)
   parity gate (BASELINE.md publishes no reference numbers — pass your
   measured reference-run numbers via ``--targets``),
4. ``PARITY_REPORT.json`` with metrics, deltas, checkpoint SHA256s and
   the verdict.

Example:
    python -m helping_hand_for_egocentric_videos_torch.cli.parity_check \\
        --backbone_ckpt lavila_large.pth --decoder_ckpt nq12.pth.tar \\
        --egomcq_meta meta/egoclip --egomcq_data /data/ego4d \\
        --epic_meta meta/epic --epic_data /data/epic \\
        --egtea_meta meta/egtea --egtea_data /data/egtea \\
        --targets reference_numbers.json --int8_diff --out_dir parity
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os

import numpy as np
import torch

from . import common


def _spearman(a: np.ndarray, b: np.ndarray) -> float:
    """Rank correlation (no tie correction; float sims rarely tie)."""
    a, b = np.asarray(a).ravel(), np.asarray(b).ravel()
    ra = np.argsort(np.argsort(a)).astype(np.float64)
    rb = np.argsort(np.argsort(b)).astype(np.float64)
    ra -= ra.mean()
    rb -= rb.mean()
    denom = np.sqrt((ra**2).sum() * (rb**2).sum())
    return float((ra * rb).sum() / denom) if denom else 1.0

def _jsonable(obj):
    """numpy scalars/arrays -> plain python, recursively."""
    if isinstance(obj, dict):
        return {k: _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if isinstance(obj, np.generic):
        return obj.item()
    return obj


def _sha256(path: str) -> str | None:
    if not path or not os.path.isfile(path):
        return None
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for blk in iter(lambda: f.read(1 << 20), b""):
            h.update(blk)
    return h.hexdigest()


def _sim_agreement(f32_npz: str, int8_npz: str, key: str) -> dict:
    """Rank stability of the int8 path vs f32 on identical inputs:
    per-row argmax agreement + global Spearman over the sim matrices
    (the tests/test_quant.py gate, applied to real dumps)."""
    a = np.load(f32_npz)[key]
    b = np.load(int8_npz)[key]
    assert a.shape == b.shape, (a.shape, b.shape)
    return {
        "argmax_agreement": float(
            np.mean(np.argmax(a, axis=-1) == np.argmax(b, axis=-1))
        ),
        "spearman": _spearman(a, b),
        "max_abs_diff": float(np.max(np.abs(a - b))),
    }


def _run_harnesses(args, get_model, out_dir: str, tag: str, limit) -> dict:
    """Run every harness whose meta/data dirs were given under ITS OWN
    reference protocol — get_model(num_frames, preprocess) returns a
    model built for that frame count (EgoMCQ evaluates at 4 frames,
    Epic/EGTEA at 16; EGTEA uses short-side + center-crop, the retrieval
    harnesses squash-resize — matching the test_* CLIs). Returns
    {harness: metrics}; sim dumps land in ``out_dir`` tagged f32/int8."""
    results = {}
    if args.egomcq_meta:
        from ..data.egoclip import EgoClipConfig, EgoClipDataset
        from ..train.evaluate import run_egomcq

        ds = EgoClipDataset(
            EgoClipConfig(
                meta_dir=args.egomcq_meta,
                data_dir=args.egomcq_data,
                split="val",
                num_frames=args.egomcq_frames,
            )
        )
        results["egomcq"] = run_egomcq(
            get_model(args.egomcq_frames, "resize"),
            ds,
            limit=limit,
            progress=common.progress,
            out_sims=os.path.join(out_dir, f"egomcq_sims_{tag}.npz"),
        )
    if args.epic_meta:
        import pickle

        from ..data.epic import EpicConfig, EpicMIRDataset
        from ..train.evaluate import run_epic_mir

        with open(
            os.path.join(
                args.epic_meta,
                "relevancy/caption_relevancy_EPIC_100_retrieval_test.pkl",
            ),
            "rb",
        ) as f:
            relevancy = pickle.load(f)
        with open(os.path.join(args.epic_meta, "indexes.pkl"), "rb") as f:
            indexes = np.asarray(pickle.load(f))
        ds = EpicMIRDataset(
            EpicConfig(
                meta_dir=args.epic_meta,
                data_dir=args.epic_data,
                split="test",
                num_frames=args.epic_frames,
            )
        )
        results["epic"] = run_epic_mir(
            get_model(args.epic_frames, "resize"),
            ds,
            relevancy,
            indexes,
            progress=common.progress,
            out_sims=os.path.join(out_dir, f"epic_sims_{tag}.npz"),
        )
    if args.egtea_meta:
        from ..data.egtea import EgteaConfig, EgteaDataset, generate_label_map
        from ..train.evaluate import run_egtea

        labels, _ = generate_label_map(
            os.path.join(args.egtea_meta, "action_idx.txt")
        )
        model = get_model(args.egtea_frames, "shortside")
        per_split = []
        for split in args.egtea_splits:
            ds = EgteaDataset(
                EgteaConfig(
                    root=args.egtea_data,
                    metadata=os.path.join(args.egtea_meta, f"test_split{split}.txt"),
                    anno_dir=args.egtea_meta,
                    num_clips=args.egtea_num_clips,
                    clip_length=args.egtea_frames,
                    clip_stride=2,
                )
            )
            per_split.append(run_egtea(model, ds, labels, progress=common.progress))
        results["egtea"] = {
            "mean_class_acc": float(
                np.mean([r["mean_class_acc"] for r in per_split])
            ),
            "top1": float(np.mean([r["top1"] for r in per_split])),
            "splits": per_split,
        }
    return results


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--backbone", default="timesformer_large")
    p.add_argument("--backbone_ckpt", default="")
    p.add_argument("--decoder_ckpt", default="")
    p.add_argument("--num_queries", type=int, default=12)
    p.add_argument("--device", default="cuda",
                   help="torch device of the models (default: the CUDA device; 'cpu' runs the "
                   "kernels' plain versions)")
    # per-harness frame counts default to the reference protocols
    # (EgoMCQ evaluates at 4 frames — cli.test_egomcq; Epic/EGTEA at 16)
    p.add_argument("--egomcq_frames", type=int, default=4)
    p.add_argument("--epic_frames", type=int, default=16)
    p.add_argument("--egtea_frames", type=int, default=16)
    for name in ("egomcq", "epic", "egtea"):
        p.add_argument(f"--{name}_meta", default="", help=f"{name} metadata dir (omit to skip)")
        p.add_argument(f"--{name}_data", default="")
    p.add_argument("--egtea_splits", nargs="*", default=["1", "2", "3"])
    p.add_argument("--egtea_num_clips", type=int, default=10)
    p.add_argument(
        "--targets",
        default="",
        help="json of reference numbers to gate against, flat keys "
        '"harness.metric" (e.g. {"egomcq.Inter-video": 63.7, '
        '"epic.mAP_AVG": 32.5, "egtea.mean_class_acc": 39.1})',
    )
    p.add_argument("--tol", type=float, default=0.5, help="parity gate, points")
    p.add_argument(
        "--int8_diff",
        action="store_true",
        help="also run the int8-quantized tower and diff sim dumps "
        "(rank-stability release gate on real weights)",
    )
    p.add_argument("--int8_fallback", type=float, default=None)
    p.add_argument(
        "--int8_argmax_min", type=float, default=0.9,
        help="int8 gate: min per-item argmax agreement vs f32",
    )
    p.add_argument(
        "--int8_spearman_min", type=float, default=0.99,
        help="int8 gate: min Spearman rank correlation vs f32",
    )
    p.add_argument("--limit", type=int, default=0, help="EgoMCQ item cap (0 = all)")
    p.add_argument("--out_dir", default="parity_report")
    args = p.parse_args(argv)
    if not (args.egomcq_meta or args.epic_meta or args.egtea_meta):
        p.error("give at least one of --egomcq_meta / --epic_meta / --egtea_meta")
    common.print_env(args.device)
    os.makedirs(args.out_dir, exist_ok=True)

    limit = args.limit or None
    device = torch.device(args.device)
    report = {
        "backend": "torch",
        "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        "backbone": args.backbone,
        "backbone_ckpt": args.backbone_ckpt,
        "backbone_ckpt_sha256": _sha256(args.backbone_ckpt),
        "decoder_ckpt": args.decoder_ckpt,
        "decoder_ckpt_sha256": _sha256(args.decoder_ckpt),
        "frames": {
            "egomcq": args.egomcq_frames,
            "epic": args.epic_frames,
            "egtea": args.egtea_frames,
        },
        "tol_points": args.tol,
    }

    cache = {}

    def model_factory(int8: bool):
        def get_model(num_frames: int, preprocess: str):
            key = (num_frames, int8)
            if key not in cache:
                args.num_frames = num_frames  # build_eval_model reads this
                args.int8 = int8
                cache[key] = common.build_eval_model(args)[0]
            model = cache[key]
            model.preprocess = preprocess  # per-harness eval transform
            return model

        return get_model

    report["metrics"] = _run_harnesses(
        args, model_factory(int8=False), args.out_dir, "f32", limit
    )

    if args.int8_diff:
        report["metrics_int8"] = _run_harnesses(
            args, model_factory(int8=True), args.out_dir, "int8", limit
        )
        agreement = {}
        for name, key in (("egomcq", "sims"), ("epic", "pred")):
            f32 = os.path.join(args.out_dir, f"{name}_sims_f32.npz")
            q = os.path.join(args.out_dir, f"{name}_sims_int8.npz")
            if os.path.exists(f32) and os.path.exists(q):
                ag = _sim_agreement(f32, q, key)
                # the tests/test_quant.py rank-stability release gate,
                # applied to the real dumps
                ag["pass"] = (
                    ag["argmax_agreement"] >= args.int8_argmax_min
                    and ag["spearman"] >= args.int8_spearman_min
                )
                agreement[name] = ag
        report["int8_agreement"] = agreement
        report["int8_certified"] = bool(agreement) and all(
            a["pass"] for a in agreement.values()
        )

    if args.targets:
        with open(args.targets) as f:
            targets = json.load(f)
        gate = {}
        for key, want in targets.items():
            harness, _, metric = key.partition(".")
            got = report["metrics"].get(harness, {}).get(metric)
            if got is None:
                gate[key] = {"target": want, "got": None, "pass": False,
                             "note": "metric not produced"}
                continue
            gate[key] = {
                "target": float(want),
                "got": float(got),
                "delta": float(got) - float(want),
                "pass": abs(float(got) - float(want)) <= args.tol,
            }
        report["gate"] = gate
        certified = bool(gate) and all(g["pass"] for g in gate.values())
        if args.int8_diff:
            # int8 sign-off requires the rank-stability gate too
            certified = certified and report.get("int8_certified", False)
        report["certified"] = certified

    report = _jsonable(report)
    out_path = os.path.join(args.out_dir, "PARITY_REPORT.json")
    with open(out_path, "w") as f:
        json.dump(report, f, indent=2)
    print(json.dumps({k: v for k, v in report.items() if k != "metrics_int8"}, indent=2))
    print(f"report -> {out_path}")
    return report


if __name__ == "__main__":
    main()
