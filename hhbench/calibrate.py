"""Readings for setting a cell's limits: the compared numbers of the
program, of its controls and of planted faults, over many seeds in one
process (so the card is reached once).

    python3 hhbench/calibrate.py --workload <cell> --variant program ref_fp8 --seeds 11 12 13 --seconds 4

``--variant``: ``program`` (the cell as it runs); ``int8`` (the
program's own int8 tower in place of the bf16 one: the configuration's
``precision.visual`` set to ``"int8"``); a control of
``reference/lowp.py``'s ``CONTROLS`` (no program: the reference in the
program's place, the named part's products in a lower precision, judged
against the float32 reference as the program is); or a fault of
``faults.py`` planted in the program. Prints one JSON line a seed;
``--out`` appends them to a file as well. The benchmark's runs never run
this.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from hhbench import harness  # noqa: E402
from hhbench.faults import FAULTS  # noqa: E402
from hhbench.reference.lowp import CONTROLS  # noqa: E402

VARIANTS = ("program", "int8", *CONTROLS, *FAULTS)


def reading(cell: harness.Cell, seed: int, seconds: float, variant: str, device) -> dict:
    import dataclasses

    if variant in CONTROLS:
        return control_reading(cell, seed, variant, device)
    fault = variant if variant not in ("program", "int8") else None
    cfg = cell.cfg
    if variant == "int8":
        cfg = dict(cfg, precision=dict(cfg["precision"], visual="int8"))
    run = harness.Run(cell=dataclasses.replace(cell, cfg=cfg, params=dict(cell.params, fault=fault)), seed=seed,
                      seconds=seconds, trace=False, device=device)
    result = harness.drive(run)
    compared = result.check()
    correct, _ = harness.judge(compared, cell.limits)
    return {"workload": cell.name, "variant": variant, "seed": seed, "compared": compared,
            "correct": correct and result.failed == 0, "e2e": result.e2e, "failed": result.failed,
            "attempted": result.attempted}


def control_reading(cell: harness.Cell, seed: int, name: str, device) -> dict:
    """The reference in the program's place with the products of the part
    that control ``name`` names in its lower precision, compared with the
    float32 reference as the program is: the three training steps, or the
    embeddings of ``check_clips`` clips from the seed at the cell's input
    shape."""
    import numpy as np
    import torch

    from hhbench import common, weights
    from hhbench.mixes import embed_store, train_step
    from hhbench.reference import full_f32, model as ref, preprocess

    prec = CONTROLS[name]
    cfg, p = cell.cfg, cell.params
    if cell.driver == "train_step":
        low = train_step.reference_steps(cfg, p, seed, device, prec=prec)
        f32 = train_step.reference_steps(cfg, p, seed, device, features=low["feats"])
        compared = train_step.compare(low, f32)
    else:
        v = cfg["visual"]
        hw = p.get("frame_hw", [v["img_size"], v["img_size"]])
        n, block = p.get("check_clips", p.get("check_requests", 8)), p.get("check_block", 4)
        video = common.rng(seed, 31).integers(0, 256, size=(n, v["num_frames"], *hw, 3), dtype=np.uint8)
        wb, wd = weights.make(cfg, "backbone", seed, device), weights.make(cfg, "decoder", seed, device)
        with torch.no_grad(), full_f32():
            x = preprocess.resize_normalize(torch.as_tensor(video, device=device), v["img_size"])
            emb, boxes, grids = ref.embed_clips(wb, wd, cfg, x, block=block, prec=prec, keep_grid=True)
        del x
        compared = embed_store.embed_compare(emb.cpu(), boxes.cpu(), grids.cpu(), video, cfg, wb, wd, device, block)
    correct, _ = harness.judge(compared, cell.limits)
    return {"workload": cell.name, "variant": name, "seed": seed, "compared": compared, "correct": correct}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--variant", choices=VARIANTS, nargs="+", default=["program"])
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=4.0)
    p.add_argument("--out", default=None)
    a = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 3
    cell = harness.load_cell(a.workload)
    for variant in a.variant:
        for seed in a.seeds:
            line = json.dumps(reading(cell, seed, a.seconds, variant, torch.device("cuda", 0)))
            print(line, flush=True)
            if a.out:
                with open(a.out, "a") as f:
                    f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
