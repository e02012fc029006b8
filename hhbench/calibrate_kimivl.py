"""Readings for setting the limits of ``kimivl4f336.b64x10``: the compared
numbers of the program, of its low-precision controls and of planted
faults, over many seeds in one process (so the card is reached once).

    python3 hhbench/calibrate_kimivl.py --variant program ref_fp8_experts tail_late --seeds 11 12 --seconds 8

``--variant``: ``program`` (the cell as it runs); a control, judged against
the float32 reference as the program is, on the clips the program kept at
that seed (its uint8 clips, prompt and ids; so each seed runs the program
once): the reference's tower, projector and language model, teacher-forced
on the program's ids, with ``ref_fp8_experts`` the experts' products in
fp8 (``lowp.fp8_linear``), ``ref_fp8`` every product in fp8, and
``ref_bf16_router`` the router's product and sigmoid in bf16; or a fault
of ``kimivl_faults.py`` planted in the program. Prints one JSON line a
reading; ``--out`` appends them to a file as well. The benchmark's runs
never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from hhbench import harness  # noqa: E402
from hhbench.kimivl_faults import FAULTS, planted  # noqa: E402

CELL = "kimivl4f336.b64x10"
# control name -> (the parts whose products run in fp8, the router's type or None for float32)
CONTROLS = {"ref_fp8_experts": (("experts",), None), "ref_fp8": (("visual", "projector", "lm", "experts"), None),
            "ref_bf16_router": ((), "bfloat16")}
VARIANTS = ("program", *CONTROLS, *FAULTS)


def program_run(cell: harness.Cell, seed: int, seconds: float, device, fault=None):
    """(the run, its compared numbers, correct) of the program, with ``fault`` planted."""
    run = harness.Run(cell=cell, seed=seed, seconds=seconds, trace=False, device=device)
    with planted(fault):
        result = harness.drive(run)
    compared = result.check()
    correct, _ = harness.judge(compared, cell.limits)
    return run, result, compared, correct and result.failed == 0


def control_clips(kept: list, cfg: dict, seed: int, device, parts=(), router=None) -> list:
    """The kept clips as a control makes them: the reference's tower,
    projector and language model on the program's uint8 clips, prompt and
    ids, the products of ``parts`` in fp8 and the router in ``router`` (a
    torch type's name)."""
    import torch

    from hhbench import kimivl_weights
    from hhbench.reference import full_f32, lowp, kimivl as ref, preprocess

    def mm(part):
        return lowp.fp8_linear if part in parts else None

    w = kimivl_weights.LayerWeights(cfg, seed, device)
    p = cfg["prompt_len"] + cfg["visual"]["num_frames"] * (cfg["visual"]["img_size"] // cfg["visual"]["patch_size"]
                                                            // cfg["projector"]["merge"]) ** 2
    n_moe = cfg["num_hidden_layers"] - cfg["first_k_dense_replace"]
    lm_mm = {k: mm(k) for k in ("lm", "experts") if mm(k) is not None}
    out = []
    with torch.no_grad(), full_f32():
        for c in kept:
            video = preprocess.resize_normalize(c["clip"][None].to(device), cfg["visual"]["img_size"])
            tokens = ref.tower(w, cfg, video, mm("visual"))
            vis = ref.project(w, cfg, tokens, mm("projector") or ref._mm)
            ids = c["ids"].to(device)
            record: list = []
            latents: list = []
            prefix = ref.prefix_embeds(w, vis, c["prompt"].to(device)).expand(ids.shape[0], -1, -1)
            logits = ref.lm_logits(w, cfg, prefix, ids[:, :-1], mm=lm_mm, router=router and getattr(torch, router),
                                   record=record, latents=latents)
            lat = torch.stack(latents)
            out.append({"clip": c["clip"], "prompt": c["prompt"], "tokens": tokens[0], "vis": vis[0], "ids": c["ids"],
                        "prefix_routes": torch.stack([record[j][0, :p] for j in range(n_moe - 1)]),
                        "routes": [torch.stack([record[j][:, p + s] for j in range(n_moe)])
                                   for s in range(ids.shape[1] - 1)],
                        "logits": list(logits.transpose(0, 1)), "prefix_cache": lat[:, 0, :p],
                        "tail_cache": lat[:, :, p:]})
    return out


def main(argv=None) -> int:
    a = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    a.add_argument("--variant", choices=VARIANTS, nargs="+", default=["program"])
    a.add_argument("--seeds", type=int, nargs="+", required=True)
    a.add_argument("--seconds", type=float, default=8.0)
    a.add_argument("--warmup_s", type=float, default=None, help="the warm-up's cap (default: the traffic's)")
    a.add_argument("--out", default=None)
    args = a.parse_args(argv)
    import dataclasses

    import numpy as np
    import torch

    from hhbench import common, kimivl_weights
    from hhbench.mixes import narrate_moe

    if not torch.cuda.is_available():
        print("calibrate_kimivl: no CUDA device", file=sys.stderr)
        return 3
    cell = harness.load_cell(CELL)
    if args.warmup_s is not None:
        cell = dataclasses.replace(cell, params={**cell.params, "warmup_s": args.warmup_s,
                                                 "warmup_min_s": min(args.warmup_s, cell.params["warmup_min_s"])})
    dev = torch.device("cuda", 0)

    def emit(line):
        text = json.dumps(line)
        print(text, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(text + "\n")

    controls = [v for v in args.variant if v in CONTROLS]
    for seed in args.seeds:
        if "program" in args.variant or controls:
            run, result, compared, correct = program_run(cell, seed, args.seconds, dev)
            emit({"workload": CELL, "variant": "program", "seed": seed, "compared": compared, "correct": correct,
                  "e2e": result.e2e, "attempted": result.attempted, "memory_peak_bytes": run.memory_peak})
            pick = np.sort(common.rng(seed, 44).choice(len(run.kept), size=min(cell.params["check_batches"],
                                                                               len(run.kept)), replace=False))
            kept = [run.kept[k] for k in pick]
            del run, result
            for control in controls:
                clips = control_clips(kept, cell.cfg, seed, dev, *CONTROLS[control])
                compared = narrate_moe.compare(clips, cell.cfg, kimivl_weights.LayerWeights(cell.cfg, seed, dev), dev)
                correct, _ = harness.judge(compared, cell.limits)
                emit({"workload": CELL, "variant": control, "seed": seed, "compared": compared, "correct": correct})
                del clips
            del kept
            torch.cuda.empty_cache()
        for fault in (v for v in args.variant if v in FAULTS):
            run, result, compared, correct = program_run(cell, seed, args.seconds, dev, fault)
            emit({"workload": CELL, "variant": fault, "seed": seed, "compared": compared, "correct": correct,
                  "e2e": result.e2e})
            del run, result
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
