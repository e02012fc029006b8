"""Readings for setting the limits of ``narrate4f336.b64x10``: the compared
numbers of the program, of its control and of planted faults, over many
seeds in one process (so the card is reached once).

    python3 hhbench/calibrate_narrate.py --variant program ref_fp8_lm self_cache_late --seeds 11 12 --seconds 4

``--variant``: ``program`` (the cell as it runs); a control (no program:
the reference in its place, sampling its own sequences from its own
logits, judged against the float32 reference as the program is), with
the products of the parts it names in fp8 (``lowp.fp8_linear``):
``ref_fp8_lm`` the language model's and its cross-attention's, the tower
and the pooler float32, ``ref_fp8`` every part's; or with the language
model's LayerNorm statistics, attention softmax and logits in bf16, the
rest float32: ``ref_bf16_ln_softmax_logits``; or a fault of
``narrate_faults.py`` planted in the program. Prints one JSON line a seed;
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
from hhbench.narrate_faults import FAULTS, planted  # noqa: E402

CELL = "narrate4f336.b64x10"
# control name -> (the parts whose products run in fp8, the type of the language
# model's LayerNorms, softmax and logits, None for float32)
CONTROLS = {"ref_fp8_lm": (("lm",), None), "ref_fp8": (("visual", "pool", "lm"), None),
            "ref_bf16_ln_softmax_logits": ((), "bfloat16")}
VARIANTS = ("program", *CONTROLS, *FAULTS)


def reading(cell: harness.Cell, seed: int, seconds: float, variant: str, device) -> dict:
    if variant in CONTROLS:
        compared = control_compared(cell, seed, device, *CONTROLS[variant])
        correct, _ = harness.judge(compared, cell.limits)
        return {"workload": cell.name, "variant": variant, "seed": seed, "compared": compared, "correct": correct}
    run = harness.Run(cell=cell, seed=seed, seconds=seconds, trace=False, device=device)
    with planted(variant if variant in FAULTS else None):
        result = harness.drive(run)
    compared = result.check()
    correct, _ = harness.judge(compared, cell.limits)
    return {"workload": cell.name, "variant": variant, "seed": seed, "compared": compared,
            "correct": correct and result.failed == 0, "e2e": result.e2e, "attempted": result.attempted,
            "memory_peak_bytes": run.memory_peak}


def control_compared(cell: harness.Cell, seed: int, device, parts=("lm",), low=None) -> dict:
    """A control's compared numbers: ``check_batches`` clips drawn as
    ``mixes/narrate.py`` draws its kept ones, each through the reference's
    tower and pooler and then sampled by its language model, the products
    of ``parts`` in fp8 and the language model's LayerNorms, softmax and
    logits in ``low`` (a torch type's name)."""
    import torch
    import torch.nn.functional as F

    from hhbench import common, narrator_weights
    from hhbench.mixes import narrate
    from hhbench.reference import full_f32, lowp, narrator as ref, preprocess

    cfg, p = cell.cfg, cell.params
    mm = {part: lowp.fp8_linear if part in parts else F.linear for part in ("visual", "pool", "lm")}
    w = narrator_weights.make(cfg, seed, device)
    pool = narrate.make_pool(cfg, p, seed, device)
    rows = common.rng(seed, 43)
    clips = []
    with torch.no_grad(), full_f32():
        for k in range(p["check_batches"]):
            clip = pool[k % len(pool)][int(rows.integers(p["batch"]))]
            video = preprocess.resize_normalize(clip[None], cfg["visual"]["img_size"])
            tokens = ref.tower(w, cfg, video, mm["visual"])
            latents = ref.pool(w, cfg, tokens, mm["pool"])
            ids, logits = ref.generate(w, cfg, latents, narrate.batch_generator(seed, k, device), mm["lm"],
                                       low and getattr(torch, low))
            clips.append({"clip": clip, "tokens": tokens[0], "latents": latents[0], "logits": list(logits),
                          "ids": ids})
    del pool
    return narrate.compare(clips, cfg, w, device)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--variant", choices=VARIANTS, nargs="+", default=["program"])
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=4.0)
    p.add_argument("--out", default=None)
    a = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("calibrate_narrate: no CUDA device", file=sys.stderr)
        return 3
    cell = harness.load_cell(CELL)
    for variant in a.variant:
        for seed in a.seeds:
            line = json.dumps(reading(cell, seed, a.seconds, variant, torch.device("cuda", 0)))
            print(line, flush=True)
            if a.out:
                with open(a.out, "a") as f:
                    f.write(line + "\n")
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
