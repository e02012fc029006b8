"""Int8-vs-f32 cosine of the JAX package's video embeddings at full depth.

Sets the gate of the int8 serving path in ``chip_smoke.py`` (phase
"end-to-end int8"): the port's int8 video embeddings must keep a cosine
with its bf16 ones of at least the floor this script prints, which is the
JAX package's own int8-vs-f32 cosine less a margin.

The model is the smoke's: TimeSformer-L/14 (width 1024, depth 24, heads
16) at 224x224 with the 13-query decoder, random weights from a seed, the
time attention given N(0, 0.02) weights (its zero init would make it an
identity). To run on a CPU the clips are cut from 16 frames to
``--frames``; widths and depth are the full model's. The int8 model is
``EvalModel(int8=True)`` with its bf16 stream, the f32 model
``EvalModel(dtype=float32)``; on a CPU both take the XLA path.

    JAX_PLATFORMS=cpu python tools/int8_cosine_floor.py [--frames 4] [--margin 0.01]

Prints one JSON line: the per-clip cosines, their minimum and the floor.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from helping_hand_for_egocentric_videos_tpu.data.tokenizer import ClipTokenizer  # noqa: E402
from helping_hand_for_egocentric_videos_tpu.models import lavila as lv  # noqa: E402
from helping_hand_for_egocentric_videos_tpu.models import obj_decoder as od  # noqa: E402
from helping_hand_for_egocentric_videos_tpu.train.evaluate import EvalModel  # noqa: E402


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=4)
    ap.add_argument("--clips", type=int, default=2)
    ap.add_argument("--margin", type=float, default=0.01)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    t0 = time.perf_counter()
    lcfg = lv.timesformer_large_config(num_frames=args.frames)
    dcfg = od.DecoderConfig(num_queries=13, feature_dim=1024, text_width=768,
                            num_frames=args.frames, pred_traj=False)
    backbone = lv.init_lavila_params(jax.random.PRNGKey(args.seed), lcfg)
    decoder = od.init_decoder_params(jax.random.PRNGKey(args.seed + 1), dcfg)
    rng = np.random.default_rng(args.seed)
    ta = backbone["visual"]["blocks"]["timeattn"]
    for name in ("qkv", "proj"):
        ta[name]["w"] = jnp.asarray(rng.normal(0.0, 0.02, size=ta[name]["w"].shape), jnp.float32)

    kw = dict(lavila_cfg=lcfg, decoder_params=decoder, dec_cfg=dcfg, tokenizer=ClipTokenizer())
    f32 = EvalModel(backbone_params=backbone, dtype=jnp.float32, **kw)
    int8 = EvalModel(backbone_params=backbone, int8=True, **kw)
    clips = rng.integers(0, 256, size=(args.clips, args.frames, 224, 224, 3), dtype=np.uint8)
    ref, _ = f32.embed_video(clips)
    got, _ = int8.embed_video(clips)
    cos = (got * ref).sum(-1) / (np.linalg.norm(got, axis=-1) * np.linalg.norm(ref, axis=-1))
    print(json.dumps({
        "model": "TimeSformer-L/14 + 13-query decoder, depth 24, width 1024, 224x224",
        "frames": args.frames, "clips": args.clips, "seed": args.seed,
        "int8_vs_f32_cosine": cos.tolist(), "min": float(cos.min()), "margin": args.margin,
        "floor": float(cos.min()) - args.margin, "seconds": time.perf_counter() - t0,
        "backend": jax.default_backend(),
    }))


if __name__ == "__main__":
    main()
