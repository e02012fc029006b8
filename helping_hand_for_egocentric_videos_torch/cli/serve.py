"""CLI: serve the dual encoder over HTTP.

Counterpart of ``helping_hand_for_egocentric_videos_tpu/cli/serve.py``.
Loads the reference's checkpoints, inflates the temporal embeddings to
``--num_frames``, warms the configured batch buckets (the kernels build at
first use, so no request pays for it) and serves embed_text / embed_video
/ similarity with cross-request micro-batching (serve/engine.py).
``--int8`` serves the quantized tower.

Example:
    python -m helping_hand_for_egocentric_videos_torch.cli.serve \\
        --backbone_ckpt lavila_large.pth --decoder_ckpt nq12.pth.tar \\
        --num_frames 16 --port 8471
"""

from __future__ import annotations

import argparse
import threading

from . import common


def main(argv=None, *, ready=None, stop=None):
    """``ready``/``stop``: test hooks. ``ready(server, engine)`` is called
    once listening; if ``stop`` (a threading.Event) is given the loop
    exits when it is set instead of serving forever."""
    p = argparse.ArgumentParser(description=__doc__)
    common.add_eval_args(p)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8471)
    p.add_argument("--clip_hw", type=int, nargs=2, default=(224, 224),
                   metavar=("H", "W"), help="deployment clip resolution")
    p.add_argument("--buckets", type=int, nargs="*", default=[1, 2, 4, 8, 16])
    p.add_argument("--max_wait_ms", type=float, default=4.0)
    p.add_argument(
        "--warmup_buckets", type=int, nargs="*", default=[],
        help="buckets to run at startup (default: every bucket)",
    )
    args = p.parse_args(argv)
    common.print_env(args.device)

    from ..serve import ServeConfig, ServingEngine
    from ..serve.server import make_server

    model, _, _ = common.build_eval_model(args)
    h, w = args.clip_hw
    engine = ServingEngine(
        model,
        video_shape=(args.num_frames, h, w, 3),
        cfg=ServeConfig(
            buckets=tuple(args.buckets),
            max_wait_ms=args.max_wait_ms,
            warmup_buckets=tuple(args.warmup_buckets) or None,
        ),
    )
    print("warming buckets", args.warmup_buckets or args.buckets, flush=True)
    engine.warmup()
    srv = make_server(engine, args.host, args.port)
    print(f"serving on http://{args.host}:{srv.server_address[1]}", flush=True)
    if ready is not None:
        ready(srv, engine)
    try:
        if stop is None:
            srv.serve_forever()
        else:
            t = threading.Thread(target=srv.serve_forever, daemon=True)
            t.start()
            stop.wait()
    finally:
        srv.shutdown()
        srv.server_close()
        engine.close()


if __name__ == "__main__":
    main()
