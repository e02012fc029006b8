"""Open-loop serving over HTTP: the program's ``serve.server.make_server``
over a ``ServingEngine`` (buckets, ``max_wait_ms``) on an ephemeral
localhost port, an ``EvalModel`` of the configuration behind it.

Set-up builds the model, warms every video bucket once (the only shapes
the traffic uses; it sends no text) and starts the load generator
(``serve_load.py``) in a child process. The window: requests of
``sizes`` clips in the proportions ``weights``, due at exponential gaps
(Poisson arrivals at ``rate``; ``serve_load.schedule``); each is timed
from its due time to the end of its reply, and one that fails or never
comes counts as missing at ``timeout_s``. ``serve_p95_ms`` is the 95th
percentile of all of them. The generator's lateness (sent - due) is kept
in the counters. With ``--trace 1`` the schedule runs ``trace_s`` seconds
longer and the profiler traces those seconds.

``correct``: ``check_requests`` finished requests drawn from the seed,
one of the largest among them, against the reference on their clips:
``embed_rel_gap``, the mean over their clips of each served embedding's
relative L2 gap; a reply with the wrong number of embeddings fails the
request.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import threading
import time

import numpy as np

from .. import common, weights
from ..harness import ROOT, Result, Run
from . import serve_load


def percentile(values, q: float) -> float:
    return float(np.percentile(np.asarray(values, float), q))


def run(run: Run) -> Result:
    import torch
    from helping_hand_for_egocentric_videos_torch.serve import ServeConfig, ServingEngine
    from helping_hand_for_egocentric_videos_torch.serve.server import make_server
    from helping_hand_for_egocentric_videos_torch.train import EvalModel

    p, cfg, dev = run.params, run.cfg, run.device
    v = cfg["visual"]
    shape = (v["num_frames"], v["img_size"], v["img_size"], 3)
    scratch = common.scratch_dir(f"serve-{run.cell.name}")
    trace_s = p["trace_s"] if run.trace else 0.0
    spec = {"seed": run.seed, "rate": p["rate"], "sizes": p["sizes"], "weights": p["weights"],
            "clip_pool": p["clip_pool"], "clip_shape": list(shape), "seconds": run.seconds + trace_s,
            "timeout_s": p["timeout_s"], "out": os.path.join(scratch, "replies.json")}
    lcfg, dcfg = weights.port_configs(cfg)
    backbone, decoder = weights.port_models(cfg, weights.make(cfg, "backbone", run.seed, dev),
                                            weights.make(cfg, "decoder", run.seed, dev), dev)
    int8, dtype = common.tower_type(cfg)
    model = EvalModel(backbone, lcfg, decoder, dcfg, None, input_res=v["img_size"], dtype=dtype, device=dev,
                      int8=int8)
    del backbone, decoder
    engine = ServingEngine(model, video_shape=shape,
                           cfg=ServeConfig(buckets=tuple(p["buckets"]), max_wait_ms=p["max_wait_ms"]))
    server = make_server(engine, "127.0.0.1", 0)
    server_thread = threading.Thread(target=server.serve_forever, daemon=True)
    child = None
    try:
        for b in p["buckets"]:  # every video bucket once, before the window
            engine.submit_video(np.zeros((b, *shape), np.uint8))
        spec["port"] = server.server_address[1]
        with open(os.path.join(scratch, "spec.json"), "w") as f:
            json.dump(spec, f)
        server_thread.start()
        env = dict(os.environ, PYTHONPATH=str(ROOT))
        child = subprocess.Popen([sys.executable, "-m", "hhbench.mixes.serve_load", os.path.join(scratch, "spec.json")],
                                 stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True, cwd=str(ROOT), env=env)
        if child.stdout.readline().strip() != "ready":
            raise RuntimeError("the load generator did not start")
        before = engine.stats["video"].snapshot()
        run.open_window()
        child.stdin.write("go\n")
        child.stdin.flush()
        if run.trace:
            time.sleep(max(0.0, run.seconds - run.elapsed()))
            mid = engine.stats["video"].snapshot()
            with run.traced(steps=0):
                time.sleep(trace_s)
            after_trace = engine.stats["video"].snapshot()
            run.traced_items = after_trace["items"] - mid["items"]
        if child.stdout.readline().strip() != "done":
            raise RuntimeError("the load generator failed")
        child.wait(timeout=30)
        after = engine.stats["video"].snapshot()
        with open(spec["out"]) as f:
            records = json.load(f)
        in_window = [r for r in records if r["due"] < run.seconds]
        run.close_window(sum(len(r["clips"]) for r in in_window if r["ok"]))
        end = mid if run.trace else after
        run.counters = {k: end[k] - before[k] for k in ("requests", "items", "device_calls", "padded_items")}
        run.read_memory()
    finally:
        if child is not None and child.poll() is None:
            child.kill()
            child.wait()
        server.shutdown()
        server.server_close()
        engine.close()
    del model, engine
    if torch.device(dev).type == "cuda":
        torch.cuda.empty_cache()

    lat = [1e3 * ((r["done"] - r["due"]) if r["ok"] else p["timeout_s"]) for r in in_window]
    late = [r["sent"] - r["due"] for r in in_window if "sent" in r]
    run.counters["generator_late_p95_ms"] = 1e3 * percentile(late, 95) if late else None
    third = max(1, len(lat) // 3)  # a backlog that grows shows as later requests waiting longer
    run.counters["latency_trend"] = float(np.median(lat[-third:]) / np.median(lat[:third]))
    failed = sum(not r["ok"] for r in in_window)
    for r in in_window:
        if not r["ok"]:
            print(f"hhbench: request due {r['due']:.3f} s failed: sent {r.get('sent')}, connected {r.get('connected')}, "
                  f"status {r.get('status')}, {r.get('error', 'wrong number of embeddings')}", file=sys.stderr)

    def check() -> dict:
        from ..reference import full_f32, model as ref, preprocess

        try:
            done = [i for i, r in enumerate(in_window) if r["ok"]]
            if not done:
                return {}
            rng = common.rng(run.seed, 23)
            largest = max(done, key=lambda i: len(in_window[i]["clips"]))
            pick = [largest] + [int(i) for i in rng.choice(done, size=min(p["check_requests"], len(done)) - 1,
                                                           replace=False) if i != largest]
            clips = sorted({c for i in pick for c in in_window[i]["clips"]})
            pool = serve_load.clip_pool(spec)[clips]
            wb = weights.make(cfg, "backbone", run.seed, dev)
            wd = weights.make(cfg, "decoder", run.seed, dev)
            with torch.no_grad(), full_f32():
                x = preprocess.resize_normalize(torch.as_tensor(pool, device=dev), v["img_size"])
                r_emb, _, _ = ref.embed_clips(wb, wd, cfg, x, block=p.get("check_block", 4))
            r_emb = r_emb.cpu()
            row = {c: k for k, c in enumerate(clips)}
            served = torch.tensor([e for i in pick for e in in_window[i]["embeddings"]])
            want = r_emb[[row[c] for i in pick for c in in_window[i]["clips"]]]
            return common.embed_gaps(served, want)
        finally:
            shutil.rmtree(scratch, ignore_errors=True)

    return Result(e2e={"serve_p95_ms": percentile(lat, 95)}, attempted=len(in_window), failed=failed, check=check)
