"""The open-loop load generator of the serving cells, run as a child
process: ``python -m hhbench.mixes.serve_load <spec.json>``.

It makes the clip pool from the seed, prints ``ready``, waits for ``go``
on standard input, then sends each request of the schedule at its due
time from a thread of its own (``POST /embed_video``, one ``.npy`` body of
the request's clips) and times it from its due time to the end of the
reply. It writes every request's record and reply to ``<out>.json`` and
prints ``done``.
"""

from __future__ import annotations

import http.client
import io
import json
import sys
import threading
import time

import numpy as np


def clip_pool(spec: dict) -> np.ndarray:
    """(clip_pool, T, H, W, C) uint8 clips from the seed."""
    rng = np.random.default_rng([spec["seed"] & 0xFFFFFFFFFFFFFFFF, 21])
    return rng.integers(0, 256, size=(spec["clip_pool"], *spec["clip_shape"]), dtype=np.uint8)


def schedule(spec: dict, seconds: float) -> list:
    """(due second, clip ids) of each request: ``round(rate * seconds)``
    requests, whose sizes come in the proportions ``weights`` (rounded by
    largest remainders) and whose gaps are the exponential distribution's
    quantiles at ``rate`` (Poisson arrivals), each set in an order drawn
    from the seed over the whole schedule. So every seed sends the same
    work at the same mean rate, and a burst runs as long as the draw makes
    it, as in a Poisson stream."""
    rng = np.random.default_rng([spec["seed"] & 0xFFFFFFFFFFFFFFFF, 22])
    n = max(1, int(round(spec["rate"] * seconds)))
    w = np.asarray(spec["weights"], float) / sum(spec["weights"])
    counts = np.floor(w * n).astype(int)
    counts[np.argsort(counts - w * n)[:n - counts.sum()]] += 1
    sizes = rng.permutation(np.repeat(spec["sizes"], counts))
    gaps = rng.permutation(-np.log(1.0 - (np.arange(n) + 0.5) / n) / spec["rate"])
    due = np.concatenate([[0.0], np.cumsum(gaps)[:-1]])
    return [(float(d), [int(i) for i in rng.choice(spec["clip_pool"], size=int(k), replace=False)])
            for d, k in zip(due, sizes)]


def body(pool: np.ndarray, ids) -> bytes:
    buf = io.BytesIO()
    np.save(buf, pool[ids])
    return buf.getvalue()


def main(path: str) -> int:
    with open(path) as f:
        spec = json.load(f)
    pool = clip_pool(spec)
    plan = schedule(spec, spec["seconds"])
    records = [None] * len(plan)
    print("ready", flush=True)
    if sys.stdin.readline().strip() != "go":
        return 1
    t0 = time.monotonic() + 0.05

    def send(i: int, due: float, ids):
        sent = time.monotonic() - t0
        rec = {"due": due, "sent": sent, "clips": ids, "ok": False}
        try:
            conn = http.client.HTTPConnection("127.0.0.1", spec["port"], timeout=spec["timeout_s"])
            try:
                conn.connect()
                rec["connected"] = time.monotonic() - t0
                conn.request("POST", "/embed_video", body=body(pool, ids),
                             headers={"Content-Type": "application/octet-stream"})
                resp = conn.getresponse()
                payload = resp.read()
                rec["done"] = time.monotonic() - t0
                rec["status"] = resp.status
                if resp.status == 200:
                    rec["embeddings"] = json.loads(payload)["embeddings"]
                    rec["ok"] = len(rec["embeddings"]) == len(ids)
            finally:
                conn.close()
        except (OSError, http.client.HTTPException, ValueError) as e:
            rec["error"] = f"{type(e).__name__}: {e}"
        records[i] = rec

    threads = []
    for i, (due, ids) in enumerate(plan):
        delay = t0 + due - time.monotonic()
        if delay > 0:
            time.sleep(delay)
        th = threading.Thread(target=send, args=(i, due, ids), daemon=True)
        th.start()
        threads.append(th)
    deadline = time.monotonic() + spec["timeout_s"]
    for th in threads:
        th.join(max(0.0, deadline - time.monotonic()))
    with open(spec["out"], "w") as f:
        json.dump([r if r is not None else {"due": plan[i][0], "clips": plan[i][1], "ok": False,
                                            "error": "no reply in time"} for i, r in enumerate(records)], f)
    print("done", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1]))
