"""Training observability: meters, JSONL metric log, optional TensorBoard.

A copy of ``helping_hand_for_egocentric_videos_tpu/utils/logging.py``
(the port imports nothing of the JAX package).

Replaces the reference's PlotterThread/AverageMeter/GPUStatsMonitor stack
(utils/tensorboard_utils.py, utils/train_utils.py:97-189) with:
- ``AverageMeter`` / ``ProgressMeter``: same semantics;
- ``MetricLogger``: appends one JSON line per log call (always on) and
  mirrors scalars to TensorBoard when a writer is importable (gated).
"""

from __future__ import annotations

import json
import os
import time

__all__ = ["AverageMeter", "ProgressMeter", "MetricLogger"]


class AverageMeter:
    def __init__(self, name: str, fmt: str = ":f"):
        self.name, self.fmt = name, fmt
        self.reset()

    def reset(self):
        self.val = self.sum = self.count = 0.0
        self.avg = 0.0

    def update(self, val, n: int = 1):
        self.val = float(val)
        self.sum += float(val) * n
        self.count += n
        self.avg = self.sum / max(self.count, 1)

    def __str__(self):
        return ("{name} {val" + self.fmt + "} ({avg" + self.fmt + "})").format(
            name=self.name, val=self.val, avg=self.avg
        )


class ProgressMeter:
    def __init__(self, num_batches: int, meters, prefix: str = ""):
        self.meters = meters
        self.prefix = prefix
        n = len(str(num_batches))
        self.batch_fmt = "[{:" + str(n) + "d}/" + f"{num_batches}]"

    def display(self, batch: int):
        entries = [self.prefix + self.batch_fmt.format(batch)]
        entries += [str(m) for m in self.meters]
        print("\t".join(entries), flush=True)


class MetricLogger:
    def __init__(self, log_dir: str, name: str = "train"):
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, f"{name}_metrics.jsonl")
        self._fh = open(self.path, "a")
        self._tb = None
        try:  # optional TensorBoard mirror
            from torch.utils.tensorboard import SummaryWriter

            self._tb = SummaryWriter(log_dir=os.path.join(log_dir, name))
        except Exception:
            pass
        self._t0 = time.time()

    def log(self, step: int, scalars: dict, prefix: str = ""):
        row = {"step": step, "time": round(time.time() - self._t0, 3)}
        for k, v in scalars.items():
            key = f"{prefix}{k}"
            row[key] = float(v)
            if self._tb is not None:
                self._tb.add_scalar(key, float(v), step)
        self._fh.write(json.dumps(row) + "\n")
        self._fh.flush()

    def close(self):
        self._fh.close()
        if self._tb is not None:
            self._tb.close()
