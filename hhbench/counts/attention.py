"""The divided space-time attention's operations and bytes, from its
shapes alone, whatever implements it.

One call attends a block's packed (B, T, N, 3D) q|k|v rows and the CLS
token's q, k, v (B, 3D each): in ``space`` mode each patch query over the
N patches of its frame and the CLS key, in ``time`` mode over the T
patches of its tube and the CLS key; the CLS query over all 1 + T*N keys.
Operations: 4 * keys * D a query (scores and values). Bytes: every input
read once and every output, (B, T, N, D) and (B, D), written once, in the
tower's type. The least time of a call is the larger of bytes / peak
bandwidth and operations / peak rate.
"""

from __future__ import annotations

ELEMENT_BYTES = {"bfloat16": 2, "float16": 2, "float32": 4}


def attention_flops(b: int, t: int, n: int, d: int, mode: str) -> float:
    keys = n + 1 if mode == "space" else t + 1
    if mode not in ("space", "time"):
        raise ValueError(f"mode must be 'space' or 'time', got {mode!r}")
    return float(b * (t * n * 4 * keys * d + 4 * (1 + t * n) * d))


def attention_bytes(b: int, t: int, n: int, d: int, dtype: str) -> float:
    e = ELEMENT_BYTES[dtype]
    inputs = b * t * n * 3 * d + b * 3 * d
    outputs = b * t * n * d + b * d
    return float(e * (inputs + outputs))


def least_seconds(b: int, t: int, n: int, d: int, mode: str, dtype: str, peaks: dict) -> float:
    """The least time of one call on a card with ``peaks``
    (``counts.peaks.PEAKS[...]``)."""
    return max(attention_bytes(b, t, n, d, dtype) / peaks["bytes"], attention_flops(b, t, n, d, mode) / peaks[dtype])


def tower_least_seconds_per_clip(visual: dict, dtype: str, peaks: dict, frames: int | None = None) -> float:
    """The least time of one clip's divided attention through the whole
    tower: a space and a time call in each of its blocks."""
    t = int(frames or visual["num_frames"])
    n = (visual["img_size"] // visual["patch_size"]) ** 2
    d = visual["width"]
    per_block = sum(least_seconds(1, t, n, d, m, dtype, peaks) for m in ("space", "time"))
    return visual["depth"] * per_block
