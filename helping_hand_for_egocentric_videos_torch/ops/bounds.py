"""The least time the card could take for one call of a kernel: its roofline.

Each bound is the larger of the bytes the call must move over the card's
memory rate and the operations it must do over their rate (``peaks``: a
column of ``utils.flops.PEAKS``), in ms, beside which of the two sets it
(``"bytes"`` or ``"operations"``). Input bytes count once read and output
bytes once written, whatever a kernel reads again. The functions take
shapes and type names, not tensors, so they run anywhere and allocate
nothing; ``chip_smoke.py`` and ``tools/torch_attention_bench.py`` print
them beside the kernels' device times, and PERF.md's table of kernels
quotes them.

- ``attention_bound_ms``: divided attention on packed qkv (K1, K2, K3 with
  ``quant_out``, K6).
- ``rows_bound_ms``: a per-row quantizing pass (K4, K5); ``rows_bytes``
  the bytes it moves.
- ``sampler_bound_ms``: the nucleus sampler over a row of logits a
  sequence (K7); ``sampler_bytes`` the bytes it moves.
- ``decode_attention_bound_ms``: the narrator's decode attention over a
  cache (K8, both modes); ``decode_attention_work`` its bytes and
  operations.
"""

from __future__ import annotations

__all__ = ["attention_bound_ms", "decode_attention_bound_ms", "decode_attention_work", "rows_bound_ms", "rows_bytes",
           "sampler_bound_ms", "sampler_bytes"]

# bytes a value by type name
_SIZE = {"float32": 4, "bfloat16": 2}


def _bound(nbytes, ops, peaks, dtype: str) -> tuple[float, str]:
    by_bytes = nbytes / peaks["bytes"]
    by_ops = ops / peaks[dtype]
    return 1e3 * max(by_bytes, by_ops), ("bytes" if by_bytes >= by_ops else "operations")


def attention_bound_ms(b: int, t: int, n: int, heads: int, dh: int, dtype: str, mode: str, peaks,
                       quant_out: bool = False) -> tuple[float, str]:
    """Divided attention over (B, T, N) tokens of ``heads`` heads of width
    ``dh`` in ``dtype`` ("float32", "bfloat16"), ``mode`` "space" (groups of
    N patches, a frame) or "time" (groups of T frames, a tube): read qkv and
    the CLS q, k, v; write the output (D values of the input type a token,
    or with ``quant_out`` D int8 codes and an f32 scale) and each group's f32
    CLS partials (max, sum, dh values a head)."""
    es = _SIZE[dtype]
    d = heads * dh
    g, w = (t, n) if mode == "space" else (n, t)
    out_bytes = b * t * n * ((d + 4) if quant_out else d * es)
    nbytes = b * t * n * 3 * d * es + 3 * b * d * es + out_bytes + b * g * heads * (2 + dh) * 4
    # QK and PV over w + 1 keys for every patch query, and the CLS query over w keys per group
    ops = 4 * b * t * n * heads * dh * (w + 2)
    return _bound(nbytes, ops, peaks, dtype)


def rows_bytes(rows: int, d: int, in_bytes: int) -> int:
    """A per-row quantizing pass: read the rows once, write a code a value
    and a scale a row."""
    return rows * d * (in_bytes + 1) + rows * 4


def rows_bound_ms(rows: int, d: int, in_bytes: int, ops_per_value: int, peaks) -> tuple[float, str]:
    """The pass's bytes over the memory rate, or its ``ops_per_value`` f32
    operations a value outside the tensor cores over their rate."""
    return _bound(rows_bytes(rows, d, in_bytes), rows * d * ops_per_value, peaks, "float32")


def sampler_bytes(rows: int, vocab: int) -> int:
    """Read a row of f32 logits, write an int64 id a row."""
    return rows * vocab * 4 + rows * 8


def sampler_bound_ms(rows: int, vocab: int, peaks) -> tuple[float, str]:
    """The sampler's bytes over the memory rate: its arithmetic is counted
    by no rate of the card's."""
    return 1e3 * sampler_bytes(rows, vocab) / peaks["bytes"], "bytes"


def decode_attention_work(mode: str, rows: int, heads: int, keys: int, dh: int, dtype: str,
                          r: int = 1) -> tuple[int, int]:
    """(bytes, operations) of one decode attention call of ``rows`` query
    rows of ``heads`` heads of width ``dh`` in ``dtype``, ``mode`` "self"
    (a row over its own ``keys`` cached positions) or "cross" (``r`` rows a
    clip over the clip's ``keys`` latents, read once for the ``r``): read the
    keys and values and the query rows, write the output rows; QK and PV
    over every key of every row."""
    es = _SIZE[dtype]
    kv_rows = rows if mode == "self" else rows // r
    nbytes = (kv_rows * 2 * keys + 2 * rows) * heads * dh * es
    return nbytes, 4 * rows * heads * keys * dh


def decode_attention_bound_ms(mode: str, rows: int, heads: int, keys: int, dh: int, dtype: str, peaks,
                              r: int = 1) -> tuple[float, str]:
    nbytes, ops = decode_attention_work(mode, rows, heads, keys, dh, dtype, r)
    return _bound(nbytes, ops, peaks, dtype)
