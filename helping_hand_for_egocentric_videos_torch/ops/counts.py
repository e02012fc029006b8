"""Every kernel's launch count, by kernel name.

Each wrapper adds one to its own attribute where it launches its kernel
(``divided_attention.divided_patch_attention.launches_*``,
``act_quant.layer_norm_int8.launches``,
``act_quant.quick_gelu_int8.launches``). A measurement sets them all to 0
just before the work it reads (``reset_counts``) and reads them just after
(``read_counts``). A CUDA graph's replay runs the kernels its recording
saw without calling their wrappers; its owner adds their counts
(``add_counts``).
"""

from __future__ import annotations

from . import act_quant as _aq
from . import divided_attention as _da

__all__ = ["add_counts", "counters", "read_counts", "reset_counts"]


def counters() -> dict:
    """(wrapper, attribute) of each kernel's count, by kernel name."""
    f = _da.divided_patch_attention
    return {
        "divided_attention_space": (f, "launches_space"),
        "divided_attention_time": (f, "launches_time"),
        "divided_attention_space_int8": (f, "launches_space_quant"),
        "divided_attention_time_int8": (f, "launches_time_quant"),
        "layer_norm_int8": (_aq.layer_norm_int8, "launches"),
        "quick_gelu_int8": (_aq.quick_gelu_int8, "launches"),
        "time_attention_headgrid": (f, "launches_time_headgrid"),
    }


def reset_counts():
    for obj, attr in counters().values():
        setattr(obj, attr, 0)


def read_counts() -> dict:
    return {name: getattr(obj, attr) for name, (obj, attr) in counters().items()}


def add_counts(counts: dict):
    """Add ``counts`` (by kernel name; names left out add 0)."""
    for name, (obj, attr) in counters().items():
        setattr(obj, attr, getattr(obj, attr) + counts.get(name, 0))
