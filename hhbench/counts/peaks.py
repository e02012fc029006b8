"""Dense peaks of one NVIDIA H100 from NVIDIA's data sheets (no sparsity,
at the full 700 W power limit): memory bytes/s and operations/s by type.
A copy of ``helping_hand_for_egocentric_videos_torch/utils/flops.py::PEAKS``."""

from __future__ import annotations

PEAKS = {
    "sxm": {"bytes": 3.35e12, "bfloat16": 989e12, "float32": 67e12, "int8": 1979e12},
    "pcie": {"bytes": 2.0e12, "bfloat16": 756e12, "float32": 51e12, "int8": 1513e12},
}


def peaks_for(device_name: str) -> dict:
    """The column of ``PEAKS`` for a card's name: the PCIe part where the
    name says PCIe, else the SXM part."""
    return PEAKS["pcie" if "pcie" in device_name.lower() else "sxm"]
