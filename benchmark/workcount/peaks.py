"""Published peak rates of the cards the benchmark runs on (NVIDIA's
data sheets, dense, outside the tensor cores for FP32/FP64), at the
card's full power limit; a roofline share is stated against them with the
card's power limit beside it."""
from __future__ import annotations

from typing import Optional

# Matched in order against torch.cuda.get_device_name(); the first match
# wins.
PEAKS = (
    ("H100 PCIe", {"fp32": 51.2e12, "fp64": 25.6e12, "bytes": 2.0e12}),
    ("H100", {"fp32": 67e12, "fp64": 34e12, "bytes": 3.35e12}),
)


def peaks(kind: str) -> Optional[dict]:
    """The peaks of the card named ``kind``, or None for an unknown card."""
    for key, value in PEAKS:
        if key in kind:
            return value
    return None


def least_seconds(ops: float, nbytes: float, kind: str,
                  unit: str = "fp32") -> Optional[float]:
    """The least time the card could take: the larger of operations over
    the peak rate and bytes over the memory rate."""
    p = peaks(kind)
    if p is None:
        return None
    return max(ops / p[unit], nbytes / p["bytes"])
