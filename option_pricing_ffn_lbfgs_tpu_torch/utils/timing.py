"""Device timing with CUDA events.

PyTorch returns before the card has finished, so a host clock around
unsynchronised work measures the enqueue. ``cuda_time_ms`` records CUDA
events around ``repeats`` calls, synchronises, and returns the mean
milliseconds per call; ``CudaTimer`` brackets arbitrary work the same way.
Both need a CUDA device and raise without one. ``synchronize(device)``
waits for a CUDA device and does nothing for the CPU, for host-clock
timings that must include the device's work.
"""
from __future__ import annotations

from typing import Callable

import torch


def synchronize(device) -> None:
    """Wait for ``device`` if it is a CUDA device."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _require_cuda():
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA timing needs a CUDA device")


class CudaTimer:
    """``with CudaTimer() as t: ...`` then ``t.ms``: elapsed device time of
    the work queued inside the block (synchronises on exit)."""

    def __enter__(self):
        _require_cuda()
        torch.cuda.synchronize()
        self._start = torch.cuda.Event(enable_timing=True)
        self._end = torch.cuda.Event(enable_timing=True)
        self._start.record()
        return self

    def __exit__(self, *exc):
        self._end.record()
        torch.cuda.synchronize()
        self.ms = self._start.elapsed_time(self._end)
        return False


def cuda_time_ms(fn: Callable, repeats: int = 20, warmup: int = 3) -> float:
    """Mean device milliseconds per call of ``fn()`` after ``warmup``
    calls."""
    _require_cuda()
    for _ in range(warmup):
        fn()
    with CudaTimer() as t:
        for _ in range(repeats):
            fn()
    return t.ms / repeats
