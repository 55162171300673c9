"""Device timing with CUDA events, and the JAX package's timing protocol.

PyTorch returns before the card has finished, so a host clock around
unsynchronised work measures the enqueue. ``cuda_time_ms`` records CUDA
events around ``repeats`` calls, synchronises, and returns the mean
milliseconds per call; ``CudaTimer`` brackets arbitrary work the same way.
Both need a CUDA device and raise without one. ``synchronize(device)``
waits for a CUDA device and does nothing for the CPU, for host-clock
timings that must include the device's work.

``time_dispatches`` and ``time_jitted`` are the JAX package's chained
protocol (``utils/timing.py``): back-to-back calls, one synchronize at the
end, the total divided by the number of calls, the median of ``repeats``
trials. On ``cuda`` the trials are timed with CUDA events; on the CPU
(``device="cpu"``, for tests) by the host clock. The first call is timed
apart as ``build_s``: it includes the kernels' nvcc build or the load of
an already built library, where JAX's ``compile_s`` had the XLA compile.
``profile_trace`` is a ``torch.profiler`` window, and
``profile_complete`` retakes one that lost its device records;
``device_ops`` and ``device_entries`` read a window's device work.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, NamedTuple, Optional, Sequence

import torch

from . import tracing


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


class Timing(NamedTuple):
    build_s: float        # first call (build or load + run + synchronize)
    steady_s: float       # per call, steady state (chained protocol)
    runs: list            # per-trial chained estimates, sorted


def _chain_s(calls: Sequence[Callable], device) -> float:
    """Seconds per call of ``calls`` run back to back, one synchronize at
    the end: CUDA events on a CUDA device, the host clock on the CPU."""
    if torch.device(device).type == "cuda":
        with CudaTimer() as t:
            for call in calls:
                call()
        return t.ms / 1e3 / len(calls)
    t0 = time.perf_counter()
    for call in calls:
        call()
    return (time.perf_counter() - t0) / len(calls)


def _first_call_s(call: Callable, device) -> float:
    synchronize(device)
    t0 = time.perf_counter()
    call()
    synchronize(device)
    return time.perf_counter() - t0


def time_dispatches(fn: Callable, inputs: Sequence, repeats: int = 3,
                    device="cuda") -> Timing:
    """Chained-protocol timing over a list of fresh input tuples:
    ``fn(*inputs[i])`` for every i back to back, one synchronize at the
    end; per call = total / len(inputs). ``inputs[0]`` also times the
    first call. Fresh inputs exercise input-dependent convergence."""
    calls = [lambda inp=inp: fn(*inp) for inp in inputs]
    build_s = _first_call_s(calls[0], device)
    runs = sorted(_chain_s(calls, device) for _ in range(repeats))
    return Timing(build_s=build_s, steady_s=runs[len(runs) // 2], runs=runs)


def time_jitted(fn: Callable, *args, repeats: int = 3, chain: int = 4,
                device="cuda", **kwargs) -> Timing:
    """``fn(*args, **kwargs)`` timed by the chained protocol: the first
    call (the build or load) apart, then ``chain`` identical calls per
    trial, the median of ``repeats`` trials."""
    call = lambda: fn(*args, **kwargs)
    build_s = _first_call_s(call, device)
    runs = sorted(_chain_s([call] * chain, device) for _ in range(repeats))
    return Timing(build_s=build_s, steady_s=runs[len(runs) // 2], runs=runs)


def device_us(entry) -> float:
    """An entry of ``key_averages()``: its own device microseconds."""
    return getattr(entry, "self_device_time_total",
                   getattr(entry, "self_cuda_time_total", 0.0))


def device_ops(prof) -> list:
    """The entries of a finished ``torch.profiler.profile``'s
    ``key_averages()`` that are device work (kernels, copies, sets). User
    annotations are left out: a ``record_function`` (the port's spans in
    ``utils/tracing.py``, ``Optimizer.step#Adam.step``) also has a device
    entry, which spans its kernels and the gaps between. A kernel's name
    may hold a ``#`` (``{lambda(float, float)#1}``)."""
    return [e for e in prof.key_averages()
            if device_us(e) > 0 and "CUDA" in str(e.device_type)
            and not getattr(e, "is_user_annotation", False)
            and e.key not in tracing.SPAN_NAMES]


def device_entries(prof):
    """(milliseconds, count) of the device work (``device_ops``) in a
    finished ``torch.profiler.profile``: the sum of its entries' own
    time, and how many there were."""
    on_dev = device_ops(prof)
    return (sum(device_us(e) for e in on_dev) / 1e3,
            sum(e.count for e in on_dev))


@contextlib.contextmanager
def profile_trace(log_dir: Optional[str] = None, device="cuda"):
    """A ``torch.profiler`` window over the host and, on ``cuda``, the
    card; yields the profiler (read ``key_averages()`` or
    ``device_entries`` after the block). With ``log_dir`` the Chrome trace
    is written to ``log_dir/trace.json``."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield prof
        synchronize(device)
    if log_dir is not None:
        os.makedirs(log_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def profile_complete(fn: Callable, complete: Callable, device="cuda",
                     windows: int = 3):
    """``fn()`` under ``profile_trace``, the window taken again, up to
    ``windows`` in all, until ``complete(prof)`` holds (torch.profiler has
    lost all of a window's device records). Returns (the profiler, ``fn``'s
    result, the windows taken)."""
    for n in range(1, windows + 1):
        with profile_trace(device=device) as prof:
            out = fn()
        if complete(prof):
            break
    return prof, out, n

