"""What the benchmark reads from a ``torch.profiler`` window.

``read(prof)`` turns the profiler's raw events into a ``Trace``: the
device's operations (kernels, copies, sets) with their intervals, the
host's operations, and the benchmark's own spans
(``bench.*``, recorded with ``record_function`` around the calls it
makes). Times are seconds on the profiler's clock, on which host and
device events are aligned.

Busy time is the union of the device operations' intervals inside the
traced window, which runs from the first ``bench.call`` span's start to
the last one's end; idle is the rest of it. This follows
``utils/timing.py::device_entries`` of the program (device-side entries
only, user annotations left out), with a union where that sums, so that
operations that overlap count once.
"""
from __future__ import annotations

import bisect
import collections
import dataclasses
import heapq
from typing import Dict, List, Tuple

from . import stats

SPAN_PREFIX = "bench."
CALL_SPAN = "bench.call"


@dataclasses.dataclass
class DeviceOp:
    start: float
    end: float
    name: str
    kind: str            # "kernel", "memcpy" or "memset"

    @property
    def seconds(self) -> float:
        return self.end - self.start


@dataclasses.dataclass
class Trace:
    device: List[DeviceOp]
    host: List[Tuple[float, float, str]]    # the host's operations
    spans: List[Tuple[float, float, str]]   # the benchmark's spans
    window: Tuple[float, float]

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    @property
    def busy_s(self) -> float:
        return stats.busy(((op.start, op.end) for op in self.device),
                          *self.window)

    def calls(self) -> List[Tuple[float, float]]:
        return sorted((a, b) for a, b, n in self.spans if n == CALL_SPAN)


def short_name(name: str) -> str:
    """A kernel's name without its return type, namespace and
    arguments."""
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[5:]
    return name.split("(")[0].strip() or name


def _kind(name: str) -> str:
    low = name.lower()
    if low.startswith("memcpy"):
        return "memcpy"
    if low.startswith("memset"):
        return "memset"
    return "kernel"


def read(prof) -> Trace:
    """The ``Trace`` of a finished profiler window."""
    from torch.autograd import DeviceType
    device, host, spans = [], [], []
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns() * 1e-9
        end = start + e.duration_ns() * 1e-9
        name = e.name()
        on_device = e.device_type() == DeviceType.CUDA
        if e.is_user_annotation():
            if not on_device and name.startswith(SPAN_PREFIX):
                spans.append((start, end, name))
            continue
        if on_device:
            device.append(DeviceOp(start, end, short_name(name),
                                   _kind(name)))
        else:
            host.append((start, end, name))
    calls = [(a, b) for a, b, n in spans if n == CALL_SPAN]
    if not calls:
        raise RuntimeError("the trace holds no bench.call span")
    window = (min(a for a, _ in calls), max(b for _, b in calls))
    device.sort(key=lambda op: op.start)
    return Trace(device=device, host=sorted(host), spans=sorted(spans),
                 window=window)


def per_call(trace: Trace, name: str) -> List[List[DeviceOp]]:
    """The device operations whose short name starts with ``name``, by
    the ``bench.call`` span they started in (one from before the first
    call goes to the first, and one between two calls to the earlier)."""
    calls = trace.calls()
    starts = [a for a, _ in calls]
    out: List[List[DeviceOp]] = [[] for _ in calls]
    for op in trace.device:
        if op.name.startswith(name):
            out[max(0, bisect.bisect_right(starts, op.start) - 1)].append(op)
    return out


def _stab(intervals, points):
    """For each point (ascending), the name of the latest-starting
    interval that covers it, or None."""
    heap, out, i = [], [], 0
    for p in points:
        while i < len(intervals) and intervals[i][0] <= p:
            a, b, n = intervals[i]
            heapq.heappush(heap, (-a, b, n))
            i += 1
        while heap and heap[0][1] < p:
            heapq.heappop(heap)
        out.append(heap[0][2] if heap else None)
    return out


def breakdown(trace: Trace, top: int = 10) -> Dict[str, list]:
    """The device operations that took most time, by short name, and the
    device's idle time inside the window by what the host was doing at
    each gap's midpoint: the benchmark's innermost span and the host's
    innermost operation (``python`` where none ran)."""
    by_op = collections.Counter()
    for op in trace.device:
        by_op[op.name] += op.seconds
    holes = stats.gaps(((op.start, op.end) for op in trace.device),
                       *trace.window)
    mids = [(a + b) / 2 for a, b in holes]
    spans = _stab(trace.spans, mids)
    ops = _stab(trace.host, mids)
    by_gap = collections.Counter()
    for (a, b), span, op in zip(holes, spans, ops):
        by_gap[f"{span or 'between calls'}: {op or 'python'}"] += b - a
    return {"device_ops": [[n, s] for n, s in by_op.most_common(top)],
            "idle_gaps": [[n, s] for n, s in by_gap.most_common(top)]}

