"""Spans and traced counters of the port's entries, search and polish.

Recording is on exactly while a ``torch.profiler`` window is open. The
entries (``calibrate_batch_mixed``, ``hybrid_calibrate_batch_mixed``,
``calibrate_batch``) are decorated with ``entry_point``: the outermost
one reads ``torch._C._autograd._profiler_enabled()`` once when it opens
and, with the profiler on, records an ``entry`` span around the call;
inside it every phase opens a span (``span(name)``) and each engine's
loop runs in ``trips``, which adds to the counters. The first entry that
sees the profiler on after an entry saw it off empties the store, so
after a window the store holds the window's calls alone (two windows with
no entry between them record as one). An entry that does not record
costs that one check, and each phase one test of a list: no clock read,
no allocation, no ``record_function``.

A span records its name, its start and end in ``time.time_ns()`` (the
clock of the profiler's events, host and device alike), the index of its
parent span (-1 for an entry) and its call (the ordinal of its ``entry``
span). While recording, each span is also a ``torch.profiler``
``record_function`` of the same name, so a Chrome trace of the window
shows the program's phases over the kernels.

The counters, by engine (``lbfgs`` or ``lm``): ``<engine>.trips``;
``.lanes_launched``, the lanes each trip's kernels price; ``.lanes_live``,
the lanes live as each trip starts (the run's live lanes on the first
trip, then the count the last read returned; a wave's padding starts
done, so it is launched and never live); ``.issue_ns``, host nanoseconds
from a trip's start (the last read's end) to its read's start;
``.read_ns``, host nanoseconds inside the read. Two clock reads a trip,
one of them between a read and the next launch; no device read, no sync.
K2/K3 add ``cos_vg.launches``, each launch, and ``cos_vg.launches_wide``,
each launch whose blocks are wider than those of launches that fill the
card (``count``; ``ops/loss_kernel.py``).
The spans' ``record_function``s are user annotations in the profiler's
events, on the card too, where each spans its kernels and the gaps
between: a sum of device time leaves them out
(``utils/timing.py::device_ops``).

``snapshot()`` gives both; ``clear()`` empties the store. The store is
this process's, and the calibrator runs on one thread.
"""
from __future__ import annotations

import functools
import time
from typing import Callable, Dict, List, NamedTuple, Optional

import torch


# Every span's name: the entry, the calibrator's phases, the engines' loops.
SPAN_NAMES = frozenset((
    "entry", "ffn", "search", "reprice", "polish.stage_a", "polish.winner",
    "polish.wave", "polish.compact", "lbfgs.loop", "lm.loop"))


class Span(NamedTuple):
    name: str
    start_ns: int
    end_ns: Optional[int]    # None while the span is open
    parent: int          # index of the parent span in the store, -1: none
    call: int            # ordinal of the span's entry span


class Snapshot(NamedTuple):
    spans: List[Span]
    counters: Dict[str, int]


_spans: List[list] = []     # [name, start_ns, end_ns, parent, call]
_open: List[int] = []       # indices of the open spans, innermost last
_counters: Dict[str, int] = {}
_calls = 0                  # entry spans since the store was emptied
_saw_profiler = False       # the last outermost entry saw the profiler on


class _Null:
    """The span of a phase that is not recorded."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def drop(self):
        pass


_NULL = _Null()


class _Span:
    """A recorded span, and its ``record_function``."""
    __slots__ = ("name", "index", "dropped", "annotation")

    def __init__(self, name: str):
        self.name = name
        self.dropped = False

    def __enter__(self):
        global _calls
        self.index = len(_spans)
        if _open:
            parent = _open[-1]
            call = _spans[parent][4]
        else:
            parent, call = -1, _calls
            _calls += 1
        _spans.append([self.name, time.time_ns(), None, parent, call])
        _open.append(self.index)
        self.annotation = torch.profiler.record_function(self.name)
        self.annotation.__enter__()
        return self

    def __exit__(self, *exc):
        _spans[self.index][2] = time.time_ns()
        self.annotation.__exit__(*exc)
        _open.pop()
        if self.dropped:
            del _spans[self.index:]
        return False

    def drop(self):
        """Leave this span and its children out of the store (a phase that
        turned out to have nothing to do)."""
        self.dropped = True


def clear() -> None:
    """Empty the store: spans, counters and the call ordinal."""
    global _calls
    del _spans[:]
    _counters.clear()
    _calls = 0


def _entry():
    """The span of an entry: recorded, as ``entry``, only when no span is
    open and the profiler is on."""
    global _saw_profiler
    if _open:
        return _NULL
    on = torch._C._autograd._profiler_enabled()
    if on and not _saw_profiler:
        clear()
    _saw_profiler = on
    return _Span("entry") if on else _NULL


def entry_point(fn):
    """``fn`` inside an ``entry`` span where it is the outermost entry and
    the profiler is on: the decorator of the port's entries."""
    @functools.wraps(fn)
    def traced(*args, **kwargs):
        with _entry():
            return fn(*args, **kwargs)
    return traced


def span(name: str):
    """The span of a phase ``name``: recorded only inside a recorded
    entry. ``drop()`` on it leaves it out of the store."""
    return _Span(name) if _open else _NULL


def count(key: str) -> None:
    """Add one to the counter ``key``, inside a recorded entry only."""
    if _open:
        _counters[key] = _counters.get(key, 0) + 1


def trips(engine: str, lanes: int, live: int, trip: Callable[[int], None],
          read: Callable[[], int]) -> None:
    """An engine's loop: ``trip(live)`` then ``live = read()`` until no
    lane is live, from ``live`` of the ``lanes`` that each trip prices.
    Inside a recorded entry the loop runs in the span ``<engine>.loop`` and
    then adds its counts to ``<engine>.*``; elsewhere it is the loop
    alone."""
    if not _open:
        while live:
            trip(live)
            live = read()
        return
    clock = time.perf_counter_ns
    n = lanes_live = issue = wait = 0
    with _Span(engine + ".loop"):
        t0 = clock()
        while live:
            trip(live)
            t1 = clock()
            next_live = read()
            t2 = clock()
            issue += t1 - t0
            wait += t2 - t1
            lanes_live += live
            n += 1
            live, t0 = next_live, t2
    for key, value in (("trips", n), ("lanes_launched", n * lanes),
                       ("lanes_live", lanes_live), ("issue_ns", issue),
                       ("read_ns", wait)):
        key = f"{engine}.{key}"
        _counters[key] = _counters.get(key, 0) + value


def snapshot() -> Snapshot:
    """The store's spans, in the order they opened, and counters,
    copied."""
    return Snapshot(spans=[Span(*s) for s in _spans],
                    counters=dict(_counters))
