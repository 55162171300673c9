"""Spans and counters of the port's entries (``utils/tracing.py``), on the CPU.

A ``calibrate_batch_mixed`` call on 2 surfaces x 3 starts at small budgets
that compacts (``polish_compact_min_lanes=1``: stage A, then waves), made
once with recording off and once inside a CPU ``torch.profiler`` window;
then, after another compacting call outside any window, the hybrid with
the shipped surrogate inside a second window. Every engine run of the
windows is wrapped to record its lanes, the lanes live as it starts and
each read's live count, so that the counters can be held to each run.
Last, the device sums of ``utils/timing.py`` leave the spans out.
"""
import dataclasses
from types import SimpleNamespace
from typing import NamedTuple

import pytest
import torch

import option_pricing_ffn_lbfgs_tpu_torch as port
from option_pricing_ffn_lbfgs_tpu_torch.calibration import calibrator
from option_pricing_ffn_lbfgs_tpu_torch.ops import lbfgs_batched as lb
from option_pricing_ffn_lbfgs_tpu_torch.ops import levenberg_marquardt as lm
from option_pricing_ffn_lbfgs_tpu_torch.utils import timing, tracing

torch.set_num_threads(1)
F64 = torch.float64
B, S = 2, 3
TRUE = [0.05, 2.0, 0.045, 0.35, -0.65, 0.04, 0.8, 0.05, 0.25, -0.45, 0.12,
        -0.05, 0.09]
CONFIG = port.CalibrationConfig(
    pricer=port.PricerConfig(n_terms=32), search_n_terms=32,
    polish_n_terms=32, search_maxeval=30, polish_stage_a_maxiter=3,
    polish_compact_min_lanes=1, polish_wave_budgets=(3, 4))
POLISH = port.LMConfig(maxiter=12, ftol=1e-15, gtol=1e-11,
                       cost_target=1e-10)
MIXED_TREE = ["entry", "search", "lbfgs.loop", "reprice", "polish.stage_a",
              "lm.loop"]
WAVE_TREE = ["polish.wave", "polish.compact", "lm.loop"]


@pytest.fixture(scope="module")
def problem():
    """Two surfaces (5 strikes x 3 maturities) priced at float64 from the
    suite's true parameters +/- 5 %."""
    g = torch.Generator().manual_seed(3)
    vecs = torch.tensor(TRUE, dtype=F64) * (
        1 + 0.1 * (torch.rand(B, 13, generator=g, dtype=F64) - 0.5))
    strikes = torch.tensor([90., 95., 100., 105., 110.] * 3,
                           dtype=F64).repeat(B, 1)
    mats = torch.tensor([0.25] * 5 + [0.5] * 5 + [1.0] * 5,
                        dtype=F64).repeat(B, 1)
    is_call = torch.ones(B, 15, dtype=torch.bool)
    spots = torch.full((B,), 100.0, dtype=F64)
    prices = port.price_surfaces(vecs, spots, 0.03, strikes, mats, is_call,
                                 n_terms=32)
    return spots, 0.03, strikes, mats, is_call, prices


def _mixed(problem):
    return port.calibrate_batch_mixed(*problem, config=CONFIG,
                                      polish=POLISH, device="cpu")


class Run(NamedTuple):
    lanes: int           # the lanes each trip prices
    live0: int           # the lanes live as the first trip starts
    reads: list          # each trip's read: the lanes live after it


def _traced(fn):
    """``fn()`` in a CPU profiler window, each engine run recorded:
    (result, profiler, {"lbfgs": [Run], "lm": [Run]})."""
    runs = {"lbfgs": [], "lm": []}
    lm_bind, lb_bind = lm._bind_trip, lb._bind_trip

    def lm_bound(*args):
        st, trip = lm_bind(*args)
        runs["lm"].append(Run(st.x.shape[0], int((~st.done).sum()), []))
        return st, trip

    def lb_bound(vg_fn, st, *args):
        runs["lbfgs"].append(Run(st.x.shape[0], st.x.shape[0], []))
        return lb_bind(vg_fn, st, *args)

    def reading(engine, read):
        def read_live(status):
            live = read(status)
            runs[engine][-1].reads.append(live)
            return live
        return read_live

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(lm, "_bind_trip", lm_bound)
        mp.setattr(lb, "_bind_trip", lb_bound)
        mp.setattr(lm, "read_live", reading("lm", lm.read_live))
        mp.setattr(lb, "read_live", reading("lbfgs", lb.read_live))
        with torch.profiler.profile() as prof:
            out = fn()
    return out, prof, runs


def _held_to_runs(counters, runs):
    """Each engine's counters are its runs': trips the reads, lanes
    launched each trip's lanes, lanes live the first trip's live lanes
    and then each read but the last."""
    for engine, engine_runs in runs.items():
        assert engine_runs
        c = {k: counters[f"{engine}.{k}"] for k in
             ("trips", "lanes_launched", "lanes_live")}
        assert c["trips"] == sum(len(r.reads) for r in engine_runs)
        assert c["lanes_launched"] == sum(r.lanes * len(r.reads)
                                          for r in engine_runs)
        assert c["lanes_live"] == sum(r.live0 + sum(r.reads[:-1])
                                      for r in engine_runs)
        assert all(r.reads[-1] == 0 for r in engine_runs)


@pytest.fixture(scope="module")
def mixed(problem):
    tracing.clear()
    off = _mixed(problem)
    off_snapshot = tracing.snapshot()
    on, prof, runs = _traced(lambda: _mixed(problem))
    return SimpleNamespace(off=off, off_snapshot=off_snapshot, on=on,
                           prof=prof, runs=runs, snap=tracing.snapshot(),
                           waves=list(calibrator.WAVE_LANES))


@pytest.fixture(scope="module")
def hybrid(problem, mixed):
    _mixed(problem)                      # outside any window, compacts
    waves_before = list(calibrator.WAVE_LANES)
    surrogate = port.load_default_model()
    cfg = dataclasses.replace(CONFIG, lbfgs=dataclasses.replace(
        CONFIG.lbfgs, maxeval=20))
    out, prof, runs = _traced(lambda: port.hybrid_calibrate_batch_mixed(
        surrogate, *problem, config=cfg, refine_maxiter=5, polish=POLISH,
        device="cpu"))
    return SimpleNamespace(out=out, prof=prof, runs=runs,
                           snap=tracing.snapshot(), waves_before=waves_before,
                           waves=list(calibrator.WAVE_LANES))


def _names(snap):
    return [s.name for s in snap.spans]


def test_off_leaves_store_empty_and_outputs_unchanged(mixed):
    assert mixed.off_snapshot == ([], {})
    for name, a, b in zip(mixed.off._fields, mixed.off, mixed.on):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True,
                                   msg=name)


def test_off_spans_are_one_shared_null():
    """Outside a recorded entry a phase's span allocates nothing."""
    assert tracing.span("search") is tracing.span("polish.wave")


def test_mixed_span_tree_nests(mixed):
    spans = mixed.snap.spans
    assert mixed.waves
    assert _names(mixed.snap) == MIXED_TREE + WAVE_TREE * len(mixed.waves)
    parents = [s.parent for s in spans]
    want = [-1, 0, 1, 0, 0, 4]
    for k in range(len(mixed.waves)):
        w = 6 + 3 * k
        want += [0, w, w]
    assert parents == want
    assert {s.call for s in spans} == {0}
    for s in spans:
        assert s.start_ns <= s.end_ns
        if s.parent >= 0:
            p = spans[s.parent]
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns


def test_counters_match_each_engine_run(mixed):
    c = mixed.snap.counters
    _held_to_runs(c, mixed.runs)
    assert c["lbfgs.lanes_live"] <= c["lbfgs.lanes_launched"]
    assert c["lm.lanes_live"] < c["lm.lanes_launched"]
    assert [r.lanes for r in mixed.runs["lbfgs"]] == [B * S]
    assert c["lbfgs.trips"] <= CONFIG.search_maxeval
    # One LM run for stage A over every lane, then one for each wave over
    # its padded lanes, of which only the real ones are ever live.
    lm_runs = mixed.runs["lm"]
    assert [r.lanes for r in lm_runs] == [B * S] + [
        padded for _, padded in mixed.waves]
    assert [r.live0 for r in lm_runs] == [B * S] + [
        live for live, _ in mixed.waves]
    assert any(live < padded for live, padded in mixed.waves)
    for r, (live, _) in zip(lm_runs[1:], mixed.waves):
        assert max(r.reads) <= live
    for key in ("lbfgs.issue_ns", "lbfgs.read_ns", "lm.issue_ns",
                "lm.read_ns"):
        assert c[key] > 0


def test_record_function_events_start_with_spans(mixed):
    names = set(MIXED_TREE + WAVE_TREE)
    events = sorted((e.start_ns(), e.name()) for e in
                    mixed.prof.profiler.kineto_results.events()
                    if e.is_user_annotation() and e.name() in names)
    spans = mixed.snap.spans
    assert [n for _, n in events] == [s.name for s in spans]
    for (start, _), s in zip(events, spans):
        assert abs(start - s.start_ns) < 1_000_000


@pytest.mark.parametrize("case", ["winners_only", "no_lane_left"])
def test_other_mixed_paths_span_trees(problem, case):
    """Polishing the search winners only gives ``polish.winner``; waves
    that find no lane to continue (no start within a margin below 1 of
    its surface's best) leave no ``polish.wave`` span."""
    if case == "winners_only":
        call = lambda: port.calibrate_batch_mixed(
            *problem, config=CONFIG, polish=POLISH, device="cpu",
            polish_all_starts=False)
        tree = ["entry", "search", "lbfgs.loop", "reprice", "polish.winner",
                "lm.loop"]
    else:
        cfg = dataclasses.replace(CONFIG, polish_continue_margin=0.5)
        call = lambda: port.calibrate_batch_mixed(
            *problem, config=cfg, polish=POLISH, device="cpu")
        tree = MIXED_TREE
    tracing.clear()
    _mixed(problem)                      # outside any window
    _traced(call)
    snap = tracing.snapshot()
    assert _names(snap) == tree
    assert [s.parent for s in snap.spans] == [-1, 0, 1, 0, 0, 4]
    assert calibrator.WAVE_LANES == []


def test_hybrid_spans(hybrid):
    assert _names(hybrid.snap) == ["entry", "ffn", "search", "lbfgs.loop",
                                   "reprice", "polish.winner", "lm.loop"]
    assert [s.parent for s in hybrid.snap.spans] == [-1, 0, 0, 2, 0, 0, 5]
    c = hybrid.snap.counters
    _held_to_runs(c, hybrid.runs)
    assert [r.lanes for r in hybrid.runs["lm"]] == [B]
    assert [r.lanes for r in hybrid.runs["lbfgs"]] == [2 * B]


def test_second_window_empties_store(mixed, hybrid):
    """The hybrid's window, the first an entry saw after one outside any
    window, holds its one call: the mixed window's spans and counters are
    gone."""
    assert len(mixed.snap.spans) > 0
    assert [s.call for s in hybrid.snap.spans] == [0] * 7
    assert sum(s.name == "entry" for s in hybrid.snap.spans) == 1
    assert hybrid.snap.counters["lm.trips"] == sum(
        len(r.reads) for r in hybrid.runs["lm"])


def test_hybrid_after_compacting_call_clears_wave_lanes(hybrid):
    assert hybrid.waves_before
    assert hybrid.waves == []


def test_device_sums_leave_the_spans_out():
    """``timing.device_ops`` and ``device_entries`` count kernels and
    copies alone: on the card each span (a user annotation) also has a
    device entry over its kernels and the gaps between, which would count
    a call's time again for every span around it."""
    def avg(key, us, count=1, annotation=False, device="DeviceType.CUDA"):
        return SimpleNamespace(key=key, self_device_time_total=us,
                               count=count, is_user_annotation=annotation,
                               device_type=device)
    sum_kernel = "reduce_kernel<sum_functor::{lambda(float, float)#1}>"
    entries = [avg("cos_vg_kernel", 700.0, 3), avg("Memcpy DtoH", 50.0, 2),
               avg(sum_kernel, 8.0),
               avg("entry", 2000.0, annotation=True),
               avg("lm.loop", 900.0),
               avg("Optimizer.step#Adam.step", 40.0, annotation=True),
               avg("aten::index", 30.0, device="DeviceType.CPU"),
               avg("aten::add", 0.0)]
    prof = SimpleNamespace(key_averages=lambda: entries)
    assert [e.key for e in timing.device_ops(prof)] == [
        "cos_vg_kernel", "Memcpy DtoH", sum_kernel]
    assert timing.device_entries(prof) == (0.758, 6)
