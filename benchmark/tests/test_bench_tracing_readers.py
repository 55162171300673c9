"""The readers of the program's spans and counters
(``utils/tracing.py``) on a synthetic snapshot and trace: each gives its
exact value, and nothing where the snapshot is not the window's calls or
the clocks disagree; and they come in as new files and entries alone."""
import hashlib
import json
import shutil
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest

from benchmark import harness, trace
from option_pricing_ffn_lbfgs_tpu_torch.utils.tracing import Snapshot, Span

ROOT = Path(__file__).resolve().parents[2]
PROGRAM_TRACE = "option_pricing_ffn_lbfgs_tpu_torch.utils.tracing"
NEW = ["search.live_lane_pct", "polish.live_lane_pct",
       "dispatch.issue_us_per_trip", "dispatch.read_wait_us_per_trip",
       "entry.glue_idle_pct"]
COUNTERS = {"lbfgs.trips": 3, "lbfgs.lanes_launched": 9,
            "lbfgs.lanes_live": 6, "lbfgs.issue_ns": 300_000,
            "lbfgs.read_ns": 45_000, "lm.trips": 6, "lm.lanes_launched": 30,
            "lm.lanes_live": 27, "lm.issue_ns": 600_000, "lm.read_ns": 45_000}
WANT = {"search.live_lane_pct": 100 * 6 / 9, "polish.live_lane_pct": 90.0,
        "dispatch.issue_us_per_trip": 100.0,
        "dispatch.read_wait_us_per_trip": 10.0,
        "entry.glue_idle_pct": 100 * 0.4192 / 2.0}


def _ns(t):
    return round(t * 1e9)


def _spans(shift=0.0):
    """Two calls: the first's entry 0.0002-0.8998 s with a search loop
    0.1-0.5 and a polish loop 0.6-0.8; the second's 1.2002-1.8998 with a
    polish loop 1.3-1.8; each 0.2 ms inside its ``bench.entry``."""
    rows = [("entry", 0.0002, 0.8998, -1, 0), ("search", 0.02, 0.55, 0, 0),
            ("lbfgs.loop", 0.1, 0.5, 1, 0), ("polish.stage_a", 0.6, 0.8, 0, 0),
            ("lm.loop", 0.6, 0.8, 3, 0), ("entry", 1.2002, 1.8998, -1, 1),
            ("polish.winner", 1.3, 1.8, 5, 1), ("lm.loop", 1.3, 1.8, 6, 1)]
    return [Span(n, _ns(a + shift), _ns(b + shift), p, c)
            for n, a, b, p, c in rows]


def _trace():
    """Device work 0.02-0.05 (glue), 0.12-0.48 and 0.62-0.78 (loops),
    1.25-1.35 (half glue, half loop): the glue's idle time is 0.0998 +
    0.1 + 0.0998 - 0.03 in the first call and 0.0998 + 0.0998 - 0.05 in
    the second, 0.4192 s of the 2-s window."""
    op = lambda a, b: trace.DeviceOp(a, b, "k", "kernel")
    spans = [(0.0, 1.0, "bench.call"), (0.0, 0.9, "bench.entry"),
             (0.9, 1.0, "bench.read"), (1.2, 2.0, "bench.call"),
             (1.2, 1.9, "bench.entry"), (1.9, 2.0, "bench.read")]
    return trace.Trace(device=[op(0.02, 0.05), op(0.12, 0.48),
                               op(0.62, 0.78), op(1.25, 1.35)],
                       host=[], spans=spans, window=(0.0, 2.0))


def _call(k2, k3):
    return harness.Call(0.5, None, {"loss_kernel.cos_vg_loss": k2,
                                    "loss_kernel.cos_vg_jac": k3}, [], True)


@pytest.fixture
def ctx(monkeypatch):
    store = SimpleNamespace(snapshot=lambda: Snapshot(_spans(), COUNTERS))
    monkeypatch.setitem(sys.modules, PROGRAM_TRACE, store)
    return SimpleNamespace(calls=[_call(3, 2), _call(0, 4)], trace=_trace(),
                           store=store)


def _read(name, ctx):
    return harness.Bench(ROOT).reader(name)(ctx)


@pytest.mark.parametrize("name", NEW)
def test_reader_gives_its_value(name, ctx):
    assert _read(name, ctx) == pytest.approx(WANT[name], rel=1e-9)


def test_glue_idle_within_device_idle(ctx):
    assert _read("entry.glue_idle_pct", ctx) <= _read("device.idle_pct", ctx)


@pytest.mark.parametrize("name", NEW)
def test_nothing_without_the_module(name, ctx, monkeypatch):
    monkeypatch.delitem(sys.modules, PROGRAM_TRACE)
    assert _read(name, ctx) is None


@pytest.mark.parametrize("name", NEW)
def test_nothing_where_entries_are_not_the_calls(name, ctx):
    ctx.calls = ctx.calls + [_call(0, 0)]
    assert _read(name, ctx) is None


@pytest.mark.parametrize("name", NEW)
@pytest.mark.parametrize("launches", [(4, 2), (3, 3)], ids=["k2", "k3"])
def test_nothing_where_trips_are_not_the_launches(name, launches, ctx):
    ctx.calls[0] = _call(*launches)
    assert _read(name, ctx) is None


@pytest.mark.parametrize("shift", [2e-3, -2e-3])
def test_glue_idle_nothing_where_clocks_disagree(shift, ctx):
    ctx.store.snapshot = lambda: Snapshot(_spans(shift), COUNTERS)
    assert _read("entry.glue_idle_pct", ctx) is None
    assert _read("search.live_lane_pct", ctx) == pytest.approx(
        WANT["search.live_lane_pct"])
    ctx.store.snapshot = lambda: Snapshot(_spans(shift * 0.45), COUNTERS)
    assert _read("entry.glue_idle_pct", ctx) is not None


def test_glue_idle_nothing_untraced(ctx):
    ctx.trace = None
    assert _read("entry.glue_idle_pct", ctx) is None


def _hashes(root: Path):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in (root / "benchmark").rglob("*") if p.is_file()
            and "__pycache__" not in p.parts}


def test_new_readers_come_in_as_new_files_and_entries(tmp_path):
    """The benchmark without the readers, then with them added: every
    file it had keeps its hash, the manifest keeps its entries in place,
    and each metric applies where it lists."""
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    added = manifest["per_layer"][-len(NEW):]
    assert [m["name"] for m in added] == NEW
    for name in NEW:
        (tmp_path / f"benchmark/metrics/{name}.py").unlink()
    (tmp_path / "benchmark/tests/test_bench_tracing_readers.py").unlink()
    base = dict(manifest, per_layer=manifest["per_layer"][:-len(NEW)])
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(base))
    before = _hashes(tmp_path)

    for name in NEW:
        shutil.copy(ROOT / f"benchmark/metrics/{name}.py",
                    tmp_path / f"benchmark/metrics/{name}.py")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(
        dict(base, per_layer=base["per_layer"] + added)))
    after = _hashes(tmp_path)
    assert {k: after[k] for k in before} == before
    assert set(after) - set(before) == {
        Path(f"benchmark/metrics/{n}.py") for n in NEW}

    bench = harness.Bench(tmp_path)
    names = lambda cell: {m["name"] for m in bench.per_layer(cell)}
    for cell in ("pure-b1000-capped", "hybrid-b1000", "pure-b1000-raw"):
        assert names(cell) & set(NEW) == {
            "search.live_lane_pct", "polish.live_lane_pct",
            "entry.glue_idle_pct"}
    assert set(NEW) <= names("pure-b5-bench")
    for name in NEW:
        assert callable(bench.reader(name))
