"""The reader of K2/K3's wide-block share (``kernels.cos_vg_wide_pct``) on
a synthetic snapshot: its exact value, and nothing where the snapshot is
not the window's calls, where its launch count is not the calls' K2/K3
launches, or where the program has no such counters; and it comes in as
a new file and a new entry alone."""
import json
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest

from benchmark import harness
from option_pricing_ffn_lbfgs_tpu_torch.utils.tracing import Snapshot, Span

ROOT = Path(__file__).resolve().parents[2]
PROGRAM_TRACE = "option_pricing_ffn_lbfgs_tpu_torch.utils.tracing"
NAME = "kernels.cos_vg_wide_pct"
COUNTERS = {"lbfgs.trips": 3, "lm.trips": 6, "cos_vg.launches": 10,
            "cos_vg.launches_wide": 4}


def _call(k2, k3, k2_f64=0):
    return harness.Call(0.5, None, {"loss_kernel.cos_vg_loss": k2,
                                    "loss_kernel.cos_vg_jac": k3,
                                    "loss_kernel.cos_vg_loss_f64": k2_f64},
                        [], True)


def _spans():
    return [Span("entry", 0, 10, -1, 0), Span("entry", 20, 30, -1, 1)]


@pytest.fixture
def ctx(monkeypatch):
    store = SimpleNamespace(snapshot=lambda: Snapshot(_spans(), COUNTERS))
    monkeypatch.setitem(sys.modules, PROGRAM_TRACE, store)
    return SimpleNamespace(calls=[_call(3, 2, 1), _call(0, 4)], trace=None,
                           store=store)


def _read(ctx):
    return harness.Bench(ROOT).reader(NAME)(ctx)


def test_reader_gives_its_value(ctx):
    assert _read(ctx) == pytest.approx(40.0, rel=1e-12)


@pytest.mark.parametrize("wide,want", [(0, 0.0), (10, 100.0)])
def test_reader_spans_none_to_all(wide, want, ctx):
    counters = dict(COUNTERS, **{"cos_vg.launches_wide": wide})
    ctx.store.snapshot = lambda: Snapshot(_spans(), counters)
    assert _read(ctx) == pytest.approx(want)


def test_nothing_without_the_module(ctx, monkeypatch):
    monkeypatch.delitem(sys.modules, PROGRAM_TRACE)
    assert _read(ctx) is None


def test_nothing_where_entries_are_not_the_calls(ctx):
    ctx.calls = ctx.calls + [_call(0, 0)]
    assert _read(ctx) is None


@pytest.mark.parametrize("calls", [
    [(4, 2, 1), (0, 4, 0)], [(3, 3, 1), (0, 4, 0)], [(3, 2, 0), (0, 4, 0)],
    [(3, 2, 2), (0, 4, 0)]], ids=["k2", "k3", "k2_f64_fewer", "k2_f64_more"])
def test_nothing_where_counted_launches_are_not_the_calls(calls, ctx):
    """A window whose counted launches do not match the calls' (a K2, K3
    or K2<double> launch more or fewer) is refused."""
    ctx.calls = [_call(*c) for c in calls]
    assert _read(ctx) is None


def test_nothing_from_a_program_without_the_counters(ctx):
    """The program before these counters: every other counter matches,
    and the reader gives nothing, without raising."""
    counters = {k: v for k, v in COUNTERS.items()
                if not k.startswith("cos_vg.")}
    ctx.store.snapshot = lambda: Snapshot(_spans(), counters)
    assert _read(ctx) is None


def test_comes_in_as_a_new_file_and_entry():
    """The metric's entry follows every entry of the manifest's other
    metrics, is reported in all four cells and has a reader of its
    own."""
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    names = [m["name"] for m in manifest["per_layer"]]
    entry = manifest["per_layer"][names.index(NAME)]
    assert names.index(NAME) >= names.index("entry.glue_idle_pct") + 1
    assert entry["source"] == "program_counter"
    assert entry["layer"] == ("kernels: K2/K3 cos_vg_kernel "
                              "(csrc/cos_vg.cu)")
    assert entry["moves"] == "surfaces_per_s"
    bench = harness.Bench(ROOT)
    for cell in [w["name"] for w in manifest["workloads"]]:
        assert NAME in {m["name"] for m in bench.per_layer(cell)}
    assert callable(bench.reader(NAME))
