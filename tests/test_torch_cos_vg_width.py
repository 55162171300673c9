"""K2/K3's block width on the CPU: the rule that picks it
(``ops/loss_kernel.py::launch_warps``), the launcher that applies it (the
C entry and the resident-lane table stubbed, so no card is needed), the
live count each engine passes its trips, and the counters
``cos_vg.launches`` / ``cos_vg.launches_wide``, recorded only inside a
profiler window (``utils/tracing.py``)."""
from types import SimpleNamespace

import pytest
import torch

from option_pricing_ffn_lbfgs_tpu_torch.ops import lbfgs_batched as lb
from option_pricing_ffn_lbfgs_tpu_torch.ops import levenberg_marquardt as lm
from option_pricing_ffn_lbfgs_tpu_torch.ops import loss_kernel
from option_pricing_ffn_lbfgs_tpu_torch.utils import tracing
from option_pricing_ffn_lbfgs_tpu_torch.utils.config import (
    LBFGSConfig, LMConfig)

F64 = torch.float64
# An H100's resident lanes at 15 options (SMs x blocks an SM)
FLOAT = {4: 528, 8: 264}
DOUBLE = {2: 528, 4: 264, 8: 132}


@pytest.mark.parametrize("table,lanes,want", [
    (FLOAT, 1, 8), (FLOAT, 15, 8), (FLOAT, 264, 8), (FLOAT, 265, 4),
    (FLOAT, 528, 4), (FLOAT, 529, 4), (FLOAT, 3000, 4),
    (DOUBLE, 15, 8), (DOUBLE, 132, 8), (DOUBLE, 133, 4), (DOUBLE, 264, 4),
    (DOUBLE, 265, 2), (DOUBLE, 528, 2), (DOUBLE, 1536, 2),
    ({2: 1056, 4: 528, 8: 264}, 600, 2), ({4: 0, 8: 0}, 1, 4)],
    ids=lambda v: str(v) if not isinstance(v, dict) else
    "-".join(f"{w}:{n}" for w, n in v.items()))
def test_launch_warps_takes_the_widest_that_holds_the_lanes(table, lanes,
                                                            want):
    """The widest width whose resident lanes hold the launch's lanes; the
    narrowest where none does (above one wave of the narrowest too)."""
    assert loss_kernel.launch_warps(lanes, table) == want


def test_widths_by_entry():
    """Float K2/K3 run at 4 and 8 warps, K2<double> at 2, 4 and 8, and
    each entry's widths are sorted, narrowest (the full card's) first."""
    assert set(loss_kernel.WARPS) == {sym for sym, _, _ in
                                      loss_kernel._ENTRIES.values()}
    assert loss_kernel.WARPS["cos_vg_f32"] == (4, 8)
    assert loss_kernel.WARPS["cos_vg_f64"] == (2, 4, 8)
    for widths in loss_kernel.WARPS.values():
        assert list(widths) == sorted(set(widths))


@pytest.fixture
def stub(monkeypatch):
    """The C entry replaced by a recorder of its calls (returning 0), the
    resident-lane table fixed at ``FLOAT``, and the current stream a
    stand-in: ``_launcher`` then runs on CPU tensors. The launch counts
    are restored afterwards, for the tests that read them."""
    calls = []
    for key, value in loss_kernel.LAUNCHES.items():
        monkeypatch.setitem(loss_kernel.LAUNCHES, key, value)

    def entry(name, symbol, argtypes):
        assert (name, symbol) == ("cos_vg", "cos_vg_f32")
        assert len(argtypes) == 19
        return lambda *args: calls.append(args) or 0
    monkeypatch.setattr(loss_kernel.kernel_build, "entry", entry)
    monkeypatch.setattr(loss_kernel, "slots", lambda *a: dict(FLOAT))
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: SimpleNamespace(cuda_stream=7))
    return calls


def _launcher(lanes, done=None):
    """A K2 launcher on ``lanes`` CPU lanes of 15 options at N = 64."""
    rows = lambda dt=torch.float32: torch.zeros(lanes, 15, dtype=dt)
    ins = [torch.zeros(lanes, 13), torch.zeros(lanes), rows(), rows(),
           rows(torch.bool), rows(), rows(torch.int32)]
    return loss_kernel._launcher(
        "cos_vg_f32", 0, "cos_vg_loss", ins, torch.zeros(lanes, 15),
        torch.zeros(lanes, 13), 0.03, 0.0, 10.0, 64, done)


@pytest.mark.parametrize("lanes,live,warps,want", [
    (3000, None, None, 4), (15, None, None, 8), (264, None, None, 8),
    (3000, 264, None, 8), (3000, 265, None, 4), (3000, 3, None, 8),
    (15, None, 4, 4), (3000, 3000, 8, 8)])
def test_launcher_width_from_live_or_launched_lanes(stub, lanes, live, warps,
                                                    want):
    """A launch with no live count (the one-shot wrappers) takes the rule
    on the lanes it launches, a bound trip's on the live count it is
    given, and a given width overrides both; the entry gets the width
    just before the stream, after the launch's lanes, rows, N and mode."""
    launch = _launcher(lanes)
    launch(live, warps)
    (args,) = stub
    assert args[-2] == want and args[-1] == 7
    assert args[-6:-2] == (lanes, 15, 64, 0)
    assert args[7] is None


def test_launcher_passes_the_done_flags(stub):
    done = torch.zeros(15, dtype=torch.bool)
    _launcher(15, done)(3)
    assert stub[0][7] == done.data_ptr()


def test_launcher_counts_each_launch_once(stub):
    """``LAUNCHES`` counts every launch, at any width, outside a window
    too; the traced counters stay empty outside one."""
    tracing.clear()
    launch = _launcher(3000)
    before = dict(loss_kernel.LAUNCHES)
    for live, warps in ((None, None), (3, None), (None, 8), (None, 4)):
        launch(live, warps)
    after = dict(loss_kernel.LAUNCHES)
    assert {k: after[k] - before[k] for k in after} == {
        "cos_vg_loss": 4, "cos_vg_jac": 0, "cos_vg_loss_f64": 0}
    assert tracing.snapshot().counters == {}


@tracing.entry_point
def _entry(fn):
    return fn()


def test_counters_recorded_only_inside_a_window(stub):
    """Inside a profiler window's entry every launch adds to
    ``cos_vg.launches`` and each wider than the full card's width (4
    warps in float) to ``cos_vg.launches_wide``; an entry outside any
    window and a launch outside any entry record nothing."""
    launch = _launcher(3000)

    def four_launches():
        launch()            # 3000 lanes: 4 warps
        launch(200)         # 8
        launch(600)         # 4
        launch(None, 8)     # 8

    tracing.clear()
    _entry(four_launches)
    assert "cos_vg.launches" not in tracing.snapshot().counters
    with torch.profiler.profile():
        _entry(four_launches)
        launch(3)           # outside the entry: not recorded
    counters = tracing.snapshot().counters
    assert counters["cos_vg.launches"] == 4
    assert counters["cos_vg.launches_wide"] == 2
    tracing.clear()


def test_count_only_inside_a_recorded_entry():
    tracing.clear()
    tracing.count("cos_vg.launches")
    assert tracing.snapshot().counters == {}
    with torch.profiler.profile():
        _entry(lambda: [tracing.count("cos_vg.launches") for _ in range(3)])
    assert tracing.snapshot().counters == {"cos_vg.launches": 3}
    tracing.clear()


@pytest.mark.parametrize("traced", [False, True])
def test_trips_pass_each_trip_its_live_count(traced):
    """``tracing.trips`` gives each trip the lanes live as it starts: the
    first from its caller, then each read's."""
    got, reads = [], iter([5, 2, 0])

    def run():
        tracing.trips("lbfgs", 8, 7, got.append, lambda: next(reads))

    tracing.clear()
    if traced:
        with torch.profiler.profile():
            _entry(run)
    else:
        run()
    assert got == [7, 5, 2]
    tracing.clear()


def _spy(monkeypatch, module):
    """Record the live count each trip of ``module``'s engine gets."""
    got = []
    bind = module._bind_trip

    def bound(*args, **kwargs):
        out = bind(*args, **kwargs)
        trip = out[1] if isinstance(out, tuple) else out

        def spied(live=None):
            got.append(live)
            trip(live)
        return (out[0], spied) if isinstance(out, tuple) else spied
    monkeypatch.setattr(module, "_bind_trip", bound)
    return got


def test_lbfgs_trips_get_the_last_read(monkeypatch):
    """The L-BFGS engine's trips get all lanes first, then the live count
    of each read: what a bound K2 sizes its blocks by."""
    got = _spy(monkeypatch, lb)
    reads = []
    monkeypatch.setattr(lb, "read_live",
                        lambda status, f=lb.read_live: reads.append(
                            f(status)) or reads[-1])
    scale = torch.tensor([1.0, 3.0, 10.0, 0.5], dtype=F64)[:, None]

    def vg(x):
        return (scale * x * x).sum(-1), 2.0 * scale * x

    x0 = torch.linspace(-1.0, 2.0, 4 * 3, dtype=F64).reshape(4, 3)
    lb.lbfgs_minimize_batched(vg, x0, LBFGSConfig(maxiter=30))
    assert got == [4] + reads[:-1] and reads[-1] == 0
    assert len(set(got)) > 1


def test_lm_trips_get_the_last_read(monkeypatch):
    """The LM engine's trips get the live lanes first (a wave's padding
    left out), then the live count of each read."""
    got = _spy(monkeypatch, lm)
    reads = []
    monkeypatch.setattr(lm, "read_live",
                        lambda status, f=lm.read_live: reads.append(
                            f(status)) or reads[-1])
    target = torch.tensor([[1.0, 2.0], [0.5, -1.0], [3.0, 0.0],
                           [0.0, 0.0]], dtype=F64)

    def residual(x):
        return torch.cat([x - target, 0.1 * x * x], dim=-1)

    x0 = torch.zeros(4, 2, dtype=F64)
    lm.lm_minimize_batched(residual, x0, LMConfig(maxiter=8), live=3)
    assert got == [3] + reads[:-1] and reads[-1] == 0
