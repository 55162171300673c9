"""The port's entry points run on the card unless the caller asks for the CPU.

The entry points added with the benchmark (the Greeks, Black–Scholes, the
host pricer, ``tools/bench.py`` and ``tools/error_ablation.py``) are
called with numpy inputs: without a card the default raises, and
``device="cpu"`` (or CPU tensors) runs them on the CPU.

``device=None`` resolves to the device of a tensor input, else to
``cuda``; there is no CPU fallback. Each entry point is called with numpy
inputs and its first placement of the inputs is intercepted, so the tests
show where it would run without allocating on a card (this machine may
have none).
"""
import inspect

import numpy as np
import pytest
import torch

import option_pricing_ffn_lbfgs_tpu_torch as port
from option_pricing_ffn_lbfgs_tpu_torch.calibration import calibrator as tcal
from option_pricing_ffn_lbfgs_tpu_torch.data import synthetic as tsyn
from option_pricing_ffn_lbfgs_tpu_torch.calibration.initial_guess import (
    GUESS0)
from option_pricing_ffn_lbfgs_tpu_torch.ops import black_scholes as tbs
from option_pricing_ffn_lbfgs_tpu_torch.surrogate import hybrid as thyb
from option_pricing_ffn_lbfgs_tpu_torch.tools import bench as tbench
from option_pricing_ffn_lbfgs_tpu_torch.tools import error_ablation
from option_pricing_ffn_lbfgs_tpu_torch.utils.hostpricer import (
    price_truth_subprocess)

CUDA, CPU = torch.device("cuda"), torch.device("cpu")


class _Placed(Exception):
    pass


def test_device_of_numpy_is_cuda():
    assert tcal._device_of(np.ones(3), None) == CUDA
    assert tcal._device_of([1.0, 2.0], None) == CUDA


@pytest.mark.parametrize("prices,device", [
    (torch.ones(3), None), (np.ones(3), "cpu"), (torch.ones(3), "cpu"),
    (np.ones(3), CPU)])
def test_device_of_cpu_when_asked(prices, device):
    assert tcal._device_of(prices, device) == CPU


def test_calibrator_and_loader_default_to_cuda():
    sig = inspect.signature(port.DoubleHestonJumpCalibrator.__init__)
    assert sig.parameters["device"].default == "cuda"
    assert inspect.signature(port.load_dataset).parameters[
        "device"].default == "cuda"
    for fn in (port.hybrid_calibrate, port.hybrid_calibrate_batch_mixed,
               port.calibrate_batch, port.calibrate_batch_mixed,
               port.calibrate_surface, port.generate_dataset):
        assert inspect.signature(fn).parameters["device"].default is None


def _surface(b=None):
    shape = (15,) if b is None else (b, 15)
    return (np.full(shape[:-1], 100.0) if b else 100.0,
            np.full(shape, 100.0), np.full(shape, 0.5),
            np.ones(shape, bool), np.full(shape, 10.0))


@pytest.mark.parametrize("entry", ["calibrate_batch", "calibrate_batch_mixed",
                                   "calibrate_surface", "hybrid_calibrate",
                                   "hybrid_calibrate_batch_mixed"])
@pytest.mark.parametrize("device,want", [(None, CUDA), ("cpu", CPU)])
def test_entry_points_place_numpy_inputs(monkeypatch, entry, device, want):
    """Numpy inputs land on ``cuda`` by default, on the CPU when asked."""
    seen = []

    def placed(*args):
        seen.append(torch.device(args[-1]))
        raise _Placed

    monkeypatch.setattr(tcal, "_inputs", placed)
    monkeypatch.setattr(thyb, "_inputs", placed)
    single = entry in ("calibrate_surface", "hybrid_calibrate")
    spot, strikes, mats, call, mkt = _surface(None if single else 2)
    args = (spot, 0.03, strikes, mats, call, mkt)
    if entry.startswith("hybrid"):
        fn = lambda: getattr(thyb, entry)(None, *args, device=device)
    else:
        fn = lambda: getattr(tcal, entry)(*args, device=device)
    with pytest.raises(_Placed):
        fn()
    assert seen == [want]


@pytest.mark.parametrize("device,want", [(None, "cuda"), ("cpu", "cpu")])
def test_generate_dataset_prices_on_cuda(monkeypatch, device, want):
    """A CPU generator still makes the draws; the pricing goes to
    ``cuda`` unless ``device`` says otherwise."""
    seen = []

    def priced(*args):
        seen.append(torch.device(args[-1]))
        raise _Placed

    monkeypatch.setattr(tsyn, "dataset_from_draws", priced)
    with pytest.raises(_Placed):
        tsyn.generate_dataset(torch.Generator().manual_seed(0),
                              port.GeneratorConfig(n_samples=2), n_terms=16,
                              device=device)
    assert seen == [torch.device(want)]


def test_dataset_from_numpy_draws_defaults_to_cuda(monkeypatch):
    seen = []

    class Paths:
        def to(self, dev, dtype):
            seen.append(dev)
            raise _Placed

    monkeypatch.setattr(tsyn, "ar1_paths", lambda *a: (Paths(), Paths()))
    with pytest.raises(_Placed):
        tsyn.dataset_from_draws(np.zeros((2, 13)), np.zeros(2),
                                np.zeros((2, 15)), port.GeneratorConfig())
    assert seen == [CUDA]



def _no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default does not raise")


_STRIKES = np.tile([90.0, 100.0, 110.0], 2)
_MATS = np.repeat([0.5, 1.0], 3)
_CALL = np.ones(6, bool)
_PRICES = np.array([13.26, 6.88, 2.87, 15.08, 9.41, 5.29])   # vol ~ 0.2
_PARAMS = port.DHParams(*(float(v) for v in GUESS0))

_NEW_ENTRIES = {
    "greeks": lambda **kw: port.greeks(
        _PARAMS, 100.0, 0.03, _STRIKES, _MATS, _CALL, n_terms=16, **kw)[1],
    "param_sensitivities": lambda **kw: port.param_sensitivities(
        _PARAMS, 100.0, 0.03, _STRIKES, _MATS, _CALL, n_terms=16,
        **kw)["sigma1"],
    "bs_price": lambda **kw: port.bs_price(100.0, _STRIKES, _MATS, 0.03,
                                           0.2, **kw),
    "bs_vega": lambda **kw: port.bs_vega(100.0, _STRIKES, _MATS, 0.03, 0.2,
                                         **kw),
    "implied_vol": lambda **kw: port.implied_vol(
        _PRICES, 100.0, _STRIKES, _MATS, 0.03, max_iter=8, **kw),
    "implied_vol_surface": lambda **kw: tbs.implied_vol_surface(
        _PRICES, 100.0, _STRIKES, _MATS, 0.03, **kw),
    "price_truth_subprocess": lambda **kw: torch.as_tensor(
        price_truth_subprocess(np.tile(GUESS0, (2, 1)), np.full(2, 100.0),
                               _STRIKES, _MATS, **kw)),
}


@pytest.mark.parametrize("entry", list(_NEW_ENTRIES))
def test_new_entry_points_default_to_cuda(entry):
    """Numpy inputs without ``device`` go to ``cuda``: without a card the
    call raises, it does not fall back to the CPU."""
    _no_card()
    with pytest.raises((AssertionError, RuntimeError)):
        _NEW_ENTRIES[entry]()


@pytest.mark.parametrize("entry", list(_NEW_ENTRIES))
def test_new_entry_points_run_on_cpu_when_asked(entry):
    out = _NEW_ENTRIES[entry](device="cpu")
    assert out.device == CPU and bool(torch.isfinite(out).all())


def test_sensitivities_follow_cpu_tensors():
    t = lambda a: torch.tensor(a)
    g = port.greeks(_PARAMS, 100.0, 0.03, t(_STRIKES), t(_MATS), t(_CALL),
                    n_terms=16)
    assert g.delta.device == CPU
    assert port.bs_price(t(100.0), _STRIKES, _MATS, 0.03, 0.2).device == CPU


def test_bench_and_ablation_need_a_card(tmp_path):
    _no_card()
    with pytest.raises(RuntimeError, match="CUDA card"):
        tbench.run("mixed")
    with pytest.raises(RuntimeError, match="CUDA card"):
        tbench.build_probe()
    with pytest.raises(RuntimeError, match="CUDA card"):
        error_ablation.main(["--out", str(tmp_path / "a.json")])
    with pytest.raises((AssertionError, RuntimeError)):
        tbench.build_problems(1)
    args, prices = tbench.build_problems(1, device="cpu")[0]
    assert args[0].device == CPU and prices.shape == (5, 15)
