"""The port's entry points run on the card unless the caller asks for the CPU.

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
from option_pricing_ffn_lbfgs_tpu_torch.surrogate import hybrid as thyb

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
