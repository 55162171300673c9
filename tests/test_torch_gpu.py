"""The port's CUDA kernels on the card, against their plain PyTorch versions.

These tests need a CUDA device and skip without one. They import neither
JAX nor the suite's conftest (which imports JAX), so on a machine with a
card and without JAX they run as

    python3 -m pytest --noconftest -m gpu tests/test_torch_gpu.py -q

Tolerances: K1<double> 1e-11 relative (same formulas and order as the
plain pricer; libm rounding only) and the reference goldens to 1e-9;
K1<float> 8e-5 relative (the JAX Pallas tests' float32 bar); K2/K3 prices
8e-5 relative and gradient/Jacobian rows 5e-3 after scaling by their
largest entry (tests/test_loss_pallas.py's tolerances).
"""
import dataclasses

import numpy as np
import pytest
import torch

import option_pricing_ffn_lbfgs_tpu_torch as port
from option_pricing_ffn_lbfgs_tpu_torch.calibration import calibrator
from option_pricing_ffn_lbfgs_tpu_torch.calibration.initial_guess import (
    initial_guesses)
from option_pricing_ffn_lbfgs_tpu_torch.calibration.transforms import (
    transform)
from option_pricing_ffn_lbfgs_tpu_torch.models.double_heston import (
    PARAM_NAMES)
from option_pricing_ffn_lbfgs_tpu_torch.ops import cos_kernel, loss_kernel
from option_pricing_ffn_lbfgs_tpu_torch.utils.config import CalibrationConfig

pytestmark = pytest.mark.gpu
F64, F32 = torch.float64, torch.float32

# The reference's demo parameters and measured prices (tests/conftest.py,
# tests/test_pricer.py), repeated here so this file needs no JAX.
DEMO = dict(v1_0=0.04, kappa1=2.0, theta1=0.04, sigma1=0.3, rho1=-0.5,
            v2_0=0.04, kappa2=1.5, theta2=0.04, sigma2=0.2, rho2=-0.3,
            lambda_j=0.5, mu_j=-0.05, sigma_j=0.10)
GOLDEN_DEMO_CALL = 13.872851144174323
GOLDEN_DEMO_PUT = 8.995793594010637
TRUE = dict(v1_0=0.05, kappa1=2.0, theta1=0.045, sigma1=0.35, rho1=-0.65,
            v2_0=0.04, kappa2=0.8, theta2=0.05, sigma2=0.25, rho2=-0.45,
            lambda_j=0.12, mu_j=-0.05, sigma_j=0.09)
STRIKES = np.tile([90.0, 95.0, 100.0, 105.0, 110.0], 3)
MATS = np.repeat([0.25, 0.5, 1.0], 5)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels are CUDA C++")
    return torch.device("cuda")


def _vec(d):
    return np.array([d[k] for k in PARAM_NAMES])


def _problem(b, n_strikes, seed):
    """tests/test_pallas.py's recipe: GUESS0-like params +/-10 %, mixed
    call/put."""
    rng = np.random.default_rng(seed)
    base = np.array([0.04, 2.5, 0.04, 0.3, -0.7, 0.04, 0.8, 0.04, 0.2, -0.5,
                     0.15, -0.04, 0.08])
    params = base * (1 + rng.uniform(-0.1, 0.1, (b, 13)))
    spots = 100.0 + rng.uniform(-3, 3, b)
    ks = np.linspace(90, 110, n_strikes)
    strikes = np.tile(np.tile(ks, 3), (b, 1))
    mats = np.tile(np.repeat([0.25, 0.5, 1.0], n_strikes), (b, 1))
    ic = np.ones((b, 3 * n_strikes), bool)
    ic[:, ::3] = False
    return params, spots, strikes, mats, ic


def test_k1_goldens(cuda):
    t = lambda a: torch.tensor(a, dtype=F64, device=cuda)
    out = cos_kernel.price_surfaces(
        t(_vec(DEMO)[None]), t([100.0]), 0.05, t([[100.0, 100.0]]),
        t([[1.0, 1.0]]), torch.tensor([[True, False]], device=cuda))
    assert abs(float(out[0, 0]) - GOLDEN_DEMO_CALL) < 1e-9
    assert abs(float(out[0, 1]) - GOLDEN_DEMO_PUT) < 1e-9


@pytest.mark.parametrize("b,n_strikes", [(17, 5), (3, 3)])
@pytest.mark.parametrize("dt,rtol", [(F64, 1e-11), (F32, 8e-5)])
def test_k1_matches_plain(cuda, dt, rtol, b, n_strikes):
    params, spots, strikes, mats, ic = _problem(b, n_strikes, seed=b)
    args = [torch.tensor(a, dtype=dt, device=cuda)
            for a in (params, spots, strikes, mats)]
    call = torch.tensor(ic, device=cuda)
    entry = f"cos_price_f{64 if dt == F64 else 32}"
    before = cos_kernel.LAUNCHES[entry]
    out = cos_kernel.price_surfaces(args[0], args[1], 0.03, *args[2:], call,
                                    n_terms=64)
    ref = cos_kernel.price_surfaces_plain(args[0], args[1], 0.03, *args[2:],
                                          call, n_terms=64)
    torch.cuda.synchronize()
    assert cos_kernel.LAUNCHES[entry] == before + 1
    assert out.shape == (b, 3 * n_strikes) and out.dtype == dt
    np.testing.assert_allclose(out.cpu().numpy(), ref.cpu().numpy(),
                               rtol=rtol)


@pytest.mark.parametrize("mode", ["loss", "jac"])
def test_k2_k3_match_plain(cuda, mode):
    """Six lanes: the port's three starts on two surfaces priced from TRUE
    (the second at a 2 % higher market), far enough from the optimum that
    float32 rounding stays inside the tolerances."""
    mkt = port.price_surfaces(
        torch.tensor(np.stack([_vec(TRUE)] * 2)),
        torch.full((2,), 100.0, dtype=F64), 0.03,
        torch.tensor(np.tile(STRIKES, (2, 1))),
        torch.tensor(np.tile(MATS, (2, 1))),
        torch.ones((2, 15), dtype=torch.bool))
    mkt = mkt * torch.tensor([[1.0], [1.02]], dtype=F64)
    t = lambda a: torch.as_tensor(a, dtype=F32).to(cuda)
    spots, strikes, mats = (t(np.full(6, 100.0)), t(np.tile(STRIKES, (6, 1))),
                            t(np.tile(MATS, (6, 1))))
    lane_mkt = t(mkt.repeat_interleave(3, dim=0))
    x = initial_guesses(3, torch.Generator().manual_seed(0), spots[::3],
                        strikes[::3], mats[::3], lane_mkt[::3]).reshape(6, 13)
    call = torch.ones((6, 15), dtype=torch.bool, device=cuda)
    args = (transform(x), spots, 0.03, strikes, mats, call, lane_mkt, 64)
    key = f"cos_vg_{mode}"
    before = loss_kernel.LAUNCHES[key]
    if mode == "loss":
        out = loss_kernel.rows_value_and_grad(*args)
        ref = loss_kernel.rows_value_and_grad_plain(*args)
    else:
        out = loss_kernel.rows_jacobian(*args)
        ref = loss_kernel.rows_jacobian_plain(*args)
    torch.cuda.synchronize()
    assert loss_kernel.LAUNCHES[key] == before + 1
    np.testing.assert_allclose(out[0].cpu().numpy(), ref[0].cpu().numpy(),
                               rtol=8e-5)
    scale = float(ref[1].abs().max())
    np.testing.assert_allclose(out[1].cpu().numpy() / scale,
                               ref[1].cpu().numpy() / scale, atol=5e-3)


@pytest.mark.parametrize("dt,n_terms,price_rtol,grad_atol", [
    (F32, 128, 8e-5, 5e-3), (F64, 128, 1e-11, 1e-9), (F64, 64, 1e-11, 1e-9)],
    ids=["f32-N128", "f64-N128", "f64-N64"])
def test_k2_new_shapes_match_plain(cuda, dt, n_terms, price_rtol, grad_atol):
    """K2 at the hybrid refine's N = 128 (float32) and K2<double> (the
    float64 value-and-grad of calibrate_surface and hybrid_calibrate)
    against autograd of the plain loss rows at the same dtype on the card.
    Float64 tolerances: the same formulas in forward mode against reverse
    mode, so only the order of the sums differs (1e-11 on prices, 1e-9 of
    the row maximum on the gradient)."""
    rng = np.random.default_rng(3)
    true = _vec(TRUE) * (1.0 + rng.uniform(-0.3, 0.3, (6, 13)))
    t = lambda a: torch.as_tensor(a, dtype=dt).to(cuda)
    spots, strikes, mats = (t(np.full(6, 100.0)), t(np.tile(STRIKES, (6, 1))),
                            t(np.tile(MATS, (6, 1))))
    call = torch.ones((6, 15), dtype=torch.bool, device=cuda)
    mkt = cos_kernel.price_surfaces_plain(
        t(np.stack([_vec(TRUE)] * 6)), spots, 0.03, strikes, mats, call,
        n_terms=n_terms)
    args = (t(true), spots, 0.03, strikes, mats, call, mkt, n_terms)
    key = "cos_vg_loss" if dt == F32 else "cos_vg_loss_f64"
    before = loss_kernel.LAUNCHES[key]
    out = loss_kernel.rows_value_and_grad(*args)
    ref = loss_kernel.rows_value_and_grad_plain(*args)
    torch.cuda.synchronize()
    assert loss_kernel.LAUNCHES[key] == before + 1
    assert out[0].dtype == dt and out[1].shape == (6, 13)
    np.testing.assert_allclose(out[0].cpu().numpy(), ref[0].cpu().numpy(),
                               rtol=price_rtol)
    scale = ref[1].abs().amax(-1, keepdim=True)
    np.testing.assert_allclose((out[1] / scale).cpu().numpy(),
                               (ref[1] / scale).cpu().numpy(), atol=grad_atol)


def test_ffn_forward_on_card(cuda, monkeypatch):
    """The shipped surrogate's forward pass on the card against the CPU,
    float32 with TF32 off: 1e-5 relative (the summation order of the
    matmuls differs)."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    s = port.load_default_model()
    ds = port.generate_dataset(torch.Generator().manual_seed(0),
                               port.GeneratorConfig(n_samples=64), n_terms=64)
    x_cpu = s.predict_x(ds.market_prices, ds.spots)
    x_gpu = s.predict_x(ds.market_prices.to(cuda), ds.spots.to(cuda))
    assert x_gpu.device.type == "cuda" and x_gpu.dtype == F32
    np.testing.assert_allclose(x_gpu.cpu().numpy(), x_cpu.numpy(), rtol=1e-5)


def test_slice_on_card(cuda):
    """calibrate_batch_mixed on two surfaces (TRUE +/- 5 %), 3 starts,
    compacted waves forced: every kernel of the path launches and the mean
    error stays below 0.03 %."""
    rng = np.random.default_rng(5)
    true = _vec(TRUE) * (1.0 + rng.uniform(-0.05, 0.05, (2, 13)))
    data = [torch.full((2,), 100.0, dtype=F64),
            torch.tensor(np.tile(STRIKES, (2, 1))),
            torch.tensor(np.tile(MATS, (2, 1))),
            torch.ones((2, 15), dtype=torch.bool)]
    prices = port.price_surfaces(torch.tensor(true), data[0], 0.03, *data[1:])
    data = [a.to(cuda) for a in data]
    cfg = CalibrationConfig(search_impl="pallas", polish_impl="pallas",
                            polish_fused_min_lanes=1,
                            polish_compact_min_lanes=1)
    polish = dataclasses.replace(calibrator.POLISH_LM, residual_impl="native")
    before = {**cos_kernel.LAUNCHES, **loss_kernel.LAUNCHES}
    out = port.calibrate_batch_mixed(
        data[0], 0.03, *data[1:], prices.to(cuda),
        torch.Generator().manual_seed(0), config=cfg, n_starts=3,
        polish=polish)
    after = {**cos_kernel.LAUNCHES, **loss_kernel.LAUNCHES}
    # The slice runs K2 at float32 only; K2<double> is not on its path.
    assert all(after[k] > before[k] for k in after
               if k != "cos_vg_loss_f64"), (before, after)
    assert calibrator.WAVE_LANES
    model = out.model_prices.cpu().numpy()
    assert model.shape == (2, 15) and np.all(np.isfinite(model))
    assert np.mean(np.abs(model / prices.numpy() - 1.0)) * 100 < 0.03
