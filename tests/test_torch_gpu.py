"""The port's CUDA kernels on the card, against their plain PyTorch versions.

These tests need a CUDA device and skip without one. They import neither
JAX nor the suite's conftest (which imports JAX), so on a machine with a
card and without JAX they run as

    python3 -m pytest --noconftest -m gpu tests/test_torch_gpu.py -q

Tolerances: K1<double> 1e-11 relative (same formulas and order as the
plain pricer; libm rounding only) and the reference goldens to 1e-9;
K1<float> 8e-5 relative (the JAX Pallas tests' float32 bar), also at the
edge shapes (lanes 1, 15, 1537 x n_opt 7, 15, 17, and 64 distinct
maturities at N = 128, over 48 KB of shared memory in double); K2/K3 prices
8e-5 relative and gradient/Jacobian rows 5e-3 after scaling by their
largest entry (tests/test_loss_pallas.py's tolerances). At the edge shapes
(lanes 1, 15, 1537 x n_opt 7, 15, 17) the loss and its gradient are held
as chip_smoke.py holds them: float32 loss 2e-4 relative, gradient 5e-3 of
its row maximum, K3 5e-3 of the Jacobian's maximum; float64 1e-11 and
1e-9.
"""
import dataclasses

import numpy as np
import pytest
import torch

import option_pricing_ffn_lbfgs_tpu_torch as port
from option_pricing_ffn_lbfgs_tpu_torch.calibration import calibrator
from option_pricing_ffn_lbfgs_tpu_torch.calibration.initial_guess import (
    initial_guesses)
from option_pricing_ffn_lbfgs_tpu_torch.calibration.loss import (
    make_loss_fn, make_residual_fn)
from option_pricing_ffn_lbfgs_tpu_torch.calibration.transforms import (
    inverse_transform, transform)
from option_pricing_ffn_lbfgs_tpu_torch.models.double_heston import (
    PARAM_NAMES)
from option_pricing_ffn_lbfgs_tpu_torch.ops import (
    cos_kernel, kernel_build, loss_kernel, opcount)
from option_pricing_ffn_lbfgs_tpu_torch.utils.config import (
    CalibrationConfig, PricerConfig)

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
# bench.py's parameter ranges
LO = np.array([0.025, 1.5, 0.025, 0.20, -0.85, 0.020, 0.30, 0.025, 0.10,
               -0.70, 0.05, -0.08, 0.03])
HI = np.array([0.080, 4.5, 0.065, 0.50, -0.40, 0.070, 1.20, 0.070, 0.35,
               -0.20, 0.25, -0.01, 0.12])


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


def _k1_edge(n_lanes, n_opt, seed, device):
    """K1 lanes cycling over three layouts, calls and puts mixed: short
    maturities with in-the-money strikes far from the money and small
    variances, where the widening of the truncation range to
    log(K/S0) -/+ 0.1 binds (lane 0 is one); all maturities distinct; three
    maturities. Every option is in or at the money and no maturity passes
    one year, so float32 prices are not small differences of large terms
    (chip_smoke.py phase 3 uses the same layouts). Returns float64 tensors
    and the number of lanes that bind."""
    rng = np.random.default_rng(seed)
    params = rng.uniform(LO, HI, (n_lanes, 13))
    kind = np.arange(n_lanes) % 3
    params[kind == 0] *= np.where(np.isin(np.arange(13), [0, 2, 5, 7]), 0.3,
                                  1.0)
    near = np.resize(STRIKES[:5], n_opt)
    far = np.resize([70.0, 125.0, 90.0, 80.0, 130.0], n_opt)
    layouts = [(far, np.resize([0.02, 0.02, 0.02, 0.5, 0.5], n_opt),
                far <= 100),
               (near, np.linspace(0.05, 0.75, n_opt), near <= 100),
               (near, np.sort(np.resize(MATS[::5], n_opt)), near <= 100)]
    pick = lambda i: np.stack([layouts[k][i] for k in kind])
    t = lambda a: torch.tensor(np.asarray(a), dtype=F64, device=device)
    prob = (t(params), t(100.0 + rng.uniform(-3, 3, n_lanes)), t(pick(0)),
            t(pick(1)), torch.tensor(pick(2), device=device))
    n_mat, n_eff = opcount.effective_groups(*prob[:4])
    return prob, int((n_eff > n_mat).sum())


def _k1_wide(device):
    """Three surfaces of 64 options at 64 distinct maturities: at N = 128
    the double kernel's items take 64 KB of shared memory."""
    rng = np.random.default_rng(64)
    ks = np.resize([80.0, 90.0, 100.0, 110.0, 120.0], 64)
    t = lambda a: torch.tensor(np.asarray(a), dtype=F64, device=device)
    return (t(rng.uniform(LO, HI, (3, 13))), t([100.0, 97.0, 103.0]),
            t(np.tile(ks, (3, 1))), t(np.tile(np.linspace(0.05, 0.75, 64),
                                              (3, 1))),
            torch.tensor(np.tile(ks <= 100, (3, 1)), device=device))


def _k1_check(prob, dt, rtol, n_terms):
    args = [a.to(dt) for a in prob[:4]]
    out = cos_kernel.price_surfaces(args[0], args[1], 0.03, *args[2:],
                                    prob[4], n_terms=n_terms)
    ref = cos_kernel.price_surfaces_plain(args[0], args[1], 0.03, *args[2:],
                                          prob[4], n_terms=n_terms)
    torch.cuda.synchronize()
    assert out.shape == ref.shape and out.dtype == dt
    np.testing.assert_allclose(out.cpu().numpy(), ref.cpu().numpy(),
                               rtol=rtol)


@pytest.mark.parametrize("n_lanes", [1, 15, 1537])
@pytest.mark.parametrize("n_opt", [7, 15, 17])
@pytest.mark.parametrize("dt,rtol", [(F64, 1e-11), (F32, 8e-5)],
                         ids=["double", "float"])
def test_k1_edge_shapes_match_plain(cuda, dt, rtol, n_opt, n_lanes):
    """K1 with all-distinct maturities and rows whose widening binds (each
    its own group in the kernel) against the plain pricer."""
    prob, n_bind = _k1_edge(n_lanes, n_opt, 40 + n_lanes + n_opt, cuda)
    assert n_bind > 0
    _k1_check(prob, dt, rtol, 64)


@pytest.mark.parametrize("dt,rtol", [(F64, 1e-11), (F32, 8e-5)],
                         ids=["double", "float"])
def test_k1_large_shared_memory(cuda, dt, rtol):
    _k1_check(_k1_wide(cuda), dt, rtol, 128)


@pytest.mark.parametrize("shape", ["edge", "wide"])
@pytest.mark.parametrize("dt", [F64, F32], ids=["double", "float"])
def test_k1_guard_band_and_identical_bits(cuda, dt, shape):
    """The C entry, called on an output one row longer than needed and
    filled with a sentinel, leaves the tail untouched; its rows equal, bit
    for bit, two launches through the wrapper."""
    prob, n_terms = ((_k1_edge(15, 17, 5, cuda)[0], 64) if shape == "edge"
                     else (_k1_wide(cuda), 128))
    args = [a.to(dt).contiguous() for a in prob[:4]]
    b, n = args[2].shape
    out = torch.full((b * n + 1,), -12345.0, dtype=dt, device=cuda)
    err = kernel_build.entry("cos_price", cos_kernel._ENTRY[dt],
                             cos_kernel._ARGTYPES)(
        *(a.data_ptr() for a in args), prob[4].contiguous().data_ptr(),
        out.data_ptr(), 0.03, 0.0, 10.0, b * n, n, n_terms,
        torch.cuda.current_stream().cuda_stream)
    first = cos_kernel.price_surfaces(args[0], args[1], 0.03, *args[2:],
                                      prob[4], n_terms=n_terms)
    second = cos_kernel.price_surfaces(args[0], args[1], 0.03, *args[2:],
                                       prob[4], n_terms=n_terms)
    torch.cuda.synchronize()
    assert err == 0 and float(out[-1]) == -12345.0
    assert torch.equal(first, second)
    assert torch.equal(out[:-1].view(b, n), first)


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
                               port.GeneratorConfig(n_samples=64), n_terms=64,
                               device="cpu")
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


def _edge_problem(n_lanes, n_opt, seed, dt, device):
    """Lanes whose layout cycles over three kinds: three maturities with
    mixed calls and puts; all maturities distinct; short maturities with
    in-the-money strikes far from the money, and truths and starts with
    small variances, where the widening of the truncation range to
    log(K/S0) -/+ 0.1 binds. Starts are drawn apart from the truths and
    kept where the float64 loss is at least 0.2: with all-distinct
    maturities up to 2 years, lanes at 0.05 carry float32 pricing noise of
    2e-4 relative on the loss (the K2 tolerance) in the plain version and
    the kernel alike; at 0.2 both stay within 6e-5. The first lane kept is
    one whose widening binds, so every shape runs the kernel's own-row
    groups."""
    rng = np.random.default_rng(seed)
    m = 4 * n_lanes + 8
    true, start = rng.uniform(LO, HI, (m, 13)), rng.uniform(LO, HI, (m, 13))
    kind = (np.arange(m) + n_opt) % 3
    small = np.where(np.isin(np.arange(13), [0, 2, 5, 7]), 0.3, 1.0)
    true[kind == 2] *= small
    start[kind == 2] *= small
    r = np.arange(n_opt)
    far = np.resize([70.0, 125.0, 100.0, 80.0, 130.0], n_opt)
    layouts = [
        (np.resize(STRIKES[:5], n_opt), np.sort(np.resize(MATS[::5], n_opt)),
         r % 2 == 0),
        (np.resize(STRIKES[:5], n_opt), np.linspace(0.1, 2.0, n_opt),
         r % 2 == 1),
        (far, np.resize([0.02, 0.02, 0.02, 0.5, 0.5], n_opt), far <= 100.0)]
    t = lambda a: torch.tensor(np.asarray(a), dtype=F64, device=device)
    strikes = t(np.stack([layouts[k][0] for k in kind]))
    mats = t(np.stack([layouts[k][1] for k in kind]))
    call = torch.tensor(np.stack([layouts[k][2] for k in kind]),
                        device=device)
    spots = torch.full((m,), 100.0, dtype=F64, device=device)
    mkt = cos_kernel.price_surfaces_plain(t(true), spots, 0.03, strikes, mats,
                                          call, n_terms=64)
    x = inverse_transform(t(start))
    cfg = CalibrationConfig(pricer=PricerConfig(n_terms=64))
    loss = make_loss_fn(spots, 0.03, strikes, mats, call, mkt, cfg)(x)
    cand = torch.nonzero(loss >= 0.2)[:, 0]
    n_mat, n_eff = opcount.effective_groups(
        transform(x[cand]), spots[cand], strikes[cand], mats[cand])
    binds = n_eff > n_mat
    assert bool(binds.any())
    first = int(torch.nonzero(binds)[0, 0])
    order = [first] + [i for i in range(cand.numel()) if i != first]
    keep = cand[order[:n_lanes]]
    assert keep.numel() == n_lanes
    return (spots[keep].to(dt), strikes[keep].to(dt), mats[keep].to(dt),
            call[keep], mkt[keep].to(dt), x[keep].to(dt))


@pytest.mark.parametrize("n_lanes", [1, 15, 1537])
@pytest.mark.parametrize("n_opt", [7, 15, 17])
@pytest.mark.parametrize("kernel", ["K2", "K3", "K2<double>"])
def test_edge_shapes_match_plain(cuda, kernel, n_opt, n_lanes):
    """K2, K3 and K2<double> through their host assemblies against autograd
    (jacfwd for K3) of the plain loss (residuals) at the same dtype."""
    dt, n_terms = (F64, 128) if kernel == "K2<double>" else (F32, 64)
    prob = _edge_problem(n_lanes, n_opt, 100 + n_lanes + n_opt, dt, cuda)
    cfg = CalibrationConfig(pricer=PricerConfig(n_terms=n_terms))
    if kernel == "K3":
        J_k = loss_kernel.make_batch_residual_jacobian(*prob[:5], 0.03,
                                                       cfg)(prob[5])
        res = make_residual_fn(*prob[:1], 0.03, *prob[1:5], cfg)
        zero = torch.zeros(13, dtype=dt, device=cuda)
        J_p = torch.func.jacfwd(lambda dl: res(prob[5] + dl))(zero)
        assert J_k.shape == (n_lanes, n_opt + 2, 13)
        scale = float(J_p.abs().max())
        np.testing.assert_allclose((J_k / scale).cpu().numpy(),
                                   (J_p / scale).cpu().numpy(), atol=5e-3)
        return
    ftol, gtol = (1e-11, 1e-9) if dt == F64 else (2e-4, 5e-3)
    f_k, g_k = loss_kernel.make_batch_value_and_grad(*prob[:5], 0.03,
                                                     cfg)(prob[5])
    xr = prob[5].detach().requires_grad_(True)
    f_p = make_loss_fn(*prob[:1], 0.03, *prob[1:5], cfg)(xr)
    g_p, = torch.autograd.grad(f_p.sum(), xr)
    np.testing.assert_allclose(f_k.cpu().numpy(), f_p.detach().cpu().numpy(),
                               rtol=ftol)
    scale = g_p.abs().amax(-1, keepdim=True).clamp(min=1e-6)
    np.testing.assert_allclose((g_k / scale).cpu().numpy(),
                               (g_p / scale).cpu().numpy(), atol=gtol)


@pytest.mark.parametrize("mode,dt,n_terms", [
    ("loss", F32, 64), ("jac", F32, 64), ("loss", F64, 128)])
def test_guard_band_and_identical_bits(cuda, mode, dt, n_terms):
    """The C entry, called at each block width on outputs one lane longer
    than needed and filled with a sentinel, leaves the tail untouched; its
    rows equal, bit for bit, two launches through the wrapper (sums in a
    fixed order, no atomics)."""
    spots, strikes, mats, call, mkt, x = _edge_problem(15, 15, 5, dt, cuda)
    params = transform(x)
    symbol, mode_no, _ = loss_kernel._ENTRIES[mode, dt]
    lanes, n = strikes.shape
    ins = [params, spots, strikes, mats, call, mkt,
           loss_kernel.maturity_groups(mats)]
    outs = []
    for warps in loss_kernel.WARPS[symbol]:
        price = torch.full((lanes + 1, n), -12345.0, dtype=dt, device=cuda)
        grad = torch.full((lanes + 1, 13) if mode == "loss" else
                          (lanes + 1, n, 13), -12345.0, dtype=dt,
                          device=cuda)
        err = kernel_build.entry("cos_vg", symbol, loss_kernel.ARGTYPES)(
            *(t.contiguous().data_ptr() for t in ins), None,
            price.data_ptr(), grad.data_ptr(), 0.03, 0.0, 10.0, lanes, n,
            n_terms, mode_no, warps, torch.cuda.current_stream().cuda_stream)
        assert err == 0
        outs.append((price, grad))
    wrap = (loss_kernel.rows_value_and_grad if mode == "loss"
            else loss_kernel.rows_jacobian)
    a = wrap(params, spots, 0.03, strikes, mats, call, mkt, n_terms)
    b = wrap(params, spots, 0.03, strikes, mats, call, mkt, n_terms)
    torch.cuda.synchronize()
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    for price, grad in outs:
        assert bool((price[lanes:] == -12345.0).all())
        assert bool((grad[lanes:] == -12345.0).all())
        assert torch.equal(price[:lanes], a[0])
        assert torch.equal(grad[:lanes], a[1])


# kernel -> (mode, dtype, N) of a bound K2/K3 launch that skips done lanes
MASKED = {"K2": ("loss", F32, 64), "K3": ("jac", F32, 64),
          "K2<double>": ("loss", F64, 128)}


@pytest.mark.parametrize("share", ["none", "two_in_five", "all"])
@pytest.mark.parametrize("n_lanes", [1, 15, 1537])
@pytest.mark.parametrize("kernel", list(MASKED))
def test_bound_k2_k3_skip_done_lanes(cuda, kernel, n_lanes, share):
    """K2, K3 and K2<double> bound with done flags (none, lanes 3 and 4 of
    every 5, all): the live lanes' rows equal the one-shot launch's in
    bits, the done lanes' rows keep their planted guard, and with the
    flags cleared in place the next launch prices every lane
    (tools/trip_check.py::check_masked_rows)."""
    from option_pricing_ffn_lbfgs_tpu_torch.tools import trip_check
    mode, dt, n_terms = MASKED[kernel]
    spots, strikes, mats, call, mkt, x = _edge_problem(
        n_lanes, 15, 100 + n_lanes + 15, dt, cuda)
    lane = torch.arange(n_lanes, device=cuda)
    done = {"none": lane < 0, "two_in_five": lane % 5 >= 3,
            "all": lane >= 0}[share]
    rep = trip_check.check_masked_rows(mode, transform(x), spots, strikes,
                                       mats, call, mkt, n_terms, done)
    assert rep["ok"], rep


@pytest.mark.parametrize("fault", ["uint8", "short", "long", "cpu",
                                   "strided"])
@pytest.mark.parametrize("mode", ["loss", "jac"])
def test_bound_k2_k3_refuse_malformed_done(cuda, mode, fault):
    """Both bindings refuse done flags that are not a contiguous bool
    tensor of one entry a lane on the inputs' device."""
    spots, strikes, mats, call, mkt, x = _edge_problem(15, 15, 130, F32,
                                                       cuda)
    n = strikes.shape[0]
    flags = lambda k, dev=cuda: torch.zeros(k, dtype=torch.bool, device=dev)
    done = {"uint8": torch.zeros(n, dtype=torch.uint8, device=cuda),
            "short": flags(n - 1), "long": flags(n + 1),
            "cpu": flags(n, "cpu"), "strided": flags(2 * n)[::2]}[fault]
    price = torch.empty((n, 15), dtype=F32, device=cuda)
    rows = torch.empty((n, 13) if mode == "loss" else (n, 15, 13),
                       dtype=F32, device=cuda)
    bind = (loss_kernel.bind_rows_value_and_grad if mode == "loss"
            else loss_kernel.bind_rows_jacobian)
    with pytest.raises(ValueError, match="done"):
        bind(transform(x).contiguous(), spots, 0.03, strikes, mats, call,
             mkt, 64, 10.0, 0.0, None, price, rows, done)


def _surface130(n_lanes, dt, device):
    """Lanes of 130 options, 10 maturities x 13 strikes (70-130, calls at
    and above the money), from TRUE and from small-variance parameters,
    whose short maturities' rows at far strikes have widenings that bind:
    more effective groups than a block's slices hold at once."""
    mats = np.repeat([0.02, 0.05, 0.1, 0.25, 0.5, 0.75, 1.0, 1.5, 2.0, 3.0],
                     13)
    strikes = np.tile(np.linspace(70.0, 130.0, 13), 10)
    small = np.where(np.isin(np.arange(13), [0, 2, 5, 7]), 0.3, 1.0)
    rng = np.random.default_rng(130)
    params = np.stack([_vec(TRUE) * (small if i % 2 else 1.0)
                       * (1 + rng.uniform(-0.05, 0.05, 13))
                       for i in range(n_lanes)])
    t = lambda a: torch.tensor(np.asarray(a), dtype=F64, device=device)
    strikes = t(np.tile(strikes, (n_lanes, 1)))
    mats = t(np.tile(mats, (n_lanes, 1)))
    call = strikes >= 100.0
    spots = t(np.full(n_lanes, 100.0))
    mkt = cos_kernel.price_surfaces_plain(t(params * 1.1), spots, 0.03,
                                          strikes, mats, call) + 0.01
    x = inverse_transform(t(params))
    n_mat, n_eff = opcount.effective_groups(transform(x), spots, strikes,
                                            mats)
    assert bool((n_eff > n_mat).any())
    return (spots.to(dt), strikes.to(dt), mats.to(dt), call, mkt.to(dt),
            x.to(dt))


def _at_every_width(mode, n_terms, prob, done=None):
    """``{warps: (price, rows)}``: the bound K2 (``mode`` "loss") or K3
    ("jac") launched once at each block width into outputs planted with a
    guard, skipping the lanes ``done`` flags."""
    spots, strikes, mats, call, mkt, x = prob
    params = transform(x).contiguous()
    lanes, n = strikes.shape
    bind = (loss_kernel.bind_rows_value_and_grad if mode == "loss"
            else loss_kernel.bind_rows_jacobian)
    out = {}
    symbol = loss_kernel._ENTRIES[mode, x.dtype][0]
    for warps in loss_kernel.WARPS[symbol]:
        price = torch.full((lanes, n), -12345.0, dtype=params.dtype,
                           device=params.device)
        rows = torch.full((lanes, 13) if mode == "loss" else (lanes, n, 13),
                          -12345.0, dtype=params.dtype, device=params.device)
        bind(params, spots, 0.03, strikes, mats, call, mkt, n_terms, 10.0,
             0.0, None, price, rows, done)(warps=warps)
        out[warps] = (price, rows)
    torch.cuda.synchronize()
    return out


# case -> (lanes, share of them done); "130" is _surface130's
WIDTH_CASES = {"single": (1, 0.0), "lanes15": (15, 0.0),
               "surface130": (4, 0.0), "done0": (1536, 0.0),
               "done40": (1536, 0.4), "done99.9": (1536, 0.999)}


@pytest.mark.parametrize("case", list(WIDTH_CASES))
@pytest.mark.parametrize("n_terms", [64, 128])
@pytest.mark.parametrize("kernel", list(MASKED))
def test_k2_k3_every_width_same_bits(cuda, kernel, n_terms, case):
    """K2, K3 and K2<double> at every block width (float 4 and 8 warps,
    double 2, 4 and 8) give the narrowest width's outputs under
    torch.equal: one lane, 15 lanes, 130-option
    surfaces whose groups take more than one chunk, and 1536 lanes with 0,
    40 and 99.9 % of them done (their rows left as planted). Each shape
    has lanes whose widening binds, so that rows are groups of their
    own."""
    mode, dt, _ = MASKED[kernel]
    lanes, share = WIDTH_CASES[case]
    prob = (_surface130(lanes, dt, cuda) if case == "surface130" else
            _edge_problem(lanes, 15, 200 + lanes, dt, cuda))
    done = None
    if share:
        order = torch.randperm(lanes, generator=torch.Generator()
                               .manual_seed(lanes)).to(cuda)
        done = torch.zeros(lanes, dtype=torch.bool, device=cuda)
        done[order[:round(share * lanes)]] = True
    out = _at_every_width(mode, n_terms, prob, done)
    first = out[min(out)]
    assert bool(torch.isfinite(first[0]).all())
    for warps, (price, rows) in out.items():
        assert torch.equal(price, first[0]), warps
        assert torch.equal(rows, first[1]), warps
    if done is not None:
        assert bool((first[0][done] == -12345.0).all())


@pytest.mark.parametrize("kernel", list(MASKED))
def test_k2_k3_count_each_launch_once_at_every_width(cuda, kernel):
    """Each bound launch adds one to its ``LAUNCHES`` key at every width,
    and the rule's own pick (no width given) as well."""
    mode, dt, n_terms = MASKED[kernel]
    key = loss_kernel._ENTRIES[mode, dt][2]
    spots, strikes, mats, call, mkt, x = _edge_problem(15, 15, 31, dt, cuda)
    params = transform(x).contiguous()
    price = torch.empty((15, 15), dtype=dt, device=cuda)
    rows = torch.empty((15, 13) if mode == "loss" else (15, 15, 13),
                       dtype=dt, device=cuda)
    bind = (loss_kernel.bind_rows_value_and_grad if mode == "loss"
            else loss_kernel.bind_rows_jacobian)
    launch = bind(params, spots, 0.03, strikes, mats, call, mkt, n_terms,
                  10.0, 0.0, None, price, rows)
    for warps in (*loss_kernel.WARPS[loss_kernel._ENTRIES[mode, dt][0]],
                  None):
        before = dict(loss_kernel.LAUNCHES)
        launch(warps=warps)
        after = dict(loss_kernel.LAUNCHES)
        assert {k: after[k] - before[k] for k in after} == {
            k: int(k == key) for k in after}
    torch.cuda.synchronize()


def test_k2_slots_and_rule_on_card(cuda):
    """The resident lanes at each width fall as the blocks widen; 15 lanes
    take the widest width, and one lane more than every width holds takes
    the narrowest, as does a launch that fills the card."""
    for symbol in ("cos_vg_f32", "cos_vg_f64"):
        table = loss_kernel.slots(symbol, 15, 64, cuda)
        widths = sorted(table)
        assert tuple(widths) == loss_kernel.WARPS[symbol]
        assert all(table[a] > table[b] > 0 for a, b in zip(widths,
                                                           widths[1:]))
        assert loss_kernel.launch_warps(15, table) == widths[-1]
        assert loss_kernel.launch_warps(max(table.values()) + 1,
                                        table) == widths[0]


def _no_dropout_copy(model, device):
    """``model``'s weights in a dropout-free ``SurrogateFFN`` on
    ``device``."""
    from option_pricing_ffn_lbfgs_tpu_torch.surrogate.ffn import SurrogateFFN
    out = SurrogateFFN(dropout=(0.0,) * 4)
    out.load_state_dict(model.state_dict())
    return out.to(device)


def test_init_ffn_and_batchnorm_on_card(cuda, monkeypatch):
    """init_ffn from a CPU generator gives the same weights on the card as
    on the CPU; from a generator on the card, Flax's lecun_normal
    statistics (std within 5 % of sqrt(1/fan_in), |w| <= 2 sigma, zero
    biases). One train-mode forward (Flax's BatchNorm) and its running
    statistics on the card against the CPU, float32 with TF32 off: 1e-5
    of each tensor's largest entry (the matmuls sum in other orders)."""
    from option_pricing_ffn_lbfgs_tpu_torch.surrogate import ffn
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    cpu = ffn.init_ffn(torch.Generator().manual_seed(0))
    moved = ffn.init_ffn(torch.Generator().manual_seed(0), device=cuda)
    assert all(torch.equal(a, b.cpu()) for a, b in zip(
        cpu.state_dict().values(), moved.state_dict().values()))
    on_card = ffn.init_ffn(torch.Generator(cuda).manual_seed(0))
    w = on_card.dense[1].weight.detach()
    target = (1.0 / 512) ** 0.5
    assert w.device.type == "cuda"
    assert abs(float(w.std()) / target - 1.0) < 0.05
    assert float(w.abs().max()) <= 2.0 * target / ffn.TRUNCATED_STD * (1 + 1e-6)
    assert not bool(on_card.dense[1].bias.any())
    x = torch.randn(256, 11, generator=torch.Generator().manual_seed(1))
    m_cpu = _no_dropout_copy(cpu, "cpu").train()
    m_gpu = _no_dropout_copy(cpu, cuda).train()
    out_c, out_g = m_cpu(x), m_gpu(x.to(cuda))
    close = lambda a, b: bool((a.detach().cpu() - b.detach()).abs().max()
                              <= 1e-5 * b.detach().abs().max())
    assert close(out_g, out_c)
    for a, b in zip(m_gpu.state_dict().values(), m_cpu.state_dict().values()):
        if b.is_floating_point():
            assert close(a, b)


def test_fit_one_epoch_card_vs_cpu(cuda, monkeypatch):
    """One epoch of fit with dropout 0 from the same init and scalers on
    the card and on the CPU: the val losses agree to 1e-3 relative
    (float32; 16 Adam steps amplify the matmuls' rounding), and the card's
    run returns its weights on the CPU."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    from option_pricing_ffn_lbfgs_tpu_torch.surrogate import ffn, train
    from option_pricing_ffn_lbfgs_tpu_torch.surrogate.scalers import (
        StandardScaler)
    ds = port.generate_dataset(torch.Generator().manual_seed(2),
                               port.GeneratorConfig(n_samples=4800),
                               dtype=F32, n_terms=64, device="cpu")
    fx, fy = train.dataset_to_xy(ds)
    model = _no_dropout_copy(ffn.init_ffn(torch.Generator().manual_seed(0)),
                             "cpu")
    init = train.TrainedSurrogate(model, StandardScaler.fit(fx),
                                  StandardScaler.fit(fy))
    cfg = train.TrainConfig(max_epochs=1)
    s_c, h_c = train.fit(fx, fy, cfg, init=init, device="cpu")
    s_g, h_g = train.fit(fx, fy, cfg, init=init, device=cuda)
    assert len(h_g["val_loss"]) == 1
    assert abs(h_g["val_loss"][0] / h_c["val_loss"][0] - 1.0) <= 1e-3
    assert abs(h_g["train_loss"][0] / h_c["train_loss"][0] - 1.0) <= 1e-3
    assert next(s_g.model.parameters()).device.type == "cpu"


# Truncation width and dividend yield away from 10 / 0: both together,
# q alone, L alone.
LQ = [(12.0, 0.02), (10.0, 0.02), (12.0, 0.0)]
LQ_IDS = ["L12_q002", "q_alone", "L_alone"]


@pytest.mark.parametrize("L,q", LQ, ids=LQ_IDS)
@pytest.mark.parametrize("kernel", ["K1<float>", "K1<double>", "K2", "K3",
                                    "K2<double>"])
def test_kernels_at_L_and_q(cuda, kernel, L, q):
    """Every kernel against its plain version at the same L and q, with
    the tolerances of its default-L/q checks above. K1<float> is held to
    the plain version at float64 on the same inputs (the float32 bar,
    8e-5): at L = 12 float32 keeps fewer digits of the wider series, and
    the kernel and the plain float32 version, each within the bar of
    float64, can round to opposite sides (8.07e-5 apart in chip_smoke.py
    phase 3)."""
    n_terms = 64
    if kernel.startswith("K1"):
        dt, rtol = (F64, 1e-11) if kernel == "K1<double>" else (F32, 8e-5)
        params, spots, strikes, mats, ic = _problem(17, 5, seed=23)
        args = lambda d: [torch.tensor(a, dtype=d, device=cuda)
                          for a in (params, spots, strikes, mats)]
        call = torch.tensor(ic, device=cuda)
        out = cos_kernel.price_surfaces(*args(dt)[:2], 0.03, *args(dt)[2:],
                                        call, n_terms=n_terms, L=L, q=q)
        ref = cos_kernel.price_surfaces_plain(*args(F64)[:2], 0.03,
                                              *args(F64)[2:], call,
                                              n_terms=n_terms, L=L, q=q)
        torch.cuda.synchronize()
        assert out.dtype == dt
        np.testing.assert_allclose(out.double().cpu().numpy(),
                                   ref.cpu().numpy(), rtol=rtol)
        return
    dt = F64 if kernel == "K2<double>" else F32
    rng = np.random.default_rng(29)
    true = _vec(TRUE) * (1.0 + rng.uniform(-0.3, 0.3, (6, 13)))
    t = lambda a: torch.as_tensor(a, dtype=dt).to(cuda)
    spots, strikes, mats = (t(np.full(6, 100.0)), t(np.tile(STRIKES, (6, 1))),
                            t(np.tile(MATS, (6, 1))))
    call = torch.tensor(np.tile(np.arange(15) % 4 != 0, (6, 1)), device=cuda)
    mkt = cos_kernel.price_surfaces_plain(
        t(np.stack([_vec(TRUE)] * 6)), spots, 0.03, strikes, mats, call,
        n_terms=n_terms)
    args = (t(true), spots, 0.03, strikes, mats, call, mkt, n_terms, L, q)
    if kernel == "K3":
        out = loss_kernel.rows_jacobian(*args)
        ref = loss_kernel.rows_jacobian_plain(*args)
        scale = ref[1].abs().max()
    else:
        out = loss_kernel.rows_value_and_grad(*args)
        ref = loss_kernel.rows_value_and_grad_plain(*args)
        scale = ref[1].abs().amax(-1, keepdim=True)
    torch.cuda.synchronize()
    price_rtol, grad_atol = (1e-11, 1e-9) if dt == F64 else (8e-5, 5e-3)
    np.testing.assert_allclose(out[0].cpu().numpy(), ref[0].cpu().numpy(),
                               rtol=price_rtol)
    np.testing.assert_allclose((out[1] / scale).cpu().numpy(),
                               (ref[1] / scale).cpu().numpy(), atol=grad_atol)


@pytest.mark.parametrize("kind", ["lm_winner_only", "wolfe"])
def test_winner_polishes_card_vs_cpu(cuda, kind):
    """One bench set (tools/bench.py, set 0): calibrate_batch_mixed with
    the polish of the search winner alone launches its kernels (K1<double>
    and K3; K2<double> and K1<double>); then the polish alone from the
    same float32 search winners on the card and on the CPU. The Wolfe
    polish is float64 throughout and holds 1e-6 on the losses and 1e-7 on
    the prices over 8 iterations; at full length, and for the LM (whose
    Jacobian is float32, K3 against its plain version), the outcome: model
    prices within 2e-4 relative."""
    from option_pricing_ffn_lbfgs_tpu_torch.tools import bench
    polish, all_starts, kernels = {
        "lm_winner_only": (calibrator.POLISH_LM, False,
                           ("cos_price_f64", "cos_vg_jac")),
        "wolfe": (calibrator.POLISH_LBFGS, True,
                  ("cos_vg_loss_f64", "cos_price_f64")),
    }[kind]
    (args, truth), = bench.build_problems(1, device=cuda)
    before = {**cos_kernel.LAUNCHES, **loss_kernel.LAUNCHES}
    out = bench.calibrate(args, "mixed", polish=polish,
                          polish_all_starts=all_starts)
    torch.cuda.synchronize()
    after = {**cos_kernel.LAUNCHES, **loss_kernel.LAUNCHES}
    assert all(after[k] > before[k] for k in kernels), (before, after)
    assert bool(torch.isfinite(out.model_prices).all())
    cfg = CalibrationConfig()
    search = dataclasses.replace(
        cfg, pricer=PricerConfig(n_terms=cfg.search_n_terms),
        lbfgs=dataclasses.replace(cfg.lbfgs, maxeval=cfg.search_maxeval))
    data = args[:5]
    x = port.calibrate_batch(data[0], 0.03, *data[1:],
                             torch.Generator().manual_seed(0), search,
                             3).x.to(F64)
    checks = [(polish, 2e-4, None)]
    if kind == "wolfe":
        checks.insert(0, (dataclasses.replace(polish, maxiter=8), 1e-7, 1e-6))
    for p, prtol, ftol in checks:
        res_g, _, model_g = calibrator._polish_winners(
            data[0], 0.03, *data[1:], x, cfg, p)
        cpu = [a.cpu() for a in data]
        res_c, _, model_c = calibrator._polish_winners(
            cpu[0], 0.03, *cpu[1:], x.cpu(), cfg, p)
        np.testing.assert_allclose(model_g.cpu().numpy(), model_c.numpy(),
                                   rtol=prtol)
        if ftol is not None:
            np.testing.assert_allclose(res_g.f.cpu().numpy(),
                                       res_c.f.numpy(), rtol=ftol)


def test_greeks_card_vs_cpu(cuda):
    """Greeks, parameter sensitivities, implied vols and the host pricer on
    the card against the CPU, float64: 1e-10 relative (sensitivities to
    1e-10 of each parameter's largest entry)."""
    from option_pricing_ffn_lbfgs_tpu_torch.ops import black_scholes
    from option_pricing_ffn_lbfgs_tpu_torch.utils.hostpricer import (
        price_truth_subprocess)
    params = port.DHParams.from_dict(DEMO)
    call = np.arange(15) % 4 != 0
    on = {dev: port.greeks(params, 100.0, 0.03, STRIKES, MATS, call,
                           device=dev) for dev in (cuda, "cpu")}
    for name, a, b in zip(on["cpu"]._fields, on[cuda], on["cpu"]):
        assert a.device.type == "cuda", name
        np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), rtol=1e-10,
                                   err_msg=name)
    sens = {dev: port.param_sensitivities(params, 100.0, 0.03, STRIKES, MATS,
                                          call, device=dev)
            for dev in (cuda, "cpu")}
    for name, col in sens["cpu"].items():
        np.testing.assert_allclose(sens[cuda][name].cpu().numpy(),
                                   col.numpy(), rtol=1e-10,
                                   atol=1e-10 * float(col.abs().max()))
    prices = on["cpu"].price.numpy()
    iv = {dev: black_scholes.implied_vol_surface(prices, 100.0, STRIKES,
                                                 MATS, 0.03, call, device=dev)
          for dev in (cuda, "cpu")}
    np.testing.assert_allclose(iv[cuda].cpu().numpy(), iv["cpu"].numpy(),
                               rtol=1e-10)
    true = np.stack([_vec(TRUE), _vec(DEMO)])
    host = {dev: price_truth_subprocess(true, [100.0, 100.0], STRIKES, MATS,
                                        device=dev) for dev in (cuda, "cpu")}
    np.testing.assert_allclose(host[cuda], host["cpu"], rtol=1e-11)


def test_calibrate_sharded_one_rank_nccl_matches_unsharded(cuda, tmp_path):
    """calibrate_sharded on a one-rank NCCL group (tools/dist_check.py in a
    subprocess) equals calibrate_batch in this process, bit for bit, on 64
    Feller-capped surfaces x 3 starts (the float32 search)."""
    from option_pricing_ffn_lbfgs_tpu_torch.tools import dist_check
    save = str(tmp_path / "one.npz")
    (line,) = dist_check.launch(1, "cuda", "smoke64", save=save)
    assert line["backend"] == "nccl" and line["summary"]["n_total"] == 64
    assert line["launches"]["cos_vg_loss"] > 0
    assert line["launches"]["cos_price_f32"] > 0
    prob = dist_check.build_problem("smoke64", cuda)
    spots, strikes, mats, is_call, prices = prob.args
    ref = calibrator.calibrate_batch(
        spots, dist_check.RATE, strikes, mats, is_call, prices,
        torch.Generator().manual_seed(prob.seed), prob.config,
        n_starts=prob.n_starts, dtype=prob.dtype)
    got = np.load(save)
    for f in calibrator.BatchCalibration._fields:
        want = getattr(ref, f).cpu().numpy()
        assert got[f].dtype == want.dtype and np.array_equal(got[f], want), f


# K4/K5, the L-BFGS trip (csrc/lbfgs_trip.cu), against the plain pair on
# the card (tools/trip_check.py): discrete fields equal on every lane,
# continuous fields within 1e-10 (double) / 1e-4 (float) of each field's
# largest entry, done lanes unchanged in bits, the live count exact.
@pytest.mark.parametrize("n_lanes", [1, 15, 1536, 1537])
@pytest.mark.parametrize("dt", [F64, F32], ids=["double", "float"])
def test_lbfgs_trip_matches_plain(cuda, dt, n_lanes):
    from option_pricing_ffn_lbfgs_tpu_torch.tools import trip_check
    rep = trip_check.check_trip(n_lanes, dt, cuda, 7 + n_lanes)
    assert rep["ok"], rep


def _f64_search_lanes(cuda, n_surfaces, seed):
    """bench.py's recipe at float64: (value-and-grad on K2<double>, x0)."""
    from option_pricing_ffn_lbfgs_tpu_torch.ops.loss_kernel import (
        make_batch_value_and_grad)
    rng = np.random.default_rng(seed)
    true = rng.uniform(LO, HI, (n_surfaces, 13))
    data = [torch.full((n_surfaces,), 100.0, dtype=F64, device=cuda),
            torch.tensor(np.tile(STRIKES, (n_surfaces, 1)), device=cuda),
            torch.tensor(np.tile(MATS, (n_surfaces, 1)), device=cuda),
            torch.ones((n_surfaces, 15), dtype=torch.bool, device=cuda)]
    prices = cos_kernel.price_surfaces_plain(
        torch.tensor(true, device=cuda), data[0], 0.03, *data[1:])
    x0 = initial_guesses(3, torch.Generator().manual_seed(seed), data[0],
                         data[1], data[2], prices).reshape(-1, 13)
    rep = lambda a: torch.repeat_interleave(a, 3, dim=0)
    vg = make_batch_value_and_grad(*(rep(a) for a in data), rep(prices),
                                   0.03, CalibrationConfig())
    return vg, x0


def test_lbfgs_engine_f64_kernels_vs_plain(cuda):
    """The whole engine at float64 on K2<double>, maxeval = 30, 64
    surfaces x 3 starts: K4/K5 against the plain pair run on the card,
    equal evaluation and iteration counts on every lane and x to 1e-7 (the
    bar tests/test_torch_optim.py holds the engine to against JAX). The
    objective is called as a plain function, so the trip is unfused."""
    from option_pricing_ffn_lbfgs_tpu_torch.tools import trip_check
    from option_pricing_ffn_lbfgs_tpu_torch.utils.config import LBFGSConfig
    vg, x0 = _f64_search_lanes(cuda, 64, 3)
    rep = trip_check.check_engine(lambda x: vg(x), x0,
                                  LBFGSConfig(maxeval=30))
    assert rep["n_evals_equal"] and rep["n_iters_equal"], rep
    assert rep["x_rel"] <= 1e-7 and rep["n_evals_max"] == 30, rep


@pytest.mark.parametrize("dt", [F64, F32], ids=["double", "float"])
def test_lbfgs_launches_equal_k2(cuda, dt):
    """calibrate_batch on 8 surfaces: every trip launches fused K4, K2 and
    fused K5 once, at the working precision, and no unfused K4/K5."""
    from option_pricing_ffn_lbfgs_tpu_torch.ops import lbfgs_batched
    rng = np.random.default_rng(1)
    true = rng.uniform(LO, HI, (8, 13))
    data = [torch.full((8,), 100.0, dtype=F64),
            torch.tensor(np.tile(STRIKES, (8, 1))),
            torch.tensor(np.tile(MATS, (8, 1))),
            torch.ones((8, 15), dtype=torch.bool)]
    prices = port.price_surfaces(torch.tensor(true), data[0], 0.03, *data[1:])
    counts = (loss_kernel.LAUNCHES, lbfgs_batched.LAUNCHES)
    before = {k: v for c in counts for k, v in c.items()}
    cfg = CalibrationConfig(pricer=PricerConfig(n_terms=64))
    port.calibrate_batch(data[0].to(cuda), 0.03,
                         *(a.to(cuda) for a in data[1:]), prices.to(cuda),
                         torch.Generator().manual_seed(0), cfg, 3, dtype=dt)
    got = {k: v - before[k] for c in counts for k, v in c.items()}
    suffix = "_f64" if dt == F64 else ""
    k2 = got["cos_vg_loss" + suffix]
    assert k2 > 0
    assert (got["lbfgs_open_fused" + suffix]
            == got["lbfgs_update_fused" + suffix] == k2)
    assert got["lbfgs_open" + suffix] == got["lbfgs_update" + suffix] == 0


# The fused trip of the calibration objective (fused K4, K2, fused K5)
# against its fused plain pair on the card, in bits (tools/trip_check.py):
# the main path's widths, then rows a lane that put torch.mean's order
# (fused K5's mean) at each block width from 1 to 64.
FUSED_SHAPES = [(1, 15), (15, 15), (1536, 15), (1537, 17), (1, 1), (2, 40),
                (3, 64), (1, 100), (7, 127), (1536, 33)]


@pytest.mark.parametrize("n_lanes,n_opt", FUSED_SHAPES,
                         ids=[f"L{a}-n{b}" for a, b in FUSED_SHAPES])
@pytest.mark.parametrize("dt", [F64, F32], ids=["double", "float"])
def test_lbfgs_fused_trip_matches_plain(cuda, dt, n_lanes, n_opt):
    from option_pricing_ffn_lbfgs_tpu_torch.tools import trip_check
    rep = trip_check.check_fused_trip(n_lanes, dt, cuda, 11 + n_lanes,
                                      n_opt=n_opt)
    assert rep["ok"], rep


@pytest.mark.parametrize("dt", [F64, F32], ids=["double", "float"])
def test_lbfgs_fused_search_equals_host_assembly(cuda, dt):
    """A search of 64 surfaces x 3 starts to its end (maxeval 160) on the
    fused trip and on the unfused trip around the objective's host
    assembly: the same computation in the same order, so every lane ends
    with the same bits and evaluation count."""
    from option_pricing_ffn_lbfgs_tpu_torch.tools import trip_check
    from option_pricing_ffn_lbfgs_tpu_torch.utils.config import LBFGSConfig
    obj, x0 = trip_check.search_lanes(64, 5, cuda, dtype=dt)
    rep = trip_check.route_sensitivity(obj, x0, LBFGSConfig(maxeval=160))
    assert rep["x_differs"] == rep["n_evals_differ"] == 0, rep


@pytest.mark.parametrize("d", [30, 64])
@pytest.mark.parametrize("dt", [F64, F32], ids=["double", "float"])
def test_lbfgs_trip_wide_lanes_match_plain(cuda, dt, d):
    """K4/K5 at 2 and 4 coordinates a thread, in bits."""
    from option_pricing_ffn_lbfgs_tpu_torch.tools import trip_check
    rep = trip_check.check_trip(1537, dt, cuda, 3 + d, d=d)
    assert rep["ok"], rep
    assert not any(sum(part["bits_differ"].values())
                   for part in (rep["open"], rep["update"])), rep


def test_lbfgs_fused_search_kernels_vs_plain(cuda):
    """A float32 search of 64 surfaces x 3 starts, maxeval = 40, on fused
    K4, K2, fused K5 against the fused plain pair around the same K2: x
    and f in bits, equal counts."""
    from option_pricing_ffn_lbfgs_tpu_torch.tools import trip_check
    from option_pricing_ffn_lbfgs_tpu_torch.utils.config import LBFGSConfig
    obj, x0 = trip_check.search_lanes(64, 3, cuda)
    rep = trip_check.check_engine(obj, x0, LBFGSConfig(maxeval=40))
    assert rep["n_evals_equal"] and rep["n_iters_equal"], rep
    assert rep["x_bits_differ"] == rep["f_bits_differ"] == 0, rep
    assert rep["n_evals_max"] == 40, rep


def test_lbfgs_fused_corrupt_index_raises_on_card(cuda):
    """The fused kernels check the circular indices as the unfused ones:
    the lane is left as it is and the loop's read raises naming it."""
    from option_pricing_ffn_lbfgs_tpu_torch.ops import lbfgs_batched as lb
    from option_pricing_ffn_lbfgs_tpu_torch.tools import trip_check
    cfg = trip_check.TRIP_CONFIG
    st, trial = trip_check.random_fused(16, F64, cuda, 4, cfg)
    st.done[:] = False
    st.head[5] = cfg.history
    before = trip_check.clone_state(st)
    status = torch.zeros(2, dtype=torch.int32, device=cuda)
    x_try = torch.empty_like(st.x)
    kernels = lb.TripKernels(st, cfg, status, x_try, trial)
    kernels.open()
    kernels.update()
    assert torch.equal(x_try[5], before.x[5])
    for name, a, b in zip(lb._BState._fields, before, st):
        assert torch.equal(a[5], b[5]), name
    with pytest.raises(RuntimeError, match="lane 5"):
        lb.read_live(status)


def test_lbfgs_corrupt_index_raises_on_card(cuda):
    """A lane that is not done with head = m sets the error word: K4 and
    K5 leave it as it is, and the loop's read raises naming the lane."""
    from option_pricing_ffn_lbfgs_tpu_torch.ops import lbfgs_batched as lb
    from option_pricing_ffn_lbfgs_tpu_torch.tools import trip_check
    cfg = trip_check.TRIP_CONFIG
    st, f_try, g_try = trip_check.random_state(16, F64, cuda, 4, cfg)
    st.done[:] = False
    st.head[5] = cfg.history
    before = trip_check.clone_state(st)
    status = torch.zeros(2, dtype=torch.int32, device=cuda)
    x_try = lb.lbfgs_open(st, cfg, status)
    lb.lbfgs_update(st, x_try, f_try, g_try, cfg, status)
    assert torch.equal(x_try[5], before.x[5])
    for name, a, b in zip(lb._BState._fields, before, st):
        assert torch.equal(a[5], b[5]), name
    with pytest.raises(RuntimeError, match="lane 5"):
        lb.read_live(status)


def test_lbfgs_engine_raises_on_what_the_kernels_do_not_take(cuda):
    """On the card there is no plain fallback: 65 coordinates (the kernels
    take d <= 64) raise before any trip."""
    from option_pricing_ffn_lbfgs_tpu_torch.ops import lbfgs_batched as lb
    x0 = torch.zeros(3, lb.MAX_DIM + 1, dtype=F64, device=cuda)
    before = dict(lb.LAUNCHES)
    with pytest.raises(ValueError, match="d <= 64"):
        lb.lbfgs_minimize_batched(
            lambda x: ((x * x).sum(-1), 2 * x), x0)
    assert lb.LAUNCHES == before


# K6/K7, the LM trip (csrc/lm_trip.cu), against the plain pair on the card
# (tools/lm_trip_check.py): every state field and x_try equal in bits (any
# NaN equal to any NaN), done lanes unchanged, the live count exact; at
# 1536 lanes every branch is taken.
@pytest.mark.parametrize("n_lanes", [1, 15, 32, 1536, 1537])
@pytest.mark.parametrize("dt", [F64, F32], ids=["double", "float"])
def test_lm_trip_matches_plain(cuda, dt, n_lanes):
    from option_pricing_ffn_lbfgs_tpu_torch.tools import lm_trip_check
    rep = lm_trip_check.check_trip(n_lanes, dt, cuda, 9 + n_lanes)
    assert rep["ok"], rep
    if n_lanes == 1536:
        assert all(v > 0 for v in rep["coverage"].values()), rep["coverage"]


def test_lm_engine_kernels_vs_plain(cuda):
    """The polish's LM (K1<double> residuals, the K3 Jacobian) on 512
    surfaces x 3 starts at stage A's maxiter 10: K6/K7 against the plain
    pair run on the card, equal counts on every lane and x in bits."""
    from option_pricing_ffn_lbfgs_tpu_torch.tools import lm_trip_check
    r, j, x0 = lm_trip_check.polish_lanes(512, 5, cuda)
    rep = lm_trip_check.check_engine(
        r, j, x0, dataclasses.replace(calibrator.POLISH_LM, maxiter=10))
    assert rep["n_evals_equal"] and rep["n_iters_equal"], rep
    assert rep["converged_equal"] and rep["x_bits_differ"] == 0, rep
    assert rep["trips"] == 11, rep


@pytest.mark.parametrize("dt", [F64, F32], ids=["double", "float"])
def test_lm_minimize_kernels_vs_plain(cuda, dt):
    """lm_minimize's engine on a linear least-squares batch at either
    precision: K6/K7 against the plain pair, counts equal and x in bits."""
    from option_pricing_ffn_lbfgs_tpu_torch.ops import (
        levenberg_marquardt as lm)
    from option_pricing_ffn_lbfgs_tpu_torch.tools import lm_trip_check
    rng = np.random.default_rng(2)
    A = torch.tensor(rng.normal(size=(64, 17, 13)), dtype=dt, device=cuda)
    b = torch.tensor(rng.normal(size=(64, 17)), dtype=dt, device=cuda)
    x0 = torch.tensor(rng.normal(size=(64, 13)), dtype=dt, device=cuda)
    before = dict(lm.LAUNCHES)
    rep = lm_trip_check.check_engine(
        lambda x: (A * x[:, None, :]).sum(-1) - b, lambda x: A, x0,
        port.LMConfig(maxiter=12))
    assert rep["n_evals_equal"] and rep["x_bits_differ"] == 0, rep
    key = "" if dt == F32 else "_f64"
    assert (lm.LAUNCHES["lm_open" + key] - before["lm_open" + key]
            == lm.LAUNCHES["lm_update" + key] - before["lm_update" + key]
            == rep["trips"])


def test_lm_launches_equal_k3(cuda):
    """calibrate_batch_mixed on 8 surfaces x 3 starts: every LM trip of the
    float64 polish launches fused K6, K1<double>, K3 and fused K7 once,
    the bootstrap trip too, and no unfused K6/K7."""
    from option_pricing_ffn_lbfgs_tpu_torch.ops import levenberg_marquardt
    rng = np.random.default_rng(1)
    true = rng.uniform(LO, HI, (8, 13))
    data = [torch.full((8,), 100.0, dtype=F64),
            torch.tensor(np.tile(STRIKES, (8, 1))),
            torch.tensor(np.tile(MATS, (8, 1))),
            torch.ones((8, 15), dtype=torch.bool)]
    prices = port.price_surfaces(torch.tensor(true), data[0], 0.03, *data[1:])
    counts = (loss_kernel.LAUNCHES, levenberg_marquardt.LAUNCHES,
              cos_kernel.LAUNCHES)
    before = {k: v for c in counts for k, v in c.items()}
    port.calibrate_batch_mixed(data[0].to(cuda), 0.03,
                               *(a.to(cuda) for a in data[1:]),
                               prices.to(cuda),
                               torch.Generator().manual_seed(0))
    got = {k: v - before[k] for c in counts for k, v in c.items()}
    k3 = got["cos_vg_jac"]
    assert k3 > 0
    assert got["lm_open_fused_f64"] == got["lm_update_fused_f64"] == k3
    assert got["cos_price_f64"] == k3
    assert got["lm_open_f64"] == got["lm_update_f64"] == 0
    assert got["lm_open"] == got["lm_update"] == 0


# The fused LM trip of the polish's objective (fused K6, K1<double>, K3,
# fused K7) against its fused plain pair on the card, in bits
# (tools/lm_trip_check.py): fused K6 after and on the bootstrap trip, fused
# K7 on seeded inputs that take every branch of the assembly.
@pytest.mark.parametrize("n_lanes", [15, 32, 1536, 1537])
def test_lm_fused_trip_matches_plain(cuda, n_lanes):
    from option_pricing_ffn_lbfgs_tpu_torch.tools import lm_trip_check
    rep = lm_trip_check.check_trip_fused(n_lanes, cuda, 9 + n_lanes)
    assert rep["ok"], rep
    if n_lanes == 1536:
        assert all(v > 0 for v in rep["coverage"].values()), rep["coverage"]


def test_lm_fused_engine_kernels_vs_plain(cuda):
    """The polish's objective on 512 surfaces x 3 starts at stage A's
    maxiter 10: the fused trip against its fused plain pair run on the
    card, equal counts on every lane and x in bits."""
    from option_pricing_ffn_lbfgs_tpu_torch.tools import lm_trip_check
    obj, x0 = lm_trip_check.polish_objective(512, 5, cuda)
    rep = lm_trip_check.check_engine(
        obj, obj.jac, x0, dataclasses.replace(calibrator.POLISH_LM,
                                              maxiter=10))
    assert rep["n_evals_equal"] and rep["n_iters_equal"], rep
    assert rep["converged_equal"] and rep["x_bits_differ"] == 0, rep
    assert rep["trips"] == 11, rep


def test_lm_fused_polish_equals_host_assembly(cuda):
    """The whole polish (POLISH_LM) on 512 surfaces x 3 starts on the
    fused trip and on the unfused trip around the host assembly: the same
    trips and every lane's x in bits."""
    from option_pricing_ffn_lbfgs_tpu_torch.tools import lm_trip_check
    obj, x0 = lm_trip_check.polish_objective(512, 5, cuda)
    rep = lm_trip_check.route_check(obj, x0, calibrator.POLISH_LM)
    assert rep["n_evals_equal"] and rep["n_iters_equal"], rep
    assert rep["converged_equal"] and rep["x_bits_differ"] == 0, rep
    assert rep["f_rel"] == 0.0, rep


def test_lm_fused_binding_raises_on_card(cuda):
    """On the card there is no plain fallback: a float32 state, or a
    state whose rows are not the objective's, raises at the binding,
    before any launch."""
    from option_pricing_ffn_lbfgs_tpu_torch.ops import (
        levenberg_marquardt as lm)
    from option_pricing_ffn_lbfgs_tpu_torch.tools import lm_trip_check
    obj, x0 = lm_trip_check.polish_objective(2, 5, cuda, n_starts=1)
    status = torch.zeros(1, dtype=torch.int32, device=cuda)
    before = dict(lm.LAUNCHES)
    for st in (lm.init_state(x0.float(), 17, port.LMConfig()),
               lm.init_state(x0, 18, port.LMConfig())):
        with pytest.raises(ValueError):
            obj.bind_trip(st, port.LMConfig(), status, False)
    assert lm.LAUNCHES == before


def test_lm_wide_objective_takes_unfused_kernels_on_card(cuda):
    """An objective with 127 options a lane (n + 2 > MAX_FUSED_ROWS)
    binds no fused trip: on the card its polish runs unfused K6/K7 around
    the host assembly, one of each a trip, and launches no fused K6/K7."""
    from option_pricing_ffn_lbfgs_tpu_torch.ops import (
        levenberg_marquardt as lm)
    n = 127
    t = lambda a: torch.tensor(np.asarray(a), dtype=F64, device=cuda)
    spots, strikes, mats = t([100.0]), t(np.resize(STRIKES, n)[None]), \
        t(np.resize(MATS, n)[None])
    call = torch.ones((1, n), dtype=torch.bool, device=cuda)
    prices = port.price_surfaces(t(_vec(TRUE)[None]), spots, 0.03, strikes,
                                 mats, call)
    obj = calibrator.polish_residual_and_jacobian(
        spots, 0.03, strikes, mats, call, prices, CalibrationConfig())
    assert obj.n_rows > lm.MAX_FUSED_ROWS
    x0 = inverse_transform(t(_vec(TRUE)[None] * 1.05))
    before = dict(lm.LAUNCHES)
    res = lm.lm_minimize_batched(obj, x0, port.LMConfig(maxiter=3),
                                 jac_fn=obj.jac)
    got = {k: v - before[k] for k, v in lm.LAUNCHES.items()}
    assert got["lm_open_fused_f64"] == got["lm_update_fused_f64"] == 0
    assert got["lm_open_f64"] == got["lm_update_f64"] == int(
        res.n_evals.max()) >= 2
    assert bool(torch.isfinite(res.f).all())


def test_lm_engine_raises_on_what_the_kernels_do_not_take(cuda):
    """On the card there is no plain fallback: 33 coordinates (the kernels
    take d <= 32) raise before any launch."""
    from option_pricing_ffn_lbfgs_tpu_torch.ops import (
        levenberg_marquardt as lm)
    x0 = torch.zeros(3, lm.MAX_DIM + 1, dtype=F64, device=cuda)
    before = dict(lm.LAUNCHES)
    with pytest.raises(ValueError, match="d <= 32"):
        lm.lm_minimize_batched(lambda x: x - 1.0, x0)
    assert lm.LAUNCHES == before


def test_dd_pricer_is_an_oracle_for_k1_double(cuda):
    """The double-float pricer (float32 operations only) against K1<double>
    on 20 generator-range surfaces: finite, within 1e-10; on the card
    against the CPU within 1e-11 at worst (their float32 log/atan2/sqrt
    round differently, and the DD pricer's own error is ~4e-12) and within
    1e-14 in the median (most prices agree in bits); the golden demo
    call and the sigma_J = 0.25, tau = 0.1 case within 1e-9."""
    from option_pricing_ffn_lbfgs_tpu_torch.tools import dd_check
    out = dd_check.run(20, timing=False)
    assert out["shape"] == [20, 15] and out["all_finite"]
    assert out["vs_k1_worst"] < 1e-10
    assert out["card_vs_cpu_worst"] < 1e-11
    assert out["card_vs_cpu_median"] < 1e-14
    assert abs(out["golden_call"] - GOLDEN_DEMO_CALL) < 1e-9
    assert abs(out["golden_put"] - GOLDEN_DEMO_PUT) < 1e-9
    assert abs(out["sigma_j_dd"] / out["sigma_j_k1"] - 1) < 1e-9
