"""The port's single-surface calibrator and hybrid against the JAX package's.

Float64 unless stated, N = 64 COS terms, the shipped surrogate on both
sides, truths from JAX's generator (Feller-capped), noiseless prices. On
the CPU the port's K2<double> / K2 / K1 / K3 wrappers run their plain
versions.

Tolerances:
  * ``compute_loss`` / ``transform_params``: 1e-12 relative at JAX's six
    starts (the same float64 arithmetic);
  * ``calibrate_surface``, ``maxiter`` 10 from JAX's starts: x within 1e-7
    relative (tests/test_torch_optim.py: 1e-9 after 10 L-BFGS trips, 1e-7
    after 30; 10 iterations take 10-30 trips). Start 0 is the literature
    guess, whose second factor sits exactly on the Feller boundary
    (sigma2^2 = 2 kappa2 theta2 = 0.04): the penalty's kink, where a
    rounding-level difference picks the side and the paths part. So that
    start is compared on its outcome only (it loses on both sides);
  * ``hybrid_calibrate``: the same FFN start (float32, 1e-5) refined by 10
    iterations; x within 1e-7 relative;
  * ``hybrid_calibrate_batch_mixed``: outcome parity, as in
    tests/test_torch_slice.py. The float32 refines round differently on
    the two sides, so the float64 polishes start from different points
    and stop in the model's flat valley at different places: the
    winners' prices agree within 2e-4 relative, each surface beats its
    FFN-only error on both sides, and both means are below 0.03 %.
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from option_pricing_ffn_lbfgs_tpu.calibration import calibrator as jcal
from option_pricing_ffn_lbfgs_tpu.calibration.initial_guess import (
    initial_guesses)
from option_pricing_ffn_lbfgs_tpu.data.synthetic import generate_dataset
from option_pricing_ffn_lbfgs_tpu.surrogate import hybrid as jhyb
from option_pricing_ffn_lbfgs_tpu.surrogate.train import (
    load_surrogate as jload)
from option_pricing_ffn_lbfgs_tpu.utils import config as jcfg
import option_pricing_ffn_lbfgs_tpu_torch as port
from option_pricing_ffn_lbfgs_tpu_torch.convert import config_from_dict
from option_pricing_ffn_lbfgs_tpu_torch.ops.cos_kernel import price_surfaces
from option_pricing_ffn_lbfgs_tpu_torch.surrogate import hybrid as thyb
from option_pricing_ffn_lbfgs_tpu_torch.surrogate.predict import (
    DEFAULT_MODEL_PATH)
from option_pricing_ffn_lbfgs_tpu_torch.utils import config as tcfg

torch.set_num_threads(1)
JCFG = jcfg.CalibrationConfig(pricer=jcfg.PricerConfig(n_terms=64),
                              lbfgs=jcfg.LBFGSConfig(maxiter=10))
TCFG = config_from_dict(tcfg.CalibrationConfig, dataclasses.asdict(JCFG))


@pytest.fixture(scope="module")
def data():
    """3 surfaces: spots, strikes, maturities, is_call, noiseless prices."""
    ds = generate_dataset(jax.random.key(21),
                          jcfg.GeneratorConfig(n_samples=3), n_terms=128)
    sp, k, m, p = (np.array(a) for a in (ds.spots, ds.strikes,
                                         ds.maturities, ds.model_prices))
    return sp, k, m, np.ones_like(k, bool), p


@pytest.fixture(scope="module")
def surrogates():
    return jload(DEFAULT_MODEL_PATH), port.load_surrogate(DEFAULT_MODEL_PATH)


def _options(k, m, p):
    return [dict(strike=float(a), maturity=float(b), price=float(c),
                 option_type="call") for a, b, c in zip(k, m, p)]


def test_calibrator_class_matches(data):
    sp, k, m, _, p = data
    opts = _options(k[0], m[0], p[0])
    cal_j = jcal.DoubleHestonJumpCalibrator(float(sp[0]), 0.03, opts,
                                            dtype=jnp.float64)
    cal_t = port.DoubleHestonJumpCalibrator(float(sp[0]), 0.03, opts,
                                            dtype=torch.float64,
                                            device="cpu")
    starts = np.array(initial_guesses(6, jax.random.key(2), sp[0], k[0],
                                      m[0], p[0], jnp.float64))
    for x in starts:
        assert cal_t.compute_loss(x) == pytest.approx(cal_j.compute_loss(x),
                                                      rel=1e-12)
    x = starts[4]
    pj, pt = cal_j.transform_params(x), cal_t.transform_params(x)
    assert list(pt) == list(pj) == cal_t.param_names
    np.testing.assert_allclose(list(pt.values()), list(pj.values()),
                               rtol=1e-12)
    np.testing.assert_allclose(cal_t.inverse_transform_params(pj),
                               cal_j.inverse_transform_params(pj),
                               rtol=1e-12)
    np.testing.assert_array_equal(
        np.stack(port.options_to_arrays(opts)[:3]),
        np.stack(jcal.options_to_arrays(opts)[:3]))

    res = cal_t.calibrate(maxiter=5, multi_start=2)
    assert isinstance(res, port.CalibrationResult) and res.success
    assert res.iterations > 0 and np.all(np.isfinite(res.model_prices))
    assert cal_t.calibrate(maxiter=5, multi_start=2).parameters \
        == res.parameters                  # each call restarts the generator


def test_calibrate_surface_matches(data):
    sp, k, m, c, p = data
    key = jax.random.key(2)
    out_j = jax.tree.map(np.asarray, jcal.calibrate_surface(
        sp[0], 0.03, k[0], m[0], c[0], p[0], key, JCFG, 3))
    x0 = np.array(initial_guesses(3, key, sp[0], k[0], m[0], p[0],
                                  jnp.float64))
    out_t = port.calibrate_surface(sp[0], 0.03, k[0], m[0], c[0],
                                   torch.tensor(p[0]), config=TCFG,
                                   n_starts=3, x0=torch.tensor(x0))
    assert out_t.x.dtype == torch.float64 and out_t.x.shape == (13,)
    assert int(out_t.n_evals) == int(out_j.n_evals)
    np.testing.assert_allclose(out_t.x.numpy(), out_j.x, rtol=1e-7)
    np.testing.assert_allclose(out_t.per_start_x.numpy()[1:],
                               out_j.per_start_x[1:], rtol=1e-7)
    np.testing.assert_allclose(float(out_t.loss), out_j.loss, rtol=1e-7)
    losses_t = out_t.per_start_loss.numpy()
    assert losses_t.argmin() == out_j.per_start_loss.argmin() != 0


def test_hybrid_calibrate_matches(data, surrogates):
    sp, k, m, c, p = data
    s_j, s_t = surrogates
    out_j = jax.tree.map(np.asarray, jhyb.hybrid_calibrate(
        s_j, sp[0], 0.03, k[0], m[0], c[0], p[0], JCFG))
    out_t = thyb.hybrid_calibrate(s_t, sp[0], 0.03, k[0], m[0], c[0],
                                  torch.tensor(p[0]), TCFG)
    assert out_t.x.dtype == torch.float64
    np.testing.assert_allclose(out_t.ffn_params.numpy(), out_j.ffn_params,
                               rtol=1e-5)
    np.testing.assert_allclose(out_t.x.numpy(), out_j.x, rtol=1e-7)
    np.testing.assert_allclose(float(out_t.loss), out_j.loss, rtol=1e-7)
    assert int(out_t.iterations) == int(out_j.iterations)
    assert float(out_t.loss) < float(out_t.ffn_loss)


def test_hybrid_batch_matches(data, surrogates):
    sp, k, m, c, p = data
    s_j, s_t = surrogates
    cfg_j = jcfg.CalibrationConfig(pricer=jcfg.PricerConfig(n_terms=64))
    polish_j = dataclasses.replace(jcal.POLISH_LM, residual_impl="native")
    out_j = jax.tree.map(np.asarray, jhyb.hybrid_calibrate_batch_mixed(
        s_j, sp, 0.03, k, m, c, p, cfg_j, polish=polish_j))
    cfg_t = config_from_dict(tcfg.CalibrationConfig,
                             dataclasses.asdict(cfg_j))
    polish_t = config_from_dict(tcfg.LMConfig, dataclasses.asdict(polish_j))
    out_t = thyb.hybrid_calibrate_batch_mixed(
        s_t, sp, 0.03, k, m, c, p, cfg_t, polish=polish_t, device="cpu")

    model_t = out_t.model_prices.numpy()
    np.testing.assert_allclose(model_t, out_j.model_prices, rtol=2e-4)
    ffn = s_t.predict_params(torch.tensor(p), torch.tensor(sp)).double()
    ffn_model = price_surfaces(ffn, torch.tensor(sp), 0.03, torch.tensor(k),
                               torch.tensor(m), torch.tensor(c)).numpy()
    err = lambda model: np.mean(np.abs(model - p) / p, axis=-1) * 100
    for model in (model_t, out_j.model_prices):
        assert model.shape == (3, 15) and np.all(np.isfinite(model))
        assert np.all(err(model) < err(ffn_model))
        assert err(model).mean() < 0.03
    win = out_t.per_start_loss.numpy().argmin(-1)
    np.testing.assert_array_equal(
        out_t.per_start_x.numpy()[np.arange(3), win], out_t.x.numpy())
    assert out_t.x.dtype == torch.float64
    assert out_t.per_start_x.shape == out_j.per_start_x.shape == (3, 2, 13)
