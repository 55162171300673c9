"""The port's objective and the plain K2/K3 against JAX autodiff.

Oracles: ``jax.value_and_grad(make_loss_fn)`` and
``jax.jacfwd(make_residual_fn)`` on the XLA path, float64 CPU. The port's
``make_batch_value_and_grad`` / ``make_batch_residual_jacobian`` run the
kernels' plain versions on CPU tensors (autograd / ``torch.func.jacfwd``
of the plain pricing rows plus the host assembly). Tolerances: float64
1e-10 (loss, gradient) and 1e-9 (Jacobian) relative; float32 those of
tests/test_loss_pallas.py (loss 2e-4, gradient and Jacobian 5e-3 after
scaling by the row / global maximum).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from option_pricing_ffn_lbfgs_tpu.calibration import initial_guess as jig
from option_pricing_ffn_lbfgs_tpu.calibration import transforms as jtr
from option_pricing_ffn_lbfgs_tpu.calibration.loss import (
    make_loss_fn, make_residual_fn)
from option_pricing_ffn_lbfgs_tpu.utils.config import (
    CalibrationConfig as JConfig, PricerConfig as JPricer)
from option_pricing_ffn_lbfgs_tpu_torch.calibration import initial_guess as tig
from option_pricing_ffn_lbfgs_tpu_torch.calibration import transforms as ttr
from option_pricing_ffn_lbfgs_tpu_torch.calibration import loss as tloss
from option_pricing_ffn_lbfgs_tpu_torch.ops import loss_kernel
from option_pricing_ffn_lbfgs_tpu_torch.utils.config import (
    CalibrationConfig, PricerConfig)

torch.set_num_threads(1)
JCFG = JConfig(pricer=JPricer(n_terms=64))
TCFG = CalibrationConfig(pricer=PricerConfig(n_terms=64))
DT = {"f64": (torch.float64, jnp.float64), "f32": (torch.float32, jnp.float32)}


@pytest.fixture(scope="module")
def lanes(surface15, noiseless_market):
    """6 lanes: JAX's 3 initial guesses for 2 surfaces priced from TRUE
    (the second at a 2 % higher market), as numpy. The starts are moved
    by ~2 % because guess type 0 sits exactly on factor 2's Feller
    boundary (0.2^2 == 2 * 0.5 * 0.04), where the penalty's kink makes the
    gradient depend on the last bit of exp(log(0.2))."""
    strikes, mats, is_call = surface15
    mkt = np.stack([noiseless_market, noiseless_market * 1.02])
    L = 6
    rep = lambda a: np.repeat(np.asarray(a)[None], 3, 0) if a.ndim == 1 \
        else np.repeat(a, 3, axis=0)
    xs = np.concatenate([np.asarray(jig.initial_guesses(
        3, jax.random.key(i), 100.0, strikes, mats, jnp.asarray(mkt[i])))
        for i in range(2)])
    xs = xs + np.random.default_rng(1).normal(scale=0.02, size=xs.shape)
    return dict(spots=np.full(L, 100.0), strikes=np.tile(strikes, (L, 1)),
                mats=np.tile(mats, (L, 1)),
                call=np.tile(np.asarray(is_call), (L, 1)),
                mkt=np.repeat(mkt, 3, axis=0), x=xs)


def _vg_one(x, s, k, m, c, p, r):
    return jax.value_and_grad(make_loss_fn(s, r, k, m, c, p, JCFG))(x)


def _jac_one(x, s, k, m, c, p, r):
    return jax.jacfwd(make_residual_fn(s, r, k, m, c, p, JCFG))(x)


# jitted once; each dtype compiles once per shape
_JAX_VG = jax.jit(jax.vmap(_vg_one, in_axes=(0,) * 6 + (None,)))
_JAX_JAC = jax.jit(jax.vmap(_jac_one, in_axes=(0,) * 6 + (None,)))


def _jax_args(ln, jdt):
    return (*(jnp.asarray(ln[k], jdt) for k in ("x", "spots", "strikes",
                                                 "mats")),
            jnp.asarray(ln["call"]), jnp.asarray(ln["mkt"], jdt),
            jnp.asarray(0.03, jdt))


def _jax_vg(ln, jdt):
    f, g = _JAX_VG(*_jax_args(ln, jdt))
    return np.asarray(f), np.asarray(g)


def _jax_jac(ln, jdt):
    return np.asarray(_JAX_JAC(*_jax_args(ln, jdt)))


def _port(ln, tdt, make):
    t = lambda k: torch.tensor(ln[k], dtype=tdt)
    fn = make(t("spots"), t("strikes"), t("mats"), torch.tensor(ln["call"]),
              t("mkt"), 0.03, TCFG)
    return fn(t("x"))


@pytest.mark.parametrize("prec", ["f64", "f32"])
def test_value_and_grad_matches_jax(lanes, prec):
    tdt, jdt = DT[prec]
    f_t, g_t = (a.numpy() for a in _port(
        lanes, tdt, loss_kernel.make_batch_value_and_grad))
    f_j, g_j = _jax_vg(lanes, jdt)
    assert f_t.dtype == g_t.dtype == np.dtype(prec.replace("f", "float"))
    if prec == "f64":
        np.testing.assert_allclose(f_t, f_j, rtol=1e-10)
        np.testing.assert_allclose(g_t, g_j, rtol=1e-10, atol=1e-12)
    else:
        np.testing.assert_allclose(f_t, f_j, rtol=2e-4, atol=1e-8)
        scale = np.maximum(np.abs(g_j).max(-1, keepdims=True), 1e-6)
        np.testing.assert_allclose(g_t / scale, g_j / scale, atol=5e-3)


@pytest.mark.parametrize("prec", ["f64", "f32"])
def test_residual_jacobian_matches_jax(lanes, prec):
    tdt, jdt = DT[prec]
    J_t = _port(lanes, tdt, loss_kernel.make_batch_residual_jacobian).numpy()
    J_j = _jax_jac(lanes, jdt)
    assert J_t.shape == J_j.shape == (6, 17, 13)
    scale = np.abs(J_j).max()
    if prec == "f64":
        np.testing.assert_allclose(J_t, J_j, rtol=1e-9, atol=1e-13 * scale)
    else:
        np.testing.assert_allclose(J_t / scale, J_j / scale, atol=5e-3)


def test_feller_rows_active(lanes):
    """A lane that violates Feller exercises the masked-sqrt rows."""
    ln = dict(lanes)
    x = ln["x"].copy()
    x[:, 3] = np.log(0.9)            # sigma1 = 0.9: sigma^2 > 2 kappa theta
    ln["x"] = x
    J_t = _port(ln, torch.float64,
                loss_kernel.make_batch_residual_jacobian).numpy()
    J_j = _jax_jac(ln, jnp.float64)
    assert np.abs(J_j[:, 15]).max() > 0
    np.testing.assert_allclose(J_t, J_j, rtol=1e-9,
                               atol=1e-13 * np.abs(J_j).max())
    f_t, g_t = (a.numpy() for a in _port(
        ln, torch.float64, loss_kernel.make_batch_value_and_grad))
    f_j, g_j = _jax_vg(ln, jnp.float64)
    np.testing.assert_allclose(f_t, f_j, rtol=1e-10)
    np.testing.assert_allclose(g_t, g_j, rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("prec", ["f64", "f32"])
def test_sentinel_lane(lanes, prec):
    """A lane whose prices blow up gets bad_loss with a zero gradient, as
    surface_loss does; the other lanes are untouched."""
    tdt, jdt = DT[prec]
    ln = dict(lanes)
    x = ln["x"].copy()
    x[0] = 40.0                       # exp(40) parameters
    ln["x"] = x
    f_t, g_t = _port(ln, tdt, loss_kernel.make_batch_value_and_grad)
    f_j, _ = _jax_vg(ln, jdt)
    assert float(f_t[0]) == TCFG.bad_loss == float(f_j[0])
    assert torch.equal(g_t[0], torch.zeros(13, dtype=tdt))
    f_ok, _ = _port(lanes, tdt, loss_kernel.make_batch_value_and_grad)
    assert torch.equal(f_t[1:], f_ok[1:])


def test_residuals_square_to_loss(lanes):
    t = lambda k: torch.tensor(lanes[k])
    args = (t("spots"), 0.03, t("strikes"), t("mats"),
            torch.tensor(lanes["call"]), t("mkt"), TCFG)
    r = tloss.make_residual_fn(*args)(t("x"))
    f = tloss.make_loss_fn(*args)(t("x"))
    np.testing.assert_allclose((r * r).sum(-1).numpy(), f.numpy(),
                               rtol=1e-12)


def test_transforms_match_jax():
    x = np.random.default_rng(0).normal(size=(5, 13))
    p = np.asarray(jtr.transform(jnp.asarray(x)))
    np.testing.assert_allclose(ttr.transform(torch.tensor(x)).numpy(), p,
                               rtol=1e-15)
    np.testing.assert_allclose(
        ttr.inverse_transform(torch.tensor(p)).numpy(),
        np.asarray(jtr.inverse_transform(jnp.asarray(p))), rtol=1e-12,
        atol=1e-15)
    diag = np.asarray(jax.vmap(jax.grad(
        lambda v: jnp.sum(jtr.transform(v))))(jnp.asarray(x)))
    np.testing.assert_allclose(ttr.dtransform_dx(torch.tensor(x)).numpy(),
                               diag, rtol=1e-14)


def test_initial_guesses_types_0_and_2_match_jax(surface15, noiseless_market):
    strikes, mats, _ = surface15
    mkt = np.stack([noiseless_market, 0.5 * noiseless_market])
    args = (torch.full((2,), 100.0, dtype=torch.float64),
            torch.tensor(np.tile(strikes, (2, 1))),
            torch.tensor(np.tile(mats, (2, 1))), torch.tensor(mkt))
    p_t = tig.initial_params(4, torch.Generator().manual_seed(0),
                             *args).numpy()
    x_t = tig.initial_guesses(4, torch.Generator().manual_seed(0),
                              *args).numpy()
    for i in range(2):
        x_j = np.asarray(jig.initial_guesses(
            4, jax.random.key(i), 100.0, strikes, mats, jnp.asarray(mkt[i])))
        # Types 0 and 2 as parameters: exactly JAX's vectors (GUESS0, and
        # the type-2 template), with JAX's implied-variance estimate in the
        # four variance slots up to a few ulp (XLA orders the masked sums
        # and divisions differently).
        iv = float(jig.implied_variance_estimate(
            100.0, strikes, mats, jnp.asarray(mkt[i]), jnp.float64))
        slots = jig._IMPLIED_VAR_SLOTS
        fixed = np.setdiff1d(np.arange(13), slots)
        np.testing.assert_array_equal(p_t[i, 0], jig.GUESS0)
        np.testing.assert_array_equal(p_t[i, 2, fixed],
                                      jig.GUESS2_TEMPLATE[fixed])
        np.testing.assert_array_max_ulp(p_t[i, 2, slots],
                                        np.full(4, iv), maxulp=4)
        # Unconstrained: XLA's CPU atanh is not correctly rounded (it is
        # off by ~50 ulp at -0.4), so the inverse transforms agree to
        # 1e-14 relative, not bit for bit.
        np.testing.assert_allclose(x_t[i, [0, 2]], x_j[[0, 2]], rtol=1e-14)
        # type 1 and the extra start: type 0's base +/-20 % (+/-15 % for
        # rho and mu_j), rho clipped to [-0.95, -0.3]
        p0 = np.asarray(jtr.transform(jnp.asarray(x_j[0])))
        for s in (1, 3):
            p = ttr.transform(torch.tensor(x_t[i, s])).numpy()
            free = np.ones(13, bool)
            free[[4, 9]] = False
            assert np.all(np.abs(p[free] / p0[free] - 1) <= 0.2 + 1e-12)
            assert np.all((p[[4, 9]] >= -0.95 - 1e-12)
                          & (p[[4, 9]] <= -0.3 + 1e-12))


def test_wrappers_run_plain_versions_on_cpu(lanes):
    before = dict(loss_kernel.LAUNCHES)
    _port(lanes, torch.float32, loss_kernel.make_batch_value_and_grad)
    _port(lanes, torch.float32, loss_kernel.make_batch_residual_jacobian)
    assert loss_kernel.LAUNCHES == before


@pytest.mark.parametrize("wrapper", ["rows_value_and_grad", "rows_jacobian"])
def test_wrappers_refuse_other_devices(lanes, wrapper):
    """Off the CPU, K2/K3 launch or raise: never the plain version."""
    t = lambda k: torch.tensor(lanes[k], dtype=torch.float32, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        getattr(loss_kernel, wrapper)(
            ttr.transform(t("x")), t("spots"), 0.03, t("strikes"), t("mats"),
            torch.tensor(lanes["call"], device="meta"), t("mkt"), 64)
