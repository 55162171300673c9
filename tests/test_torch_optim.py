"""The port's batched L-BFGS and LM engines against the JAX engines.

Both sides run at float64 on the same lanes and the same objective (the
port's plain value-and-grad / residuals vs JAX autodiff of the XLA
pricer). The discrete path (iteration and evaluation counts, accept and
stop decisions) must be identical. The iterates then agree to rounding,
which the optimizers amplify: XLA's and PyTorch's libm differ in the last
bits of exp/sin/cos/atan2, so gradients and Jacobians differ by ~1e-12
relative, and that difference grows
  * in L-BFGS about tenfold every ten evaluations through the line search
    and the (s, y) history (measured on these lanes: 4e-12 after 10,
    7e-10 after 20, 6e-9 after 30 trips);
  * in LM through the ill-conditioned normal equations of the lane that
    converges towards zero cost (measured: 1e-11 after 2, 4e-10 after 4,
    3e-8 after 8 iterations).
Hence x and cost to 1e-9 relative after 10 L-BFGS trips and 4 LM
iterations, and to 1e-7 after 30 trips and 8 iterations. At the
convergence floor LM's accept/reject of a step whose cost change is at
rounding level can go either way (seen on a linear lane: one side keeps a
last 2.4e-9 step the other rejects), so x also gets an absolute 1e-8 and a
cost near zero an absolute 1e-14.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from option_pricing_ffn_lbfgs_tpu.calibration import initial_guess as jig
from option_pricing_ffn_lbfgs_tpu.calibration.loss import (
    make_loss_fn, make_residual_fn)
from option_pricing_ffn_lbfgs_tpu.ops import lbfgs_batched as jlb
from option_pricing_ffn_lbfgs_tpu.ops import levenberg_marquardt as jlm
from option_pricing_ffn_lbfgs_tpu.utils import config as jcfg
from option_pricing_ffn_lbfgs_tpu_torch.calibration import loss as tloss
from option_pricing_ffn_lbfgs_tpu_torch.ops import lbfgs_batched as tlb
from option_pricing_ffn_lbfgs_tpu_torch.ops import levenberg_marquardt as tlm
from option_pricing_ffn_lbfgs_tpu_torch.ops.loss_kernel import (
    make_batch_value_and_grad)
from option_pricing_ffn_lbfgs_tpu_torch.utils import config as tcfg

torch.set_num_threads(1)
JCFG = jcfg.CalibrationConfig(pricer=jcfg.PricerConfig(n_terms=32))
TCFG = tcfg.CalibrationConfig(pricer=tcfg.PricerConfig(n_terms=32))


@pytest.fixture(scope="module")
def lanes(surface15, noiseless_market):
    """4 lanes: JAX's initial guesses (moved ~2 % off guess type 0's
    Feller-boundary kink) against the TRUE surface, float64 numpy."""
    strikes, mats, is_call = surface15
    x = np.asarray(jig.initial_guesses(4, jax.random.key(7), 100.0, strikes,
                                       mats, jnp.asarray(noiseless_market)))
    x = x + np.random.default_rng(2).normal(scale=0.02, size=x.shape)
    L = x.shape[0]
    return dict(x=x, spots=np.full(L, 100.0), strikes=np.tile(strikes, (L, 1)),
                mats=np.tile(mats, (L, 1)),
                call=np.tile(np.asarray(is_call), (L, 1)),
                mkt=np.tile(noiseless_market, (L, 1)))


def _jax_data(ln):
    return (jnp.asarray(ln["spots"]), jnp.asarray(ln["strikes"]),
            jnp.asarray(ln["mats"]), jnp.asarray(ln["call"]),
            jnp.asarray(ln["mkt"]))


def _port_data(ln):
    t = lambda k: torch.tensor(ln[k])
    return (t("spots"), t("strikes"), t("mats"), torch.tensor(ln["call"]),
            t("mkt"))


@pytest.mark.parametrize("maxeval,rtol", [(10, 1e-9), (30, 1e-7)])
def test_lbfgs_matches_jax(lanes, maxeval, rtol):
    """``maxeval`` evaluations (trips) of the flat state machine."""
    cfg_j = jcfg.LBFGSConfig(maxeval=maxeval)
    cfg_t = tcfg.LBFGSConfig(maxeval=maxeval)
    sp, ks, ms, cs, mk = _jax_data(lanes)

    def one(x, s, k, m, c, p):
        return jax.value_and_grad(make_loss_fn(s, 0.03, k, m, c, p, JCFG))(x)

    vg_j = lambda x: jax.vmap(one)(x, sp, ks, ms, cs, mk)
    res_j = jax.jit(lambda x0: jlb.lbfgs_minimize_batched(vg_j, x0, cfg_j))(
        jnp.asarray(lanes["x"]))
    sp, ks, ms, cs, mk = _port_data(lanes)
    vg_t = make_batch_value_and_grad(sp, ks, ms, cs, mk, 0.03, TCFG)
    res_t = tlb.lbfgs_minimize_batched(vg_t, torch.tensor(lanes["x"]), cfg_t)
    np.testing.assert_array_equal(res_t.n_evals.numpy(),
                                  np.asarray(res_j.n_evals))
    np.testing.assert_array_equal(res_t.n_iters.numpy(),
                                  np.asarray(res_j.n_iters))
    assert int(res_t.n_iters.min()) >= maxeval // 10
    np.testing.assert_allclose(res_t.x.numpy(), np.asarray(res_j.x),
                               rtol=rtol, atol=1e-10)
    np.testing.assert_allclose(res_t.f.numpy(), np.asarray(res_j.f),
                               rtol=rtol)


@pytest.mark.parametrize("maxiter,rtol", [(4, 1e-9), (8, 1e-7)])
def test_lm_matches_jax(lanes, maxiter, rtol):
    """LM on the calibration residuals, jacfwd Jacobians on both sides."""
    cfg_j = jcfg.LMConfig(maxiter=maxiter)
    cfg_t = tcfg.LMConfig(maxiter=maxiter)
    sp, ks, ms, cs, mk = _jax_data(lanes)

    def one(x, s, k, m, c, p):
        return make_residual_fn(s, 0.03, k, m, c, p, JCFG)(x)

    r_j = lambda x: jax.vmap(one)(x, sp, ks, ms, cs, mk)
    j_j = lambda x: jax.vmap(jax.jacfwd(one))(x, sp, ks, ms, cs, mk)
    res_j = jax.jit(lambda x0: jlm.lm_minimize_batched(
        r_j, x0, cfg_j, jac_fn=j_j))(jnp.asarray(lanes["x"]))
    r_t = tloss.make_residual_fn(*_port_data(lanes)[:1], 0.03,
                                 *_port_data(lanes)[1:], TCFG)
    res_t = tlm.lm_minimize_batched(r_t, torch.tensor(lanes["x"]), cfg_t)
    np.testing.assert_array_equal(res_t.n_iters.numpy(),
                                  np.asarray(res_j.n_iters))
    # the engine's own cost: sum(r^2) over the rows in order
    cost0 = tlm.trial_cost(r_t(torch.tensor(lanes["x"])))
    assert bool((res_t.f <= cost0).all()) and bool((res_t.f < cost0).any())
    np.testing.assert_allclose(res_t.x.numpy(), np.asarray(res_j.x),
                               rtol=rtol, atol=1e-8)
    np.testing.assert_allclose(res_t.f.numpy(), np.asarray(res_j.f),
                               rtol=rtol, atol=1e-14)
    np.testing.assert_allclose(res_t.lam.numpy(), np.asarray(res_j.lam),
                               rtol=1e-12)


def _linear_problem():
    """Three linear least-squares lanes r = J x - b."""
    rng = np.random.default_rng(3)
    return (rng.normal(size=(3, 6, 4)), rng.normal(size=(3, 6)),
            rng.normal(size=(3, 4)))


def test_lm_unfactorable_lane_matches_jax():
    """Lane 1's Jacobian carries a NaN entry, so its damped normal matrix
    is not positive definite and has no Cholesky factor: JAX gets a NaN
    factor and zeroes the non-finite step, the port sees info != 0 and
    takes a zero step. The lane never moves and stops on the stalled-cost
    test; the other lanes are unaffected."""
    J, b, x0 = _linear_problem()
    J_bad = J.copy()
    J_bad[1, 0, 0] = np.nan
    cfg_j, cfg_t = jcfg.LMConfig(maxiter=12), tcfg.LMConfig(maxiter=12)
    Jj, Jbj, bj = jnp.asarray(J), jnp.asarray(J_bad), jnp.asarray(b)
    res_j = jax.jit(lambda x: jlm.lm_minimize_batched(
        lambda v: jnp.einsum("lmd,ld->lm", Jj, v) - bj, x, cfg_j,
        jac_fn=lambda v: Jbj))(jnp.asarray(x0))
    Jt, Jbt, bt = torch.tensor(J), torch.tensor(J_bad), torch.tensor(b)
    res_t = tlm.lm_minimize_batched(
        lambda v: torch.einsum("lmd,ld->lm", Jt, v) - bt, torch.tensor(x0),
        cfg_t, jac_fn=lambda v: Jbt)
    np.testing.assert_array_equal(res_t.x[1].numpy(), x0[1])
    assert bool(res_t.converged[1]) and int(res_t.n_iters[1]) == 2
    cost0 = ((np.einsum("lmd,ld->lm", J, x0) - b) ** 2).sum(-1)
    assert np.all(res_t.f.numpy()[[0, 2]] < cost0[[0, 2]])
    for field in ("n_iters", "n_evals", "converged"):
        np.testing.assert_array_equal(getattr(res_t, field).numpy(),
                                      np.asarray(getattr(res_j, field)))
    np.testing.assert_allclose(res_t.x.numpy(), np.asarray(res_j.x),
                               rtol=1e-7, atol=1e-8)
    np.testing.assert_allclose(res_t.f.numpy(), np.asarray(res_j.f),
                               rtol=1e-7, atol=1e-14)


def test_lm_warm_start_damping():
    """lam0 continues a solve: the bootstrap trip multiplies it by
    lambda_down, as in JAX."""
    J, b, x0 = _linear_problem()
    lam0 = np.array([1e-2, 1.0, 10.0])
    cfg_j, cfg_t = jcfg.LMConfig(maxiter=1), tcfg.LMConfig(maxiter=1)
    Jj, bj = jnp.asarray(J), jnp.asarray(b)
    res_j = jlm.lm_minimize_batched(
        lambda v: jnp.einsum("lmd,ld->lm", Jj, v) - bj, jnp.asarray(x0),
        cfg_j, jac_fn=lambda v: Jj, lam0=jnp.asarray(lam0))
    Jt, bt = torch.tensor(J), torch.tensor(b)
    res_t = tlm.lm_minimize_batched(
        lambda v: torch.einsum("lmd,ld->lm", Jt, v) - bt, torch.tensor(x0),
        cfg_t, jac_fn=lambda v: Jt, lam0=torch.tensor(lam0))
    np.testing.assert_allclose(res_t.lam.numpy(), np.asarray(res_j.lam),
                               rtol=1e-15)
    np.testing.assert_allclose(res_t.x.numpy(), np.asarray(res_j.x),
                               rtol=1e-12)
