"""The port's per-lane engines and exports against the JAX package's.

  * ``lbfgs_minimize_nested`` (the nested strong-Wolfe oracle) walks the
    flat engine's trajectories on tests/test_lbfgs_parity.py's three
    functions (smooth, ill-conditioned, penalty-kinked), five random
    starts each, in float64 and float32: the same ``n_iters``, ``n_evals``
    and ``converged``, and ``x``/``f`` to 1e-12 (float64) or 1e-5
    (float32) relative, that test's tolerances;
  * ``lbfgs_minimize`` (both engines) and ``lm_minimize`` on one lane of
    the calibration objective (float64, N = 32) against the JAX functions,
    at the horizons where tests/test_torch_optim.py holds ``x`` to 1e-9
    (10 flat trips, 4 LM iterations; the nested engine: 7 iterations,
    which take 10 evaluations here). XLA's and PyTorch's libm differ in
    the last bits, and the optimizers amplify that with the horizon (that
    file's docstring);
  * ``lm_minimize``'s lower-precision Jacobian twin and ``lam0``;
  * ``params_to_x`` round trips and matches JAX;
  * both packages' ``__all__``: the port lacks only the three parallel
    names, and its own additions are the names listed here.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import option_pricing_ffn_lbfgs_tpu as jpkg
import option_pricing_ffn_lbfgs_tpu_torch as port
from option_pricing_ffn_lbfgs_tpu.calibration import initial_guess as jig
from option_pricing_ffn_lbfgs_tpu.calibration.loss import (
    make_loss_fn, make_residual_fn)
from option_pricing_ffn_lbfgs_tpu.calibration import transforms as jtr
from option_pricing_ffn_lbfgs_tpu.models.double_heston import DHParams as JP
from option_pricing_ffn_lbfgs_tpu.ops import lbfgs as jlbfgs
from option_pricing_ffn_lbfgs_tpu.ops import levenberg_marquardt as jlm
from option_pricing_ffn_lbfgs_tpu.utils import config as jcfg
from option_pricing_ffn_lbfgs_tpu_torch.calibration import loss as tloss
from option_pricing_ffn_lbfgs_tpu_torch.calibration import transforms as ttr
from option_pricing_ffn_lbfgs_tpu_torch.models.double_heston import (
    DHParams as TP)
from option_pricing_ffn_lbfgs_tpu_torch.ops import levenberg_marquardt as tlm
from option_pricing_ffn_lbfgs_tpu_torch.utils import config as tcfg

torch.set_num_threads(1)
JCFG = jcfg.CalibrationConfig(pricer=jcfg.PricerConfig(n_terms=32))
TCFG = tcfg.CalibrationConfig(pricer=tcfg.PricerConfig(n_terms=32))


def rosenbrock(x):
    return torch.sum(100.0 * (x[1:] - x[:-1] ** 2) ** 2 + (1.0 - x[:-1]) ** 2)


def quadratic(x):
    scales = torch.tensor([1.0, 10.0, 100.0, 1e3, 1e4][: x.shape[0]],
                          dtype=x.dtype)
    return torch.sum(scales * x ** 2)


def kinked(x):
    smooth = torch.sum((x - 0.3) ** 2) + 0.1 * torch.sum(torch.cos(3.0 * x))
    penalty = 1000.0 * torch.sum(torch.clamp(x - 0.5, min=0.0) ** 2)
    return smooth + penalty


FUNS = [rosenbrock, quadratic, kinked]


@pytest.mark.parametrize("fun", FUNS, ids=[f.__name__ for f in FUNS])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
def test_nested_matches_flat_trajectories(fun, dtype):
    cfg = tcfg.LBFGSConfig(maxiter=120)
    rtol = 1e-12 if dtype == torch.float64 else 1e-5
    rng = np.random.default_rng(7)
    for i in range(5):
        x0 = torch.tensor(rng.uniform(-1.5, 1.5, 5), dtype=dtype)
        flat = port.lbfgs_minimize(fun, x0, cfg)
        nested = port.lbfgs_minimize(
            fun, x0, tcfg.LBFGSConfig(maxiter=120, flat=False))
        assert int(flat.n_iters) == int(nested.n_iters), f"start {i}"
        assert int(flat.n_evals) == int(nested.n_evals), f"start {i}"
        assert bool(flat.converged) == bool(nested.converged), f"start {i}"
        assert flat.x.dtype == nested.x.dtype == dtype
        np.testing.assert_allclose(flat.x, nested.x, rtol=rtol, atol=rtol)
        np.testing.assert_allclose(flat.f, nested.f, rtol=rtol, atol=rtol)


@pytest.fixture(scope="module")
def lane(surface15, noiseless_market):
    """One lane: JAX's type-1 start for the TRUE surface, moved ~2 % (as
    in tests/test_torch_optim.py), float64 numpy."""
    strikes, mats, is_call = surface15
    x = np.asarray(jig.initial_guesses(3, jax.random.key(7), 100.0, strikes,
                                       mats, jnp.asarray(noiseless_market)))
    x = x[1] + np.random.default_rng(2).normal(scale=0.02, size=13)
    return dict(x=x, strikes=np.asarray(strikes), mats=np.asarray(mats),
                call=np.asarray(is_call), mkt=noiseless_market)


def _jax_fn(ln, make):
    return make(100.0, 0.03, jnp.asarray(ln["strikes"]),
                jnp.asarray(ln["mats"]), jnp.asarray(ln["call"]),
                jnp.asarray(ln["mkt"]), JCFG)


def _port_fn(ln, make):
    t = lambda k: torch.tensor(ln[k])[None]
    fn = make(torch.tensor([100.0]), 0.03, t("strikes"), t("mats"),
              t("call"), t("mkt"), TCFG)
    return lambda x: fn(x[None])[0]


@pytest.mark.parametrize("flat,cfg", [
    (True, dict(maxeval=10)), (False, dict(maxiter=7))],
    ids=["flat", "nested"])
def test_lbfgs_minimize_matches_jax(lane, flat, cfg):
    res_j = jax.jit(lambda x: jlbfgs.lbfgs_minimize(
        _jax_fn(lane, make_loss_fn), x,
        jcfg.LBFGSConfig(flat=flat, **cfg)))(jnp.asarray(lane["x"]))
    res_t = port.lbfgs_minimize(_port_fn(lane, tloss.make_loss_fn),
                                torch.tensor(lane["x"]),
                                tcfg.LBFGSConfig(flat=flat, **cfg))
    assert int(res_t.n_evals) == int(res_j.n_evals) == 10
    assert int(res_t.n_iters) == int(res_j.n_iters) >= 3
    assert bool(res_t.converged) == bool(res_j.converged)
    np.testing.assert_allclose(res_t.x.numpy(), np.asarray(res_j.x),
                               rtol=1e-9, atol=1e-10)
    np.testing.assert_allclose(float(res_t.f), float(res_j.f), rtol=1e-9)
    assert float(res_t.f) < float(_port_fn(lane, tloss.make_loss_fn)(
        torch.tensor(lane["x"])))


def test_lm_minimize_matches_jax(lane):
    cfg_j, cfg_t = jcfg.LMConfig(maxiter=4), tcfg.LMConfig(maxiter=4)
    res_j = jax.jit(lambda x: jlm.lm_minimize(
        _jax_fn(lane, make_residual_fn), x, cfg_j))(jnp.asarray(lane["x"]))
    res_t = tlm.lm_minimize(_port_fn(lane, tloss.make_residual_fn),
                            torch.tensor(lane["x"]), cfg_t)
    for field in ("n_iters", "n_evals", "converged"):
        assert int(getattr(res_t, field)) == int(getattr(res_j, field))
    assert res_t.x.shape == (13,) and res_t.r.shape == (17,)
    np.testing.assert_allclose(res_t.x.numpy(), np.asarray(res_j.x),
                               rtol=1e-9, atol=1e-8)
    np.testing.assert_allclose(float(res_t.f), float(res_j.f), rtol=1e-9)
    np.testing.assert_allclose(res_t.grad.numpy(), np.asarray(res_j.grad),
                               rtol=1e-6, atol=1e-12)
    np.testing.assert_allclose(float(res_t.lam), float(res_j.lam),
                               rtol=1e-12)


def test_lm_minimize_jacobian_twin_and_lam0(lane):
    """``jac_residual_fn`` is differentiated at ``x`` cast to float32 and
    the Jacobian cast back; ``lam0`` is the first trip's damping. Both
    hold exactly against the batched engine given the same Jacobian, and
    against JAX by outcome: the two float32 Jacobians round differently,
    which moves the steps (not their acceptance on the float64 cost)."""
    res_fn = _port_fn(lane, tloss.make_residual_fn)
    t32 = {k: torch.tensor(lane[k]).to(torch.float32)[None]
           for k in ("strikes", "mats", "mkt")}
    twin_b = tloss.make_residual_fn(torch.tensor([100.0]), 0.03,
                                    t32["strikes"], t32["mats"],
                                    torch.tensor(lane["call"])[None],
                                    t32["mkt"], TCFG)
    twin = lambda x: twin_b(x[None])[0]
    cfg = tcfg.LMConfig(maxiter=6)
    x0 = torch.tensor(lane["x"])
    res = tlm.lm_minimize(res_fn, x0, cfg, jac_residual_fn=twin, lam0=0.5)
    ref = tlm.lm_minimize_batched(
        lambda x: res_fn(x[0])[None], x0[None], cfg,
        jac_fn=lambda x: torch.func.jacfwd(twin)(x[0].float())[None],
        lam0=torch.tensor([0.5], dtype=torch.float64))
    for a, b in zip(res, ref):
        assert torch.equal(a, b[0])
    twin_j = make_residual_fn(
        100.0, 0.03, *(jnp.asarray(lane[k], jnp.float32)
                       for k in ("strikes", "mats")),
        jnp.asarray(lane["call"]), jnp.asarray(lane["mkt"], jnp.float32),
        JCFG)
    res_j = jax.jit(lambda x: jlm.lm_minimize(
        _jax_fn(lane, make_residual_fn), x, jcfg.LMConfig(maxiter=6),
        jac_residual_fn=twin_j, lam0=0.5))(jnp.asarray(lane["x"]))
    assert int(res.n_iters) == int(res_j.n_iters)
    cost0 = float((res_fn(x0) ** 2).sum())
    assert float(res.f) < cost0 and float(res_j.f) < cost0
    np.testing.assert_allclose(float(res.f), float(res_j.f), rtol=1e-3)


def test_params_to_x_round_trip():
    rng = np.random.default_rng(4)
    x = rng.normal(scale=0.5, size=(6, 13))
    x[:, [4, 9]] = np.clip(x[:, [4, 9]], -3.0, 3.0)   # |rho| < 0.999
    p = ttr.transform_to_params(torch.tensor(x))
    back = port.params_to_x(p).numpy()
    np.testing.assert_allclose(back, x, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(
        back, np.asarray(jpkg.params_to_x(JP.from_vector(jnp.asarray(
            p.to_vector().numpy())))), rtol=1e-12, atol=1e-14)
    one = TP(*(torch.tensor(v) for v in p.to_vector()[0].numpy()))
    np.testing.assert_allclose(port.params_to_x(one).numpy(), x[0],
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(jtr.transform(jnp.asarray(back)),
                               p.to_vector().numpy(), rtol=1e-14)


# Names the port exports that the JAX package does not: the kernel wrapper,
# the batched engine, the LM polish's config, the shipped-surrogate
# loaders and the training/checkpoint helpers.
PORT_ONLY = {
    "price_surfaces", "lbfgs_minimize_batched", "LMConfig",
    "load_default_model", "make_predict_fn", "FINETUNE", "TrainConfig",
    "dataset_to_xy", "load_batch_calibration", "load_surrogate_state",
    "save_batch_calibration", "save_surrogate_state"}


def test_all_matches_jax():
    jax_all, port_all = set(jpkg.__all__), set(port.__all__)
    assert jax_all - port_all == set()
    assert {"make_mesh", "distributed_init", "calibrate_sharded"} <= port_all
    assert port_all - jax_all == PORT_ONLY
    assert all(hasattr(port, n) for n in port.__all__)
    assert port.__version__ == jpkg.__version__ == "0.1.0"
    assert port.calibrate_batch_fused is port.calibrate_batch
    assert port.LBFGSResult._fields == jpkg.LBFGSResult._fields
    assert port.Greeks._fields == jpkg.Greeks._fields
