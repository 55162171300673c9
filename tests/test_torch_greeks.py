"""The port's Greeks and Black–Scholes functions against the JAX package's.

Float64 on the CPU, numpy inputs to both sides:
  * ``greeks`` (``torch.func`` over the plain pricer) on the demo surface
    with calls and puts: every field finite and within 1e-11 relative of
    JAX's, the pricer's parity (tests/test_torch_pricer.py);
  * ``param_sensitivities`` at the defaults and at L = 12, q = 0.02: each
    parameter's column within 1e-11 relative, measured against that
    column's largest entry (an entry two orders below it, e.g. dP/dkappa2
    on a short maturity, is a difference of nearly equal terms and keeps
    only ~1e-10 of its own digits on either side);
  * ``bs_price``, ``bs_vega``, ``implied_vol`` and ``implied_vol_surface``
    on tests/test_black_scholes.py's grids, arbitrage NaNs included, to
    1e-12 (a price also to 1e-14 absolute: a far out-of-the-money call of
    2.5e-3 is the difference of two terms near 20, and keeps ~1e-12 of its
    own digits); ``implied_vol``'s ``max_iter`` masked iterations return JAX's
    ``v`` where JAX's ``while_loop`` stopped early, and iterations past
    convergence leave every element's bits unchanged.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from option_pricing_ffn_lbfgs_tpu.models import greeks as jg
from option_pricing_ffn_lbfgs_tpu.models.double_heston import (
    DHParams as JP, price_options as jprice)
from option_pricing_ffn_lbfgs_tpu.ops import black_scholes as jbs
import option_pricing_ffn_lbfgs_tpu_torch as port
from option_pricing_ffn_lbfgs_tpu_torch.models.double_heston import (
    DHParams as TP)
from option_pricing_ffn_lbfgs_tpu_torch.ops import black_scholes as tbs
from tests.conftest import DEMO

torch.set_num_threads(1)
STRIKES = np.tile([90.0, 95.0, 100.0, 105.0, 110.0], 3)
MATS = np.repeat([0.25, 0.5, 1.0], 5)
CALL = np.arange(15) % 4 != 0
VEC = jnp.asarray([DEMO[k] for k in JP._fields])


def _jax_surface():
    return jnp.asarray(STRIKES), jnp.asarray(MATS), jnp.asarray(CALL)


def test_greeks_match_jax():
    g_j = jax.jit(lambda v: jg.greeks(JP.from_vector(v), 100.0, 0.03,
                                      *_jax_surface()))(VEC)
    g_t = port.greeks(TP.from_dict(DEMO), 100.0, 0.03, torch.tensor(STRIKES),
                      torch.tensor(MATS), torch.tensor(CALL))
    assert g_t._fields == g_j._fields
    for name, a, b in zip(g_t._fields, g_t, g_j):
        a = a.numpy()
        assert a.shape == (15,) and a.dtype == np.float64, name
        assert np.all(np.isfinite(a)), name
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-11,
                                   err_msg=name)


@pytest.mark.parametrize("L,q", [(10.0, 0.0), (12.0, 0.02)],
                         ids=["default", "L12_q002"])
def test_param_sensitivities_match_jax(L, q):
    s_j = jax.jit(lambda v: jg.param_sensitivities(
        JP.from_vector(v), 100.0, 0.03, *_jax_surface(), L=L, q=q))(VEC)
    s_t = port.param_sensitivities(
        TP.from_dict(DEMO), 100.0, 0.03, STRIKES, MATS, CALL, L=L, q=q,
        device="cpu")
    assert list(s_t) == list(JP._fields)
    for name, col in s_t.items():
        ref = np.asarray(s_j[name])
        assert col.shape == (15,) and bool(torch.isfinite(col).all()), name
        np.testing.assert_allclose(col.numpy(), ref, rtol=1e-11,
                                   atol=1e-11 * np.abs(ref).max(),
                                   err_msg=name)


def test_greeks_reverse_mode_finite():
    """Reverse mode through the pricer (theta's path) keeps every
    parameter's gradient finite: the k = 0 and csqrt double wheres."""
    vec = TP.from_dict(DEMO).to_vector().requires_grad_(True)
    price = port.price_options(TP.from_vector(vec), 100.0, 0.03,
                               torch.tensor(STRIKES), torch.tensor(MATS),
                               torch.tensor(CALL))
    grad, = torch.autograd.grad(price.sum(), vec)
    assert bool(torch.isfinite(grad).all())


def _grid():
    k, t, v = np.meshgrid([80.0, 90.0, 100.0, 110.0, 125.0],
                          [0.25, 0.5, 2.0], [0.15, 0.2, 0.8])
    call = np.arange(k.size) % 3 != 0
    return k.ravel(), t.ravel(), v.ravel(), call


def test_bs_price_and_vega_match_jax():
    k, t, v, call = _grid()
    for q in (0.0, 0.02):
        p_j = jbs.bs_price(100.0, k, t, 0.03, v, call, q)
        p_t = tbs.bs_price(100.0, k, t, 0.03, v, call, q, device="cpu")
        assert p_t.dtype == torch.float64
        np.testing.assert_allclose(p_t.numpy(), np.asarray(p_j), rtol=1e-12,
                                   atol=1e-14)
        np.testing.assert_allclose(
            tbs.bs_vega(100.0, k, t, 0.03, v, q, device="cpu").numpy(),
            np.asarray(jbs.bs_vega(100.0, k, t, 0.03, v, q)), rtol=1e-12)
    # degenerate tau / vol: discounted intrinsic, as in JAX
    for args in ((100.0, 90.0, 0.0, 0.05, 0.2), (100.0, 90.0, 1.0, 0.05, 0.0),
                 (100.0, 110.0, 1.0, 0.05, 0.0)):
        for call_ in (True, False):
            assert float(tbs.bs_price(*args, call_, device="cpu")) == \
                pytest.approx(float(jbs.bs_price(*args, call_)), abs=1e-12)


def test_implied_vol_matches_jax():
    k, t, v, call = _grid()
    prices = np.asarray(jbs.bs_price(100.0, k, t, 0.03, v, call))
    # arbitrage violations: below intrinsic, above the spot; no maturity
    bad_p = np.array([5.0, 150.0, 10.0, 0.0])
    bad_k = np.array([90.0, 100.0, 100.0, 100.0])
    bad_t = np.array([0.5, 1.0, 0.0, 1.0])
    p = np.concatenate([prices, bad_p])
    kk, tt = np.concatenate([k, bad_k]), np.concatenate([t, bad_t])
    cc = np.concatenate([call, np.ones(4, bool)])
    iv_j = np.asarray(jbs.implied_vol(p, 100.0, kk, tt, 0.03, cc))
    iv_t = tbs.implied_vol(p, 100.0, kk, tt, 0.03, cc, device="cpu").numpy()
    np.testing.assert_array_equal(np.isnan(iv_t), np.isnan(iv_j))
    assert np.all(np.isnan(iv_t[-4:]))
    np.testing.assert_allclose(iv_t, iv_j, rtol=1e-12, atol=1e-12)


def test_implied_vol_masked_loop_stops_like_jax():
    """JAX's while_loop stops at the iteration where every element is
    done: its result at max_iter = 24 equals the one at 64 bit for bit.
    The port runs all max_iter iterations, masked: its results at 24, 64
    and 200 are the same bits, and equal JAX's to 1e-12."""
    k, t, v, call = _grid()
    prices = np.asarray(jbs.bs_price(100.0, k, t, 0.03, v, call))
    j24, j64 = (np.asarray(jbs.implied_vol(prices, 100.0, k, t, 0.03, call,
                                           max_iter=n)) for n in (24, 64))
    np.testing.assert_array_equal(j24, j64)
    ports = [tbs.implied_vol(prices, 100.0, k, t, 0.03, call, max_iter=n,
                             device="cpu") for n in (24, 64, 200)]
    assert torch.equal(ports[0], ports[1]) and torch.equal(ports[1], ports[2])
    np.testing.assert_allclose(ports[1].numpy(), j64, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(ports[1].numpy(), v, atol=1e-7)


def test_implied_vol_surface_matches_jax():
    """Implied vols of a Double Heston COS surface (calls), as in
    tests/test_black_scholes.py: finite, skewed, JAX's to 1e-12."""
    params = JP.from_vector(VEC)
    prices = np.asarray(jprice(params, 100.0, 0.03, jnp.asarray(STRIKES),
                               jnp.asarray(MATS), jnp.ones(15, bool)))
    iv_j = np.asarray(jbs.implied_vol(prices, 100.0, STRIKES, MATS, 0.03))
    iv_t = tbs.implied_vol_surface(torch.tensor(prices), 100.0,
                                   torch.tensor(STRIKES), torch.tensor(MATS),
                                   0.03).numpy()
    assert np.all(np.isfinite(iv_t)) and np.all((iv_t > 0.05) & (iv_t < 1.5))
    assert all(iv_t[m * 5] > iv_t[m * 5 + 2] for m in range(3))
    np.testing.assert_allclose(iv_t, iv_j, rtol=1e-12)
