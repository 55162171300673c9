"""The port's COS pricer (plain K1) against the JAX package's XLA pricer.

The JAX oracle is ``price_options`` on the XLA path (``lax.atan2``), under
the suite's float64 CPU configuration. Inputs are made with numpy and
handed to both sides. Tolerances: float64 1e-11 relative (both sides
evaluate the same formulas in the same order; the remaining difference is
libm rounding), float32 8e-5 relative (the JAX Pallas tests' float32 bar),
goldens 1e-9 absolute (the reference's measured prices).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from option_pricing_ffn_lbfgs_tpu.models import double_heston as jdh
from option_pricing_ffn_lbfgs_tpu_torch import convert
from option_pricing_ffn_lbfgs_tpu_torch.models import double_heston as tdh
from option_pricing_ffn_lbfgs_tpu_torch.ops import cos_kernel
from tests.conftest import DEMO, GUESS0
from tests.test_pricer import (GOLDEN_DEMO_CALL, GOLDEN_DEMO_PUT,
                               GOLDEN_README_CALL, GOLDEN_TRUNC)

torch.set_num_threads(1)
F64, F32 = torch.float64, torch.float32


def _t(a, dt=F64):
    return torch.tensor(np.asarray(a), dtype=dt)


def _problem(b, n_strikes=5, seed=0, mixed_types=True):
    """tests/test_pallas.py's recipe: GUESS0-like params +/-10 %."""
    rng = np.random.default_rng(seed)
    base = np.array([0.04, 2.5, 0.04, 0.3, -0.7, 0.04, 0.8, 0.04, 0.2, -0.5,
                     0.15, -0.04, 0.08])
    params = base * (1 + rng.uniform(-0.1, 0.1, (b, 13)))
    spots = 100.0 + rng.uniform(-3, 3, b)
    ks = np.linspace(90, 110, n_strikes)
    strikes = np.tile(np.tile(ks, 3), (b, 1))
    mats = np.tile(np.repeat([0.25, 0.5, 1.0], n_strikes), (b, 1))
    ic = np.ones((b, 3 * n_strikes), bool)
    if mixed_types:
        ic[:, ::3] = False
    return params, spots, strikes, mats, ic


def _jax_prices(params, spots, strikes, mats, ic, dt, n_terms):
    f = jax.jit(jax.vmap(lambda p, s, k, m, c: jdh.price_options(
        jdh.DHParams.from_vector(p), s, 0.03, k, m, c, n_terms=n_terms)))
    return np.asarray(f(*(jnp.asarray(a, dt) for a in
                          (params, spots, strikes, mats)), jnp.asarray(ic)))


def _port_prices(params, spots, strikes, mats, ic, dt, n_terms):
    return cos_kernel.price_surfaces(
        _t(params, dt), _t(spots, dt), 0.03, _t(strikes, dt), _t(mats, dt),
        torch.tensor(ic), n_terms=n_terms).numpy()


def _single(params, strike, tau, rate, is_call):
    p = tdh.DHParams.from_dict(params)
    return float(tdh.price_options(p, 100.0, rate, _t([strike]), _t([tau]),
                                   torch.tensor([is_call]))[0])


class TestGoldens:
    def test_demo_call(self):
        assert abs(_single(DEMO, 100.0, 1.0, 0.05, True)
                   - GOLDEN_DEMO_CALL) < 1e-9

    def test_demo_put(self):
        assert abs(_single(DEMO, 100.0, 1.0, 0.05, False)
                   - GOLDEN_DEMO_PUT) < 1e-9

    def test_readme_call(self):
        assert abs(_single(dict(GUESS0, kappa2=0.8), 105.0, 0.5, 0.03, True)
                   - GOLDEN_README_CALL) < 1e-9

    def test_truncation_range(self):
        a, b = tdh.truncation_range(tdh.DHParams.from_dict(DEMO), _t(1.0),
                                    _t(100.0), 100.0, 0.05)
        assert abs(float(a) - GOLDEN_TRUNC[0]) < 1e-9
        assert abs(float(b) - GOLDEN_TRUNC[1]) < 1e-9

    def test_put_call_parity(self):
        c = _single(DEMO, 100.0, 1.0, 0.05, True)
        p = _single(DEMO, 100.0, 1.0, 0.05, False)
        assert abs(c - p - (100.0 - 100.0 * np.exp(-0.05))) < 1e-8


@pytest.mark.parametrize("b", [1, 5, 17])
@pytest.mark.parametrize("n_terms", [64, 128])
def test_float64_matches_jax(b, n_terms):
    args = _problem(b, seed=b)
    np.testing.assert_allclose(
        _port_prices(*args, F64, n_terms),
        _jax_prices(*args, jnp.float64, n_terms), rtol=1e-11)


@pytest.mark.parametrize("b", [1, 5, 17])
def test_float32_matches_jax(b):
    args = _problem(b, seed=b)
    np.testing.assert_allclose(
        _port_prices(*args, F32, 64), _jax_prices(*args, jnp.float32, 64),
        rtol=8e-5)


@pytest.mark.parametrize("dt,jdt,rtol", [(F64, jnp.float64, 1e-11),
                                         (F32, jnp.float32, 8e-5)])
def test_unaligned_option_count(dt, jdt, rtol):
    """n_opt = 9, mixed call/put."""
    args = _problem(3, n_strikes=3, seed=9)
    out = _port_prices(*args, dt, 128)
    assert out.shape == (3, 9)
    np.testing.assert_allclose(out, _jax_prices(*args, jdt, 128), rtol=rtol)


def test_truncation_range_matches_jax():
    params, spots, strikes, mats, _ = _problem(4, seed=4)
    aj, bj = jax.vmap(lambda p, s, k, m: jdh.truncation_range(
        jdh.DHParams.from_vector(p), m, k, s, 0.03))(
            jnp.asarray(params), jnp.asarray(spots), jnp.asarray(strikes),
            jnp.asarray(mats))
    p = tdh.DHParams(*(_t(params[:, i])[:, None] for i in range(13)))
    at, bt = tdh.truncation_range(p, _t(mats), _t(strikes),
                                  _t(spots)[:, None], 0.03)
    np.testing.assert_allclose(at.numpy(), np.asarray(aj), rtol=1e-13)
    np.testing.assert_allclose(bt.numpy(), np.asarray(bj), rtol=1e-13)


def test_wrapper_uses_plain_version_on_cpu():
    args = _problem(3, seed=3)
    before = dict(cos_kernel.LAUNCHES)
    tensors = [_t(a) for a in args[:4]] + [torch.tensor(args[4])]
    out = cos_kernel.price_surfaces(tensors[0], tensors[1], 0.03,
                                    *tensors[2:], n_terms=64)
    ref = cos_kernel.price_surfaces_plain(tensors[0], tensors[1], 0.03,
                                          *tensors[2:], n_terms=64)
    assert torch.equal(out, ref)
    assert cos_kernel.LAUNCHES == before


@pytest.mark.parametrize("mode", ["reverse", "forward"])
def test_derivatives_finite(mode):
    """The double-where guards keep autograd and forward mode NaN-free
    (the k = 0 term has u = 0, where a naive csqrt/chi/psi is singular)."""
    params, spots, strikes, mats, ic = _problem(2, seed=2)
    p = _t(params)

    def total(v):
        return tdh.price_options(tdh.DHParams.from_vector(v), _t(spots), 0.03,
                                 _t(strikes), _t(mats), torch.tensor(ic),
                                 n_terms=64).sum()

    if mode == "reverse":
        g = torch.func.grad(total)(p)
    else:
        g = torch.func.jacfwd(total)(p)
    assert torch.isfinite(g).all()


def test_wrapper_refuses_other_devices():
    """A tensor off the CPU launches the kernel or raises: never the plain
    version. A meta tensor stands in for a device without the kernel."""
    args = _problem(2, seed=2)
    tensors = [_t(a).to("meta") for a in args[:4]]
    with pytest.raises(ValueError, match="CUDA"):
        cos_kernel.price_surfaces(tensors[0], tensors[1], 0.03, *tensors[2:],
                                  torch.tensor(args[4], device="meta"))


def test_convert_params_from_jax():
    """A JAX DHParams, a dict and a numpy 13-vector cross to the same port
    tensor, and the port prices it as JAX does."""
    jp = jdh.DHParams.from_dict(DEMO, jnp.float64)
    vec = np.array([DEMO[k] for k in tdh.PARAM_NAMES])
    p = convert.to_dhparams(jp)
    for other in (DEMO, vec, vec.tolist()):
        assert torch.equal(convert.to_param_tensor(other), p.to_vector())
    assert {k: float(v) for k, v in p.to_dict().items()} == DEMO
    args = _problem(1, seed=1)
    np.testing.assert_allclose(
        _port_prices(p.to_vector()[None].numpy(), *args[1:], F64, 64),
        _jax_prices(np.asarray(jp.to_vector())[None], *args[1:], jnp.float64,
                    64), rtol=1e-11)
    with pytest.raises(ValueError):
        convert.to_param_tensor(vec[:12])
