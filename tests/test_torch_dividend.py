"""The kernels' plain versions away from L = 10 and q = 0, against JAX's XLA.

Every kernel takes the truncation width ``L`` and the dividend yield ``q``
(K1: ``ops/cos_kernel.py``; K2/K3: ``ops/loss_kernel.py``), and the CPU
runs their plain versions: ``price_surfaces_plain``,
``rows_value_and_grad_plain`` (through ``make_batch_value_and_grad``) and
``rows_jacobian_plain`` (through ``make_batch_residual_jacobian``). The
oracle is the JAX package's XLA path (``price_options``,
``jax.value_and_grad(make_loss_fn)``, ``jax.jacfwd(make_residual_fn)``)
at float64, not its Pallas kernels, which drop ``L`` and ``q``.

Three settings: q = 0.02 and L = 12 together, q alone, L alone. The
tolerances are those of the default-L/q parity tests: prices 1e-11
relative (tests/test_torch_pricer.py), loss and gradient 1e-10, Jacobian
1e-9 (tests/test_torch_loss_kernel.py). Each setting first shows that it
moves the prices by more than the tolerance, so a kernel that ignored it
would fail: q by ~1e-2, L = 12 against 10 by ~1e-7 at N = 64.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from option_pricing_ffn_lbfgs_tpu.calibration.loss import (
    make_loss_fn, make_residual_fn)
from option_pricing_ffn_lbfgs_tpu.models import double_heston as jdh
from option_pricing_ffn_lbfgs_tpu.utils.config import (
    CalibrationConfig as JConfig, PricerConfig as JPricer)
from option_pricing_ffn_lbfgs_tpu_torch.calibration.transforms import (
    inverse_transform as transform_inverse, transform)
from option_pricing_ffn_lbfgs_tpu_torch.ops import cos_kernel, loss_kernel
from option_pricing_ffn_lbfgs_tpu_torch.utils.config import (
    CalibrationConfig, PricerConfig)

torch.set_num_threads(1)
N_TERMS = 64
SETTINGS = [(12.0, 0.02), (10.0, 0.02), (12.0, 0.0)]
IDS = ["L12_q002", "q_alone", "L_alone"]


def _problem(b=5, seed=3):
    """tests/test_pallas.py's recipe: GUESS0-like params +/-10 %, 5 strikes
    x 3 maturities, calls and puts mixed."""
    rng = np.random.default_rng(seed)
    base = np.array([0.04, 2.5, 0.04, 0.3, -0.7, 0.04, 0.8, 0.04, 0.2, -0.5,
                     0.15, -0.04, 0.08])
    params = base * (1 + rng.uniform(-0.1, 0.1, (b, 13)))
    spots = 100.0 + rng.uniform(-3, 3, b)
    strikes = np.tile(np.tile(np.linspace(90, 110, 5), 3), (b, 1))
    mats = np.tile(np.repeat([0.25, 0.5, 1.0], 5), (b, 1))
    call = np.ones((b, 15), bool)
    call[:, ::3] = False
    return params, spots, strikes, mats, call


def _jax_prices(params, spots, strikes, mats, call, L, q):
    f = jax.vmap(lambda p, s, k, m, c: jdh.price_options(
        jdh.DHParams.from_vector(p), s, 0.03, k, m, c, n_terms=N_TERMS, L=L,
        q=q))
    return np.asarray(f(*map(jnp.asarray, (params, spots, strikes, mats,
                                           call))))


def _port_prices(params, spots, strikes, mats, call, L, q):
    t = lambda a: torch.tensor(a, dtype=torch.float64)
    return cos_kernel.price_surfaces_plain(
        t(params), t(spots), 0.03, t(strikes), t(mats), torch.tensor(call),
        n_terms=N_TERMS, L=L, q=q).numpy()


@pytest.mark.parametrize("L,q", SETTINGS, ids=IDS)
def test_price_surfaces_plain_matches_jax(L, q):
    prob = _problem()
    ref = _jax_prices(*prob, L, q)
    moved = np.abs(ref / _jax_prices(*prob, 10.0, 0.0) - 1).max()
    assert moved > 1e-8
    np.testing.assert_allclose(_port_prices(*prob, L, q), ref, rtol=1e-11)


@pytest.fixture(scope="module")
def lanes(noiseless_market):
    """6 lanes: the literature guess (type 0 of initial_guess.py) moved by
    up to +/-20 % (off its Feller kink) on 2 surfaces, the TRUE surface
    and a 2 % higher market; calls and puts mixed."""
    rng = np.random.default_rng(1)
    base = np.array([0.04, 2.5, 0.04, 0.3, -0.7, 0.04, 0.5, 0.04, 0.2, -0.5,
                     0.15, -0.04, 0.08])
    params = base * (1.0 + rng.uniform(-0.2, 0.2, (6, 13)))
    xs = np.asarray(transform_inverse(torch.tensor(params)))
    mkt = np.stack([noiseless_market, noiseless_market * 1.02])
    call = np.arange(15) % 4 != 0
    return dict(spots=np.full(6, 100.0),
                strikes=np.tile(np.tile([90.0, 95.0, 100.0, 105.0, 110.0], 3),
                                (6, 1)),
                mats=np.tile(np.repeat([0.25, 0.5, 1.0], 5), (6, 1)),
                call=np.tile(call, (6, 1)), mkt=np.repeat(mkt, 3, axis=0),
                x=xs)


def _configs(L, q):
    return (JConfig(pricer=JPricer(n_terms=N_TERMS, trunc_L=L,
                                   dividend_yield=q)),
            CalibrationConfig(pricer=PricerConfig(n_terms=N_TERMS, trunc_L=L,
                                                  dividend_yield=q)))


def _jax(ln, make, transform_fn):
    args = [jnp.asarray(ln[k]) for k in ("x", "spots", "strikes", "mats",
                                         "call", "mkt")]
    one = lambda x, s, k, m, c, p: transform_fn(make(s, 0.03, k, m, c, p))(x)
    return jax.vmap(one)(*args)


def _port(ln, make, cfg):
    t = lambda k: torch.tensor(ln[k])
    return make(t("spots"), t("strikes"), t("mats"), t("call"), t("mkt"),
                0.03, cfg)(t("x"))


@pytest.mark.parametrize("L,q", SETTINGS, ids=IDS)
def test_rows_value_and_grad_plain_matches_jax(lanes, L, q):
    """make_batch_value_and_grad runs rows_value_and_grad_plain on CPU
    tensors; held to jax.value_and_grad of make_loss_fn."""
    jcfg, tcfg = _configs(L, q)
    f_j, g_j = _jax(lanes, lambda *a: make_loss_fn(*a, jcfg),
                    jax.value_and_grad)
    f_t, g_t = _port(lanes, loss_kernel.make_batch_value_and_grad, tcfg)
    np.testing.assert_allclose(f_t.numpy(), np.asarray(f_j), rtol=1e-10)
    np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j), rtol=1e-10,
                               atol=1e-12)


@pytest.mark.parametrize("L,q", SETTINGS, ids=IDS)
def test_rows_jacobian_plain_matches_jax(lanes, L, q):
    """make_batch_residual_jacobian runs rows_jacobian_plain on CPU
    tensors; held to jax.jacfwd of make_residual_fn."""
    jcfg, tcfg = _configs(L, q)
    J_j = np.asarray(_jax(lanes, lambda *a: make_residual_fn(*a, jcfg),
                          jax.jacfwd))
    J_t = _port(lanes, loss_kernel.make_batch_residual_jacobian, tcfg).numpy()
    assert J_t.shape == J_j.shape == (6, 17, 13)
    np.testing.assert_allclose(J_t, J_j, rtol=1e-9,
                               atol=1e-13 * np.abs(J_j).max())


@pytest.mark.parametrize("wrapper", ["rows_value_and_grad", "rows_jacobian"])
def test_wrappers_pass_L_and_q_to_plain(lanes, wrapper):
    """On the CPU the wrappers hand L and q on to the plain versions: the
    rows at L = 12, q = 0.02 equal the plain version's and differ from
    the default's."""
    t = lambda k: torch.tensor(lanes[k])
    args = (transform(t("x")), t("spots"), 0.03, t("strikes"), t("mats"),
            t("call"), t("mkt"), N_TERMS)
    got = getattr(loss_kernel, wrapper)(*args, L=12.0, q=0.02)
    plain = getattr(loss_kernel, wrapper + "_plain")(*args, L=12.0, q=0.02)
    default = getattr(loss_kernel, wrapper)(*args)
    for a, b, d in zip(got, plain, default):
        assert torch.equal(a, b) and not torch.equal(a, d)
