"""The port's double-float path against the JAX package's.

``ops/doublefloat.py``, ``ops/complex_dd.py``, ``models/double_heston_dd.py``,
``calibration/transforms.py::transform_to_params_dd`` and
``calibration/loss.py::make_residual_fn_dd`` of the port, on the CPU, held
against the same JAX modules on the same numpy inputs (the cases of
``tests/test_doublefloat.py``; its ``TestLM`` lives in
``tests/test_torch_engines.py``):

  * ``two_sum``, ``_split``, ``two_prod``, ``from_f64``, ``add``, ``mul``
    and ``div`` equal JAX's in bits on 100,000 seeded pairs whose
    magnitudes span 10^-8..10^8, so that no correction term is subnormal
    (XLA:CPU flushes subnormals to zero, PyTorch keeps them: at 10^-15 a
    ``sqr`` parts in one lane of 100,000). JAX runs op by op here: under ``jit``
    XLA:CPU contracts ``a*b + c`` into a fused multiply-add, which changes
    the correction terms of ``mul`` and ``div`` (the port never fuses: each
    step is one ATen kernel);
  * the transcendentals meet the accuracy contracts of JAX's tests and
    agree with JAX to 2^-44 of max(|value|, 1): their float32 seeds (log,
    atan2) may round differently. Where ``exp``'s result leaves the float32
    normal range the allowance is the representation limit 2e-38/exp(x),
    as in JAX's contract (XLA:CPU flushes the subnormal lo word, PyTorch
    keeps it);
  * the complex DD operations agree with JAX's to 2^-44;
  * no DD module calls an ATen op that could fuse a product into a sum;
  * ``price_options_dd`` is within 1e-11 (median 1e-12) of JAX's
    ``price_options_dd`` and within 1e-10 of the port's float64
    ``price_options`` on the 50 draws of ``default_rng(7)``, batched over
    surfaces; the golden demo call and the sigma_J = 0.25, tau = 0.1 case
    are within 1e-9. Two DD pricers agree only to their own accuracy:
    see ``test_price_options_dd_matches_jax``;
  * ``transform_to_params_dd`` matches JAX's on bench set 0 (JAX's own
    starts, ``tools/data/bench_jax_starts.npz``) to 1e-12;
    ``make_residual_fn_dd``'s prices match JAX's to 1e-11 and the float64
    ones to 1e-10, its squared Feller rows both to 1e-12.
"""
import ast
import inspect
import math

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from option_pricing_ffn_lbfgs_tpu.calibration import loss as jloss
from option_pricing_ffn_lbfgs_tpu.calibration import transforms as jtr
from option_pricing_ffn_lbfgs_tpu.models import double_heston as jdh
from option_pricing_ffn_lbfgs_tpu.models import double_heston_dd as jdd
from option_pricing_ffn_lbfgs_tpu.ops import complex_dd as jcz
from option_pricing_ffn_lbfgs_tpu.ops import doublefloat as jdf
from option_pricing_ffn_lbfgs_tpu_torch.calibration import loss as tloss
from option_pricing_ffn_lbfgs_tpu_torch.calibration import transforms as ttr
from option_pricing_ffn_lbfgs_tpu_torch.models import double_heston as tdh
from option_pricing_ffn_lbfgs_tpu_torch.models import double_heston_dd as tdd
from option_pricing_ffn_lbfgs_tpu_torch.ops import complex_dd as tcz
from option_pricing_ffn_lbfgs_tpu_torch.ops import doublefloat as tdf
from option_pricing_ffn_lbfgs_tpu_torch.tools import bench as tbench
from option_pricing_ffn_lbfgs_tpu_torch.tools.error_ablation import (
    load_jax_starts)
from tests.conftest import DEMO

torch.set_num_threads(1)
AGREE = 2.0 ** -44
F64 = torch.float64
# The generator's market ranges (tests/test_doublefloat.py:253-256).
RANGES = [(0.025, 0.080), (1.5, 4.5), (0.025, 0.065), (0.20, 0.50),
          (-0.85, -0.40), (0.020, 0.070), (0.30, 1.20), (0.025, 0.070),
          (0.10, 0.35), (-0.70, -0.20), (0.05, 0.25), (-0.08, -0.01),
          (0.03, 0.12)]


def wide(n, seed):
    """n seeded values, log-uniform in magnitude over 10^-8 .. 10^8, of
    both signs."""
    rng = np.random.default_rng(seed)
    return rng.choice([-1.0, 1.0], n) * 10.0 ** rng.uniform(-8, 8, n)


def bits(x):
    return np.asarray(x).view(np.uint32)


def assert_bits(got, want):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(bits(g.numpy()), bits(w))


def dd_pair(x):
    """The same float64 values as a JAX DD and a port DD."""
    return jdf.from_f64(jnp.asarray(x)), tdf.from_f64(torch.from_numpy(x))


def t64(a):
    return tdf.to_f64(a).numpy()


def j64(a):
    return np.asarray(jdf.to_f64(a))


def assert_agree(got, want, tol=AGREE):
    err = np.abs(got - want) / np.maximum(np.abs(want), 1.0)
    assert err.max() <= tol, err.max()


# ---------------------------------------------------------------------------
# Error-free transformations and ring ops: JAX's bits
# ---------------------------------------------------------------------------

N_PAIRS = 100_000


@pytest.mark.parametrize("name", ["two_sum", "_split", "two_prod"])
def test_eft_bits_match_jax(name):
    a = np.float32(wide(N_PAIRS, 20))
    b = np.float32(wide(N_PAIRS, 21))
    fj, ft = getattr(jdf, name), getattr(tdf, name)
    args = (a,) if name == "_split" else (a, b)
    got = ft(*(torch.from_numpy(v) for v in args))
    assert_bits(got, fj(*(jnp.asarray(v) for v in args)))


@pytest.mark.parametrize("name", ["from_f64", "add", "sub", "mul", "div",
                                  "sqr", "mul_f", "add_f"])
def test_dd_ops_bits_match_jax(name):
    x, y = wide(N_PAIRS, 22), wide(N_PAIRS, 23)
    (jx, tx), (jy, ty) = dd_pair(x), dd_pair(y)
    if name == "from_f64":
        got, want = tx, jx
    elif name == "sqr":
        got, want = tdf.sqr(tx), jdf.sqr(jx)
    elif name in ("mul_f", "add_f"):
        got = getattr(tdf, name)(tx, ty[0])
        want = getattr(jdf, name)(jx, jy[0])
    else:
        got, want = getattr(tdf, name)(tx, ty), getattr(jdf, name)(jx, jy)
    assert_bits(got, want)


# ATen calls that may fuse a rounded product into a sum (or compile a
# graph that does): the DD algorithms are exact only without them.
FUSING = {"addcmul", "addcdiv", "lerp", "baddbmm", "addmm", "addmv", "addr",
          "compile", "jit", "script", "trace", "fma"}


@pytest.mark.parametrize("module", [tdf, tcz, tdd])
def test_dd_modules_call_no_fusing_op(module):
    """No call of the DD modules can fuse a product into a sum: none of
    ``FUSING`` by name, and no ``alpha=`` (``add``/``sub`` with a scale)."""
    tree = ast.parse(inspect.getsource(module))
    names = {n.attr for n in ast.walk(tree) if isinstance(n, ast.Attribute)}
    names |= {n.id for n in ast.walk(tree) if isinstance(n, ast.Name)}
    keywords = {k.arg for n in ast.walk(tree) if isinstance(n, ast.Call)
                for k in n.keywords}
    assert not names & FUSING and "alpha" not in keywords


def test_two_sum_and_two_prod_exact():
    rng = np.random.default_rng(0)
    a = np.float32(wide(20000, 0))
    b = np.float32(wide(20000, 1))
    s, e = tdf.two_sum(torch.from_numpy(a), torch.from_numpy(b))
    got = s.numpy().astype(np.float64) + e.numpy().astype(np.float64)
    assert np.array_equal(got, a.astype(np.float64) + b.astype(np.float64))
    a = np.float32(rng.normal(size=20000))
    b = np.float32(rng.normal(size=20000))
    p, e = tdf.two_prod(torch.from_numpy(a), torch.from_numpy(b))
    got = p.numpy().astype(np.float64) + e.numpy().astype(np.float64)
    exact = a.astype(np.float64) * b.astype(np.float64)
    assert np.max(np.abs(got - exact) / np.abs(exact)) < 3e-16


def test_split_halves_are_narrow():
    a = np.float32(np.random.default_rng(2).normal(size=10000))
    hi, lo = (v.numpy() for v in tdf._split(torch.from_numpy(a)))
    assert np.array_equal(hi + lo, a)
    for h in (hi, lo):
        assert np.array_equal(np.asarray(h * h, np.float64),
                              h.astype(np.float64) ** 2)


def test_constant_keeps_two_sum_error_term():
    """JAX pins constants against XLA's ``(c + y) - c -> y`` fold; eager
    PyTorch has no such fold, so ``1 - x`` keeps its lo word."""
    x = torch.tensor(0.0018357, dtype=torch.float32)
    hi, lo = tdf.sub(tdf.dd_const(1.0, like=x), (x, torch.zeros_like(x)))
    assert abs(float(hi) + float(lo) - (1.0 - float(x))) < 1e-12
    assert float(lo) != 0.0


def test_pow2_exact_and_clamped():
    k = torch.arange(-126, 128, dtype=torch.float32)
    assert np.array_equal(tdf._pow2(k).numpy().astype(np.float64),
                          2.0 ** np.arange(-126, 128))
    wild = torch.tensor([-4000.0, -200.0, 300.0, 5000.0])
    assert np.array_equal(tdf._pow2(wild).numpy().astype(np.float64),
                          [2.0 ** -126, 2.0 ** -126, 2.0 ** 127, 2.0 ** 127])


# ---------------------------------------------------------------------------
# Arithmetic accuracy (double-float wordlength ~2^-48)
# ---------------------------------------------------------------------------

def test_mul_sqr_div_add_accuracy():
    rng = np.random.default_rng(3)
    x, y = rng.normal(size=10000), rng.normal(size=10000)
    tx, ty = tdf.from_f64(torch.from_numpy(x)), tdf.from_f64(torch.from_numpy(y))
    for got, want in ((tdf.mul(tx, ty), x * y), (tdf.sqr(tx), x * x),
                      (tdf.div(tx, ty), x / y)):
        assert np.abs(t64(got) / want - 1).max() < 5e-14
    assert np.max(np.abs(t64(tdf.add(tx, ty)) - (x + y))) < 1e-13
    assert np.max(np.abs(t64(tdf.sub(tx, ty)) - (x - y))) < 1e-13


def test_comparisons_and_select():
    rng = np.random.default_rng(8)
    tx = tdf.from_f64(torch.from_numpy(rng.normal(size=1000)))
    ty = tdf.from_f64(torch.from_numpy(rng.normal(size=1000)))
    xr, yr = t64(tx), t64(ty)
    assert np.array_equal(tdf.gt(tx, ty).numpy(), xr > yr)
    assert np.array_equal(tdf.lt(tx, ty).numpy(), xr < yr)
    assert np.array_equal(t64(tdf.max_(tx, ty)), np.maximum(xr, yr))
    assert np.array_equal(t64(tdf.min_(tx, ty)), np.minimum(xr, yr))


# ---------------------------------------------------------------------------
# Transcendentals: JAX's accuracy contracts, and agreement with JAX
# ---------------------------------------------------------------------------

def _unary(name, x):
    jx, tx = dd_pair(x)
    return t64(getattr(tdf, name)(tx)), j64(getattr(jdf, name)(jx))


def test_exp_accuracy_contract():
    x = np.linspace(-86.0, 85.0, 12001)
    got, jax_got = _unary("exp", x)
    rel = np.abs(got / np.exp(x) - 1)
    assert np.all(rel <= np.maximum(1e-12, 2e-38 / np.exp(x)))
    assert rel[np.abs(x) <= 55].max() < 5e-13
    assert np.all(np.abs(got / jax_got - 1)
                  <= np.maximum(AGREE, 2e-38 / np.exp(x)))


def test_exp_domain_cliffs():
    lo = t64(tdf.exp(tdf.from_f64(torch.tensor(
        [-88.0, -200.0, -400.0, -532.0, -1e6], dtype=F64))))
    assert np.array_equal(lo, np.zeros(5))
    hi = t64(tdf.exp(tdf.from_f64(torch.tensor([89.0, 200.0, 1e6],
                                               dtype=F64))))
    assert np.all(np.isposinf(hi))


@pytest.mark.parametrize("lim", [3.0, 400.0, 2e4])
def test_sincos_range(lim):
    y = np.linspace(-lim, lim, 4001)
    jy, ty = dd_pair(y)
    (ts, tc), (js, jc) = tdf.sincos(ty), jdf.sincos(jy)
    bound = max(1e-13, lim * 2.0 ** -46)
    assert np.max(np.abs(t64(ts) - np.sin(y))) < bound
    assert np.max(np.abs(t64(tc) - np.cos(y))) < bound
    assert_agree(t64(ts), j64(js))
    assert_agree(t64(tc), j64(jc))


def test_log_range():
    z = np.concatenate([np.linspace(1e-4, 1.0, 2001),
                        np.linspace(1.0, 1e4, 2001)])
    got, jax_got = _unary("log", z)
    assert np.max(np.abs(got - np.log(z))) < 1e-12
    assert_agree(got, jax_got)


def test_sqrt_accuracy():
    x = np.abs(np.random.default_rng(7).normal(size=5000)) * 10
    got, jax_got = _unary("sqrt", x)
    assert np.abs(got / np.sqrt(x) - 1).max() < 5e-14
    assert_agree(got, jax_got)
    assert float(tdf.to_f64(tdf.sqrt(tdf.from_f64(
        torch.zeros(1, dtype=F64))))[0]) == 0.0


def test_atan2_all_quadrants():
    rng = np.random.default_rng(10)
    b, a = rng.normal(size=4000) * 5, rng.normal(size=4000) * 5
    (jb, tb), (ja, ta) = dd_pair(b), dd_pair(a)
    got = t64(tdf.atan2(tb, ta))
    assert np.max(np.abs(got - np.arctan2(b, a))) < 1e-13
    assert_agree(got, j64(jdf.atan2(jb, ja)))


def test_tanh():
    t = np.linspace(-25, 25, 2001)
    got, jax_got = _unary("tanh", t)
    assert np.max(np.abs(got - np.tanh(t))) < 1e-14
    assert_agree(got, jax_got)


def test_compensated_sum():
    x = np.random.default_rng(11).normal(size=(7, 128)) * 100
    jx, tx = dd_pair(x)
    got = t64(tdf.sum_(tx, axis=-1))
    assert np.max(np.abs(got - x.sum(axis=-1))) < 1e-11
    assert_bits(tdf.sum_(tx, axis=-1), jdf.sum_(jx, axis=-1))
    assert_bits(tdf.sum_(tx), jdf.sum_(jx))


# ---------------------------------------------------------------------------
# Complex DD
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["cmul", "cdiv", "cexp", "clog", "csqrt",
                                  "cabs"])
def test_complex_dd_matches_jax(name):
    rng = np.random.default_rng(12)
    parts = [rng.normal(size=2000) * 3 for _ in range(4)]
    (ja_r, ta_r), (ja_i, ta_i), (jb_r, tb_r), (jb_i, tb_i) = map(dd_pair,
                                                                  parts)
    fj, ft = getattr(jcz, name), getattr(tcz, name)
    if name in ("cmul", "cdiv"):
        got = ft((ta_r, ta_i), (tb_r, tb_i))
        want = fj((ja_r, ja_i), (jb_r, jb_i))
    else:
        got, want = ft((ta_r, ta_i)), fj((ja_r, ja_i))
    if name == "cabs":
        got, want = (got,), (want,)
    for g, w in zip(got, want):
        assert_agree(t64(g), j64(w))


# ---------------------------------------------------------------------------
# The DD pricer
# ---------------------------------------------------------------------------

def generator_draws(n, seed=7):
    rng = np.random.default_rng(seed)
    return np.stack([rng.uniform(lo, hi, n) for lo, hi in RANGES], axis=-1)


@pytest.fixture(scope="module")
def draws50():
    """The 50 draws of default_rng(7) on the 5 x 3 all-call grid: the
    port's DD prices (batched), JAX's DD prices and the port's float64
    prices."""
    V = generator_draws(50)
    strikes = np.tile([90., 95., 100., 105., 110.], 3)
    mats = np.repeat([0.25, 0.5, 1.0], 5)
    calls = np.ones(15, bool)
    grid = lambda a: torch.from_numpy(np.tile(a, (50, 1)))
    vt = tdh.DHParams.from_vector(torch.from_numpy(V))
    spots = torch.full((50,), 100.0, dtype=F64)
    dd = tdd.price_options_dd(vt, spots, 0.03, grid(strikes), grid(mats),
                              grid(calls)).numpy()
    f64 = tdh.price_options(vt, spots, 0.03, grid(strikes), grid(mats),
                            grid(calls)).numpy()
    jax_dd = np.asarray(jax.jit(jax.vmap(lambda v: jdd.price_options_dd(
        jdh.DHParams.from_vector(v), 100.0, 0.03, jnp.asarray(strikes),
        jnp.asarray(mats), jnp.asarray(calls))))(jnp.asarray(V)))
    return dd, jax_dd, f64


def test_price_options_dd_matches_jax(draws50):
    """Within 1e-11 (median 1e-12) of JAX's jitted DD pricer. Two DD
    evaluations agree only to the DD pricer's own accuracy (JAX: worst
    3.7e-12 against float64): a transcendental's result carries ~1e-15 of
    its float32 seed's rounding (log, atan2, sqrt round differently in XLA
    and ATen), and the CF's exponent multiplies it by up to kappa*theta /
    sigma^2. Measured: worst 4.3e-12, median 2.7e-13; JAX's own jitted
    and op-by-op runs differ by 3.5e-12 (XLA:CPU's FMA contraction)."""
    dd, jax_dd, _ = draws50
    assert dd.shape == (50, 15) and np.isfinite(dd).all()
    rel = np.abs(dd / jax_dd - 1)
    assert rel.max() < 1e-11 and np.median(rel) < 1e-12


def test_price_options_dd_matches_float64(draws50):
    dd, _, f64 = draws50
    assert np.max(np.abs(dd / f64 - 1)) < 1e-10


def test_golden_demo_call_and_put():
    demo = tdh.DHParams.from_dict(DEMO)
    got = tdd.price_options_dd(demo, 100.0, 0.05,
                               torch.tensor([100.0, 100.0], dtype=F64),
                               torch.tensor([1.0, 1.0], dtype=F64),
                               torch.tensor([True, False]))
    assert got.dtype == F64
    assert abs(float(got[0]) - 13.872851144174323) < 1e-9
    # put-call parity against the same call: C - P = S - K exp(-rT)
    assert abs(float(got[0] - got[1]) - (100.0 - 100.0 * math.exp(-0.05))) \
        < 1e-9


def test_sigma_j_large_short_tau():
    """sigma_J = 0.25, tau = 0.1: the jump CF's amplitude exponent reaches
    ~ -28600, below exp's underflow cliff."""
    pv = [0.04, 2.5, 0.04, 0.3, -0.7, 0.04, 0.5, 0.04, 0.2, -0.5, 0.15,
          -0.04, 0.25]
    p = tdh.DHParams.from_vector(torch.tensor(pv, dtype=F64))
    k1, t1 = torch.tensor([100.0], dtype=F64), torch.tensor([0.1], dtype=F64)
    c1 = torch.ones(1, dtype=torch.bool)
    a = float(tdh.price_options(p, 100.0, 0.03, k1, t1, c1)[0])
    b = float(tdd.price_options_dd(p, 100.0, 0.03, k1, t1, c1)[0])
    assert np.isfinite(b) and abs(b / a - 1) < 1e-9


def test_price_options_dd_core_leading_shapes():
    """One surface (scalar fields) and a [2, 3] batch of surfaces agree
    with each other in bits: batching adds no loop and no reordering."""
    V = generator_draws(6, seed=3)
    strikes = torch.from_numpy(np.tile([90., 100., 110.], 2))
    mats = torch.from_numpy(np.repeat([0.5, 1.0], 3))
    calls = torch.tensor([True, False, True, False, True, True])
    batch = tdd.price_options_dd(
        tdh.DHParams.from_vector(torch.from_numpy(V).reshape(2, 3, 13)),
        100.0, 0.03, strikes.expand(2, 3, 6), mats.expand(2, 3, 6),
        calls.expand(2, 3, 6), n_terms=32)
    assert batch.shape == (2, 3, 6)
    one = tdd.price_options_dd(
        tdh.DHParams.from_vector(torch.from_numpy(V[4])), 100.0, 0.03,
        strikes, mats, calls, n_terms=32)
    np.testing.assert_array_equal(batch[1, 1].numpy(), one.numpy())


# ---------------------------------------------------------------------------
# The DD transform and residuals on bench set 0, from JAX's starts
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def bench0():
    fix = load_jax_starts()
    x = fix["x0"][0].reshape(15, 13).astype(np.float64)   # 5 surfaces x 3
    rep = lambda a: np.repeat(a, 3, axis=0)
    strikes = rep(np.tile(tbench.STRIKES, (5, 1)))
    mats = rep(np.tile(tbench.MATS, (5, 1)))
    return x, strikes, mats, rep(fix["prices"][0])


def test_transform_to_params_dd_matches_jax(bench0):
    x = bench0[0]
    got = ttr.transform_to_params_dd(torch.from_numpy(x))
    want = jax.vmap(jtr.transform_to_params_dd)(jnp.asarray(x))
    for g, w in zip(got, want):
        np.testing.assert_allclose(t64(g), j64(w), rtol=1e-12, atol=0)
    np.testing.assert_allclose(
        np.stack([t64(g) for g in got], -1),
        ttr.transform(torch.from_numpy(x)).numpy(), rtol=1e-14)


def _residual_parts(r, n=15):
    """The model prices relative to the market's (``1 + r sqrt(n)``) and
    the squared Feller rows (``weight * max(0, sigma^2 - 2 kappa theta)``,
    linear in the parameters: the row itself is its square root, which
    multiplies a parameter's last bits by ~1e6 near the kink, as start 0,
    the literature guess, sits)."""
    return 1.0 + r[:, :n] * math.sqrt(n), r[:, n:] ** 2


def test_make_residual_fn_dd_matches_jax(bench0):
    x, strikes, mats, prices = bench0
    calls = np.ones_like(strikes, bool)
    spots = np.full(len(x), 100.0)
    data = tuple(map(torch.from_numpy, (spots, strikes, mats, calls, prices)))
    got = tloss.make_residual_fn_dd(data[0], 0.03, *data[1:])(
        torch.from_numpy(x)).numpy()
    want = np.asarray(jax.jit(jax.vmap(
        lambda s, k, m, c, p, v: jloss.make_residual_fn_dd(
            s, 0.03, k, m, c, p)(v)))(*map(jnp.asarray, (
                spots, strikes, mats, calls, prices, x))))
    native = tloss.make_residual_fn(data[0], 0.03, *data[1:])(
        torch.from_numpy(x)).numpy()
    assert got.shape == (15, 17)
    (pg, fg), (pj, fj), (pn, fn) = map(_residual_parts, (got, want, native))
    assert np.max(np.abs(pg / pj - 1)) < 1e-11      # the pricer's spread
    assert np.max(np.abs(fg - fj)) < 1e-12
    assert np.max(np.abs(pg / pn - 1)) < 1e-10
    assert np.max(np.abs(fg - fn)) < 1e-12
