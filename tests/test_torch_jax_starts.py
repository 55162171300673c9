"""JAX's own starts for the bench sets, as a fixture the port can read.

``option_pricing_ffn_lbfgs_tpu_torch/tools/data/bench_jax_starts.npz``
holds, for bench sets 0-5 (``bench.py``'s seeds 2026 + i, 5 surfaces of
15 all-call options each):

  * ``x0``: the ``[6, 5, 3, 13]`` float32 starts that JAX's
    ``calibrate_batch_mixed`` draws for ``bench.py``'s calibration:
    ``initial_guesses(3, key, ...)`` at float32 on each set's truth prices,
    with ``keys = jax.random.split(jax.random.key(i), 5)``, vmapped over
    the surfaces as ``tests/test_torch_slice.py`` does;
  * ``truths``: the ``[6, 5, 13]`` ground-truth parameters;
  * ``prices``: the ``[6, 5, 15]`` float64 truth prices from JAX's host
    pricer's program (``utils/hostpricer.py``'s child, run in-process).

``tools/error_ablation.py --starts jax`` hands ``x0`` to the port, so the
port's ablation runs from the starts of the JAX package's record
(``results/error_ablation.json``). These tests hold the fixture to JAX:
the starts in bits, the truths in bits, and the port's truth prices
(``tools/bench.py::build_problems``) within 1e-12 relative of JAX's.

They also reproduce on the CPU the surfaces where the port's ablation from
these starts lands in another basin than JAX's (errors more than a factor 2
apart, one above 0.005 %), and hold the repair of the one fault that
parted them: the polish's float32 Jacobian dropped a Feller row wherever
``sigma^2 - 2 kappa theta`` rounded to exactly 0 in float32, which near the
Feller boundary is about 1 point in 4, so its LM polish gave up there
(``ops/loss_kernel.py::feller_violation``). From one and the same point
the port's polish then ended worse than JAX's on 20 of the 28 lanes where
the two parted; since the repair on 13 of 27, and the surfaces that still part do so because the search's
float32 rounding picks the basin (``test_parting_surface_basin_follows_
the_search_end``).

Rewrite the fixture (only if JAX's starts change), or run the sweeps
behind PERF.md's CPU columns (all 30 surfaces; about 10 minutes each
configuration on 8 CPU cores), with::

    python -m tests.test_torch_jax_starts --write
    python -m tests.test_torch_jax_starts --pairs [--sets 0,1,2,3,4,5]
        [--configs default,polish_winner_only] [--key-offset K] [--out F]
    python -m tests.test_torch_jax_starts --polish-pairs [--out F]
    python -m tests.test_torch_jax_starts --feller-ties N

``--pairs`` runs each set through JAX's ``calibrate_batch_mixed`` in the
record's configuration (``search_impl="vmap"``) and with its batched
search (the engine the port's follows), and through the port's, from the
same starts: the fixture's, or with ``--key-offset K`` JAX's draws from
``jax.random.key(K + i)``. ``--polish-pairs`` polishes each side's
float32 search ends (the batched engines, N = 64, 160 evaluations) with
both polishes and prints the error of every lane. ``--feller-ties``
prints ``feller_ties``' shares on N points.
"""
import argparse
import dataclasses
import json
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import tests.conftest  # noqa: F401  (CPU backend and x64, also under -m)
from option_pricing_ffn_lbfgs_tpu.calibration import calibrator as jcal
from option_pricing_ffn_lbfgs_tpu.calibration.initial_guess import (
    initial_guesses)
from option_pricing_ffn_lbfgs_tpu.calibration.loss import (
    make_loss_fn, make_residual_fn as jax_residual_fn)
from option_pricing_ffn_lbfgs_tpu.models.double_heston import (
    DHParams, price_options)
from option_pricing_ffn_lbfgs_tpu.ops.lbfgs_batched import (
    lbfgs_minimize_batched)
from option_pricing_ffn_lbfgs_tpu.ops.levenberg_marquardt import (
    lm_minimize_batched as jax_lm)
import option_pricing_ffn_lbfgs_tpu_torch as port
from option_pricing_ffn_lbfgs_tpu.utils import config as jcfg
from option_pricing_ffn_lbfgs_tpu_torch.calibration import calibrator as tcal
from option_pricing_ffn_lbfgs_tpu_torch.calibration.loss import (
    make_residual_fn as port_residual_fn)
from option_pricing_ffn_lbfgs_tpu_torch.calibration.transforms import (
    transform)
from option_pricing_ffn_lbfgs_tpu_torch.ops.loss_kernel import (
    FELLER_IDX, make_batch_residual_jacobian)
from option_pricing_ffn_lbfgs_tpu_torch.ops.levenberg_marquardt import (
    lm_minimize_batched as port_lm)
from option_pricing_ffn_lbfgs_tpu_torch.utils import config as tcfg
from option_pricing_ffn_lbfgs_tpu_torch.tools import bench as tbench
from option_pricing_ffn_lbfgs_tpu_torch.tools.error_ablation import (
    CONFIGS, JAX_RECORD, JAX_STARTS, ablate, load_jax_starts)

N_SETS = 6
F64 = torch.float64


def jax_truth_prices(true):
    """``utils/hostpricer.py``'s child program of the JAX package, run in
    this process (CPU, x64): ``[B, 15]`` all-call prices at N = 128."""
    strikes = jnp.asarray(np.tile(tbench.STRIKES, (true.shape[0], 1)))
    mats = jnp.asarray(np.tile(tbench.MATS, (true.shape[0], 1)))
    spots = jnp.full(true.shape[0], 100.0)
    out = jax.jit(jax.vmap(lambda v, s, k, m: price_options(
        DHParams.from_vector(v), s, 0.03, k, m, jnp.ones(15, bool))))(
        jnp.asarray(true), spots, strikes, mats)
    return np.asarray(out)


def jax_starts(i, prices):
    """Set ``i``'s ``[5, 3, 13]`` float32 starts, as JAX's
    ``calibrate_batch_mixed`` draws them in ``bench.py``."""
    f32 = jnp.float32
    b = prices.shape[0]
    keys = jax.random.split(jax.random.key(i), b)
    x0 = jax.vmap(lambda s, k, m, p, ky: initial_guesses(
        3, ky, s, k, m, p, f32))(
        jnp.full(b, 100.0, f32),
        jnp.asarray(np.tile(tbench.STRIKES, (b, 1)), f32),
        jnp.asarray(np.tile(tbench.MATS, (b, 1)), f32),
        jnp.asarray(prices, f32), keys)
    return np.asarray(x0)


def build_fixture():
    truths = np.stack([tbench.truths(i) for i in range(N_SETS)])
    prices = np.stack([jax_truth_prices(t) for t in truths])
    x0 = np.stack([jax_starts(i, p) for i, p in enumerate(prices)])
    return {"x0": x0, "truths": truths, "prices": prices}


def test_fixture_is_jax_starts_in_bits():
    fix = load_jax_starts()
    want = build_fixture()
    assert fix["x0"].dtype == np.float32 and fix["x0"].shape == (6, 5, 3, 13)
    for key in ("x0", "truths", "prices"):
        np.testing.assert_array_equal(fix[key], want[key], err_msg=key)


def test_port_truths_match_jax():
    """The same starts mean something only on the same problems: the
    port's truths are JAX's in bits and its truth prices (the plain
    K1<double> on the CPU) within 1e-12 relative of JAX's."""
    fix = load_jax_starts()
    sets = tbench.build_problems(N_SETS, device="cpu")
    for i, (args, prices) in enumerate(sets):
        np.testing.assert_array_equal(tbench.truths(i), fix["truths"][i])
        np.testing.assert_allclose(prices, fix["prices"][i], rtol=1e-12,
                                   atol=0)
        # the starts' inputs: the port hands float32 prices to the search
        np.testing.assert_array_equal(np.float32(prices),
                                      np.float32(fix["prices"][i]))


def port_search(surface, maxeval, dtype):
    """The port's search (``calibrate_batch``, the kernels' plain versions)
    on bench surface ``surface`` (set surface // 5) from JAX's 3 starts, at
    N = 64 and ``maxeval`` evaluations a lane: ``([3, 13] x, [3] loss)``."""
    i, j = divmod(surface, 5)
    fix = load_jax_starts()
    cfg = tcfg.CalibrationConfig(pricer=tcfg.PricerConfig(n_terms=64),
                                 lbfgs=tcfg.LBFGSConfig(maxeval=maxeval))
    out = tcal.calibrate_batch(
        np.full(1, 100.0), 0.03, tbench.STRIKES[None], tbench.MATS[None],
        np.ones((1, 15), bool), fix["prices"][i][j:j + 1], config=cfg,
        n_starts=3, x0=torch.as_tensor(fix["x0"][i][j:j + 1], dtype=dtype),
        device="cpu", dtype=dtype)
    return out.per_start_x[0].numpy(), out.per_start_loss[0].numpy()


def search_pair(surface, maxeval, dtype):
    """JAX's batched L-BFGS search on XLA's autodiff gradient and
    ``port_search``, from the same starts: each side's ``(x, loss)``."""
    i, j = divmod(surface, 5)
    fix = load_jax_starts()
    x0, prices = fix["x0"][i][j], fix["prices"][i][j]
    jdt = {torch.float64: jnp.float64, torch.float32: jnp.float32}[dtype]
    cfg_j = jcfg.CalibrationConfig(pricer=jcfg.PricerConfig(n_terms=64),
                                   lbfgs=jcfg.LBFGSConfig(maxeval=maxeval))
    loss_fn = make_loss_fn(
        jnp.asarray(100.0, jdt), jnp.asarray(0.03, jdt),
        jnp.asarray(tbench.STRIKES, jdt), jnp.asarray(tbench.MATS, jdt),
        jnp.ones(15, bool), jnp.asarray(prices, jdt), cfg_j)
    vg = jax.vmap(jax.value_and_grad(loss_fn))
    res = jax.jit(lambda x: lbfgs_minimize_batched(vg, x, cfg_j.lbfgs))(
        jnp.asarray(x0, jdt))
    return ((np.asarray(res.x), np.asarray(res.f)),
            port_search(surface, maxeval, dtype))


def errors_pct(model, prices):
    """Mean relative pricing error in percent over the last axis."""
    return (np.abs(np.asarray(model) - prices) / prices).mean(-1) * 100.0


_SEARCH32 = jcfg.CalibrationConfig(pricer=jcfg.PricerConfig(n_terms=64),
                                   lbfgs=jcfg.LBFGSConfig(maxeval=160))


@jax.jit
def _jax_search32(x0, prices):
    f32 = jnp.float32
    loss_fn = make_loss_fn(
        jnp.asarray(100.0, f32), jnp.asarray(0.03, f32),
        jnp.asarray(tbench.STRIKES, f32), jnp.asarray(tbench.MATS, f32),
        jnp.ones(15, bool), prices, _SEARCH32)
    res = lbfgs_minimize_batched(jax.vmap(jax.value_and_grad(loss_fn)), x0,
                                 _SEARCH32.lbfgs)
    return res.x, res.f


def search_ends(surface, losses=False):
    """The float32 search ends ``[3, 13]`` (float64) of JAX's batched
    search and of the port's on bench surface ``surface`` from JAX's
    starts, as the benchmark runs them (N = 64, 160 evaluations); with
    ``losses``, each side's ``[3]`` final losses too."""
    i, j = divmod(surface, 5)
    fix = load_jax_starts()
    xj, fj = _jax_search32(jnp.asarray(fix["x0"][i][j]),
                           jnp.asarray(fix["prices"][i][j], jnp.float32))
    xt, ft = port_search(surface, 160, torch.float32)
    ends = np.asarray(xj, np.float64), xt.astype(np.float64)
    return ends + (np.asarray(fj), ft) if losses else ends


def polish_pair(surface, x):
    """Both polishes of every row of ``x [3, 13]`` on bench surface
    ``surface`` (``POLISH_LM`` at N = 64): JAX's in the record's
    configuration (``_polish_batch_lm_starts``: per-lane LM, double-float
    residuals, float32 ``jacfwd`` Jacobian) and the port's
    (``_polish_starts_fused``: K1<double> residuals, K3 Jacobian, their
    plain versions here). ``([3], [3])`` errors in percent."""
    i, j = divmod(surface, 5)
    prices = load_jax_starts()["prices"][i][j]
    one = lambda a: a[None]
    _, _, model_j = jcal._polish_batch_lm_starts(
        jnp.full(1, 100.0), jnp.asarray(0.03),
        jnp.asarray(one(tbench.STRIKES)), jnp.asarray(one(tbench.MATS)),
        jnp.ones((1, 15), bool), jnp.asarray(one(prices)),
        jnp.asarray(one(x)),
        jcal._polish_pricer_config(jcfg.CalibrationConfig()), jcal.POLISH_LM)
    t = lambda a: torch.from_numpy(one(np.asarray(a, np.float64)))
    _, _, model_t = tcal._polish_starts_fused(
        torch.full((1,), 100.0, dtype=F64), 0.03, t(tbench.STRIKES),
        t(tbench.MATS), torch.ones((1, 15), dtype=torch.bool), t(prices),
        t(x), tcal._polish_pricer_config(tcfg.CalibrationConfig()),
        tcal.POLISH_LM)
    return (errors_pct(np.asarray(model_j)[0], prices),
            errors_pct(model_t.numpy()[0], prices))


def one_basin(a, b):
    """Errors in one basin: within a factor 2, or both at most 0.005 %."""
    return max(a, b) <= 2 * min(a, b) or max(a, b) <= 0.005


def feller_ties(n, seed=5):
    """On ``n`` points drawn within 1e-7 of both factors' Feller boundary
    (every other parameter a bench truth), the shares of factor rows:
    ``exact`` whose violation of the float32 parameters is positive,
    ``float32_zero`` whose float32 ``s*s - 2*k*t`` is exactly 0, and
    ``port`` / ``jax`` whose row the port's / JAX's float32 Jacobian keeps
    exactly where ``exact`` holds; plus the boolean arrays themselves."""
    rng = np.random.default_rng(seed)
    truths = np.resize(load_jax_starts()["truths"].reshape(-1, 13), (n, 13))
    x = np.log(np.abs(truths))
    x[:, 11] = truths[:, 11]                 # mu_j: the identity
    x[:, (4, 9)] = np.arctanh(truths[:, (4, 9)])
    for s, k, t in FELLER_IDX:
        # sigma^2 = 2 kappa theta (1 + e), |e| < 1e-7
        x[:, s] = 0.5 * (np.log(2.0) + x[:, k] + x[:, t]
                         + rng.uniform(-1e-7, 1e-7, n))
    x32 = torch.from_numpy(x.astype(np.float32))
    p32 = transform(x32).numpy()
    p = p32.astype(np.float64)
    exact = np.stack([p[:, s] * p[:, s] - 2.0 * p[:, k] * p[:, t]
                      for s, k, t in FELLER_IDX], -1) > 0.0
    zero = np.stack([p32[:, s] * p32[:, s] - np.float32(2.0) * p32[:, k]
                     * p32[:, t] == 0 for s, k, t in FELLER_IDX], -1)
    prices = load_jax_starts()["prices"][0][0].astype(np.float32)
    grid = lambda a: torch.from_numpy(np.tile(a, (n, 1)).astype(np.float32))
    jac = make_batch_residual_jacobian(
        torch.full((n,), 100.0), grid(tbench.STRIKES), grid(tbench.MATS),
        torch.ones((n, 15), dtype=torch.bool), grid(prices), 0.03,
        tcfg.CalibrationConfig(pricer=tcfg.PricerConfig(n_terms=16)))
    f32 = jnp.float32
    one = jax_residual_fn(
        jnp.asarray(100.0, f32), jnp.asarray(0.03, f32),
        jnp.asarray(tbench.STRIKES, f32), jnp.asarray(tbench.MATS, f32),
        jnp.ones(15, bool), jnp.asarray(prices),
        jcfg.CalibrationConfig(pricer=jcfg.PricerConfig(n_terms=16)))
    kept = lambda rows: np.abs(rows[:, 15:]).max(-1) > 0.0
    port_kept = kept(jac(x32).numpy())
    jax_kept = kept(np.asarray(jax.jit(jax.vmap(jax.jacfwd(one)))(
        jnp.asarray(x, f32))))
    return {"exact": float(exact.mean()), "float32_zero": float(zero.mean()),
            "port": float((port_kept == exact).mean()),
            "jax": float((jax_kept == exact).mean())}, exact, port_kept


def test_feller_rows_take_the_exact_sign():
    """The polish's float32 Jacobian keeps a Feller row exactly where the
    violation ``sigma^2 - 2 kappa theta`` of its float32 parameters is
    positive, on points within 1e-7 of the Feller boundary. In plain
    float32 arithmetic both products round first and the violation reads
    exactly 0 at about 1 point in 4, where the row dropped out; JAX's
    float32 Jacobian (XLA on the CPU contracts the difference into a fused
    multiply-add) keeps the sign at about 8 in 10."""
    shares, exact, port_kept = feller_ties(512)
    assert 0.3 < shares["exact"] < 0.7 and shares["float32_zero"] > 0.15
    np.testing.assert_array_equal(port_kept, exact)
    assert shares["jax"] > 0.7


@pytest.mark.parametrize("surface,lane", [(0, 2), (6, 1), (8, 1), (22, 1)])
def test_polish_from_the_same_point_is_jax_polish(surface, lane):
    """From the port's float32 search end on this lane, the port's polish
    lands in the basin of JAX's polish. Before the Feller rows took the
    exact sign it gave up on the boundary: 0.05069 % against JAX's
    0.00441 % (0, 2), 0.55451 against 0.04750 (6, 1), 0.43359 against
    0.01684 (8, 1), 0.06265 against 0.00963 (22, 1)."""
    x_port = port_search(surface, 160, torch.float32)[0].astype(np.float64)
    e_j, e_t = polish_pair(surface, x_port)
    assert one_basin(e_j[lane], e_t[lane]), (e_j, e_t)


# Minutes each (JAX compiles its search, and polishes in double-float on
# the CPU): run with ``-m slow``.
@pytest.mark.slow
@pytest.mark.parametrize("surface", [26, 27])
def test_parting_surface_basin_follows_the_search_end(surface):
    """Surfaces where the pipelines still part (26, 27 in the default
    configuration): neither polish is the worse one. From JAX's search
    ends the port's polish finds a basin at least as good as JAX's own
    (best of the 3 starts), and from the port's search ends JAX's polish
    finds one at least as good as the port's; the two searches' ends
    differ by float32 rounding alone (same method at float64,
    ``test_search_is_jax_search_at_float64``)."""
    x_jax, x_port = search_ends(surface)
    e_jj, e_jt = polish_pair(surface, x_jax)
    e_tj, e_tt = polish_pair(surface, x_port)
    assert e_jt.min() <= e_jj.min() and e_tj.min() <= e_tt.min(), (
        e_jj, e_jt, e_tj, e_tt)


@pytest.mark.parametrize("surface", [26, 27])
def test_search_is_jax_search_at_float64(surface):
    """From JAX's starts, on surfaces where the card's ablation lands in
    another basin than JAX's record: at float64 the port's search follows
    JAX's for 40 evaluations, to 1e-9 in x and 1e-8 in the loss, every
    start. The method is JAX's; at float32 the two searches part within 5
    evaluations (PERF.md), as their gradients round differently."""
    (xj, fj), (xt, ft) = search_pair(surface, 40, torch.float64)
    np.testing.assert_allclose(xt, xj, rtol=0, atol=1e-9)
    np.testing.assert_allclose(ft, fj, rtol=1e-8)


@pytest.mark.parametrize("surface", [8, 29])
def test_polish_is_jax_polish_with_float64_jacobians(surface):
    """Bench surfaces where the CPU pair landed in different basins. On 8
    (set 1) the port's LM polish stopped on start 1 (lambda past lambda_max
    after 23 trips) while JAX's float32-Jacobian polish walked on to a loss
    of 4e-8. From the port's float32 search ends (the benchmark's search:
    N = 64, 160 evaluations), with a float64 Jacobian (jacfwd) on both
    sides, the two LM engines run the whole polish (POLISH_LM) alike: x
    within 1e-11, the same trips and flags, and on 8 JAX's stops on start 1
    where the port's does. The method is the same; what parted them was the
    port's float32 Jacobian, which dropped the Feller row at a float32 tie
    (``test_feller_rows_take_the_exact_sign``)."""
    i, j = divmod(surface, 5)
    prices = load_jax_starts()["prices"][i][j]
    x = torch.from_numpy(port_search(surface, 160, torch.float32)[0]).to(F64)
    t3 = lambda a: torch.from_numpy(np.tile(a, (3, 1)))
    res_t = port_lm(port_residual_fn(
        torch.full((3,), 100.0, dtype=F64), 0.03, t3(tbench.STRIKES),
        t3(tbench.MATS), torch.ones((3, 15), dtype=torch.bool),
        t3(prices), tcfg.CalibrationConfig(pricer=tcfg.PricerConfig(
            n_terms=64))), x, tcal.POLISH_LM)
    one = jax_residual_fn(
        jnp.asarray(100.0), jnp.asarray(0.03), jnp.asarray(tbench.STRIKES),
        jnp.asarray(tbench.MATS), jnp.ones(15, bool), jnp.asarray(prices),
        jcfg.CalibrationConfig(pricer=jcfg.PricerConfig(n_terms=64)))
    res_j = jax.jit(lambda v: jax_lm(jax.vmap(one), v, jcal.POLISH_LM))(
        jnp.asarray(x.numpy()))
    np.testing.assert_allclose(res_t.x.numpy(), np.asarray(res_j.x),
                               rtol=0, atol=1e-11)
    np.testing.assert_array_equal(res_t.n_iters.numpy(),
                                  np.asarray(res_j.n_iters))
    np.testing.assert_array_equal(res_t.converged.numpy(),
                                  np.asarray(res_j.converged))
    if surface == 8:
        assert int(res_t.n_iters[1]) < tcal.POLISH_LM.maxiter
        assert float(res_t.f[1]) > 1e-5


def cpu_pair(surface, name, key_offset=0):
    """Bench surface ``surface`` under ablation configuration ``name``, on
    the CPU: JAX's ``calibrate_batch_mixed`` in the configuration of its
    record (``search_impl`` as ``CONFIGS``' JAX twin, by default
    ``"vmap"``), whose keys draw the fixture's starts, and the port's from
    the fixture's ``x0``. ``(JAX error %, port error %)``."""
    fix = load_jax_starts()
    i, j = divmod(surface, 5)
    prices = fix["prices"][i][j:j + 1]
    cfg_t, all_starts = CONFIGS[name]
    out_j = jcal.calibrate_batch_mixed(
        jnp.full(1, 100.0), jnp.asarray(0.03),
        jnp.asarray(tbench.STRIKES[None]),
        jnp.asarray(tbench.MATS[None]), jnp.ones((1, 15), bool),
        jnp.asarray(prices), jax.random.split(jax.random.key(i), 5)[j:j + 1],
        config=jax_config(cfg_t), n_starts=3, polish_all_starts=all_starts)
    out_t = port.calibrate_batch_mixed(
        np.full(1, 100.0), 0.03, tbench.STRIKES[None], tbench.MATS[None],
        np.ones((1, 15), bool), prices, config=cfg_t, n_starts=3,
        x0=torch.from_numpy(fix["x0"][i][j:j + 1]), device="cpu",
        polish_all_starts=all_starts)
    return (float(errors_pct(out_j.model_prices, prices)[0]),
            float(errors_pct(out_t.model_prices.numpy(), prices)[0]))


def jax_config(cfg_t, search_impl="vmap"):
    """The JAX package's ``CalibrationConfig`` with the search and polish
    settings of the port's ``cfg_t``."""
    return dataclasses.replace(
        jcfg.CalibrationConfig(search_impl=search_impl),
        search_maxeval=cfg_t.search_maxeval,
        search_n_terms=cfg_t.search_n_terms,
        polish_n_terms=cfg_t.polish_n_terms)


def test_cpu_pair_agrees_where_the_record_differs():
    """Bench surface 27 (set 5), ``polish_winner_only``: the port on the
    card lands at 0.49 % from JAX's own starts, JAX's record (a TPU run) at
    0.00014 %. On the CPU, JAX's ``calibrate_batch_mixed`` in the record's
    configuration (keys -> the same starts) and the port's from the
    fixture's ``x0`` land in one basin (errors within a factor 2), and both
    more than 100x the record's: the record's basin is its TPU rounding."""
    e_j, e_t = cpu_pair(27, "polish_winner_only")
    with open(JAX_RECORD) as f:
        record = json.load(f)["configs"]["polish_winner_only"][
            "per_surface_error_pct"][27]
    assert max(e_j, e_t) < 2 * min(e_j, e_t)
    assert min(e_j, e_t) > 100 * record


# Minutes each (JAX compiles its whole calibration): run with ``-m slow``.
@pytest.mark.slow
@pytest.mark.parametrize("surface", [6, 8, 16, 29])
def test_cpu_pair_shares_a_basin(surface):
    """The default configuration on surfaces where the card's ablation from
    JAX's starts or the CPU pair parted: JAX in its record's configuration
    and the port land in one basin. Before the Feller rows of the polish's
    Jacobian took the exact sign, the port's polish gave up on the Feller
    boundary on 8 (0.43359 % against JAX's 0.01687 %) and 29 (0.34799
    against 0.06858)."""
    e_j, e_t = cpu_pair(surface, "default")
    assert one_basin(e_j, e_t), (e_j, e_t)


def test_ablate_runs_from_the_given_starts():
    """``tools/error_ablation.py --starts jax`` hands the fixture's starts
    to ``ablate``: set 0 under ``polish_winner_only`` gives the errors of
    ``calibrate_batch_mixed`` from those starts, and not those of the
    default ``torch.Generator`` starts."""
    fix = load_jax_starts()
    sets = tbench.build_problems(1, device="cpu")
    name = "polish_winner_only"
    rows = ablate(sets, {name: CONFIGS[name]}, x0=fix["x0"][:1])
    rows_torch = ablate(sets, {name: CONFIGS[name]})
    (spots, strikes, mats, calls, prices, _), truth = sets[0]
    cfg, all_starts = CONFIGS[name]
    out = port.calibrate_batch_mixed(
        spots, tbench.RATE, strikes, mats, calls, prices, config=cfg,
        n_starts=3, x0=torch.from_numpy(fix["x0"][0]),
        polish_all_starts=all_starts)
    want = [round(float(v), 5) for v in errors_pct(
        out.model_prices.numpy(), truth)]
    assert rows[name]["per_surface_error_pct"] == want
    assert rows_torch[name]["per_surface_error_pct"] != want


def pairs(i, name, key_offset=0):
    """Set ``i`` under ablation configuration ``name`` from one set of
    starts: ``{engine: [5] errors %}`` for JAX in its record's
    configuration (``jax_vmap``), JAX with its batched search
    (``jax_batched``) and the port."""
    fix = load_jax_starts()
    cfg_t, all_starts = CONFIGS[name]
    prices = fix["prices"][i]
    x0 = (fix["x0"][i] if key_offset == 0
          else jax_starts(key_offset + i, prices))
    grid = lambda a: np.tile(a, (5, 1))
    out = {}
    for impl in ("vmap", "batched"):
        res = jcal.calibrate_batch_mixed(
            jnp.full(5, 100.0), jnp.asarray(0.03),
            jnp.asarray(grid(tbench.STRIKES)), jnp.asarray(grid(tbench.MATS)),
            jnp.ones((5, 15), bool), jnp.asarray(prices),
            jax.random.split(jax.random.key(key_offset + i), 5),
            config=jax_config(cfg_t, impl), n_starts=3,
            polish_all_starts=all_starts)
        out["jax_" + impl] = errors_pct(res.model_prices, prices)
    res = port.calibrate_batch_mixed(
        np.full(5, 100.0), 0.03, grid(tbench.STRIKES), grid(tbench.MATS),
        np.ones((5, 15), bool), prices, config=cfg_t, n_starts=3,
        x0=torch.from_numpy(np.asarray(x0)), device="cpu",
        polish_all_starts=all_starts)
    out["port"] = errors_pct(res.model_prices.numpy(), prices)
    return {k: np.round(v, 5).tolist() for k, v in out.items()}


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m tests.test_torch_jax_starts")
    ap.add_argument("--write", action="store_true")
    ap.add_argument("--pairs", action="store_true")
    ap.add_argument("--polish-pairs", action="store_true")
    ap.add_argument("--feller-ties", type=int, metavar="N")
    ap.add_argument("--sets", default="0,1,2,3,4,5")
    ap.add_argument("--configs", default="default,polish_winner_only")
    ap.add_argument("--key-offset", type=int, default=0)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    if args.write:
        fx = build_fixture()
        JAX_STARTS.parent.mkdir(parents=True, exist_ok=True)
        np.savez_compressed(JAX_STARTS, **fx)
        print("wrote", JAX_STARTS, {k: v.shape for k, v in fx.items()})
        return 0
    if args.feller_ties:
        print(json.dumps(feller_ties(args.feller_ties)[0]))
        return 0
    rows = []
    if args.pairs:
        for i in map(int, args.sets.split(",")):
            for name in args.configs.split(","):
                rows.append({"set": i, "config": name,
                             "key_offset": args.key_offset,
                             **pairs(i, name, args.key_offset)})
                print(json.dumps(rows[-1]), flush=True)
    if args.polish_pairs:
        for surface in range(6 * 5):
            x_jax, x_port, f_jax, f_port = search_ends(surface, losses=True)
            row = {"surface": surface, "search_loss": {
                "jax": f_jax.tolist(), "port": f_port.tolist()}}
            for end, x in (("jax_ends", x_jax), ("port_ends", x_port)):
                e_j, e_t = polish_pair(surface, x)
                row[end] = {"jax": np.round(e_j, 5).tolist(),
                            "port": np.round(e_t, 5).tolist()}
            rows.append(row)
            print(json.dumps(row), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
