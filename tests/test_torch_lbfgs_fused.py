"""The fused L-BFGS trip of the calibration objective on the CPU, where it
runs its plain versions (``ops/loss_kernel.py``): ``lbfgs_open_fused_plain``
(``lbfgs_open_plain`` and the transform), K2's plain version,
``search_assembly_plain`` (the loss and its gradient assembled from K2's
outputs, the host assembly of ``BatchValueAndGrad``) and
``lbfgs_update_plain``.

  * the plain assembly on the plain K2's outputs against JAX's XLA loss
    (``make_loss_fn``, its value and ``jax.grad``, float64) on lanes with
    an invalid price row (the sentinel, where JAX's gradient is not
    finite and the engine's ``safe_vg`` zeroes it), each Feller factor
    above its bound, both and neither: the loss and the gradient to 1e-12
    relative (the gradient with atol 1e-14 for its entries near 0, where
    autograd and JAX's autodiff round apart by a few 1e-15).
    The Feller kink is left out: there JAX's ``maximum`` splits the
    gradient, the port's assembly (and the JAX package's Pallas assembly)
    gives 0, a recorded divergence;
  * the plain assembly against ``make_batch_value_and_grad``'s host
    assembly on the CPU: in bits;
  * the fused kernels' constants (the transform's masks, the Feller
    indices, torch.mean's order) follow the parameter layout;
  * ``calibrate_batch`` on the CPU (the fused route) against JAX's
    ``calibrate_batch_fused`` (XLA autodiff) over 10 trips at float64, at
    tests/test_torch_optim.py's 1e-9;
  * done lanes hold, bit for bit, over 20 fused trips;
  * nothing reads a done lane's K2 rows, the premise of the bound K2's
    skip of done lanes on the card: a 20-trip search ends in the same
    bits, and the same status words, with those rows set to NaN;
  * the trip's binding rejects, before any trip, every malformed state
    that the wrappers reject, and an objective that does not fit it;
  * the fused route is what the engine takes for the objective (with
    fewer than 128 rows a lane), and any other callable takes the unfused
    trip; both end in the same bits.
The card's tests (tests/test_torch_gpu.py) hold the fused kernels to the
fused plain pair in bits.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from option_pricing_ffn_lbfgs_tpu.calibration import calibrator as jcal
from option_pricing_ffn_lbfgs_tpu.calibration.initial_guess import (
    initial_guesses)
from option_pricing_ffn_lbfgs_tpu.calibration.loss import make_loss_fn
from option_pricing_ffn_lbfgs_tpu.models.double_heston import (
    DHParams, price_options)
from option_pricing_ffn_lbfgs_tpu.utils.config import (
    CalibrationConfig as JConfig, LBFGSConfig as JLBFGS, PricerConfig as JPricer)
from option_pricing_ffn_lbfgs_tpu_torch.calibration import calibrator as tcal
from option_pricing_ffn_lbfgs_tpu_torch.calibration.transforms import (
    transform)
from option_pricing_ffn_lbfgs_tpu_torch.ops import lbfgs_batched as lb
from option_pricing_ffn_lbfgs_tpu_torch.ops import loss_kernel
from option_pricing_ffn_lbfgs_tpu_torch.tools import trip_check
from option_pricing_ffn_lbfgs_tpu_torch.utils.config import (
    CalibrationConfig, LBFGSConfig, PricerConfig)
from tests.conftest import TRUE

torch.set_num_threads(1)
F64 = torch.float64
JCFG = JConfig(pricer=JPricer(n_terms=64))
TCFG = CalibrationConfig(pricer=PricerConfig(n_terms=64))
# (sigma, kappa, theta) coordinates of the two variance factors
FACTORS = ((3, 1, 2), (8, 6, 7))


@pytest.fixture(scope="module")
def lanes(surface15, noiseless_market):
    """8 lanes on the suite's surface: TRUE moved by ~5 %, then each
    factor's sigma set 30 % above or below sqrt(2 kappa theta) (neither,
    the first, the second, both; twice), lane 6 with v1_0 = exp(800),
    whose prices are not finite (the sentinel)."""
    strikes, mats, is_call = surface15
    rng = np.random.default_rng(3)
    base = np.array([TRUE[k] for k in DHParams._fields])
    p = base * (1.0 + rng.uniform(-0.05, 0.05, (8, 13)))
    for lane in range(8):
        for f, (s_, k_, t_) in enumerate(FACTORS):
            above = (lane >> f) & 1
            p[lane, s_] = np.sqrt(2 * p[lane, k_] * p[lane, t_]) * (
                1.3 if above else 0.7)
    x = np.log(np.abs(p))                           # exp coordinates
    for c in (4, 9):
        x[:, c] = np.arctanh(p[:, c])
    x[:, 11] = p[:, 11]
    x[6, 0] = 800.0
    mkt = np.asarray(noiseless_market) * (1.0 + rng.uniform(
        -0.02, 0.02, (8, 15)))
    return dict(spots=np.full(8, 100.0), strikes=np.tile(strikes, (8, 1)),
                mats=np.tile(mats, (8, 1)),
                call=np.tile(np.asarray(is_call), (8, 1)), mkt=mkt, x=x)


def _port_objective(ln, dt=F64, config=TCFG):
    t = lambda k: torch.tensor(ln[k], dtype=dt)
    return loss_kernel.make_batch_value_and_grad(
        t("spots"), t("strikes"), t("mats"), torch.tensor(ln["call"]),
        t("mkt"), 0.03, config)


def _fused_vg(obj, x):
    """The fused route's evaluation at x: the plain K2 at transform(x),
    then the plain assembly."""
    params = transform(x)
    price, g_price = obj.rows(params)
    return loss_kernel.search_assembly_plain(
        price, g_price, obj.mkt, params, obj.config.feller_weight,
        obj.config.bad_loss)


def test_assembly_matches_jax_loss(lanes):
    """Value and gradient (non-finite entries zeroed, as the engine's
    safe_vg does) against JAX's XLA loss, lane by lane."""
    x = torch.tensor(lanes["x"])
    f_t, g_t = (a.numpy() for a in _fused_vg(_port_objective(lanes), x))

    def one(x_, s, k, m, c, p):
        return jax.value_and_grad(make_loss_fn(s, 0.03, k, m, c, p, JCFG))(x_)
    f_j, g_j = jax.jit(jax.vmap(one))(
        *(jnp.asarray(lanes[k]) for k in ("x", "spots", "strikes", "mats",
                                          "call", "mkt")))
    f_j, g_j = np.asarray(f_j), np.asarray(g_j)
    assert not np.isfinite(g_j[6]).all()             # JAX: not finite
    g_j = np.where(np.isfinite(g_j), g_j, 0.0)
    assert f_t[6] == f_j[6] == TCFG.bad_loss
    np.testing.assert_array_equal(g_t[6], np.zeros(13))
    np.testing.assert_allclose(f_t, f_j, rtol=1e-12)
    np.testing.assert_allclose(g_t, g_j, rtol=1e-12, atol=1e-14)
    # every Feller case is present, and its penalty gradient reaches g
    params = transform(x).numpy()
    viol = np.stack([params[:, s] ** 2 - 2 * params[:, k] * params[:, t]
                     for s, k, t in FACTORS], -1)
    seen = {tuple(v > 0) for v in viol[np.isfinite(viol).all(-1)]}
    assert seen == {(False, False), (True, False), (False, True),
                    (True, True)}


def test_assembly_matches_host_assembly(lanes):
    """The fused route's evaluation against the host assembly of
    ``BatchValueAndGrad.__call__``: the same bits."""
    obj = _port_objective(lanes)
    x = torch.tensor(lanes["x"])
    f_fused, g_fused = _fused_vg(obj, x)
    f_host, g_host = obj(x)
    assert torch.equal(g_fused, g_host)
    assert torch.equal(f_fused, f_host)


def test_fused_constants_follow_the_parameter_layout():
    """What the fused kernels take from the objective: the transform's
    masks give ``transform``'s bits, the Feller indices name each factor's
    sigma, kappa and theta, and torch.mean's order at the search's shape
    is 8 threads a row and 1/15 rounded to the dtype."""
    x = torch.tensor(np.random.default_rng(2).normal(size=(5, 13)))
    bit = lambda mask: torch.tensor([(mask >> c) & 1 == 1
                                     for c in range(13)])
    by_mask = torch.where(bit(loss_kernel.EXP_MASK), torch.exp(x),
                          torch.where(bit(loss_kernel.TANH_MASK),
                                      torch.tanh(x), x))
    assert torch.equal(by_mask, transform(x))
    assert loss_kernel.EXP_MASK & loss_kernel.TANH_MASK == 0
    names = DHParams._fields
    assert [[names[c] for c in f] for f in loss_kernel.FELLER_IDX] == [
        [f"sigma{i}", f"kappa{i}", f"theta{i}"] for i in (1, 2)]
    assert loss_kernel.FELLER_IDX == FACTORS
    for dt, real in ((torch.float32, np.float32), (F64, np.float64)):
        assert loss_kernel.torch_mean_order(1536, 15, dt) == (
            8, float(real(1.0) / real(15.0)))


def test_assembly_in_kernel_order():
    """The row mean is torch.mean's (fused K5 sums in its order on the
    card) and the Feller gradient is 0 at the kink, where sigma^2 ==
    2 kappa theta exactly."""
    price = torch.tensor([[1.0, 2.0, 4.0, 0.5]] * 2, dtype=F64)
    mkt = torch.tensor([[1.1, 1.9, 3.0, 0.7]] * 2, dtype=F64)
    params = torch.full((2, 13), 0.5, dtype=F64)
    params[:, 3] = 1.0                              # sigma1^2 = 2 * 0.5 * 1
    params[:, 2] = 1.0
    params[1, 3] = 1.5                              # lane 1: above
    g_price = torch.zeros(2, 13, dtype=F64)
    f, g = loss_kernel.search_assembly_plain(price, g_price, mkt, params,
                                             1000.0, 1e10)
    rel = ((price - mkt) / mkt)[0]
    mse = torch.mean(rel * rel)
    assert float(f[0]) == float(mse)
    assert torch.equal(g[0], torch.zeros(13, dtype=F64))
    assert float(f[1]) == float(mse + 1000.0 * (1.5 ** 2 - 1.0))
    assert float(g[1, 3]) == 1000.0 * 2.0 * 1.5 * 1.5   # times exp'(x) = p


def test_calibrate_batch_matches_jax(surface15):
    """The search through the fused route against JAX's XLA search from
    the same starts: 2 surfaces x 3 starts, 10 trips, float64. Start 0 of
    ``initial_guesses`` is the fixed guess, whose second factor sits on
    its Feller bound (0.2^2 = 2 * 0.5 * 0.04), the kink where JAX's
    ``maximum`` splits the penalty's gradient and the port's gives 0 (the
    recorded divergence): there the two searches part, so starts 1 and 2
    are held to each other and start 0 is shown to be on the kink."""
    strikes, mats, is_call = surface15
    rng = np.random.default_rng(5)
    base = np.array([TRUE[k] for k in DHParams._fields])
    vecs = jnp.asarray(base * (1.0 + rng.uniform(-0.05, 0.05, (2, 13))))
    spots = jnp.full(2, 100.0)
    prices = jax.vmap(lambda s, v: price_options(
        DHParams.from_vector(v), s, 0.03, strikes, mats, is_call))(spots, vecs)
    keys = jax.random.split(jax.random.key(2), 2)
    data = (spots, jnp.broadcast_to(strikes, (2, 15)),
            jnp.broadcast_to(mats, (2, 15)), jnp.broadcast_to(is_call, (2, 15)),
            prices)
    cfg_j = dataclasses.replace(JCFG, lbfgs=JLBFGS(maxeval=10))
    out_j = jcal.calibrate_batch_fused(data[0], 0.03, *data[1:], keys,
                                       config=cfg_j, impl="batched")
    x0 = jax.vmap(lambda s, k, m, p, ky: initial_guesses(
        3, ky, s, k, m, p, jnp.float64))(spots, data[1], data[2], prices,
                                          keys)
    cfg_t = dataclasses.replace(TCFG, lbfgs=LBFGSConfig(maxeval=10))
    out_t = tcal.calibrate_batch(
        np.array(data[0]), 0.03, *(np.array(a) for a in data[1:]),
        config=cfg_t, n_starts=3, x0=np.array(x0), device="cpu", dtype=F64)
    np.testing.assert_allclose(out_t.per_start_x.numpy()[:, 1:],
                               np.asarray(out_j.per_start_x)[:, 1:],
                               rtol=1e-9, atol=1e-10)
    np.testing.assert_allclose(out_t.per_start_loss.numpy()[:, 1:],
                               np.asarray(out_j.per_start_loss)[:, 1:],
                               rtol=1e-9)
    p0 = transform(torch.tensor(np.array(x0)[:, 0]))
    viol = p0[:, 8] ** 2 - 2.0 * p0[:, 6] * p0[:, 7]
    assert float(viol.abs().max()) <= 1e-17
    assert np.isfinite(out_t.per_start_loss.numpy()).all()
    assert bool((out_t.n_evals == 10).all())


def test_done_lanes_hold_over_20_fused_trips(lanes):
    """Lanes done before the first trip (a third of them also starting)
    keep every field bit for bit over 20 fused trips; the others move."""
    obj = _port_objective(lanes)
    st, _, _ = trip_check.random_state(8, F64, "cpu", 5,
                                       trip_check.TRIP_CONFIG)
    st.x.copy_(torch.tensor(lanes["x"]) + 0.01)
    st.done.copy_(torch.arange(8) % 3 == 0)
    st.starting.copy_(torch.arange(8) % 2 == 0)
    st.n_iters.zero_()
    st.n_evals.zero_()
    assert bool((st.done & st.starting).any())
    before = trip_check.clone_state(st)
    status = torch.zeros(2, dtype=torch.int32)
    trip = lb._bind_trip(obj, st, trip_check.TRIP_CONFIG, status, False)
    for _ in range(20):
        trip()
        assert lb.read_live(status) == int((~st.done).sum())
    done = before.done
    for name, a, b in zip(lb._BState._fields, before, st):
        assert torch.equal(a[done], b[done]), name
    assert int((st.n_evals[~done] == 20).sum()) > 0
    assert not torch.equal(st.x[~done], before.x[~done])


def _nan_rows(rows, flags):
    """K2's (or K3's) outputs with every row of a lane that ``flags`` marks
    set to NaN: a skipped lane's rows hold whatever they held."""
    return tuple(t.masked_fill(flags.view(-1, *([1] * (t.dim() - 1))),
                               float("nan")) for t in rows)


def _search_20_trips(ln, dt, route, nan_lanes):
    """20 trips of the fused route from x0 with lanes 2 and 5 done from
    the start and lanes 1 and 4 eight evaluations short of ``maxeval``:
    route "pair" runs ``lbfgs_open_fused_plain``, the plain K2 and
    ``lbfgs_update_fused_plain`` (a trip's status word: its live count),
    route "bound" the objective's bound plain trip in place. Before K5
    the rows of the lanes that ``nan_lanes(st)`` marks are set to NaN
    (None: none). Returns the state and each trip's status word."""
    cfg = LBFGSConfig(maxeval=28)
    obj = _port_objective(ln, dt)
    st = lb.init_state(torch.tensor(ln["x"], dtype=dt), cfg.history)
    st.done[[2, 5]] = True
    st.n_evals[[1, 4]] = cfg.maxeval - 8
    words = []
    if route == "bound":
        status = torch.zeros(2, dtype=torch.int32)
        if nan_lanes is not None:
            rows = obj.rows
            obj.rows = lambda params: _nan_rows(rows(params), nan_lanes(st))
        trip = obj.bind_trip(st, cfg, status, plain=True)
        for _ in range(20):
            trip()
            words.append(status.tolist())
        return st, words
    for _ in range(20):
        st, x_try, params = loss_kernel.lbfgs_open_fused_plain(st, cfg)
        rows = obj.rows(params)
        if nan_lanes is not None:
            rows = _nan_rows(rows, nan_lanes(st))
        st = loss_kernel.lbfgs_update_fused_plain(
            st, x_try, params, *rows, obj.mkt, obj.config.feller_weight,
            obj.config.bad_loss, cfg)
        words.append([int((~st.done).sum()), 0])
    return st, words


@pytest.mark.parametrize("dt", [torch.float32, F64], ids=["f32", "f64"])
@pytest.mark.parametrize("route", ["pair", "bound"])
def test_search_never_reads_done_lanes_k2_rows(lanes, route, dt):
    """The bound K2 skips the lanes done as a trip starts and leaves their
    rows as they were: a 20-trip search with those rows set to NaN before
    K5 ends with every field of the state, and every trip's status word,
    equal in bits to the search as it is. Lanes done from the start and
    lanes that finish on the way (maxeval, the sentinel lane) are both
    skipped, while other lanes stay live to the end. Setting a live
    lane's rows to NaN instead changes the end: the check can see a read."""
    same, words = _search_20_trips(lanes, dt, route, None)
    nan, nan_words = _search_20_trips(lanes, dt, route, lambda st: st.done)
    assert nan_words == words
    for name, a, b in zip(lb._BState._fields, same, nan):
        assert not trip_check._bits_differ(a, b).any(), name
    assert bool(same.done[[1, 2, 4, 5, 6]].all()), same.done
    assert words[0][0] == 6 and words[-1][0] > 0
    assert len({w[0] for w in words}) > 2          # lanes finish on the way
    live, _ = _search_20_trips(lanes, dt, route, lambda st: ~st.done)
    assert any(trip_check._bits_differ(a, b).any()
               for a, b in zip(same, live))


@pytest.mark.parametrize("fault", ["uint8", "short", "long", "strided",
                                   "device"])
def test_done_flags_check_refuses_what_k2_k3_do_not_read(fault):
    """The done flags a bound K2/K3 reads must be a contiguous bool tensor
    of one entry a lane on the inputs' device (the bindings' check,
    ``loss_kernel._check_done``); None and such a tensor pass."""
    flags = lambda n: torch.zeros(n, dtype=torch.bool)
    loss_kernel._check_done(None, 4, torch.device("cpu"))
    loss_kernel._check_done(flags(4), 4, torch.device("cpu"))
    done = {"uint8": torch.zeros(4, dtype=torch.uint8), "short": flags(3),
            "long": flags(5), "strided": flags(8)[::2],
            "device": flags(4).to("meta")}[fault]
    with pytest.raises(ValueError, match="done"):
        loss_kernel._check_done(done, 4, torch.device("cpu"))


@pytest.mark.parametrize("fault", ["int64_head", "float16", "strided_g",
                                   "d_too_wide", "short_status", "d_not_13",
                                   "objective_dtype", "objective_lanes"])
def test_binding_rejects_what_the_kernels_do_not_take(lanes, fault):
    """The fused trip's binding checks the state, the status word and the
    objective once, before any trip, as the wrappers check them on every
    call (tests/test_torch_lbfgs_trip.py), on the CPU as on the card."""
    cfg = trip_check.TRIP_CONFIG
    obj = _port_objective(lanes)
    st, _, _ = trip_check.random_state(8, F64, "cpu", 1, cfg)
    status = torch.zeros(2, dtype=torch.int32)
    if fault == "int64_head":
        st = st._replace(head=st.head.long())
    elif fault == "float16":
        st = lb.init_state(torch.zeros(8, 13, dtype=torch.float16), 10)
    elif fault == "strided_g":
        st = st._replace(g=torch.zeros(13, 8, dtype=F64).t())
    elif fault == "d_too_wide":
        st = lb.init_state(torch.zeros(8, lb.MAX_DIM + 1, dtype=F64), 10)
    elif fault == "short_status":
        status = torch.zeros(1, dtype=torch.int32)
    elif fault == "d_not_13":
        st = lb.init_state(torch.zeros(8, 12, dtype=F64), 10)
    elif fault == "objective_dtype":
        obj = _port_objective(lanes, torch.float32)
    else:
        st = lb.init_state(torch.zeros(4, 13, dtype=F64), 10)
    before = trip_check.clone_state(st)
    with pytest.raises(ValueError):
        lb._bind_trip(obj, st, cfg, status, False)
    for a, b in zip(before, st):
        assert torch.equal(a, b)


def test_engine_routes_objective_to_fused_trip(lanes, monkeypatch):
    """``lbfgs_minimize_batched`` takes the fused route for the objective
    and the unfused one for any other callable, which calls the objective
    (whose host assembly is the fused route's); the two end in the same
    bits."""
    keep = [0, 1, 2, 3, 4, 5, 7]                    # finite prices
    obj = _port_objective({k: v[keep] for k, v in lanes.items()})
    x0 = torch.tensor(lanes["x"][keep]) * 1.01
    calls = {"host": 0, "fused": 0}
    host, plain = loss_kernel.BatchValueAndGrad.__call__, \
        loss_kernel.search_assembly_plain

    def count_host(self, x):
        calls["host"] += 1
        return host(self, x)

    def count_assembly(*args):
        calls["fused"] += 1
        return plain(*args)
    monkeypatch.setattr(loss_kernel.BatchValueAndGrad, "__call__",
                        count_host)
    monkeypatch.setattr(loss_kernel, "search_assembly_plain",
                        count_assembly)
    cfg = LBFGSConfig(maxeval=15)
    fused = lb.lbfgs_minimize_batched(obj, x0, cfg)
    trips = int(fused.n_evals.max())
    assert trips > 5 and calls == {"host": 0, "fused": trips}
    unfused = lb.lbfgs_minimize_batched(lambda x: obj(x), x0, cfg)
    assert calls == {"host": trips, "fused": 2 * trips}
    assert torch.equal(fused.x, unfused.x)
    assert torch.equal(fused.n_evals, unfused.n_evals)


def test_wide_objective_takes_the_unfused_trip(surface15):
    """With 128 rows a lane or more (where ATen vectorises torch.mean's
    loads, an order fused K5 does not follow) the objective binds no
    fused trip, and the engine's unfused trip around it runs."""
    strikes, mats, is_call = surface15
    n = 9 * 15
    rep = lambda a, dt=F64: torch.tensor(np.tile(np.asarray(a), 9)[None],
                                         dtype=dt)
    obj = loss_kernel.make_batch_value_and_grad(
        torch.tensor([100.0]), rep(strikes), rep(mats),
        rep(is_call, torch.bool), torch.full((1, n), 5.0, dtype=F64), 0.03,
        TCFG)
    st = lb.init_state(torch.zeros(1, 13, dtype=F64), 10)
    status = torch.zeros(2, dtype=torch.int32)
    assert obj.bind_trip(st, LBFGSConfig(), status, False) is None
    res = lb.lbfgs_minimize_batched(obj, torch.zeros(1, 13, dtype=F64),
                                    LBFGSConfig(maxeval=3))
    assert int(res.n_evals[0]) == 3 and bool(torch.isfinite(res.f).all())
