"""The fused LM trip of the polish's objective on the CPU, where it runs its
plain versions (``ops/levenberg_marquardt.py``): ``lm_open_fused_plain``
(``lm_open_plain`` and the transform at float64 and float32), the plain K1
and K3, ``polish_assembly_plain`` (the residuals and the Jacobian assembled
from their outputs, the host assembly of ``PolishObjective``) and
``lm_update_plain``.

  * the plain assembly against the objective's ``(residual_fn, jac_fn)``
    (``calibration/calibrator.py::polish_residual_and_jacobian``), in bits,
    on lanes with non-finite prices (the sentinel), each Feller factor
    above, below and exactly on its bound, and with a non-positive price;
  * the plain fused pair against ``lm_open_plain``, the host assembly and
    ``lm_update_plain`` over 22 trips, bootstrap trip and done lanes
    included, in bits; the engine's routes (fused and unfused) end in the
    same bits;
  * padding lanes (``live``) start done and leave the real lanes' bits
    and live counts as they are without them;
  * nothing reads a done lane's K3 rows, the premise of the bound K3's
    skip of done lanes on the card: a stage-A run (maxiter 10) ends in
    the same bits, and the same status words, with those rows set to NaN;
  * ``_polish_lanes_fused`` on the CPU (the fused plain trip) against the
    JAX package's ``_polish_lanes_fused`` (its Pallas Jacobian in interpret
    mode), from the same lanes and starts: model prices within the
    slice's 2e-4 relative, no lane's cost above its start's;
  * the binding's refusals, before any trip, and the row bound past which
    the objective binds no fused trip.
The card's tests (tests/test_torch_gpu.py) hold the fused kernels to the
fused plain pair in bits.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from option_pricing_ffn_lbfgs_tpu.calibration import calibrator as jcal
from option_pricing_ffn_lbfgs_tpu.models.double_heston import (
    DHParams, price_options)
from option_pricing_ffn_lbfgs_tpu.utils.config import (
    CalibrationConfig as JConfig, PricerConfig as JPricer)
from option_pricing_ffn_lbfgs_tpu_torch.calibration import calibrator as tcal
from option_pricing_ffn_lbfgs_tpu_torch.calibration.transforms import (
    transform)
from option_pricing_ffn_lbfgs_tpu_torch.ops import levenberg_marquardt as lm
from option_pricing_ffn_lbfgs_tpu_torch.ops import loss_kernel, opcount
from option_pricing_ffn_lbfgs_tpu_torch.tools import lm_trip_check
from option_pricing_ffn_lbfgs_tpu_torch.utils.config import (
    CalibrationConfig, LMConfig, PricerConfig)
from tests.conftest import TRUE

torch.set_num_threads(1)
F32, F64 = torch.float32, torch.float64
TCFG = CalibrationConfig(pricer=PricerConfig(n_terms=64))
JCFG = JConfig(pricer=JPricer(n_terms=64))
FACTORS = ((3, 1, 2), (8, 6, 7))


@pytest.fixture(scope="module")
def lanes(surface15, noiseless_market):
    """10 lanes on the suite's surface: TRUE moved by ~5 %, each factor's
    sigma 30 % above or below sqrt(2 kappa theta) (neither, the first, the
    second, both; twice), lane 6 with v1_0 = exp(800), whose prices are
    not finite (the sentinel), lanes 8 and 9 with a factor exactly on its
    bound at float64 and float32 (sigma = kappa = 1, theta = 0.5: exp(0)
    and exp(log 0.5) are exact at both)."""
    strikes, mats, is_call = surface15
    rng = np.random.default_rng(3)
    base = np.array([TRUE[k] for k in DHParams._fields])
    p = base * (1.0 + rng.uniform(-0.05, 0.05, (10, 13)))
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
    for lane, (s_, k_, t_) in zip((8, 9), FACTORS):
        x[lane, [s_, k_, t_]] = 0.0, 0.0, math.log(0.5)
    mkt = np.asarray(noiseless_market) * (1.0 + rng.uniform(
        -0.02, 0.02, (10, 15)))
    return dict(spots=np.full(10, 100.0), strikes=np.tile(strikes, (10, 1)),
                mats=np.tile(mats, (10, 1)),
                call=np.tile(np.asarray(is_call), (10, 1)), mkt=mkt, x=x)


def _objective(ln, keep=slice(None)):
    t = lambda k: torch.tensor(ln[k][keep], dtype=F64)
    return tcal.polish_residual_and_jacobian(
        t("spots"), 0.03, t("strikes"), t("mats"),
        torch.tensor(ln["call"][keep]), t("mkt"), TCFG)


def _assembled(obj, x):
    """The fused route's evaluation at x: the plain K1 at transform(x),
    the plain K3 at transform(float32(x)), then the plain assembly."""
    p64, p32 = transform(x), transform(x.to(F32))
    return loss_kernel.polish_assembly_plain(
        obj.prices(p64), obj.rows(p32), obj.mkt, p64, p32,
        TCFG.feller_weight, TCFG.bad_loss)


def _same_bits(a, b):
    return not lm_trip_check._bits_differ(a, b).any()


def test_assembly_equals_host_pair(lanes):
    """r and J of the plain assembly are the objective's residual_fn and
    jac_fn (cast to float64, as the engine casts it), bit for bit; the
    sentinel lane's J is left as computed, and every Feller case is
    present at both precisions."""
    obj = _objective(lanes)
    x = torch.tensor(lanes["x"])
    residual_fn, jac_fn = obj
    r, J = _assembled(obj, x)
    assert torch.equal(r, residual_fn(x))
    assert J.dtype == F64 and _same_bits(J, jac_fn(x).to(F64))
    assert bool((r[6] == math.sqrt(TCFG.bad_loss / 17)).all())
    assert not bool(torch.isfinite(J[6]).all())
    assert bool(torch.isfinite(r).all())
    for params in (transform(x), transform(x.to(F32))):
        viol = torch.stack([params[:, s] ** 2 - 2.0 * params[:, k]
                            * params[:, t] for s, k, t in FACTORS], -1)
        cases = {tuple(np.sign(v).astype(int)) for v in viol.numpy()
                 if np.isfinite(v).all()}
        assert {(1, 1), (1, -1), (-1, 1), (-1, -1)} <= cases
        assert float(viol[8, 0]) == 0.0 and float(viol[9, 1]) == 0.0
    # the kink lane's Feller row is 0 with a zero Jacobian row
    assert float(r[8, 15]) == 0.0 and not bool(J[8, 15].any())


def test_assembly_sentinel_on_non_positive_price(lanes):
    """A price that is 0 or negative puts the sentinel on every row of its
    lane, as ``residual_rows`` does, and leaves J as computed."""
    obj = _objective(lanes, slice(0, 3))
    x = torch.tensor(lanes["x"][:3])
    p64, p32 = transform(x), transform(x.to(F32))
    price = obj.prices(p64)
    price[1, 4] = 0.0
    price[2, 0] = -1e-3
    rows = obj.rows(p32)
    r, J = loss_kernel.polish_assembly_plain(
        price, rows, obj.mkt, p64, p32, TCFG.feller_weight, TCFG.bad_loss)
    sentinel = math.sqrt(TCFG.bad_loss / 17)
    assert bool((r[1:] == sentinel).all()) and not bool((r[0] == sentinel)
                                                       .any())
    _, J_ref = loss_kernel.polish_assembly_plain(
        obj.prices(p64), rows, obj.mkt, p64, p32, TCFG.feller_weight,
        TCFG.bad_loss)
    assert torch.equal(J, J_ref)


def _host_loop(obj, st, config, trips):
    """The parent's engine loop from ``st``: lm_open_plain, the host pair
    (residuals at x on the bootstrap trip), lm_update_plain."""
    residual_fn, jac_fn = obj
    r0 = residual_fn(st.x)
    for k in range(trips):
        st, x_try = lm.lm_open_plain(st, config)
        r_try = r0 if k == 0 else residual_fn(x_try)
        st = lm.lm_update_plain(st, x_try, r_try, jac_fn(x_try).to(F64),
                                config)
    return st


def test_fused_plain_pair_equals_host_loop_over_22_trips(lanes):
    """From a bootstrap state with a third of the lanes done: 22 trips of
    the objective's bound plain trip against the parent's loop, every
    field in bits after every trip's count of live lanes; done lanes hold,
    the others move, and some lanes finish on the way."""
    keep = [0, 1, 2, 3, 4, 5, 7, 8, 9]              # finite prices
    obj = _objective(lanes, keep)
    x0 = torch.tensor(lanes["x"][keep]) * 1.01
    cfg = LMConfig(maxiter=15, ftol=1e-15, gtol=1e-11, cost_target=1e-10)
    st = lm.init_state(x0, 17, cfg)
    st.done.copy_(torch.arange(9) % 3 == 1)
    before = lm_trip_check.clone_state(st)
    status = torch.zeros(1, dtype=torch.int32)
    trip = obj.bind_trip(st, cfg, status, False)
    for _ in range(22):
        trip()
        assert lm.read_live(status) == int((~st.done).sum())
    want = _host_loop(obj, before, cfg, 22)
    for name, a, b in zip(lm._State._fields, want, st):
        assert _same_bits(a, b), name
    done = before.done
    for name, a, b in zip(lm._State._fields, before, st):
        assert _same_bits(a[done], b[done]), name
    assert not torch.equal(st.x[~done], before.x[~done])
    assert int(st.done.sum()) > int(done.sum())


def test_fused_open_boot_takes_params_at_x():
    """On the bootstrap trip fused K6's plain version gives K1 the
    parameters of x, whose -0.0 coordinates x + 0 would turn to +0.0 (tanh
    and the identity keep the sign of zero), and K3 those of x_try."""
    cfg = LMConfig()
    x0 = torch.zeros(2, 13, dtype=F64)
    x0[0, 4], x0[0, 11] = -0.0, -0.0
    st = lm.init_state(x0, 17, cfg)
    _, x_try, p64, p32 = lm.lm_open_fused_plain(st, cfg, True)
    assert torch.equal(x_try, x0) and bool(torch.signbit(p64[0, 4]))
    assert bool(torch.signbit(p64[0, 11]))
    assert not bool(torch.signbit(p32[0, 4]))
    _, _, p64_later, _ = lm.lm_open_fused_plain(st, cfg, False)
    assert not bool(torch.signbit(p64_later[0, 4]))


@pytest.mark.parametrize("maxiter", [3, 12])
def test_engine_routes_end_in_the_same_bits(lanes, maxiter, monkeypatch):
    """``lm_minimize_batched`` on the objective (the fused plain trip,
    one host read a trip, the residuals taken in the trip only) and on
    its unpacked ``(residual_fn, jac_fn)`` (the unfused trip around the
    host assembly): every field of the results in bits."""
    keep = [0, 1, 2, 3, 5, 7, 8, 9]
    obj = _objective(lanes, keep)
    x0 = torch.tensor(lanes["x"][keep]) * 1.02
    cfg = dataclasses.replace(tcal.POLISH_LM, maxiter=maxiter)
    reads, calls = [], []
    read_live = lm.read_live
    monkeypatch.setattr(lm, "read_live", lambda s: reads.append(1)
                        or read_live(s))
    monkeypatch.setattr(type(obj), "__call__", lambda self, x:
                        calls.append(1))
    fused = lm.lm_minimize_batched(obj, x0, cfg, jac_fn=obj.jac)
    assert len(reads) == maxiter + 1 and not calls
    monkeypatch.undo()
    residual_fn, jac_fn = obj
    host = lm.lm_minimize_batched(residual_fn, x0, cfg, jac_fn=jac_fn)
    for name, a, b in zip(lm.LMResult._fields, fused, host):
        assert _same_bits(a, b), name
    assert int(fused.n_evals.max()) == maxiter + 1


def test_padding_starts_done(lanes, monkeypatch):
    """Lanes from ``live`` on (a wave's padding: copies of its first lane)
    start done: they keep x0 and count no iteration, each trip's live
    count leaves them out, and the real lanes end in the bits, after the
    same live counts, of a run without the padding."""
    keep, pad = [0, 1, 2, 3], [0, 1, 2, 3, 0, 0, 0]
    x0 = torch.tensor(lanes["x"][pad]) * 1.02
    cfg = dataclasses.replace(tcal.POLISH_LM, maxiter=6)
    reads = []
    read_live = lm.read_live
    monkeypatch.setattr(lm, "read_live",
                        lambda st: reads.append(read_live(st)) or reads[-1])
    obj = _objective(lanes, pad)
    padded = lm.lm_minimize_batched(obj, x0, cfg, jac_fn=obj.jac, live=4)
    padded_reads, reads[:] = reads[:], []
    obj = _objective(lanes, keep)
    alone = lm.lm_minimize_batched(obj, x0[:4], cfg, jac_fn=obj.jac)
    assert padded_reads == reads and reads[0] == 4
    for name, a, b in zip(lm.LMResult._fields, padded, alone):
        assert _same_bits(a[:4], b), name
    assert _same_bits(padded.x[4:], x0[4:])
    assert not padded.n_iters[4:].any() and not padded.converged[4:].any()


def _stage_a(ln, route, nan_lanes):
    """Stage A's LM (``POLISH_LM`` at maxiter 10, 11 trips) on lanes 0-5,
    7-9 from x0 * 1.01, lanes 2 and 6 done from the start (as a wave's
    padding is) and lanes 1 and 4 with five iterations already counted:
    route "pair" runs ``lm_open_fused_plain``, the plain K1 and K3 and
    ``lm_update_fused_plain`` (a trip's status word: its live count),
    route "bound" the objective's bound plain trip in place. Before K7 the
    K3 rows of the lanes that ``nan_lanes(st)`` marks are set to NaN
    (None: none). Returns the state and each trip's status word."""
    keep = [0, 1, 2, 3, 4, 5, 7, 8, 9]
    obj = _objective(ln, keep)
    cfg = dataclasses.replace(tcal.POLISH_LM, maxiter=10)
    st = lm.init_state(torch.tensor(ln["x"][keep]) * 1.01, obj.n_rows, cfg)
    st.done[[2, 6]] = True
    st.n_iters[[1, 4]] = 5
    nan_rows = lambda j: j.masked_fill(nan_lanes(st)[:, None, None],
                                       float("nan"))
    words = []
    if route == "bound":
        status = torch.zeros(1, dtype=torch.int32)
        if nan_lanes is not None:
            rows = obj.rows
            obj.rows = lambda params32: nan_rows(rows(params32))
        trip = obj.bind_trip(st, cfg, status, plain=True)
        for _ in range(cfg.maxiter + 1):
            trip()
            words.append(status.tolist())
        return st, words
    for k in range(cfg.maxiter + 1):
        st, x_try, p64, p32 = lm.lm_open_fused_plain(st, cfg, k == 0)
        j_price = obj.rows(p32)
        if nan_lanes is not None:
            j_price = nan_rows(j_price)
        st = lm.lm_update_fused_plain(
            st, x_try, p64, p32, obj.prices(p64), j_price, obj.mkt,
            TCFG.feller_weight, TCFG.bad_loss, cfg)
        words.append([int((~st.done).sum())])
    return st, words


@pytest.mark.parametrize("route", ["pair", "bound"])
def test_stage_a_never_reads_done_lanes_k3_rows(lanes, route):
    """The bound K3 skips the lanes done as a trip starts and leaves their
    rows as they were: stage A with those rows set to NaN before K7 ends
    with every field of the state, and every trip's status word, equal in
    bits to stage A as it is. Lanes done from the start and lanes that
    finish on the way are both skipped, while other lanes stay live to
    the last trip. Setting a live lane's rows to NaN instead changes the
    end: the check can see a read."""
    same, words = _stage_a(lanes, route, None)
    nan, nan_words = _stage_a(lanes, route, lambda st: st.done)
    assert nan_words == words
    for name, a, b in zip(lm._State._fields, same, nan):
        assert _same_bits(a, b), name
    assert words[0] == [7] and words[5][0] <= 5 and words[-2][0] > 0
    live, _ = _stage_a(lanes, route, lambda st: ~st.done)
    assert any(not _same_bits(a, b) for a, b in zip(same, live))


def test_polish_matches_jax(surface15):
    """The port's ``_polish_lanes_fused`` on the CPU (the fused plain
    trip) against the JAX package's, from the same numpy-seeded lanes and
    starts: 2 surfaces x 3 starts, 15 iterations. Model prices within
    2e-4 relative (the slice's bar: the two float32 Jacobians round apart,
    and the polishes stop at different places of the flat valley), and on
    both sides no lane's cost above its start's."""
    strikes, mats, is_call = surface15
    rng = np.random.default_rng(7)
    base = np.array([TRUE[k] for k in DHParams._fields])
    vecs = base * (1.0 + rng.uniform(-0.05, 0.05, (2, 13)))
    spots = np.full(2, 100.0)
    prices = np.asarray(jax.vmap(lambda s, v: price_options(
        DHParams.from_vector(v), s, 0.03, strikes, mats, is_call))(
            jnp.asarray(spots), jnp.asarray(vecs)))
    rep = lambda a: np.repeat(np.asarray(a), 3, axis=0)
    lanes_np = (rep(spots), rep(np.tile(strikes, (2, 1))),
                rep(np.tile(mats, (2, 1))), rep(np.tile(is_call, (2, 1))),
                rep(prices))
    x_true = np.log(np.abs(vecs))
    for c in (4, 9):
        x_true[:, c] = np.arctanh(vecs[:, c])
    x_true[:, 11] = vecs[:, 11]
    x0 = rep(x_true) + rng.normal(0.0, 0.05, (6, 13))
    polish = dataclasses.replace(tcal.POLISH_LM, maxiter=15)
    res_j, _, model_j = jcal._polish_lanes_fused(
        *(jnp.asarray(a) for a in lanes_np[:1]), 0.03,
        *(jnp.asarray(a) for a in lanes_np[1:]), jnp.asarray(x0),
        jnp.zeros(6), JCFG, dataclasses.replace(jcal.POLISH_LM, maxiter=15,
                                                residual_impl="native"))
    t = lambda a: torch.tensor(a, dtype=torch.bool if a.dtype == bool
                               else F64)
    res_t, _, model_t = tcal._polish_lanes_fused(
        t(lanes_np[0]), 0.03, *(t(a) for a in lanes_np[1:]),
        torch.tensor(x0), None, TCFG, polish)
    np.testing.assert_allclose(model_t.numpy(), np.asarray(model_j),
                               rtol=2e-4)
    obj = _objective(dict(spots=lanes_np[0], strikes=lanes_np[1],
                          mats=lanes_np[2], call=lanes_np[3],
                          mkt=lanes_np[4]))
    start = lm.trial_cost(obj(torch.tensor(x0))).numpy()
    assert np.all(res_t.f.numpy() <= start)
    assert np.all(np.asarray(res_j.f) <= start * (1 + 1e-12))
    assert np.all(np.isfinite(model_t.numpy()))


@pytest.mark.parametrize("fault", ["float32_state", "d_not_13", "rows",
                                   "lanes", "strided_J", "short_status",
                                   "mkt_dtype", "masks"])
def test_binding_rejects_what_the_fused_kernels_do_not_take(lanes, fault):
    """The objective's binding checks the state, the status word and the
    buffers once, before any trip, on the CPU as on the card; nothing is
    written."""
    obj = _objective(lanes, slice(0, 4))
    cfg = LMConfig()
    st = lm.init_state(torch.zeros(4, 13, dtype=F64), 17, cfg)
    status = torch.zeros(1, dtype=torch.int32)
    if fault == "float32_state":
        st = lm.init_state(torch.zeros(4, 13, dtype=F32), 17, cfg)
    elif fault == "d_not_13":
        st = lm.init_state(torch.zeros(4, 12, dtype=F64), 17, cfg)
    elif fault == "rows":
        st = lm.init_state(torch.zeros(4, 13, dtype=F64), 18, cfg)
    elif fault == "lanes":
        st = lm.init_state(torch.zeros(5, 13, dtype=F64), 17, cfg)
    elif fault == "strided_J":
        st = st._replace(J=st.J.transpose(1, 2).contiguous().transpose(1, 2))
    elif fault == "short_status":
        status = torch.zeros(2, dtype=torch.int32)
    elif fault == "mkt_dtype":
        obj.mkt = obj.mkt.to(F32)
    else:
        trial = obj.fused_trial(4, "cpu")._replace(exp_mask=1 << 13)
        with pytest.raises(ValueError):
            lm._check_fused(st, trial)
        return
    before = lm_trip_check.clone_state(st)
    with pytest.raises(ValueError):
        obj.bind_trip(st, cfg, status, False)
    for a, b in zip(before, st):
        assert _same_bits(a, b)


def test_kernels_bind_cuda_tensors_only(lanes):
    """LMTripKernels binds CUDA tensors only: on the CPU the objective's
    trip is the plain pair, and the kernels' binding raises."""
    obj = _objective(lanes, slice(0, 2))
    st = lm.init_state(torch.zeros(2, 13, dtype=F64), 17, LMConfig())
    status = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        lm.LMTripKernels(st, LMConfig(), status, torch.empty_like(st.x),
                         obj.fused_trial(2, "cpu"))


def test_wide_objective_takes_the_unfused_trip(surface15):
    """With more than 128 residual rows a lane (n + 2 > MAX_FUSED_ROWS)
    the objective binds no fused trip, and the engine's unfused trip
    around its host assembly runs; at 126 options (128 rows) it binds
    one."""
    strikes, mats, is_call = surface15
    for n, fused in ((126, True), (127, False)):
        tile = lambda a: np.resize(np.asarray(a), n)[None]
        obj = tcal.polish_residual_and_jacobian(
            torch.tensor([100.0], dtype=F64), 0.03,
            torch.tensor(tile(strikes), dtype=F64),
            torch.tensor(tile(mats), dtype=F64), torch.tensor(tile(is_call)),
            torch.full((1, n), 5.0, dtype=F64), TCFG)
        st = lm.init_state(torch.zeros(1, 13, dtype=F64), n + 2,
                           LMConfig())
        status = torch.zeros(1, dtype=torch.int32)
        trip = obj.bind_trip(st, LMConfig(), status, False)
        assert (trip is not None) == fused and (n + 2 <= lm.MAX_FUSED_ROWS) \
            == fused
    x0 = torch.tensor(np.log([[TRUE[k] if k not in ("rho1", "rho2", "mu_j")
                               else 0.5 for k in DHParams._fields]]))
    res = lm.lm_minimize_batched(obj, x0, LMConfig(maxiter=1),
                                 jac_fn=obj.jac)
    assert int(res.n_evals[0]) == 2 and bool(torch.isfinite(res.f).all())


def test_fused_work_counts():
    """The fused kernels' work (``ops/opcount.py``): fused K6 is K6 and
    every lane's 13 trial parameters written at float64 and float32 (12
    exp or tanh each); fused K7 reads a live lane's n prices, n market
    prices and 13 parameters at both precisions in place of r_try, and an
    accepting lane's float32 K3 rows in place of j_try. Both are bound
    by bytes at the polish's shape."""
    g = torch.Generator().manual_seed(0)
    st = lm.init_state(torch.zeros(4, 13, dtype=F64), 17, LMConfig())
    st.J.copy_(torch.randn(st.J.shape, generator=g, dtype=F64))
    st.r.copy_(torch.randn(st.r.shape, generator=g, dtype=F64))
    k6, k6f = opcount.lm_open_work(st), opcount.lm_open_fused_work(st)
    assert k6f["bytes"] - k6["bytes"] == 4 * 13 * (8 + 4)
    assert k6f["ops"] - k6["ops"] == 4 * 2 * 12
    st.cost[:] = 1.0
    for r, accepting in ((torch.zeros(4, 17, dtype=F64), 4),
                         (torch.ones(4, 17, dtype=F64), 0)):
        k7, k7f = (opcount.lm_update_work(st, r),
                   opcount.lm_update_fused_work(st, r, 15))
        assert k7f["bytes"] - k7["bytes"] == (
            4 * (2 * 15 * 8 + 13 * (8 + 4) - 17 * 8)
            + accepting * (15 * 13 * 4 - 17 * 13 * 8))
        assert opcount.bound_ms(k7f, F64)[1] == "bytes"
    assert opcount.bound_ms(k6f, F64)[1] == "bytes"
