"""The LM trip split at its evaluation (K6 ``lm_open``, K7 ``lm_update``)
on the CPU, where the wrappers run the plain versions.

  * the engine over the plain pair against the JAX package's
    ``lm_minimize_batched`` on seeded lanes, m in {6, 17} and d in {4, 13},
    in six cases whose lanes between them take every branch (counted by
    ``tools/lm_trip_check.py::coverage_run``): accept and reject, gconv,
    fconv on an accepted and on a rejected step, xconv from the rejection
    side, tconv with cost_target > 0, give_up at lambda_max, maxiter, a
    damped matrix with no factor (a NaN in J; a negative pivot), non-finite
    residuals and a lam0 warm start. Counts and flags are equal; x, f and
    lam agree to rtol 1e-9 (the two Cholesky factors round differently,
    so the steps differ in their last bits and that grows little over a
    few trips of well-conditioned 4- and 13-column problems). The
    converging case stops at ftol 1e-8 and gtol 1e-5, so that its last
    decision is taken far above rounding: a trip whose cost decrease is at
    rounding level accepts or rejects on either side's last bit, which
    changes lam fiftyfold and x by that trip's step;
  * done lanes hold bit for bit over 20 trips, through the pure plain pair
    and through the in-place wrappers;
  * the engine's in-place loop equals a loop over the pure plain pair in
    bits, with one host read a trip;
  * the wrappers reject d > 32, other dtypes, non-contiguous or mismatched
    fields and a bad status word;
  * the seeded random states of ``tools/lm_trip_check.py`` reach every
    branch the card's check holds the kernels to;
  * the state layout in ``csrc/lm_trip.cu`` is the wrappers', the file is
    built with -fmad=false, and K6/K7's byte counts.
The card's tests (tests/test_torch_gpu.py) hold the kernels to the plain
pair.
"""
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from option_pricing_ffn_lbfgs_tpu.ops import levenberg_marquardt as jlm
from option_pricing_ffn_lbfgs_tpu.utils import config as jcfg
from option_pricing_ffn_lbfgs_tpu_torch.ops import kernel_build, opcount
from option_pricing_ffn_lbfgs_tpu_torch.ops import levenberg_marquardt as lm
from option_pricing_ffn_lbfgs_tpu_torch.tools import lm_trip_check
from option_pricing_ffn_lbfgs_tpu_torch.utils import config as tcfg

F64 = torch.float64
CSRC = Path(lm.__file__).resolve().parent.parent / "csrc"

# case -> (LMConfig fields, the branches its lanes must take)
CASES = {
    "converge": (dict(maxiter=30, ftol=1e-8, gtol=1e-5),
                 ("accept", "gconv", "fconv_accept", "no_factor",
                  "fconv_stall")),
    "wall": (dict(xtol=1e-6, maxiter=60),
             ("reject", "xconv_stall", "nonfinite_r", "step_small")),
    "target": (dict(cost_target=1e-6, maxiter=30), ("tconv",)),
    "give_up": (dict(lambda_max=1.0, maxiter=60), ("give_up",)),
    "maxiter": (dict(maxiter=3), ("maxiter",)),
    "negative_pivot": (dict(lambda_min=-10.0, maxiter=8), ("no_factor",)),
}


def _lanes(case, m, d, seed):
    """Per-lane problem data for r(x) = A x - b + c sin(x)[i mod d], plus
    ``jump`` (NaN, or a finite step up) beyond x_0 > wall: (A, b, c, wall,
    jump, x0, lam0, nan_lane)."""
    rng = np.random.default_rng(seed)
    L = 8
    A = rng.normal(size=(L, m, d)) * 10 ** rng.uniform(-0.5, 0.5, (L, 1, d))
    x0 = rng.normal(size=(L, d))
    xs = rng.normal(size=(L, d))
    b = np.einsum("lmd,ld->lm", A, xs)
    b[1::2] += 0.3 * rng.normal(size=(L // 2, m))     # inconsistent lanes
    c = np.where(np.arange(L) % 3 == 2, 0.3, 0.0)
    wall = np.full(L, np.inf)
    jump = np.where(np.arange(L) < 3, np.nan, 1e3)
    lam0 = np.full(L, 1e-3)
    lam0[3] = 10.0                                    # a warm start
    nan_lane = np.zeros(L, bool)
    if case == "converge":
        nan_lane[5] = True
    elif case in ("wall", "give_up"):
        # the optimum beyond a wall at x0: every step across it fails, as
        # a non-finite cost (a stall at once: |inf - f| <= ftol * inf) or a
        # finite one (rejections until the step is below xtol)
        xs[:, 0] = x0[:, 0] + 1.0
        b = np.einsum("lmd,ld->lm", A, xs)
        wall[:6] = x0[:6, 0]
    elif case == "target":
        b[1::2] = np.einsum("lmd,ld->lm", A, xs)[1::2]
    elif case == "maxiter":
        c[:] = 1.5
    elif case == "negative_pivot":
        A[:, :, 1] = A[:, :, 0] * (1 + 1e-3 * rng.normal(size=(L, m)))
        lam0[:4] = -rng.uniform(0.3, 0.9, 4)
    return A, b, c, wall, jump, x0, lam0, nan_lane


def _fns(xp, data, m, d):
    """(residual_fn, jac_fn) over the namespace ``xp`` (jnp or torch)."""
    A, b, c, wall, jump, _, _, nan_lane = (xp.asarray(a) for a in data)
    idx = np.arange(m) % d
    pick = xp.asarray((idx[:, None] == np.arange(d)[None, :]) * 1.0)
    nan_entry = xp.asarray(np.zeros((m, d)) + np.where(
        (np.arange(m)[:, None] == 0) & (np.arange(d)[None, :] == 0),
        np.nan, 0.0))

    def residual_fn(x):
        r = (xp.einsum("lmd,ld->lm", A, x) - b
             + c[:, None] * xp.sin(x)[:, idx])
        return xp.where((x[:, 0] > wall)[:, None], r + jump[:, None], r)

    def jac_fn(x):
        J = A + c[:, None, None] * xp.cos(x)[:, None, :] * pick[None]
        return xp.where(nan_lane[:, None, None], J + nan_entry[None], J)
    return residual_fn, jac_fn


class _T:                                   # the numpy-like torch namespace
    asarray = staticmethod(torch.tensor)
    einsum = staticmethod(torch.einsum)
    sin = staticmethod(torch.sin)
    cos = staticmethod(torch.cos)
    where = staticmethod(torch.where)


@pytest.mark.parametrize("m,d", [(6, 4), (17, 13)])
@pytest.mark.parametrize("case", list(CASES))
def test_plain_pair_matches_jax(case, m, d):
    fields, need = CASES[case]
    data = _lanes(case, m, d, seed=m + d)
    x0, lam0 = data[5], data[6]
    r_j, j_j = _fns(jnp, data, m, d)
    res_j = jax.jit(lambda x, l: jlm.lm_minimize_batched(
        r_j, x, jcfg.LMConfig(**fields), jac_fn=j_j, lam0=l))(
            jnp.asarray(x0), jnp.asarray(lam0))
    r_t, j_t = _fns(_T, data, m, d)
    res_t, counts = lm_trip_check.coverage_run(
        r_t, j_t, torch.tensor(x0), tcfg.LMConfig(**fields),
        torch.tensor(lam0))
    for branch in need:
        assert counts[branch] > 0, (branch, dict(counts))
    for field in ("n_iters", "n_evals", "converged"):
        np.testing.assert_array_equal(getattr(res_t, field).numpy(),
                                      np.asarray(getattr(res_j, field)),
                                      err_msg=field)
    np.testing.assert_allclose(res_t.x.numpy(), np.asarray(res_j.x),
                               rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(res_t.f.numpy(), np.asarray(res_j.f),
                               rtol=1e-9, atol=1e-20)
    np.testing.assert_allclose(res_t.lam.numpy(), np.asarray(res_j.lam),
                               rtol=1e-12)
    if case == "negative_pivot":             # those lanes never move
        np.testing.assert_array_equal(res_t.x.numpy()[:4], x0[:4])


@pytest.mark.parametrize("route", ["pure", "in_place"])
def test_done_lanes_hold_over_20_trips(route):
    """Lanes done before the first trip keep every field bit for bit over
    20 trips; the other lanes move."""
    cfg = tcfg.LMConfig(maxiter=1000, ftol=-1.0, gtol=-1.0, xtol=-1.0,
                        lambda_max=float("inf"))
    st, r_try, j_try = lm_trip_check.random_state(48, F64, "cpu", 5, cfg)
    n = st.x.shape[0]
    st = st._replace(done=torch.arange(n) % 3 == 0,
                     n_iters=torch.zeros(n, dtype=torch.int32),
                     cost=torch.full((n,), float("inf"), dtype=F64),
                     lam=torch.full((n,), 1e-3, dtype=F64))
    before = lm_trip_check.clone_state(st)
    A = torch.tensor(np.random.default_rng(6).normal(size=(n, 17, 13)))
    residual = lambda x: torch.einsum("lmd,ld->lm", A, x) - 1.0
    status = torch.zeros(1, dtype=torch.int32)
    for _ in range(20):
        if route == "pure":
            st, x_try = lm.lm_open_plain(st, cfg)
            st = lm.lm_update_plain(st, x_try, residual(x_try), A, cfg)
        else:
            x_try = lm.lm_open(st, cfg, status)
            lm.lm_update(st, x_try, residual(x_try), A, cfg, status)
            assert lm.read_live(status) == int((~st.done).sum())
    done = before.done
    for name, a, b in zip(lm._State._fields, before, st):
        assert not lm_trip_check._bits_differ(a[done], b[done]).any(), name
    assert bool((st.n_evals[~done] == before.n_evals[~done] + 20).all())
    assert not torch.equal(st.x[~done], before.x[~done])


def test_wrappers_equal_pure_plain_pair(monkeypatch):
    """The engine's in-place loop on the CPU (the wrappers' plain route)
    equals a loop over the pure plain pair, in bits, with the live count
    read once a trip and no kernel launched; x0 is not written."""
    data = _lanes("converge", 17, 13, seed=3)
    r_t, j_t = _fns(_T, data, 17, 13)
    x0 = torch.tensor(data[5])
    cfg = tcfg.LMConfig(maxiter=25)
    reads = []
    monkeypatch.setattr(lm, "read_live", lambda s: reads.append(1)
                        or int(s.item()))
    before = dict(lm.LAUNCHES)
    got = lm.lm_minimize_batched(r_t, x0, cfg, jac_fn=j_t)
    assert lm.LAUNCHES == before
    st = lm.init_state(x0, 17, cfg)
    r0, trips = r_t(x0), 0
    while bool((~st.done).any()):
        st, x_try = lm.lm_open_plain(st, cfg)
        st = lm.lm_update_plain(st, x_try, r0 if trips == 0 else r_t(x_try),
                                j_t(x_try), cfg)
        trips += 1
    for name in ("x", "r", "cost", "lam", "n_iters", "n_evals",
                 "converged"):
        want = getattr(st, name)
        have = getattr(got, "f" if name == "cost" else name)
        assert not lm_trip_check._bits_differ(have, want).any(), name
    assert trips == int(got.n_evals.max()) == len(reads)
    assert torch.equal(x0, torch.tensor(data[5]))


@pytest.mark.parametrize("fault", ["int64_counter", "float16", "strided_J",
                                   "d_too_wide", "rows_mismatch",
                                   "short_status", "int64_status",
                                   "x_try_shape"])
def test_wrappers_reject_what_the_kernels_do_not_take(fault):
    """The wrappers check dtype, shape and contiguity of every field, d,
    the evaluation's tensors and the status word before dispatching, on
    the CPU as on the card."""
    cfg = lm_trip_check.TRIP_CONFIG
    st, r_try, j_try = lm_trip_check.random_state(4, F64, "cpu", 1, cfg)
    status = torch.zeros(1, dtype=torch.int32)
    x_try = st.x.clone()
    if fault == "int64_counter":
        st = st._replace(n_iters=st.n_iters.long())
    elif fault == "float16":
        st = lm.init_state(torch.zeros(4, 13, dtype=torch.float16), 17, cfg)
    elif fault == "strided_J":
        st = st._replace(J=st.J.transpose(1, 2).contiguous().transpose(1, 2))
    elif fault == "d_too_wide":
        st = lm.init_state(torch.zeros(4, lm.MAX_DIM + 1, dtype=F64), 17,
                           cfg)
    elif fault == "rows_mismatch":
        st = st._replace(r=st.r[:, :16].contiguous())
    elif fault == "short_status":
        status = torch.zeros(0, dtype=torch.int32)
    elif fault == "int64_status":
        status = torch.zeros(1, dtype=torch.int64)
    with pytest.raises(ValueError):
        if fault == "x_try_shape":
            lm.lm_update(st, x_try[:, :12], r_try, j_try, cfg, status)
        else:
            lm.lm_open(st, cfg, status)


@pytest.mark.parametrize("dt", [F64, torch.float32], ids=["double", "float"])
def test_random_states_reach_every_branch(dt):
    """tools/lm_trip_check.py's states at 1536 lanes (the card's check):
    the in-place route agrees with the pure plain pair in bits, and every
    branch is taken, a negative pivot among the lanes without a factor."""
    rep = lm_trip_check.check_trip(1536, dt, "cpu", 1543)
    assert rep["ok"] and rep["done_lanes_changed"] == 0, rep
    for branch in lm_trip_check.BRANCHES:
        assert rep["coverage"][branch] > 0, branch
    st, _, _ = lm_trip_check.random_state(1536, dt, "cpu", 1543)
    negative = ~st.done & (st.lam < 0)
    _, ok = lm.cholesky(lm.damped_normal_equations(st.J, st.r, st.lam)[0])
    assert int((negative & ~ok & ~torch.isnan(st.J).flatten(1).any(-1))
               .sum()) > 0


def test_kernel_state_layout_matches_wrappers():
    """csrc/lm_trip.cu unpacks the pointers in _State's field order, with
    the wrappers' element types."""
    src = (CSRC / "lm_trip.cu").read_text()
    body = src[src.index("State<T> unpack"):src.index("return s;")]
    order = re.findall(r"s\.(\w+) = static_cast<([\w ]+)\*>", body)
    assert [n for n, _ in order] == list(lm._State._fields)
    ctype = {"t": "T", "i": "int", "b": "unsigned char"}
    assert [c for _, c in order] == [ctype[k] for _, k in lm._LAYOUT.values()]


def test_trip_file_built_without_fma(monkeypatch, tmp_path):
    """The nvcc command of csrc/lm_trip.cu carries -fmad=false, as
    csrc/lbfgs_trip.cu's does, and the pricers' do not."""
    cmds = {}

    class Proc:
        def __init__(self, cmd, **kw):
            cmds[Path(cmd[-1]).stem] = cmd
    monkeypatch.setattr(kernel_build, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(kernel_build, "BUILD", tmp_path)
    monkeypatch.setattr(kernel_build.subprocess, "Popen", Proc)
    for name in ("lm_trip", "lbfgs_trip", "cos_price"):
        kernel_build._start(name)
    assert "-fmad=false" in cmds["lm_trip"]
    assert "-fmad=false" in cmds["lbfgs_trip"]
    assert "-fmad=false" not in cmds["cos_price"]


def test_trip_work_counts():
    """K6/K7 bytes: a done lane reads its flag and x and writes x_try (K6)
    or reads its flag (K7); a live lane's K6 bytes grow by d + 1 values per
    residual row; an accepting lane's K7 bytes by its copies. Both are
    bound by bytes at the polish's shapes."""
    cfg = tcfg.LMConfig()
    st = lm.init_state(torch.zeros(4, 13, dtype=F64), 17, cfg)
    st.done[:] = True
    r = torch.zeros(4, 17, dtype=F64)
    assert opcount.lm_open_work(st)["bytes"] == 4 * (1 + 2 * 13 * 8) + 4
    assert opcount.lm_update_work(st, r)["bytes"] == 4 + 4
    st.done[:] = False
    st.J.normal_()
    st.r.normal_()
    w17 = opcount.lm_open_work(st)
    st18 = lm.init_state(torch.zeros(4, 13, dtype=F64), 18, cfg)
    st18.J.normal_()
    st18.r.normal_()
    w18 = opcount.lm_open_work(st18)
    assert w18["bytes"] - w17["bytes"] == 4 * (13 + 1) * 8
    st.cost[:] = 1.0
    rejected = opcount.lm_update_work(st, r + 1.0)
    accepted = opcount.lm_update_work(st, r)
    # x_try read and x written, j_try read and J written, r written
    assert accepted["bytes"] - rejected["bytes"] == 4 * (
        2 * (13 * 8 + 17 * 13 * 8) + 17 * 8)
    for w in (w17, accepted):
        assert opcount.bound_ms(w, F64)[1] == "bytes"
