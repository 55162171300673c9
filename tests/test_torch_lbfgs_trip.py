"""The L-BFGS trip split at its evaluation (K4 ``lbfgs_open``, K5
``lbfgs_update``) on the CPU, where the wrappers run the plain versions.

  * the plain two-loop direction against the JAX package's
    ``_two_loop_direction_batched`` at float64, rtol 1e-12 (the same
    products and sums over 13 coordinates; only the summation order may
    differ), on histories with hist_len 0..10, wrapped heads and rho over
    1e-3..1e3;
  * done lanes, starting ones included, keep every field bit for bit over
    20 trips, through the pure plain pair and through the in-place
    wrappers;
  * non-finite values and gradient entries are treated as the JAX
    engine's ``safe_vg`` treats them: the update equals the update on the
    sanitised evaluation in bits, and a whole run on an objective that
    returns NaN values and infinite gradient entries walks JAX's path
    (equal counts, x to 1e-9 as tests/test_torch_optim.py holds the
    engine after 10 trips);
  * the in-place wrappers equal the pure plain pair in bits and count the
    live lanes; a corrupt circular index raises naming its lane;
  * the seeded random states of ``tools/trip_check.py`` reach every branch
    the card's check holds the kernels to;
  * the kernels' state layout in ``csrc/lbfgs_trip.cu`` is the wrappers',
    the file is built with -fmad=false, and K4/K5's byte counts.
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

from option_pricing_ffn_lbfgs_tpu.ops import lbfgs_batched as jlb
from option_pricing_ffn_lbfgs_tpu.utils import config as jcfg
from option_pricing_ffn_lbfgs_tpu_torch.ops import kernel_build, opcount
from option_pricing_ffn_lbfgs_tpu_torch.ops import lbfgs_batched as lb
from option_pricing_ffn_lbfgs_tpu_torch.tools import trip_check
from option_pricing_ffn_lbfgs_tpu_torch.utils import config as tcfg

F64 = torch.float64
CSRC = Path(lb.__file__).resolve().parent.parent / "csrc"


def _history(seed, L=33, m=10, d=13):
    """Random histories: hist_len cycling 0..m, heads in [0, m) (wrapped
    where head < hist_len), s . y = 1 / rho over 1e-3..1e3."""
    rng = np.random.default_rng(seed)
    s = rng.normal(size=(L, m, d)) * 10 ** rng.uniform(-2, 0, (L, m, 1))
    y = s * rng.uniform(0.2, 5.0, (L, m, d))
    curv = 10 ** rng.uniform(-3, 3, (L, m))
    y *= (curv / (s * y).sum(-1))[..., None]
    return dict(g=rng.normal(size=(L, d)), s_hist=s, y_hist=y,
                rho_hist=1 / curv, hist_len=np.arange(L) % (m + 1),
                head=rng.integers(0, m, L), gamma=10 ** rng.uniform(-1, 1, L))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_two_loop_matches_jax(seed):
    h = _history(seed)
    assert np.any(h["head"] < h["hist_len"])          # wrapped heads
    args = ("g", "s_hist", "y_hist", "rho_hist", "hist_len", "head", "gamma")
    ints = ("hist_len", "head")
    got = lb._two_loop_direction(*(
        torch.tensor(h[k], dtype=torch.int32 if k in ints else F64)
        for k in args))
    want = jax.jit(jlb._two_loop_direction_batched)(*(
        jnp.asarray(h[k], dtype=jnp.int32 if k in ints else jnp.float64)
        for k in args))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12,
                               atol=0)
    empty = h["hist_len"] == 0                        # d = -gamma g
    np.testing.assert_array_equal(
        got.numpy()[empty], -(h["gamma"][:, None] * h["g"])[empty])


def _quadratic_vg(L, d, seed):
    """Per lane f = 0.5 sum_i a_i (x_i - c_i)^2 + 0.1 (x . x)^2 / d."""
    rng = np.random.default_rng(seed)
    a = torch.tensor(10 ** rng.uniform(-1, 1, (L, d)))
    c = torch.tensor(rng.normal(size=(L, d)))

    def vg(x):
        r = x - c
        xx = (x * x).sum(-1, keepdim=True)
        f = 0.5 * (a * r * r).sum(-1) + 0.1 * xx[:, 0] ** 2 / d
        return f, a * r + 0.4 * xx * x / d
    return vg


@pytest.mark.parametrize("route", ["pure", "in_place"])
def test_done_lanes_hold_over_20_trips(route):
    """Lanes done before the first trip (a third of them also starting)
    keep every field bit for bit over 20 trips; the other lanes move."""
    cfg = trip_check.TRIP_CONFIG
    st, _, _ = trip_check.random_state(64, F64, "cpu", 5, cfg)
    st = st._replace(done=torch.arange(64) % 3 == 0,
                     starting=torch.arange(64) % 2 == 0,
                     n_iters=torch.zeros(64, dtype=torch.int32),
                     n_evals=torch.zeros(64, dtype=torch.int32))
    assert bool((st.done & st.starting).any())
    before = trip_check.clone_state(st)
    vg = _quadratic_vg(64, 13, 6)
    status = torch.zeros(2, dtype=torch.int32)
    for _ in range(20):
        if route == "pure":
            st, x_try = lb.lbfgs_open_plain(st, cfg)
            st = lb.lbfgs_update_plain(st, x_try, *vg(x_try), cfg)
        else:
            x_try = lb.lbfgs_open(st, cfg, status)
            lb.lbfgs_update(st, x_try, *vg(x_try), cfg, status)
            assert lb.read_live(status) == int((~st.done).sum())
    done = before.done
    for name, a, b in zip(lb._BState._fields, before, st):
        assert torch.equal(a[done], b[done]), name
    assert int((st.n_evals[~done] == 20).sum()) > 0
    assert not torch.equal(st.x[~done], before.x[~done])


def test_update_sanitises_like_safe_vg():
    """Non-finite f_try counts as +inf and non-finite gradient entries as
    0: the update equals the update on the sanitised evaluation, in bits."""
    st, f_try, g_try = trip_check.random_state(256, F64, "cpu", 9)
    st, x_try = lb.lbfgs_open_plain(st, trip_check.TRIP_CONFIG)
    assert not bool(torch.isfinite(f_try).all())
    assert not bool(torch.isfinite(g_try).all())
    clean_f = torch.where(torch.isfinite(f_try), f_try,
                          torch.full_like(f_try, float("inf")))
    clean_g = torch.where(torch.isfinite(g_try), g_try,
                          torch.zeros_like(g_try))
    a = lb.lbfgs_update_plain(st, x_try, f_try, g_try,
                              trip_check.TRIP_CONFIG)
    b = lb.lbfgs_update_plain(st, x_try, clean_f, clean_g,
                              trip_check.TRIP_CONFIG)
    for name, u, v in zip(lb._BState._fields, a, b):
        assert torch.equal(u, v), name
    assert bool(torch.isinf(a.f_prev).any())


@pytest.mark.parametrize("fault", ["nan_value", "inf_gradient"])
def test_nonfinite_objective_matches_jax(fault):
    """A whole run on a per-lane quadratic that returns a NaN value beyond
    x_0 > 1.2 (``nan_value``) or an infinite gradient entry beyond x_1 <
    -0.8 (``inf_gradient``), from starts on both sides: the port and the
    JAX engine take the same decisions and reach the same points."""
    L, d = 6, 4
    rng = np.random.default_rng(11)
    a = 10 ** rng.uniform(-0.5, 0.5, (L, d))
    c = rng.normal(scale=0.5, size=(L, d))
    x0 = rng.normal(size=(L, d))
    x0[:3, 0] = [1.5, 2.0, 0.5]
    x0[3:, 1] = [-1.5, -1.0, 0.0]

    def make(xp, where, inf):
        def vg(x):
            r = x - xp.asarray(c)
            f = 0.5 * (xp.asarray(a) * r * r).sum(-1)
            g = xp.asarray(a) * r
            if fault == "nan_value":
                f = where(x[:, 0] > 1.2, f * np.nan, f)
            else:
                g = where((x[:, 1] < -0.8)[:, None]
                          & (xp.arange(d) == 2)[None, :], g * inf, g)
            return f, g
        return vg

    cfg_j, cfg_t = jcfg.LBFGSConfig(maxeval=30), tcfg.LBFGSConfig(maxeval=30)
    res_j = jax.jit(lambda x: jlb.lbfgs_minimize_batched(
        make(jnp, jnp.where, jnp.inf), x, cfg_j))(jnp.asarray(x0))

    class T:                                   # numpy-like torch namespace
        asarray = staticmethod(torch.tensor)
        arange = staticmethod(torch.arange)
    res_t = lb.lbfgs_minimize_batched(make(T, torch.where, float("inf")),
                                      torch.tensor(x0), cfg_t)
    for field in ("n_evals", "n_iters", "converged"):
        np.testing.assert_array_equal(getattr(res_t, field).numpy(),
                                      np.asarray(getattr(res_j, field)))
    np.testing.assert_allclose(res_t.x.numpy(), np.asarray(res_j.x),
                               rtol=1e-9, atol=1e-12)
    assert int(res_t.n_evals.max()) > 5


def test_wrappers_equal_pure_plain_pair():
    """The engine's in-place loop on the CPU (the wrappers' plain route)
    equals a loop over the pure plain pair, in bits, with the live count
    read from the status word on every trip."""
    L, d = 24, 13
    vg = _quadratic_vg(L, d, 3)
    x0 = torch.tensor(np.random.default_rng(4).normal(size=(L, d)))
    cfg = tcfg.LBFGSConfig(maxeval=40)
    before = dict(lb.LAUNCHES)
    got = lb.lbfgs_minimize_batched(vg, x0, cfg)
    assert lb.LAUNCHES == before                # no kernel on the CPU
    st = lb.init_state(x0, cfg.history)
    trips = 0
    while bool((~st.done).any()):
        st, x_try = lb.lbfgs_open_plain(st, cfg)
        st = lb.lbfgs_update_plain(st, x_try, *vg(x_try), cfg)
        trips += 1
    for name in ("x", "f", "g", "n_iters", "n_evals", "converged"):
        assert torch.equal(getattr(got, "grad" if name == "g" else name),
                           getattr(st, name)), name
    assert trips == int(got.n_evals.max())
    assert torch.equal(x0, torch.tensor(np.random.default_rng(4).normal(
        size=(L, d))))                         # x0 is not written


@pytest.mark.parametrize("field,value", [("head", -1), ("head", 10),
                                         ("hist_len", 11)])
def test_corrupt_history_index_raises_with_lane(field, value):
    """A lane that is not done with head outside [0, m) or hist_len
    outside [0, m] sets the error word; the loop's read raises naming the
    lane. The same value on a done lane is not looked at."""
    cfg = trip_check.TRIP_CONFIG
    st, f_try, g_try = trip_check.random_state(8, F64, "cpu", 2, cfg)
    st.done[:] = False
    st.done[1] = True
    getattr(st, field)[1] = value
    status = torch.zeros(2, dtype=torch.int32)
    x_try = lb.lbfgs_open(st, cfg, status)
    lb.lbfgs_update(st, x_try, f_try, g_try, cfg, status)
    assert lb.read_live(status) == int((~st.done).sum())
    getattr(st, field)[5] = value
    lb.lbfgs_open(st, cfg, status)
    assert int(status[1]) == 6
    with pytest.raises(RuntimeError, match="lane 5"):
        lb.read_live(status)


def test_random_states_reach_every_branch():
    """tools/trip_check.py's states at 1536 lanes (the card's check): the
    plain route agrees with itself, and every branch is taken."""
    rep = trip_check.check_trip(1536, F64, "cpu", 1543)
    assert rep["ok"] and rep["done_lanes_changed"] == 0
    cov = rep["coverage"]
    assert cov["opening_hist_len"] == list(range(11))
    for key in ("done", "done_and_starting", "opening",
                "opening_wrapped_head", "bootstrap", "in_zoom",
                "pairs_stored", "resets", "newly_done", "converged",
                "nonfinite_f", "nonfinite_g"):
        assert cov[key] > 0, key
    assert all(v > 0 for v in cov["stage_after"].values())


def test_kernel_state_layout_matches_wrappers():
    """csrc/lbfgs_trip.cu unpacks the pointers in _BState's field order,
    with the wrappers' element types."""
    src = (CSRC / "lbfgs_trip.cu").read_text()
    body = src[src.index("State<T> unpack"):src.index("return s;")]
    order = re.findall(r"s\.(\w+) = static_cast<([\w ]+)\*>", body)
    assert [n for n, _ in order] == list(lb._BState._fields)
    ctype = {"t": "T", "i": "int", "b": "unsigned char"}
    assert [c for _, c in order] == [ctype[k] for _, k in lb._LAYOUT.values()]


def test_trip_file_built_without_fma(monkeypatch, tmp_path):
    """The nvcc command of csrc/lbfgs_trip.cu carries -fmad=false, and no
    other file's does."""
    cmds = {}

    class Proc:
        def __init__(self, cmd, **kw):
            cmds[Path(cmd[-1]).stem] = cmd
    monkeypatch.setattr(kernel_build, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(kernel_build, "BUILD", tmp_path)
    monkeypatch.setattr(kernel_build.subprocess, "Popen", Proc)
    for name in ("lbfgs_trip", "cos_vg"):
        kernel_build._start(name)
    assert "-fmad=false" in cmds["lbfgs_trip"]
    assert "-fmad=false" not in cmds["cos_vg"]


def test_trip_work_counts():
    """K4/K5 bytes: a done lane reads its flag and x and writes x_try (K4)
    or reads its flag (K5); an opening lane's K4 bytes grow by one
    history pair, 2d + 1 values, per unit of hist_len."""
    st = lb.init_state(torch.zeros(4, 13, dtype=F64), 10)
    st.done[:] = True
    assert opcount.lbfgs_open_work(st)["bytes"] == 4 * (1 + 2 * 13 * 8) + 4
    assert opcount.lbfgs_update_work(st, st)["bytes"] == 4 + 4
    st.done[:] = False
    st.starting[:] = True
    w0 = opcount.lbfgs_open_work(st)
    st.hist_len[0] = 3
    w3 = opcount.lbfgs_open_work(st)
    assert w3["bytes"] - w0["bytes"] == 3 * (2 * 13 + 1) * 8
    for w in (w0, w3):
        assert opcount.bound_ms(w, F64)[1] == "bytes"
    # The fused modes: K4 also writes params_try on every lane; K5 reads
    # price and mkt (n_opt each), g_price and params_try instead of f_try
    # and g_try on a live lane, and nothing more on a done one.
    assert (opcount.lbfgs_open_work(st, fused=True)["bytes"]
            - w3["bytes"]) == 4 * 13 * 8
    live = opcount.lbfgs_update_work(st, st)
    fused = opcount.lbfgs_update_work(st, st, n_opt=15)
    assert fused["bytes"] - live["bytes"] == 4 * (2 * 15 + 13 - 1) * 8
    assert fused["ops"] > live["ops"]
    st.done[:] = True
    assert opcount.lbfgs_update_work(st, st, n_opt=15)["bytes"] == 4 + 4
    assert opcount.bound_ms(fused, F64)[1] == "bytes"


@pytest.mark.parametrize("fault", ["int64_head", "float16", "strided_g",
                                   "d_too_wide", "short_status"])
def test_wrappers_reject_what_the_kernels_do_not_take(fault):
    """The wrappers check dtype, shape and contiguity of every field, d and
    the status word before dispatching, on the CPU as on the card."""
    cfg = trip_check.TRIP_CONFIG
    st, _, _ = trip_check.random_state(4, F64, "cpu", 1, cfg)
    status = torch.zeros(2, dtype=torch.int32)
    if fault == "int64_head":
        st = st._replace(head=st.head.long())
    elif fault == "float16":
        st = lb.init_state(torch.zeros(4, 13, dtype=torch.float16), 10)
    elif fault == "strided_g":
        st = st._replace(g=torch.zeros(13, 4, dtype=F64).t())
    elif fault == "d_too_wide":
        st = lb.init_state(torch.zeros(4, lb.MAX_DIM + 1, dtype=F64), 10)
    else:
        status = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError):
        lb.lbfgs_open(st, cfg, status)
