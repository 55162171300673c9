"""K6/K7 (the LM trip, ``csrc/lm_trip.cu``) against their plain versions,
on seeded random states and on whole runs of the engine.

    random_state(n_lanes, dtype, device, seed, config, m, d)
        -> (st, r_try, j_try)
    random_fused(n_lanes, device, seed, config) -> (st, trial)
    check_trip(n_lanes, dtype, device, seed, config) -> report
    check_trip_fused(n_lanes, device, seed, config) -> report
    check_engine(residual_fn, jac_fn, x0, config, lam0) -> report
    route_check(objective, x0, config, lam0) -> report
    coverage_run(residual_fn, jac_fn, x0, config, lam0) -> (result, counts)
    polish_objective(n_surfaces, seed, device) -> (objective, x0)
    polish_lanes(n_surfaces, seed, device) -> (residual_fn, jac_fn, x0)
    trip_ms(residual_fn, jac_fn, x0, config) -> report (the card only)
    steady_trip_ms(residual_fn, jac_fn, x0) -> report (the card only)

``random_state`` draws every field of ``ops/levenberg_marquardt.py::
_State`` with numpy from ``seed``, lane ``i`` of kind ``i % 13`` (then
varied by the draws): a plain live lane; a bootstrap lane (NaN residuals,
zero Jacobian, infinite cost); a done lane (with a NaN in its Jacobian);
lanes set up for gconv, fconv on an accepted step, fconv on a rejected
step (equal costs), xconv from the rejection side, tconv, give_up at
lambda_max, maxiter; a NaN in the Jacobian; a negative damping over two
nearly equal columns (a negative pivot); non-finite trial residuals.

``random_fused`` adds to a double ``random_state`` (m = 17, d = 13) what
the fused K7 assembles the evaluation from (``LMFusedTrial``): market
prices, K1 prices that give about the state's trial residuals, with a
non-positive or non-finite price on some lanes (the sentinel); seeded K3
rows with a NaN or an infinity on some lanes; trial parameters with each
variance factor above, below and exactly on its Feller bound at both
precisions, a correlation past 1 (a negative chain-rule factor, so zeros
change sign) and an overflowing sigma on the non-finite lanes; the costs
set from the assembled residuals by lane kind as ``random_state`` sets
them.

``check_trip`` runs one trip both ways from the same state: K6 against
``lm_open_plain``, then K7 against ``lm_update_plain`` from the
plain-opened state (so each kernel is held on its own inputs), and
reports per field the entries whose bits differ (any NaN equals any NaN),
the largest absolute difference, the lanes done before the trip that
changed, the live counts, and how many lanes took each branch
(``branches``). ``check_trip_fused`` does the same for fused K6 (on the
bootstrap trip and after it) against ``lm_open_fused_plain`` and fused K7
against ``lm_update_fused_plain``, through ``LMTripKernels``, and counts
the assembly's branches too. ``check_engine`` runs the engine to its end
with the kernels and with the plain pair (``ops/levenberg_marquardt.py::
_run``): on the polish's objective that is the fused trip and its plain
pair. ``route_check`` runs the objective's fused trip against the unfused
trip around its host assembly. On CPU tensors the wrappers run the plain
versions, so there the checks hold the plain versions' in-place wrappers
to the pure ones. ``polish_objective`` builds the polish's objective
(K1<double> residuals, the K3 Jacobian) over surfaces priced at seeded
truths, from the starts of ``initial_guesses``, and ``polish_lanes`` its
unfused ``(residual_fn, jac_fn)``; ``trip_ms`` times the engine's trip on
either against its evaluation alone (CUDA events), ``steady_trip_ms`` one
bound trip in a steady state: with its read, the host's issue alone, and
the device time by kernel.

Measurement only: no calibration path imports this module.
"""
from __future__ import annotations

import re
import time
from collections import Counter

import numpy as np
import torch

from ..calibration import calibrator
from ..calibration.initial_guess import initial_guesses
from ..data.synthetic import RANGE_HI, RANGE_LO
from ..ops import levenberg_marquardt as lm
from ..ops.cos_kernel import price_surfaces
from ..ops.loss_kernel import (EXP_MASK, FELLER_IDX, TANH_MASK,
                               polish_assembly_plain)
from ..utils.config import CalibrationConfig, LMConfig
from ..utils.timing import CudaTimer, device_entries, profile_complete

# cost_target > 0 so that tconv can fire; maxiter near the drawn counters.
TRIP_CONFIG = LMConfig(maxiter=20, cost_target=1e-10)
N_KINDS = 13
BRANCHES = ("accept", "reject", "step_small", "xconv_stall", "fconv_accept",
            "fconv_stall", "gconv", "tconv", "give_up", "bootstrap",
            "maxiter", "no_factor", "nonfinite_r", "newly_done")


def random_state(n_lanes: int, dtype, device, seed: int,
                 config: LMConfig = TRIP_CONFIG, m: int = 17, d: int = 13):
    """A seeded state entering a trip and that trip's evaluation:
    ``(st, r_try [L, m], j_try [L, m, d])``."""
    rng = np.random.default_rng(seed)
    L = n_lanes
    kind = (np.arange(L) + rng.integers(0, N_KINDS)) % N_KINDS
    u = lambda lo, hi, *shape: rng.uniform(lo, hi, shape or (L,))
    x = rng.normal(size=(L, d)) * 10 ** u(-1, 1, L, 1)
    J = rng.normal(size=(L, m, d)) * 10 ** u(-2, 1, L, 1, d)
    r = rng.normal(size=(L, m)) * 10 ** u(-3, 0, L, 1)
    lam = 10 ** u(-6, 2)
    r_try = rng.normal(size=(L, m)) * 10 ** u(-3, 0, L, 1)
    j_try = rng.normal(size=(L, m, d))
    cost_try = (r_try ** 2).sum(-1)
    cost = cost_try * 10 ** u(-0.3, 0.3)          # accept and reject
    n_iters = rng.integers(0, config.maxiter, L)
    done = np.zeros(L, bool)
    is_ = lambda k: kind == k

    boot = is_(1)                                 # the engine's first trip
    r[boot], J[boot], cost[boot] = np.nan, 0.0, np.inf
    n_iters[boot] = 0
    done[is_(2)] = True                           # held, NaN and all
    J[is_(2), 0, 0] = np.nan
    r[is_(3)] *= 1e-12                            # gconv
    J[is_(3)] = rng.normal(size=(int(is_(3).sum()), m, d))
    small = 1e-5 if dtype == torch.float64 else 3e-5
    r_try[is_(4)] *= small / np.sqrt(m)           # fconv on an accept
    cost_try[is_(4)] = (r_try[is_(4)] ** 2).sum(-1)
    cost[is_(4)] = cost_try[is_(4)] * (1 + 1e-7)
    r[is_(6)] *= 1e-6 / np.abs(r[is_(6)]).max(-1, keepdims=True)
    lam[is_(6)] = 10 ** u(5, 7)[is_(6)]           # xconv from rejection
    cost[is_(6)] = cost_try[is_(6)] * 0.5
    r_try[is_(7)] *= 1e-7                         # tconv
    cost[is_(7)] = 1.0
    lam[is_(8)] = 10 ** u(7.05, 7.9)[is_(8)]      # give_up
    cost[is_(8)] = cost_try[is_(8)] * 0.5
    n_iters[is_(9)] = config.maxiter              # maxiter
    J[is_(10), rng.integers(0, m), rng.integers(0, d)] = np.nan
    near = is_(11)                                # a negative pivot
    J[near, :, 1] = J[near, :, 0] * (1 + 1e-3 * rng.normal(size=(
        int(near.sum()), m)))
    lam[near] = -u(0.3, 0.9)[near]
    bad = is_(12)                                 # non-finite residuals
    r_try[bad, rng.integers(0, m, int(bad.sum()))] = rng.choice(
        [np.nan, np.inf, -np.inf], int(bad.sum()))
    t = lambda a, kind_=dtype: torch.tensor(np.asarray(a), dtype=kind_,
                                            device=device)
    st = lm._State(
        x=t(x), r=t(r), J=t(J), cost=t(cost), lam=t(lam),
        n_iters=t(n_iters, torch.int32),
        n_evals=t(n_iters + rng.integers(0, 3, L), torch.int32),
        done=t(done, torch.bool), converged=t(rng.random(L) < 0.1,
                                              torch.bool),
        dx_max=t(rng.random(L)), g_max=t(rng.random(L)))
    # the equal-cost lanes (fconv on a rejection): the cost in the dtype
    st.cost[t(is_(5), torch.bool)] = lm.trial_cost(t(r_try))[
        t(is_(5), torch.bool)]
    return st, t(r_try), t(j_try)


def random_fused(n_lanes: int, device, seed: int,
                 config: LMConfig = TRIP_CONFIG, n_opt: int = 15):
    """A seeded double state entering a fused trip (m = n_opt + 2, d = 13)
    and what the fused K7 assembles its evaluation from: ``(st, trial)``,
    ``trial`` an ``LMFusedTrial`` whose buffers hold the inputs."""
    f32, f64 = torch.float32, torch.float64
    m = n_opt + 2
    st, r_try, _ = random_state(n_lanes, f64, device, seed, config, m, 13)
    rng = np.random.default_rng(seed + 1)
    L = n_lanes
    kind = (np.arange(L) + np.random.default_rng(seed).integers(
        0, N_KINDS)) % N_KINDS
    r = r_try.cpu().numpy()
    mkt = rng.uniform(1.0, 20.0, (L, n_opt))
    with np.errstate(invalid="ignore"):
        price = mkt * (1.0 + r[:, :n_opt] * np.sqrt(n_opt))
    sentinel = (np.arange(L) % 11 == 5) & (kind != 7)
    rows = rng.integers(0, n_opt, L)
    price[sentinel, rows[sentinel]] = rng.choice(
        [0.0, -1.0, np.nan, np.inf], int(sentinel.sum()))
    # parameters near the generator's ranges; each factor above, on or
    # below its Feller bound by lane, or at a tie: sigma = 1 - 2^-24 and
    # 2 kappa theta = 1 - 2^-23, whose float products are equal while
    # the exact violation is 2^-48 > 0
    p64 = rng.uniform(RANGE_LO, RANGE_HI, (L, 13))
    for f, (s_, k_, t_) in enumerate(FELLER_IDX):
        case = (np.arange(L) // (1 + 2 * f)) % 4  # above, kink, below, tie
        case[kind == 7] = 2                           # tconv: no Feller row
        p64[:, k_] = 0.5
        p64[:, t_] = np.where(case == 3, 1.0 - 2.0**-23, 1.0)
        p64[:, s_] = np.where(case == 0, 1.0 + 1e-4 * rng.random(L),
                              np.where(case == 1, 1.0,
                                       np.where(case == 3, 1.0 - 2.0**-24,
                                                0.5 + 0.4 * rng.random(L))))
    p64[kind == 12, FELLER_IDX[0][0]] = 1e200         # sigma^2: inf
    with np.errstate(over="ignore"):
        p32 = p64.astype(np.float32)
    p32[::7, 4] = 1.5                                 # 1 - p^2 < 0
    jac = rng.normal(size=(L, n_opt, 13)).astype(np.float32)
    jac[np.arange(L) % 13 == 4, 0, 3] = np.nan
    jac[np.arange(L) % 13 == 9, 1, 8] = np.inf
    t = lambda a, dt: torch.tensor(np.asarray(a), dtype=dt, device=device)
    trial = lm.LMFusedTrial(
        params64=t(p64, f64), params32=t(p32, f32), price=t(price, f64),
        jac=t(jac, f32), mkt=t(mkt, f64), weight=1000.0, bad_loss=1e10,
        exp_mask=EXP_MASK, tanh_mask=TANH_MASK, feller=FELLER_IDX)
    # the costs against the assembled residuals, by kind as random_state
    r_fused, _ = polish_assembly_plain(
        trial.price, trial.jac, trial.mkt, trial.params64, trial.params32,
        trial.weight, trial.bad_loss)
    c_old = lm.trial_cost(r_try)
    c_new = lm.trial_cost(r_fused)
    scale = torch.where(torch.isfinite(c_old) & torch.isfinite(c_new)
                        & (c_old > 0), c_new / c_old,
                        torch.ones_like(c_new))
    keep = t((kind == 1) | (kind == 7), torch.bool)   # bootstrap, tconv
    st.cost.copy_(torch.where(keep, st.cost, st.cost * scale))
    equal = t(kind == 5, torch.bool)
    st.cost[equal] = c_new[equal]
    return st, trial


def clone_state(st):
    return lm._State(*(t.clone() for t in st))


def _bits_differ(a, b):
    """Entries whose bits differ, any NaN equal to any NaN."""
    if not a.is_floating_point():
        return a != b
    ints = {torch.float32: torch.int32, torch.float64: torch.int64}[a.dtype]
    both_nan = torch.isnan(a) & torch.isnan(b)
    return (a.view(ints) != b.view(ints)) & ~both_nan


def compare_states(kern, plain, **extra) -> dict:
    """Per state field, and per ``name=(kernel, plain)`` pair in ``extra``,
    the entries whose bits differ, and the largest absolute difference over
    the entries finite on both sides."""
    pairs = {name: (getattr(kern, name), getattr(plain, name))
             for name in lm._State._fields}
    pairs.update(extra)
    out = {"bits_differ": {}, "max_abs_err": 0.0}
    for name, (a, b) in pairs.items():
        out["bits_differ"][name] = int(_bits_differ(a, b).sum())
        if a.is_floating_point():
            fin = torch.isfinite(a) & torch.isfinite(b)
            if bool(fin.any()):
                out["max_abs_err"] = max(out["max_abs_err"], float(
                    (a[fin] - b[fin]).abs().max()))
    out["ok"] = not any(out["bits_differ"].values())
    return out


def _held(before, after) -> int:
    """Lanes done in ``before`` whose fields changed in ``after`` (bits)."""
    changed = torch.zeros_like(before.done)
    for a, b in zip(before, after):
        diff = _bits_differ(a, b)
        changed |= diff.reshape(diff.shape[0], -1).any(-1)
    return int((changed & before.done).sum())


def branches(st, r_try, config: LMConfig) -> Counter:
    """How many lanes not done take each branch of a trip from ``st`` (a
    state opened by K6 or its plain version) with trial residuals
    ``r_try``; ``no_factor`` is read from the factor of ``st``'s damped
    matrix."""
    live = ~st.done
    tests = lm.stop_tests(st, lm.trial_cost(r_try), config)
    tests["reject"] = ~tests["accept"]
    _, ok = lm.cholesky(lm.damped_normal_equations(st.J, st.r, st.lam)[0])
    tests["no_factor"] = ~ok
    tests["nonfinite_r"] = ~torch.isfinite(r_try).all(-1)
    tests["newly_done"] = tests["done"]
    return Counter({k: int((tests[k] & live).sum()) for k in BRANCHES})


def check_trip(n_lanes: int, dtype, device, seed: int,
               config: LMConfig = TRIP_CONFIG) -> dict:
    """One trip from ``random_state``: K6 and K7 against the plain pair,
    in bits."""
    st0, r_try, j_try = random_state(n_lanes, dtype, device, seed, config)
    status = torch.zeros(1, dtype=torch.int32, device=st0.x.device)
    st_k = clone_state(st0)
    x_k = lm.lm_open(st_k, config, status)
    st_p, x_p = lm.lm_open_plain(st0, config)
    opened = compare_states(st_k, st_p, x_try=(x_k, x_p))

    st_k7 = clone_state(st_p)
    lm.lm_update(st_k7, x_p, r_try, j_try, config, status)
    st_p7 = lm.lm_update_plain(st_p, x_p, r_try, j_try, config)
    updated = compare_states(st_k7, st_p7)
    live_kernel = lm.read_live(status)
    live_plain = int((~st_p7.done).sum())
    held = _held(st0, st_k) + _held(st_p, st_k7)
    return {"lanes": n_lanes, "dtype": str(dtype).replace("torch.", ""),
            "open": opened, "update": updated, "done_lanes_changed": held,
            "live": (live_kernel, live_plain),
            "coverage": dict(branches(st_p, r_try, config)),
            "ok": (opened["ok"] and updated["ok"]
                   and live_kernel == live_plain and held == 0)}


def fused_branches(trial) -> Counter:
    """How many lanes the fused K7's assembly takes each way: the
    sentinel, and each Feller factor above, on and below its bound at
    float64 (the residual rows) and float32 (the Jacobian rows, whose
    violation is evaluated in double: ``feller_violation``), and at a
    float32 tie (the float products equal, the violation positive)."""
    out = Counter()
    out["sentinel"] = int((~(torch.isfinite(trial.price)
                             & (trial.price > 0))).any(-1).sum())
    for name, q in (("64", trial.params64), ("32", trial.params32)):
        for f, (s_, k_, t_) in enumerate(FELLER_IDX):
            v = q[:, s_].double() ** 2 - 2.0 * q[:, k_].double() * q[:, t_]
            out[f"feller{f + 1}_above_{name}"] = int((v > 0).sum())
            out[f"feller{f + 1}_kink_{name}"] = int((v == 0).sum())
            out[f"feller{f + 1}_below_{name}"] = int((v < 0).sum())
            if name == "32":
                tie = (q[:, s_] * q[:, s_] == 2.0 * q[:, k_] * q[:, t_])
                out[f"feller{f + 1}_tie_32"] = int((tie & (v > 0)).sum())
    return out


def check_trip_fused(n_lanes: int, device, seed: int,
                     config: LMConfig = TRIP_CONFIG) -> dict:
    """One fused trip from ``random_fused`` through ``LMTripKernels``:
    fused K6 (after the bootstrap trip and on it) against
    ``lm_open_fused_plain``, then fused K7 against
    ``lm_update_fused_plain`` from the plain-opened state on the seeded
    inputs, in bits."""
    st0, trial = random_fused(n_lanes, device, seed, config)
    status = torch.zeros(1, dtype=torch.int32, device=st0.x.device)
    out = {"lanes": n_lanes, "dtype": "float64"}
    held = 0
    for boot in (False, True):
        st_k = clone_state(st0)
        x_k = torch.empty_like(st_k.x)
        bufs = trial._replace(params64=torch.empty_like(trial.params64),
                              params32=torch.empty_like(trial.params32))
        lm.LMTripKernels(st_k, config, status, x_k, bufs).open(boot)
        st_p, x_p, p64, p32 = lm.lm_open_fused_plain(st0, config, boot)
        out["open_boot" if boot else "open"] = compare_states(
            st_k, st_p, x_try=(x_k, x_p), params64=(bufs.params64, p64),
            params32=(bufs.params32, p32))
        held += _held(st0, st_k)
    st_k7 = clone_state(st_p)
    x_try = x_p.clone()
    lm.LMTripKernels(st_k7, config, status, x_try, trial).update()
    st_p7 = lm.lm_update_fused_plain(
        st_p, x_p, trial.params64, trial.params32, trial.price, trial.jac,
        trial.mkt, trial.weight, trial.bad_loss, config)
    out["update"] = compare_states(st_k7, st_p7)
    live_kernel = lm.read_live(status)
    live_plain = int((~st_p7.done).sum())
    held += _held(st_p, st_k7)
    r_fused, _ = polish_assembly_plain(
        trial.price, trial.jac, trial.mkt, trial.params64, trial.params32,
        trial.weight, trial.bad_loss)
    out.update(done_lanes_changed=held, live=(live_kernel, live_plain),
               coverage=dict(branches(st_p, r_fused, config)
                             + fused_branches(trial)))
    out["ok"] = (out["open"]["ok"] and out["open_boot"]["ok"]
                 and out["update"]["ok"] and live_kernel == live_plain
                 and held == 0)
    return out


def _agreement(a, b) -> dict:
    """Counts equal on every lane, the entries of x whose bits differ, and
    the largest relative difference of x and f, of two LMResults."""
    rel = lambda u, v: float(((u - v).abs()
                              / v.abs().clamp(min=1e-300)).max())
    return {
        "n_evals_equal": bool(torch.equal(a.n_evals, b.n_evals)),
        "n_iters_equal": bool(torch.equal(a.n_iters, b.n_iters)),
        "converged_equal": bool(torch.equal(a.converged, b.converged)),
        "x_bits_differ": int(_bits_differ(a.x, b.x).sum()),
        "x_rel": rel(a.x, b.x), "f_rel": rel(a.f, b.f),
        "trips": int(b.n_evals.max()),
    }


def check_engine(residual_fn, jac_fn, x0: torch.Tensor, config: LMConfig,
                 lam0=None) -> dict:
    """The engine to its end with the kernels and with the plain pair (on
    the polish's objective: the fused trip and the fused plain pair):
    ``_agreement``."""
    return _agreement(lm._run(residual_fn, jac_fn, x0, config, lam0),
                      lm._run(residual_fn, jac_fn, x0, config, lam0,
                              plain=True))


def route_check(objective, x0: torch.Tensor, config: LMConfig,
                lam0=None) -> dict:
    """The polish's objective to its end on its fused trip and on the
    unfused trip around its host assembly (``(residual_fn, jac_fn) =
    objective``): ``_agreement``, the unfused run as the reference."""
    residual_fn, jac_fn = objective
    return _agreement(lm._run(objective, objective.jac, x0, config, lam0),
                      lm._run(residual_fn, jac_fn, x0, config, lam0))


def coverage_run(residual_fn, jac_fn, x0: torch.Tensor, config: LMConfig,
                 lam0=None):
    """The engine's loop over the plain pair (the bootstrap trip on the
    residuals at x0), counting the branches each trip takes
    (``branches``) over all its trips: ``(LMResult, Counter)``."""
    counts = Counter()
    r_try = residual_fn(x0)
    st = lm.init_state(x0, r_try.shape[-1], config, lam0)
    status = torch.zeros(1, dtype=torch.int32, device=x0.device)
    live = x0.shape[0]
    while live:
        x_try = lm._open_plain_inplace(st, config, status)
        if r_try is None:
            r_try = residual_fn(x_try)
        counts.update(branches(st, r_try, config))
        lm._update_plain_inplace(st, x_try, r_try,
                                 jac_fn(x_try).to(x0.dtype), config, status)
        r_try = None
        live = lm.read_live(status)
    return lm._result(st), counts


def polish_objective(n_surfaces: int, seed: int, device, n_starts: int = 3):
    """``(objective, x0 [n_surfaces * n_starts, 13])``: the LM polish of
    ``calibrate_batch_mixed`` (``PolishObjective``: K1<double> residuals
    and the K3 Jacobian at ``polish_n_terms``) over ``n_surfaces`` 5 x 3
    call surfaces priced at truths drawn in the generator's ranges, from
    the starts of ``initial_guesses``."""
    f64 = torch.float64
    rng = np.random.default_rng(seed)
    true = torch.tensor(rng.uniform(RANGE_LO, RANGE_HI, (n_surfaces, 13)),
                        dtype=f64, device=device)
    tile = lambda row: torch.tensor(np.tile(row, (n_surfaces, 1)),
                                    dtype=f64, device=device)
    spots = torch.full((n_surfaces,), 100.0, dtype=f64, device=device)
    strikes = tile(np.tile([90.0, 95.0, 100.0, 105.0, 110.0], 3))
    mats = tile(np.repeat([0.25, 0.5, 1.0], 5))
    call = torch.ones((n_surfaces, 15), dtype=torch.bool, device=device)
    prices = price_surfaces(true, spots, 0.03, strikes, mats, call)
    x0 = initial_guesses(n_starts, torch.Generator().manual_seed(seed),
                         spots, strikes, mats, prices).reshape(-1, 13)
    rep = lambda a: torch.repeat_interleave(a, n_starts, dim=0)
    objective = calibrator.polish_residual_and_jacobian(
        rep(spots), 0.03, rep(strikes), rep(mats), rep(call), rep(prices),
        calibrator._polish_pricer_config(CalibrationConfig()))
    return objective, x0


def polish_lanes(n_surfaces: int, seed: int, device, n_starts: int = 3):
    """``(residual_fn, jac_fn, x0)``: ``polish_objective``'s unfused pair,
    whose engine trip is K6, K1<double> and K3 with the host assembly,
    K7."""
    objective, x0 = polish_objective(n_surfaces, seed, device, n_starts)
    residual_fn, jac_fn = objective
    return residual_fn, jac_fn, x0


def trip_ms(residual_fn, jac_fn, x0: torch.Tensor, config: LMConfig,
            repeats: int = 3) -> dict:
    """On the card: the engine's ms a trip on the kernels (best of
    ``repeats`` whole runs over their trips), and the evaluation alone
    (``residual_fn`` and ``jac_fn`` at ``x0``, with the host assembly)
    that each trip but the first repeats; the rest of a trip is K6, K7
    and the live count's read. ``residual_fn`` the polish's objective: the
    engine takes its fused trip (fused K6, K1<double>, K3, fused K7)."""
    runs = []
    for _ in range(repeats + 1):                  # the first warms up
        with CudaTimer() as timer:
            res = lm.lm_minimize_batched(residual_fn, x0, config,
                                         jac_fn=jac_fn)
        runs.append(timer.ms / int(res.n_evals.max()))
    with CudaTimer() as timer:
        for _ in range(repeats):
            residual_fn(x0)
            jac_fn(x0)
    evaluation = timer.ms / repeats
    trip = min(runs[1:])
    return {"lanes": x0.shape[0], "trips": int(res.n_evals.max()),
            "trip_ms": trip, "evaluation_ms": evaluation,
            "rest_ms": trip - evaluation}


# Stops that never fire: every lane stays live, trip after trip.
NEVER = LMConfig(maxiter=1 << 30, ftol=-float("inf"), gtol=-1.0, xtol=-1.0,
                 lambda_max=float("inf"), cost_target=0.0)


def steady_trip_ms(residual_fn, jac_fn, x0: torch.Tensor,
                   trips: int = 50) -> dict:
    """On the card: the engine's trip bound once (``_bind_trip``) from x0
    under stops that never fire, after 3 trips: ms a trip with its read
    (CUDA events over ``trips``), the host's issue of a trip without the
    read (host clock, then one synchronize), and over 20 trips with reads
    the device's busy ms and records a trip and each kernel's ms a trip
    (torch.profiler; a window that recorded nothing is taken again)."""
    status = torch.zeros(1, dtype=torch.int32, device=x0.device)
    _, trip = lm._bind_trip(residual_fn, jac_fn, x0, NEVER, None, status,
                            False)

    def run(n, read=True):
        for _ in range(n):
            trip()
            if read:
                lm.read_live(status)
    run(3)
    with CudaTimer() as timer:
        run(trips)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run(trips, read=False)
    host = (time.perf_counter() - t0) / trips * 1e3
    torch.cuda.synchronize()
    prof, _, _ = profile_complete(lambda: run(20),
                                  lambda p: device_entries(p)[1] > 0,
                                  device=x0.device)
    busy, records = device_entries(prof)
    dev_us = lambda e: getattr(e, "self_device_time_total",
                               getattr(e, "self_cuda_time_total", 0.0))
    name = lambda key: re.sub(r"\(anonymous namespace\)::|void |"
                              r"at::native::", "", key).split("(")[0][:48]
    kernels = {name(e.key): dev_us(e) / 20e3 for e in prof.key_averages()
               if dev_us(e) > 0 and "CUDA" in str(e.device_type)}
    return {"lanes": x0.shape[0], "trip_ms": timer.ms / trips,
            "host_issue_ms": host, "device_busy_ms": busy / 20,
            "records": records / 20,
            "kernel_ms": dict(sorted(kernels.items(),
                                     key=lambda kv: -kv[1])[:6])}
