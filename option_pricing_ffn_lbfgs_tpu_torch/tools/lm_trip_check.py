"""K6/K7 (the LM trip, ``csrc/lm_trip.cu``) against their plain versions,
on seeded random states and on whole runs of the engine.

    random_state(n_lanes, dtype, device, seed, config, m, d)
        -> (st, r_try, j_try)
    check_trip(n_lanes, dtype, device, seed, config) -> report
    check_engine(residual_fn, jac_fn, x0, config, lam0) -> report
    coverage_run(residual_fn, jac_fn, x0, config, lam0) -> (result, counts)
    polish_lanes(n_surfaces, seed, device) -> (residual_fn, jac_fn, x0)
    trip_ms(residual_fn, jac_fn, x0, config) -> report (the card only)

``random_state`` draws every field of ``ops/levenberg_marquardt.py::
_State`` with numpy from ``seed``, lane ``i`` of kind ``i % 13`` (then
varied by the draws): a plain live lane; a bootstrap lane (NaN residuals,
zero Jacobian, infinite cost); a done lane (with a NaN in its Jacobian);
lanes set up for gconv, fconv on an accepted step, fconv on a rejected
step (equal costs), xconv from the rejection side, tconv, give_up at
lambda_max, maxiter; a NaN in the Jacobian; a negative damping over two
nearly equal columns (a negative pivot); non-finite trial residuals.

``check_trip`` runs one trip both ways from the same state: K6 against
``lm_open_plain``, then K7 against ``lm_update_plain`` from the
plain-opened state (so each kernel is held on its own inputs), and
reports per field the entries whose bits differ (any NaN equals any NaN),
the largest absolute difference, the lanes done before the trip that
changed, the live counts, and how many lanes took each branch
(``branches``). ``check_engine`` runs the engine to its end with the
kernels and with the plain pair (``ops/levenberg_marquardt.py::_run``).
On CPU tensors the wrappers run the plain versions, so there the checks
hold the plain versions' in-place wrappers to the pure ones.
``polish_lanes`` builds the polish's own residuals (K1<double>) and
Jacobian (K3) over surfaces priced at seeded truths, from the starts of
``initial_guesses``; ``trip_ms`` times the engine's trip on them against
its evaluation alone (CUDA events).

Measurement only: no calibration path imports this module.
"""
from __future__ import annotations

from collections import Counter

import numpy as np
import torch

from ..calibration import calibrator
from ..calibration.initial_guess import initial_guesses
from ..data.synthetic import RANGE_HI, RANGE_LO
from ..ops import levenberg_marquardt as lm
from ..ops.cos_kernel import price_surfaces
from ..utils.config import CalibrationConfig, LMConfig
from ..utils.timing import CudaTimer

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


def check_engine(residual_fn, jac_fn, x0: torch.Tensor, config: LMConfig,
                 lam0=None) -> dict:
    """The engine to its end with the kernels and with the plain pair:
    equal counts on every lane, the entries of x whose bits differ, and
    the largest relative difference of x and f."""
    kern = lm._run(residual_fn, jac_fn, x0, config, lam0)
    plain = lm._run(residual_fn, jac_fn, x0, config, lam0,
                    lm._open_plain_inplace, lm._update_plain_inplace)
    rel = lambda a, b: float(((a - b).abs()
                              / b.abs().clamp(min=1e-300)).max())
    return {
        "n_evals_equal": bool(torch.equal(kern.n_evals, plain.n_evals)),
        "n_iters_equal": bool(torch.equal(kern.n_iters, plain.n_iters)),
        "converged_equal": bool(torch.equal(kern.converged,
                                            plain.converged)),
        "x_bits_differ": int(_bits_differ(kern.x, plain.x).sum()),
        "x_rel": rel(kern.x, plain.x), "f_rel": rel(kern.f, plain.f),
        "trips": int(plain.n_evals.max()),
    }


def coverage_run(residual_fn, jac_fn, x0: torch.Tensor, config: LMConfig,
                 lam0=None):
    """The engine over the plain pair, counting the branches each trip
    takes (``branches``) over all its trips: ``(LMResult, Counter)``."""
    counts = Counter()

    def update(st, x_try, r_try, j_try, config_, status):
        counts.update(branches(st, r_try, config_))
        lm._update_plain_inplace(st, x_try, r_try, j_try, config_, status)

    res = lm._run(residual_fn, jac_fn, x0, config, lam0,
                  lm._open_plain_inplace, update)
    return res, counts


def polish_lanes(n_surfaces: int, seed: int, device, n_starts: int = 3):
    """``(residual_fn, jac_fn, x0 [n_surfaces * n_starts, 13])``: the LM
    polish of ``calibrate_batch_mixed`` (K1<double> residuals and the K3
    Jacobian at ``polish_n_terms``) over ``n_surfaces`` 5 x 3 call surfaces
    priced at truths drawn in the generator's ranges, from the starts of
    ``initial_guesses``."""
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
    residual_fn, jac_fn = calibrator.polish_residual_and_jacobian(
        rep(spots), 0.03, rep(strikes), rep(mats), rep(call), rep(prices),
        calibrator._polish_pricer_config(CalibrationConfig()))
    return residual_fn, jac_fn, x0


def trip_ms(residual_fn, jac_fn, x0: torch.Tensor, config: LMConfig,
            repeats: int = 3) -> dict:
    """On the card: the engine's ms a trip on the kernels (best of
    ``repeats`` whole runs over their trips), and the evaluation alone
    (``residual_fn`` and ``jac_fn`` at ``x0``) that each trip but the
    first repeats; the rest of a trip is K6, K7 and the live count's
    read."""
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
