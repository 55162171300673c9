"""K4/K5 (the L-BFGS trip, ``csrc/lbfgs_trip.cu``) against their plain
versions, on seeded random states and on a whole run of the engine.

    random_state(n_lanes, dtype, device, seed, config) -> (st, f_try, g_try)
    check_trip(n_lanes, dtype, device, seed, config) -> report
    check_engine(vg_fn, x0, config) -> report

``random_state`` draws every field of ``ops/lbfgs_batched.py::_BState``
with numpy from ``seed``: histories with ``hist_len`` cycling over 0..m,
heads that wrap (head < hist_len), curvature 1/rho spanning 1e-3..1e3;
every line-search stage; counters next to the caps of ``TRIP_CONFIG``;
bootstrap, starting and done lanes (done lanes that are starting too);
evaluations with non-finite values and gradient entries.

``check_trip`` runs one trip both ways from the same state: K4 against
``lbfgs_open_plain``, then K5 against ``lbfgs_update_plain`` from the
plain-opened state (so each kernel is held on its own inputs). The
report lists, per field, the lanes whose discrete value differs and each
continuous field's ``max |kernel - plain| / max |plain|`` over its finite
entries (non-finite entries must match), the lanes done before the trip
that changed in any field (bits), the live counts, and how many lanes took
each branch. ``check_engine`` runs the engine to its end with the kernels
and with the plain pair (``ops/lbfgs_batched.py::_run``). On CPU tensors
the wrappers run the plain versions, so there the checks hold the plain
versions' in-place wrappers to the pure ones.

Measurement only: no calibration path imports this module.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops import lbfgs_batched as lb
from ..utils.config import LBFGSConfig

# Caps near the drawn counters, so the maxiter and maxeval stops fire.
TRIP_CONFIG = LBFGSConfig(maxiter=50, maxeval=200)
DISCRETE = ("hist_len", "head", "n_iters", "n_evals", "n_fail", "done",
            "converged", "bootstrap", "starting", "stage", "ls_evals", "ok")
# The stated bars: max |kernel - plain| over max |plain|, per field.
TOLERANCE = {torch.float64: 1e-10, torch.float32: 1e-4}


def random_state(n_lanes: int, dtype, device, seed: int,
                 config: LBFGSConfig = TRIP_CONFIG):
    """A seeded state entering a trip and the evaluation of that trip:
    ``(st, f_try [L], g_try [L, d])``, d = 13, m = ``config.history``."""
    rng = np.random.default_rng(seed)
    L, d, m = n_lanes, 13, config.history
    u = lambda lo, hi, *shape: rng.uniform(lo, hi, shape or (L,))
    x = rng.normal(size=(L, d))
    g = rng.normal(size=(L, d)) * 10 ** u(-2, 1, L, 1)
    f = u(0.5, 2.0)
    s_hist = rng.normal(size=(L, m, d)) * 10 ** u(-2, 0, L, m, 1)
    y_hist = s_hist * u(0.2, 5.0, L, m, d)
    curvature = 10 ** u(-3, 3, L, m)                  # s . y = 1 / rho
    y_hist *= (curvature / (s_hist * y_hist).sum(-1))[..., None]
    hist_len = np.arange(L) % (m + 1)
    head = rng.integers(0, m, L)
    direction = -g * u(0.5, 2.0, L, 1) + 0.3 * rng.normal(size=(L, d))
    alpha = 10 ** u(-2, 0.5)
    a_lo, a_hi = alpha * u(0.0, 0.5), alpha * u(1.5, 3.0)
    flip = rng.random(L) < 0.3                        # reversed intervals
    a_lo, a_hi = np.where(flip, a_hi, a_lo), np.where(flip, a_lo, a_hi)
    f_try = f + u(-0.05, 0.05) * f
    bad_f = rng.random(L) < 0.06
    f_try[bad_f] = rng.choice([np.nan, np.inf, -np.inf], int(bad_f.sum()))
    g_try = rng.normal(size=(L, d)) * 10 ** u(-2, 1, L, 1)
    g_try[rng.random(L) < 0.04] *= 1e-9               # below gtol
    bad_g = rng.random(L) < 0.06
    g_try[bad_g, rng.integers(0, d, int(bad_g.sum()))] = rng.choice(
        [np.nan, np.inf, -np.inf], int(bad_g.sum()))
    near = lambda cap: np.where(rng.random(L) < 0.2, cap - 1,
                                rng.integers(0, cap, L))
    fields = dict(
        x=x, f=f, g=g, s_hist=s_hist, y_hist=y_hist, rho_hist=1 / curvature,
        hist_len=hist_len, head=head, gamma=10 ** u(-1, 1),
        n_iters=near(config.maxiter), n_evals=near(max(config.maxeval, 1)),
        n_fail=rng.integers(0, config.max_restarts + 1, L),
        done=rng.random(L) < 0.15, converged=rng.random(L) < 0.1,
        bootstrap=rng.random(L) < 0.05, starting=rng.random(L) < 0.35,
        direction=direction, dg0=(direction * g).sum(-1),
        stage=rng.integers(0, 3, L), alpha=alpha, a_lo=a_lo, a_hi=a_hi,
        f_lo=f + u(-0.1, 0.1), a_prev=alpha * u(0.0, 1.0),
        f_prev=f + u(-0.1, 0.1),
        ls_evals=rng.integers(0, config.max_linesearch, L),
        a_star=alpha * u(0.0, 1.0), f_star=f + u(-0.05, 0.2),
        g_star=g + 0.1 * rng.normal(size=(L, d)),
        x_star=x + 0.01 * rng.normal(size=(L, d)),
        ok=rng.random(L) < 0.5)
    kinds = {"t": dtype, "i": torch.int32, "b": torch.bool}
    st = lb._BState(**{
        name: torch.tensor(np.asarray(fields[name]), dtype=kinds[kind],
                           device=device)
        for name, (_, kind) in lb._LAYOUT.items()})
    t = lambda a: torch.tensor(a, dtype=dtype, device=device)
    return st, t(f_try), t(g_try)


def clone_state(st):
    return lb._BState(*(t.clone() for t in st))


def _field_error(a, b):
    """(max |a - b| / max |b| and max |a - b| over b's finite entries,
    entries whose non-finite value differs)."""
    fin = torch.isfinite(b)
    same = (torch.isnan(a) == torch.isnan(b)) & (
        ~torch.isinf(b) | (a == b)) & (torch.isinf(a) == torch.isinf(b))
    if not bool(fin.any()):
        return 0.0, 0.0, int((~same).sum())
    scale = float(b[fin].abs().max())
    err = float((a[fin] - b[fin]).abs().max())
    return (err / scale if scale > 0 else err), err, int((~same).sum())


def compare_states(kern, plain, tol: float) -> dict:
    """Per field: lanes whose discrete value differs, or the continuous
    field's error and its mismatched non-finite entries."""
    out = {"discrete": {}, "continuous": {}, "nonfinite": {},
           "max_abs_err": 0.0}
    for name in lb._BState._fields:
        a, b = getattr(kern, name), getattr(plain, name)
        if name in DISCRETE:
            out["discrete"][name] = int((a != b).sum())
        else:
            out["continuous"][name], err, out["nonfinite"][name] = \
                _field_error(a, b)
            out["max_abs_err"] = max(out["max_abs_err"], err)
    out["ok"] = (not any(out["discrete"].values())
                 and not any(out["nonfinite"].values())
                 and all(v <= tol for v in out["continuous"].values()))
    return out


def _held(before, after) -> int:
    """Lanes done in ``before`` whose fields changed in ``after`` (bits)."""
    changed = torch.zeros_like(before.done)
    for a, b in zip(before, after):
        diff = (a != b) & ~(torch.isnan(a) & torch.isnan(b)) \
            if a.is_floating_point() else a != b
        changed |= diff.reshape(diff.shape[0], -1).any(-1)
    return int((changed & before.done).sum())


def check_trip(n_lanes: int, dtype, device, seed: int,
               config: LBFGSConfig = TRIP_CONFIG) -> dict:
    """One trip from ``random_state``: K4 and K5 against the plain pair."""
    tol = TOLERANCE[dtype]
    st0, f_try, g_try = random_state(n_lanes, dtype, device, seed, config)
    status = torch.zeros(2, dtype=torch.int32, device=st0.x.device)
    st_k = clone_state(st0)
    x_k = lb.lbfgs_open(st_k, config, status)
    st_p, x_p = lb.lbfgs_open_plain(st0, config)
    opened = compare_states(st_k, st_p, tol)
    opened["continuous"]["x_try"], err, opened["nonfinite"]["x_try"] = \
        _field_error(x_k, x_p)
    opened["max_abs_err"] = max(opened["max_abs_err"], err)
    opened["ok"] = (opened["ok"] and opened["continuous"]["x_try"] <= tol
                    and not opened["nonfinite"]["x_try"])

    st_k5 = clone_state(st_p)
    lb.lbfgs_update(st_k5, x_p, f_try, g_try, config, status)
    st_p5 = lb.lbfgs_update_plain(st_p, x_p, f_try, g_try, config)
    updated = compare_states(st_k5, st_p5, tol)
    live_kernel = lb.read_live(status)
    live_plain = int((~st_p5.done).sum())

    live = ~st0.done
    count = lambda mask: int(mask.sum())
    coverage = {
        "done": count(st0.done),
        "done_and_starting": count(st0.done & st0.starting),
        "opening": count(live & st0.starting),
        "opening_wrapped_head": count(live & st0.starting
                                      & (st0.head < st0.hist_len)),
        "opening_hist_len": sorted(set(
            st0.hist_len[live & st0.starting].tolist())),
        "bootstrap": count(live & st0.bootstrap),
        "in_zoom": count(live & (st_p.stage == 1)),
        "stage_after": {k: count(live & (st_p5.stage == k))
                        for k in (0, 1, 2)},
        "pairs_stored": count(live & ~st_p.bootstrap & (
            st_p5.rho_hist != st_p.rho_hist).any(-1)),
        "resets": count(live & ~st_p.bootstrap & (st_p.hist_len > 0)
                        & (st_p5.hist_len == 0)),
        "newly_done": count(live & st_p5.done),
        "converged": count(live & st_p5.converged & ~st0.converged),
        "nonfinite_f": count(live & ~torch.isfinite(f_try)),
        "nonfinite_g": count(live & ~torch.isfinite(g_try).all(-1)),
    }
    return {"lanes": n_lanes, "dtype": str(dtype).replace("torch.", ""),
            "tol": tol, "open": opened, "update": updated,
            "done_lanes_changed": _held(st0, st_k) + _held(st_p, st_k5),
            "live": (live_kernel, live_plain), "coverage": coverage,
            "ok": (opened["ok"] and updated["ok"]
                   and live_kernel == live_plain
                   and _held(st0, st_k) + _held(st_p, st_k5) == 0)}


def check_engine(vg_fn, x0: torch.Tensor, config: LBFGSConfig) -> dict:
    """The engine to its end with the kernels and with the plain pair:
    equal evaluation and iteration counts on every lane, and the largest
    relative difference of x."""
    kern = lb._run(vg_fn, x0, config)
    plain = lb._run(vg_fn, x0, config, lb._open_plain_inplace,
                    lb._update_plain_inplace)
    scale = plain.x.abs().clamp(min=1e-300)
    return {
        "n_evals_equal": bool(torch.equal(kern.n_evals, plain.n_evals)),
        "n_iters_equal": bool(torch.equal(kern.n_iters, plain.n_iters)),
        "converged_equal": bool(torch.equal(kern.converged,
                                            plain.converged)),
        "x_rel": float(((kern.x - plain.x).abs() / scale).max()),
        "f_rel": float(((kern.f - plain.f).abs()
                        / plain.f.abs().clamp(min=1e-300)).max()),
        "n_evals_max": int(plain.n_evals.max()),
    }
