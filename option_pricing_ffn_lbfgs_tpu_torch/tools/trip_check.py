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
entries (non-finite entries must match), the entries whose bits differ
(any NaN equal to any NaN), the lanes done before the trip that changed
in any field (bits), the live counts, and how many lanes took each
branch. ``check_engine`` runs the engine to its end with the kernels and
with the plain pair (``ops/lbfgs_batched.py::_run``). On CPU tensors
the wrappers run the plain versions, so there the checks hold the plain
versions' in-place wrappers to the pure ones.

The fused trip (the calibration objective, d = 13)::

    random_fused(n_lanes, dtype, device, seed, config, n_opt)
        -> (st, trial)
    check_fused_trip(n_lanes, dtype, device, seed, config, n_opt) -> report
    search_lanes(n_surfaces, seed, device, ...) -> (objective, x0)
    search_trip_ms(objective, x0, config) -> report

``route_sensitivity(objective, x0, config)`` runs the engine to its end on
the fused trip and on the unfused trip around the objective's host
assembly, and counts the lanes whose end differs: on the card the two
are the same computation in the same order, so none should.

``random_fused`` adds to ``random_state``'s state a ``FusedTrial`` (the
objective's constants, ``ops/loss_kernel.py``) whose K2 outputs are
drawn: prices near the market's with an invalid row (0, negative, NaN or
+/-inf) on some lanes, gradient sums with NaN/inf entries on others; x
puts each Feller factor above and below its bound on about half the
lanes. ``check_fused_trip`` launches fused K4 and K5 through the
engine's binding (``TripKernels``) and holds them to
``loss_kernel.lbfgs_open_fused_plain`` (state, x_try and params_try) and
``lbfgs_update_fused_plain`` from the plain-opened state, in bits.
``check_engine`` on a ``search_lanes`` objective runs the fused trip
(K2 both ways: on the card the bound K2 skips done lanes, the plain one
prices them). ``search_trip_ms`` times a search trip on the card
against K2 alone.

``check_masked_rows(mode, params, ..., done)`` holds K2 or K3 bound with
the done flags ``done`` to the one-shot launch, which prices every lane:
live lanes' rows in bits, done lanes' rows left as planted.

Measurement only: no calibration path imports this module.
"""
from __future__ import annotations

import numpy as np
import torch

from ..calibration.initial_guess import initial_guesses
from ..data.synthetic import RANGE_HI, RANGE_LO
from ..ops import lbfgs_batched as lb
from ..ops import loss_kernel as lk
from ..ops.cos_kernel import price_surfaces
from ..ops.loss_kernel import make_batch_value_and_grad
from ..utils.config import CalibrationConfig, LBFGSConfig, PricerConfig
from ..utils.timing import CudaTimer
from .lm_trip_check import _bits_differ

# Caps near the drawn counters, so the maxiter and maxeval stops fire.
TRIP_CONFIG = LBFGSConfig(maxiter=50, maxeval=200)
DISCRETE = ("hist_len", "head", "n_iters", "n_evals", "n_fail", "done",
            "converged", "bootstrap", "starting", "stage", "ls_evals", "ok")
# The stated bars: max |kernel - plain| over max |plain|, per field.
TOLERANCE = {torch.float64: 1e-10, torch.float32: 1e-4}


def random_state(n_lanes: int, dtype, device, seed: int,
                 config: LBFGSConfig = TRIP_CONFIG, d: int = 13):
    """A seeded state entering a trip and the evaluation of that trip:
    ``(st, f_try [L], g_try [L, d])``, m = ``config.history``."""
    rng = np.random.default_rng(seed)
    L, m = n_lanes, config.history
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
    field's error and its mismatched non-finite entries; and per field the
    entries whose bits differ."""
    out = {"discrete": {}, "continuous": {}, "nonfinite": {},
           "max_abs_err": 0.0,
           "bits_differ": {name: int(_bits_differ(a, b).sum())
                           for name, a, b in zip(lb._BState._fields, kern,
                                                 plain)}}
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
               config: LBFGSConfig = TRIP_CONFIG, d: int = 13) -> dict:
    """One trip from ``random_state`` with d coordinates: K4 and K5
    against the plain pair."""
    tol = TOLERANCE[dtype]
    st0, f_try, g_try = random_state(n_lanes, dtype, device, seed, config,
                                     d)
    status = torch.zeros(2, dtype=torch.int32, device=st0.x.device)
    st_k = clone_state(st0)
    x_k = lb.lbfgs_open(st_k, config, status)
    st_p, x_p = lb.lbfgs_open_plain(st0, config)
    opened = compare_states(st_k, st_p, tol)
    opened["continuous"]["x_try"], err, opened["nonfinite"]["x_try"] = \
        _field_error(x_k, x_p)
    opened["max_abs_err"] = max(opened["max_abs_err"], err)
    opened["bits_differ"]["x_try"] = int(_bits_differ(x_k, x_p).sum())
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
    return {"lanes": n_lanes, "d": d,
            "dtype": str(dtype).replace("torch.", ""),
            "tol": tol, "open": opened, "update": updated,
            "done_lanes_changed": _held(st0, st_k) + _held(st_p, st_k5),
            "live": (live_kernel, live_plain), "coverage": coverage,
            "ok": (opened["ok"] and updated["ok"]
                   and live_kernel == live_plain
                   and _held(st0, st_k) + _held(st_p, st_k5) == 0)}


def check_engine(vg_fn, x0: torch.Tensor, config: LBFGSConfig) -> dict:
    """The engine to its end with the kernels and with the plain pair
    (for a ``BatchValueAndGrad``, the fused trip both ways): equal
    evaluation and iteration counts on every lane, the largest relative
    difference of x, the entries of x and f whose bits differ, and per
    field of the results the entries whose bits differ."""
    kern = lb._run(vg_fn, x0, config)
    plain = lb._run(vg_fn, x0, config, plain=True)
    scale = plain.x.abs().clamp(min=1e-300)
    return {
        "bits_differ": {name: int(_bits_differ(a, b).sum()) for name, a, b
                        in zip(lb.LBFGSResult._fields, kern, plain)},
        "x_bits_differ": int(_bits_differ(kern.x, plain.x).sum()),
        "f_bits_differ": int(_bits_differ(kern.f, plain.f).sum()),
        "n_evals_equal": bool(torch.equal(kern.n_evals, plain.n_evals)),
        "n_iters_equal": bool(torch.equal(kern.n_iters, plain.n_iters)),
        "converged_equal": bool(torch.equal(kern.converged,
                                            plain.converged)),
        "x_rel": float(((kern.x - plain.x).abs() / scale).max()),
        "f_rel": float(((kern.f - plain.f).abs()
                        / plain.f.abs().clamp(min=1e-300)).max()),
        "n_evals_max": int(plain.n_evals.max()),
    }


def check_masked_rows(mode: str, params, spots, strikes, mats, call, mkt,
                      n_terms: int, done) -> dict:
    """On the card: K2 (``mode`` "loss") or K3 ("jac") bound with the done
    flags ``done [L]`` (``bind_rows_value_and_grad`` /
    ``bind_rows_jacobian``) into outputs planted with a guard pattern,
    against the one-shot launch, which prices every lane. The entries of
    the live lanes' rows whose bits differ, the entries of the done lanes'
    rows that lost their guard, and, after the flags are cleared in place
    and the binding launched again, the entries of any row whose bits
    differ (the binding reads the flags at each launch)."""
    dt, dev = params.dtype, params.device
    wrap, bind = ((lk.rows_value_and_grad, lk.bind_rows_value_and_grad)
                  if mode == "loss" else
                  (lk.rows_jacobian, lk.bind_rows_jacobian))
    problem = (spots, 0.03, strikes, mats, call, mkt, n_terms, 10.0, 0.0,
               lk.maturity_groups(mats))
    want = wrap(params, *problem)
    guard = [-12345.0 - torch.arange(t.numel(), dtype=dt,
                                     device=dev).reshape(t.shape)
             for t in want]
    out = [g.clone() for g in guard]
    flags = done.clone()
    launch = bind(params, *problem, *out, flags)
    launch()
    differ = lambda pairs, rows: sum(int(_bits_differ(a[rows], b[rows]).sum())
                                     for a, b in pairs)
    rep = {"lanes": int(done.numel()), "done": int(done.sum()),
           "live_bits_differ": differ(zip(out, want), ~done),
           "guard_entries_written": differ(zip(out, guard), done)}
    flags.zero_()
    launch()
    rep["cleared_bits_differ"] = differ(zip(out, want), slice(None))
    rep["ok"] = not (rep["live_bits_differ"] or rep["guard_entries_written"]
                     or rep["cleared_bits_differ"])
    return rep


# ------------------------------------------------------- the fused trip --

def random_fused(n_lanes: int, dtype, device, seed: int,
                 config: LBFGSConfig = TRIP_CONFIG, n_opt: int = 15):
    """``random_state``'s state entering a fused trip, with x set so that
    each Feller factor lies above its bound on about half the lanes, and
    a ``FusedTrial`` whose K2 outputs are drawn: ``(st, trial)``."""
    st, _, _ = random_state(n_lanes, dtype, device, seed, config)
    rng = np.random.default_rng(seed + 1)
    L = n_lanes
    x = st.x.cpu().double().numpy()
    for s_, k_, t_ in lk.FELLER_IDX:           # log sigma^2 vs log 2 kappa theta
        x[:, k_] = rng.normal(scale=0.3, size=L)
        x[:, t_] = rng.normal(scale=0.3, size=L)
        x[:, s_] = 0.5 * (np.log(2.0) + x[:, k_] + x[:, t_]
                          + rng.choice([-0.5, 0.5], L))
    st.x.copy_(torch.tensor(x, dtype=dtype))
    mkt = rng.uniform(0.5, 20.0, (L, n_opt))
    price = mkt * (1.0 + rng.normal(scale=0.05, size=(L, n_opt)))
    bad = rng.random(L) < 0.08
    price[bad, rng.integers(0, n_opt, int(bad.sum()))] = rng.choice(
        [0.0, -1.0, np.nan, np.inf, -np.inf], int(bad.sum()))
    g_price = rng.normal(size=(L, lb.N_PARAMS)) * 10 ** rng.uniform(
        -3, 1, (L, 1))
    bad_g = rng.random(L) < 0.06
    g_price[bad_g, rng.integers(0, lb.N_PARAMS, int(bad_g.sum()))] = \
        rng.choice([np.nan, np.inf, -np.inf], int(bad_g.sum()))
    t = lambda a: torch.tensor(a, dtype=dtype, device=device)
    cfg = CalibrationConfig()
    width, factor = lk.torch_mean_order(L, n_opt, dtype)
    trial = lb.FusedTrial(
        params_try=torch.full((L, lb.N_PARAMS), float("nan"), dtype=dtype,
                              device=device),
        price=t(price), g_price=t(g_price), mkt=t(mkt),
        weight=cfg.feller_weight, bad_loss=cfg.bad_loss,
        exp_mask=lk.EXP_MASK, tanh_mask=lk.TANH_MASK, feller=lk.FELLER_IDX,
        mean_width=width, mean_factor=factor)
    return st, trial


def _feller_active(params):
    return [int((params[:, s_] * params[:, s_]
                 - 2.0 * params[:, k_] * params[:, t_] > 0).sum())
            for s_, k_, t_ in lk.FELLER_IDX]


def check_fused_trip(n_lanes: int, dtype, device, seed: int,
                     config: LBFGSConfig = TRIP_CONFIG,
                     n_opt: int = 15) -> dict:
    """One fused trip from ``random_fused`` on the card: fused K4 (bound by
    ``TripKernels``) against ``lbfgs_open_fused_plain``, then fused K5
    against ``lbfgs_update_fused_plain`` from the plain-opened state and
    params_try; every field, x_try and params_try in bits."""
    st0, trial = random_fused(n_lanes, dtype, device, seed, config, n_opt)
    status = torch.zeros(2, dtype=torch.int32, device=st0.x.device)
    st_k = clone_state(st0)
    trial_k = trial._replace(params_try=trial.params_try.clone())
    x_k = torch.empty_like(st0.x)
    lb.TripKernels(st_k, config, status, x_k, trial_k).open()
    st_p, x_p, params_p = lk.lbfgs_open_fused_plain(st0, config)
    bits = lambda a, b: int(_bits_differ(a, b).sum())
    opened = {name: bits(a, b)
              for name, a, b in zip(lb._BState._fields, st_k, st_p)}
    opened.update(x_try=bits(x_k, x_p),
                  params_try=bits(trial_k.params_try, params_p))

    trial_p = trial._replace(params_try=params_p.contiguous())
    st_k5 = clone_state(st_p)
    lb.TripKernels(st_k5, config, status, x_p.contiguous(), trial_p).update()
    st_p5 = lk.lbfgs_update_fused_plain(
        st_p, x_p, params_p, trial.price, trial.g_price, trial.mkt,
        trial.weight, trial.bad_loss, config)
    updated = {name: bits(a, b)
               for name, a, b in zip(lb._BState._fields, st_k5, st_p5)}
    live_kernel = lb.read_live(status)
    live_plain = int((~st_p5.done).sum())
    f_p, g_p = lk.search_assembly_plain(trial.price, trial.g_price,
                                        trial.mkt, params_p, trial.weight,
                                        trial.bad_loss)
    live = ~st0.done
    count = lambda mask: int(mask.sum())
    invalid = ~(torch.isfinite(trial.price) & (trial.price > 0)).all(-1)
    f1, f2 = _feller_active(params_p[live])
    coverage = {
        "done": count(st0.done), "bootstrap": count(live & st0.bootstrap),
        "opening": count(live & st0.starting),
        "invalid_row": count(live & invalid),
        "nonfinite_g_price": count(
            live & ~torch.isfinite(trial.g_price).all(-1)),
        "feller_1_active": f1, "feller_1_inactive": count(live) - f1,
        "feller_2_active": f2, "feller_2_inactive": count(live) - f2,
        "sentinel": count(live & (f_p == trial.bad_loss)),
        "gradient_zeroed_entries": int((g_p[live] == 0).sum()),
        "newly_done": count(live & st_p5.done),
    }
    held = _held(st0, st_k) + _held(st_p, st_k5)
    pairs = [*zip(st_k, st_p), (x_k, x_p), (trial_k.params_try, params_p),
             *zip(st_k5, st_p5)]
    diff = lambda a, b: (a - b)[torch.isfinite(a) & torch.isfinite(b)].abs()
    max_abs = max(float(torch.cat([diff(a, b).reshape(-1), a.new_zeros(1)])
                        .max())
                  for a, b in pairs if a.is_floating_point())
    return {"lanes": n_lanes, "n_opt": n_opt, "max_abs_err": max_abs,
            "dtype": str(dtype).replace("torch.", ""),
            "open": opened, "update": updated, "done_lanes_changed": held,
            "live": (live_kernel, live_plain), "coverage": coverage,
            "ok": (not any(opened.values()) and not any(updated.values())
                   and live_kernel == live_plain and held == 0)}


def search_lanes(n_surfaces: int, seed: int, device, n_starts: int = 3,
                 dtype=torch.float32, n_terms: int = 64):
    """``(objective, x0 [n_surfaces * n_starts, 13])``: the float32 search
    of ``calibrate_batch_mixed`` (``make_batch_value_and_grad`` at
    ``n_terms``) over 5 x 3 call surfaces priced at float64 at truths
    drawn in the generator's ranges, from ``initial_guesses``' starts."""
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
    rep = lambda a: torch.repeat_interleave(a, n_starts, dim=0).to(
        dtype if a.is_floating_point() else a.dtype)
    cfg = CalibrationConfig(pricer=PricerConfig(n_terms=n_terms))
    objective = make_batch_value_and_grad(
        rep(spots), rep(strikes), rep(mats), rep(call), rep(prices), 0.03,
        cfg)
    return objective, x0.to(dtype)


def search_trip_ms(objective, x0: torch.Tensor, config: LBFGSConfig,
                   repeats: int = 3) -> dict:
    """On the card: the engine's ms a trip on ``objective`` (best of
    ``repeats`` whole runs over their trips; the fused trip for a
    ``BatchValueAndGrad``), and K2 alone at ``transform(x0)``, which each
    trip launches once; the rest is fused K4, K5 and the read."""
    from ..calibration.transforms import transform
    runs = []
    for _ in range(repeats + 1):                  # the first warms up
        with CudaTimer() as timer:
            res = lb.lbfgs_minimize_batched(objective, x0, config)
        runs.append(timer.ms / int(res.n_evals.max()))
    params = transform(x0)
    with CudaTimer() as timer:
        for _ in range(repeats):
            objective.rows(params)
    k2 = timer.ms / repeats
    trip = min(runs[1:])
    return {"lanes": x0.shape[0], "trips": int(res.n_evals.max()),
            "trip_ms": trip, "k2_ms": k2, "rest_ms": trip - k2}


def route_sensitivity(objective, x0: torch.Tensor,
                      config: LBFGSConfig) -> dict:
    """The engine to its end on ``objective`` (the fused trip) and on
    ``lambda x: objective(x)`` (the unfused trip around the host
    assembly): lanes whose x differs in any bit, lanes whose evaluation
    count differs, lanes whose final loss differs by more than 1e-3
    relative, and the mean final loss of each."""
    fused = lb.lbfgs_minimize_batched(objective, x0, config)
    host = lb.lbfgs_minimize_batched(lambda x: objective(x), x0, config)
    rel = ((fused.f - host.f).abs() / host.f.abs()).double()
    return {"lanes": x0.shape[0],
            "x_differs": int(_bits_differ(fused.x, host.x).any(-1).sum()),
            "n_evals_differ": int((fused.n_evals != host.n_evals).sum()),
            "f_differs_1e-3": int((rel > 1e-3).sum()),
            "mean_f": (float(fused.f.double().mean()),
                       float(host.f.double().mean()))}
