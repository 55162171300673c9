"""Batched flat L-BFGS with an explicit lane axis.

Port of the JAX package's ``ops/lbfgs_batched.py::lbfgs_minimize_batched``
(the per-lane algorithm is ``ops/lbfgs.py::lbfgs_minimize_flat``): every
state tensor carries a leading ``[L]`` lane axis and the objective is one
batch-level call ``vg_fn(x: [L, d]) -> (f: [L], g: [L, d])`` per loop trip
— on the calibration path the K2 kernel (``ops/loss_kernel.py``).

Per trip each lane advances its strong-Wolfe bracket/zoom line search by
exactly one evaluation (curvature-safe circular (s, y) history,
restart-on-failure, ftol/gtol/maxiter/maxeval stops); lanes that are done
hold their state. A trip is split at its one evaluation::

    x_try = lbfgs_open(st)                  # K4
    f_try, g_try = vg_fn(x_try)             # K2 on the calibration path
    lbfgs_update(st, x_try, f_try, g_try)   # K5

  * K4, ``lbfgs_open``: for the lanes that open an iteration, the two-loop
    direction, the bad-direction fallback, the initial step and the
    line search's opening resets; for every lane the trial point ``x_try``;
  * K5, ``lbfgs_update``: ``safe_vg``'s treatment of non-finite values,
    one bracket or zoom step, the best point so far, the curvature-safe
    history write, the convergence, restart and give-up tests, commit and
    bootstrap; lanes that were done hold. It counts the lanes not done.

On CUDA tensors the wrappers launch the hand-written kernels of
``csrc/lbfgs_trip.cu``, which update the state tensors in place; K4
zeroes a device ``int32`` live count that K5 adds to, and the loop reads
that count with an error word in one host read per trip (the one
synchronisation of a trip, where the JAX package evaluates its
``while_loop`` condition on the device). On CPU tensors the wrappers run
the plain versions ``lbfgs_open_plain`` / ``lbfgs_update_plain``, which
build new state tensors, and copy the result into the state. There is no
other path: a CUDA tensor launches the kernels or raises.

An objective that has a ``bind_trip`` method binds its own trip: the
calibration objective (``ops/loss_kernel.py::BatchValueAndGrad``, what
``make_batch_value_and_grad`` returns) binds the fused trip, in which K4
also writes ``params_try = transform(x_try)``, K2 prices it into
preallocated buffers, and K5 assembles the loss and its gradient from
K2's outputs (its host assembly, in the same order) before its update::

    K4 fused        # x_try, params_try
    K2              # price, g_price at params_try
    K5 fused        # the loss and its gradient, then the update

The engine's side of it is ``TripKernels`` with a ``FusedTrial``: the
buffers and the objective's constants the fused entries take. Any other
callable takes the trip above. Either way the trip is bound once per run
(``TripKernels``: the state, status word and buffers checked, the pointer
array packed, the C entries and the stream resolved once), so a trip on
the card is two or three ctypes calls, the evaluation, and one host read.
On CUDA tensors the plain versions sum in the kernels' order (``_dot``),
so on the card the kernels equal them in bits.
"""
from __future__ import annotations

import ctypes
from typing import Callable, NamedTuple

import torch

from ..utils import tracing
from ..utils.config import LBFGSConfig
from . import kernel_build

# Launches of each kernel, counted where it is launched.
LAUNCHES = {"lbfgs_open": 0, "lbfgs_update": 0, "lbfgs_open_f64": 0,
            "lbfgs_update_f64": 0, "lbfgs_open_fused": 0,
            "lbfgs_update_fused": 0, "lbfgs_open_fused_f64": 0,
            "lbfgs_update_fused_f64": 0}
# The kernels keep a lane's coordinates in registers, 16 threads a lane
# and up to 4 coordinates a thread; the history's alphas in shared memory.
MAX_DIM = 64
MAX_HISTORY = 512
GROUP = 16                  # threads a lane
N_PARAMS = 13               # the fused mode's d
MAX_ROWS = 128              # the fused mode's n: below it


class LBFGSResult(NamedTuple):
    x: torch.Tensor          # final iterates [L, d]
    f: torch.Tensor          # final objective values [L]
    grad: torch.Tensor       # final gradients [L, d]
    n_iters: torch.Tensor    # outer iterations taken [L]
    n_evals: torch.Tensor    # value_and_grad evaluations [L]
    converged: torch.Tensor  # hit gtol/ftol (vs maxiter / line-search failure)


class _BState(NamedTuple):
    x: torch.Tensor
    f: torch.Tensor
    g: torch.Tensor
    s_hist: torch.Tensor
    y_hist: torch.Tensor
    rho_hist: torch.Tensor
    hist_len: torch.Tensor
    head: torch.Tensor
    gamma: torch.Tensor
    n_iters: torch.Tensor
    n_evals: torch.Tensor
    n_fail: torch.Tensor
    done: torch.Tensor
    converged: torch.Tensor
    bootstrap: torch.Tensor
    starting: torch.Tensor
    direction: torch.Tensor
    dg0: torch.Tensor
    stage: torch.Tensor
    alpha: torch.Tensor
    a_lo: torch.Tensor
    a_hi: torch.Tensor
    f_lo: torch.Tensor
    a_prev: torch.Tensor
    f_prev: torch.Tensor
    ls_evals: torch.Tensor
    a_star: torch.Tensor
    f_star: torch.Tensor
    g_star: torch.Tensor
    x_star: torch.Tensor
    ok: torch.Tensor


# Each field's trailing shape ("d": [L, d]; "md": [L, m, d]; "m": [L, m];
# "": [L]) and kind ("t": the working dtype, "i": int32, "b": bool), in
# the order csrc/lbfgs_trip.cu's State<T> takes the pointers.
_LAYOUT = {
    "x": ("d", "t"), "f": ("", "t"), "g": ("d", "t"), "s_hist": ("md", "t"),
    "y_hist": ("md", "t"), "rho_hist": ("m", "t"), "hist_len": ("", "i"),
    "head": ("", "i"), "gamma": ("", "t"), "n_iters": ("", "i"),
    "n_evals": ("", "i"), "n_fail": ("", "i"), "done": ("", "b"),
    "converged": ("", "b"), "bootstrap": ("", "b"), "starting": ("", "b"),
    "direction": ("d", "t"), "dg0": ("", "t"), "stage": ("", "i"),
    "alpha": ("", "t"), "a_lo": ("", "t"), "a_hi": ("", "t"),
    "f_lo": ("", "t"), "a_prev": ("", "t"), "f_prev": ("", "t"),
    "ls_evals": ("", "i"), "a_star": ("", "t"), "f_star": ("", "t"),
    "g_star": ("d", "t"), "x_star": ("d", "t"), "ok": ("", "b"),
}
assert tuple(_LAYOUT) == _BState._fields


def _dot(a, b):
    """``sum_c a_c b_c`` over the last axis. On CUDA tensors in the
    kernels' order: the products padded with zeros to a multiple of 16,
    u_t = 0 + the products of coordinates t, t + 16, ... in order, then the
    butterfly u_t + u_{t+8}, ..., + u_{t+1}. On the CPU ``torch.sum``."""
    p = a * b
    if p.device.type == "cpu":
        return torch.sum(p, dim=-1)
    d = p.shape[-1]
    per = -(-d // GROUP)
    p = torch.nn.functional.pad(p, (0, per * GROUP - d))
    u = torch.zeros_like(p[..., :GROUP])
    for k in range(per):
        u = u + p[..., k * GROUP:(k + 1) * GROUP]
    o = GROUP // 2
    while o:
        u = u[..., :o] + u[..., o:2 * o]
        o //= 2
    return u[..., 0]


def _col(v):
    return v[:, None]


def init_state(x0: torch.Tensor, history: int) -> _BState:
    """The engine's state before its first (bootstrap) trip; every field
    is a tensor of its own, so the kernels may update them in place."""
    dt, dev = x0.dtype, x0.device
    L, d = x0.shape
    shapes = {"d": (L, d), "md": (L, history, d), "m": (L, history), "": (L,)}
    types = {"t": dt, "i": torch.int32, "b": torch.bool}
    fill = {"f": float("inf"), "f_lo": float("inf"),
            "f_prev": float("inf"), "f_star": float("inf"), "gamma": 1.0,
            "bootstrap": True}
    st = {name: torch.full(shapes[shape], fill.get(name, 0),
                           dtype=types[kind], device=dev)
          for name, (shape, kind) in _LAYOUT.items()}
    st["x"] = x0.clone()
    st["x_star"] = x0.clone()
    return _BState(**st)


def _two_loop_direction(g, s_hist, y_hist, rho_hist, hist_len, head, gamma):
    """Batched two-loop recursion: d = -H_k g per lane."""
    L, m, _ = s_hist.shape
    lanes = torch.arange(L, device=g.device)
    q = g
    alphas = torch.zeros((L, m), dtype=g.dtype, device=g.device)
    for j in range(m):
        idx = torch.remainder(head - 1 - j, m)
        valid = j < hist_len
        alpha = rho_hist[lanes, idx] * _dot(s_hist[lanes, idx], q)
        q = torch.where(_col(valid), q - _col(alpha) * y_hist[lanes, idx], q)
        alphas[lanes, idx] = torch.where(valid, alpha, torch.zeros_like(alpha))
    r = _col(gamma) * q
    for j in range(m):
        idx = torch.remainder(head - hist_len + j, m)
        valid = j < hist_len
        beta = rho_hist[lanes, idx] * _dot(y_hist[lanes, idx], r)
        r = torch.where(_col(valid),
                        r + _col(alphas[lanes, idx] - beta) * s_hist[lanes, idx],
                        r)
    return -r


def lbfgs_open_plain(st: _BState, config: LBFGSConfig):
    """Plain K4: ``(state, x_try)``. Lanes that are starting and not done
    open an iteration (direction, initial step, line-search resets); done
    lanes keep every field. ``x_try`` is ``x`` for bootstrap and done
    lanes, else ``x + alpha * direction``. Builds new tensors."""
    where = torch.where
    direction = _two_loop_direction(st.g, st.s_hist, st.y_hist, st.rho_hist,
                                    st.hist_len, st.head, st.gamma)
    dgn = _dot(direction, st.g)
    bad_dir = (dgn >= 0) | ~torch.isfinite(dgn)
    direction = where(_col(bad_dir), -st.g, direction)
    gmax = torch.amax(torch.abs(st.g), dim=-1)
    zeros = torch.zeros_like(st.f)
    init_step = where(st.hist_len == 0,
                      torch.clamp(1.0 / torch.clamp(gmax, min=1e-8), max=1.0),
                      torch.ones_like(st.f))

    opening = st.starting & ~st.done
    direction = where(_col(opening), direction, st.direction)
    alpha = where(opening, init_step, st.alpha)
    i0 = torch.zeros_like(st.stage)
    st = st._replace(
        direction=direction,
        dg0=where(opening, _dot(direction, st.g), st.dg0),
        alpha=alpha,
        stage=where(opening, i0, st.stage),
        a_lo=where(opening, zeros, st.a_lo),
        a_hi=where(opening, zeros, st.a_hi),
        f_lo=where(opening, st.f, st.f_lo),
        a_prev=where(opening, zeros, st.a_prev),
        f_prev=where(opening, st.f, st.f_prev),
        ls_evals=where(opening, i0, st.ls_evals),
        a_star=where(opening, zeros, st.a_star),
        f_star=where(opening, st.f, st.f_star),
        g_star=where(_col(opening), st.g, st.g_star),
        x_star=where(_col(opening), st.x, st.x_star),
        ok=st.ok & ~opening)
    x_try = where(_col(st.bootstrap | st.done), st.x,
                  st.x + _col(alpha) * direction)
    return st, x_try


def lbfgs_update_plain(st: _BState, x_try, f_try, g_try,
                       config: LBFGSConfig) -> _BState:
    """Plain K5: the state after the evaluation ``(f_try, g_try)`` at
    ``x_try`` of a state opened by ``lbfgs_open_plain``. Non-finite
    gradient entries count as 0 and a non-finite value as +inf (the JAX
    engine's ``safe_vg``); lanes that were done keep every field. Builds
    new tensors."""
    where = torch.where
    m = config.history
    c1, c2 = config.wolfe_c1, config.wolfe_c2
    i0 = torch.zeros_like(st.stage)
    false = torch.zeros_like(st.done)
    ones = torch.ones_like(st.f)
    g_try = where(torch.isfinite(g_try), g_try, torch.zeros_like(g_try))
    f_try = where(torch.isfinite(f_try), f_try,
                  torch.full_like(f_try, float("inf")))
    alpha, dg0, f_lo, f_prev = st.alpha, st.dg0, st.f_lo, st.f_prev
    a_lo, a_hi, a_prev = st.a_lo, st.a_hi, st.a_prev
    dg_try = _dot(g_try, st.direction)
    n_evals = st.n_evals + 1
    ls_evals = st.ls_evals + 1

    f0 = st.f
    armijo_fail = f_try > f0 + c1 * alpha * dg0
    wolfe_ok = (~armijo_fail) & (torch.abs(dg_try) <= -c2 * dg0)

    br_hi_from_fail = armijo_fail | ((f_try >= f_prev) & (ls_evals > 1))
    br_enter_zoom = br_hi_from_fail | (
        (~br_hi_from_fail) & (~wolfe_ok) & (dg_try >= 0))
    br_accept = wolfe_ok & ~br_hi_from_fail
    br_stage = where(br_accept, 2, where(br_enter_zoom, 1, 0)).to(i0.dtype)
    br_a_lo = where(br_hi_from_fail, a_prev, alpha)
    br_f_lo = where(br_hi_from_fail, f_prev, f_try)
    br_a_hi = where(br_hi_from_fail, alpha, a_prev)
    br_alpha = where(br_stage == 1, 0.5 * (br_a_lo + br_a_hi),
                     where(br_stage == 0, alpha * 2.0, alpha))

    zm_accept = wolfe_ok
    zm_shrink_hi = armijo_fail | (f_try >= f_lo)
    zm_flip = (~zm_shrink_hi) & (dg_try * (a_hi - a_lo) >= 0)
    zm_a_hi = where(zm_shrink_hi, alpha, where(zm_flip, a_lo, a_hi))
    zm_a_lo = where(zm_shrink_hi, a_lo, alpha)
    zm_f_lo = where(zm_shrink_hi, f_lo, f_try)
    interval_dead = (torch.abs(zm_a_hi - zm_a_lo)
                     * torch.clamp(torch.abs(dg0), min=1.0) < 1e-14)
    zm_stage = where(zm_accept | interval_dead, 2, 1).to(i0.dtype)
    span = zm_a_lo - alpha
    denom = where(torch.abs(span) > 1e-30, span, ones)
    curv = (zm_f_lo - f_try - dg_try * span) / (denom * denom)
    t_interp = alpha - dg_try / (2.0 * torch.clamp(curv, min=1e-30))
    lo_b = torch.minimum(zm_a_lo, zm_a_hi)
    hi_b = torch.maximum(zm_a_lo, zm_a_hi)
    width = hi_b - lo_b
    interp_ok = ((curv > 0) & torch.isfinite(t_interp)
                 & (t_interp > lo_b + 0.1 * width)
                 & (t_interp < hi_b - 0.1 * width))
    zm_alpha = where(interp_ok, t_interp, 0.5 * (zm_a_lo + zm_a_hi))

    in_zoom = st.stage == 1
    accept = where(in_zoom, zm_accept, br_accept)
    new_stage = where(in_zoom, zm_stage, br_stage)
    new_a_lo = where(in_zoom, zm_a_lo, br_a_lo)
    new_a_hi = where(in_zoom, zm_a_hi, br_a_hi)
    new_f_lo = where(in_zoom, zm_f_lo, br_f_lo)
    next_alpha = where(in_zoom, zm_alpha, br_alpha)

    take_star = accept | ((f_try < st.f_star) & (new_stage != 2))
    a_star = where(take_star, alpha, st.a_star)
    f_star = where(take_star, f_try, st.f_star)
    g_star = where(_col(take_star), g_try, st.g_star)
    x_star = where(_col(take_star), x_try, st.x_star)
    ok = st.ok | take_star

    ls_exhausted = ls_evals >= config.max_linesearch
    end_iter = (new_stage == 2) | ls_exhausted

    x_new, f_new, g_new = x_star, f_star, g_star
    s = x_new - st.x
    y = g_new - st.g
    sy = _dot(s, y)
    yy = _dot(y, y)
    good_pair = end_iter & ok & (
        sy > 1e-10 * torch.sqrt(_dot(s, s) * yy + 1e-300))
    gp = _col(good_pair)
    lanes = torch.arange(st.x.shape[0], device=st.x.device)
    s_hist = st.s_hist.clone()
    y_hist = st.y_hist.clone()
    rho_hist = st.rho_hist.clone()
    s_hist[lanes, st.head] = where(gp, s, st.s_hist[lanes, st.head])
    y_hist[lanes, st.head] = where(gp, y, st.y_hist[lanes, st.head])
    rho_hist[lanes, st.head] = where(
        good_pair, 1.0 / torch.clamp(sy, min=1e-300),
        st.rho_hist[lanes, st.head])
    head = where(good_pair, torch.remainder(st.head + 1, m), st.head)
    hist_len = where(good_pair, torch.clamp(st.hist_len + 1, max=m),
                     st.hist_len)
    gamma = where(good_pair, sy / torch.clamp(yy, min=1e-300), st.gamma)

    n_iters = st.n_iters + end_iter.to(i0.dtype)
    gconv = torch.amax(torch.abs(g_new), dim=-1) <= config.gtol
    fconv = (st.f - f_new) <= config.ftol * torch.clamp(
        torch.maximum(torch.abs(st.f), torch.abs(f_new)), min=1.0)
    ls_failed = end_iter & ~ok
    converged = end_iter & (gconv | (fconv & ok))
    n_fail = where(end_iter, where(ok, i0, st.n_fail + 1), st.n_fail)
    give_up = end_iter & (n_fail > config.max_restarts)
    reset = ls_failed & ~give_up
    hist_len = where(reset, i0, hist_len)
    head = where(reset, i0, head)
    gamma = where(reset, ones, gamma)
    eval_cap = ((n_evals >= config.maxeval) if config.maxeval > 0
                else false)
    done = converged | give_up | (n_iters >= config.maxiter) | eval_cap

    commit = end_iter & ok
    x_c = where(_col(commit), x_new, st.x)
    f_c = where(commit, f_new, st.f)
    g_c = where(_col(commit), g_new, st.g)

    boot = st.bootstrap
    x_c = where(_col(boot), x_try, x_c)
    f_c = where(boot, f_try, f_c)
    g_c = where(_col(boot), g_try, g_c)
    n_iters = where(boot, i0, n_iters)
    n_fail = where(boot, i0, n_fail)
    done = where(boot, false, done)
    converged_new = where(boot, false, st.converged | converged)
    end_or_boot = end_iter | boot

    b3 = boot[:, None, None]
    new = _BState(
        x=x_c, f=f_c, g=g_c,
        s_hist=where(b3, st.s_hist, s_hist),
        y_hist=where(b3, st.y_hist, y_hist),
        rho_hist=where(_col(boot), st.rho_hist, rho_hist),
        hist_len=where(boot, st.hist_len, hist_len),
        head=where(boot, st.head, head),
        gamma=where(boot, st.gamma, gamma),
        n_iters=n_iters, n_evals=n_evals, n_fail=n_fail,
        done=done, converged=converged_new,
        bootstrap=false, starting=end_or_boot,
        direction=st.direction, dg0=dg0,
        stage=new_stage, alpha=next_alpha,
        a_lo=new_a_lo, a_hi=new_a_hi, f_lo=new_f_lo,
        a_prev=alpha, f_prev=f_try, ls_evals=ls_evals,
        a_star=a_star, f_star=f_star, g_star=g_star, x_star=x_star,
        ok=ok)
    # Done lanes hold their state.
    return _BState(*(torch.where(st.done.view(-1, *([1] * (old.dim() - 1))),
                                 old, upd) for old, upd in zip(st, new)))


# ------------------------------------------------------------- wrappers --

def _check_state(st: _BState, config: LBFGSConfig):
    """(L, d, m) of a state the kernels take; raises on anything else."""
    if not isinstance(st, _BState):
        raise TypeError("the L-BFGS trip takes a _BState")
    L, d = st.x.shape
    m = config.history
    dt, dev = st.x.dtype, st.x.device
    if dt not in (torch.float32, torch.float64):
        raise ValueError(f"K4/K5 take float32 or float64, got {dt}")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"K4/K5 take CUDA or CPU tensors, got {dev}")
    if not 1 <= d <= MAX_DIM or not 1 <= m <= MAX_HISTORY:
        raise ValueError(f"K4/K5 take 1 <= d <= {MAX_DIM} and 1 <= history "
                         f"<= {MAX_HISTORY}, got d={d}, history={m}")
    shapes = {"d": (L, d), "md": (L, m, d), "m": (L, m), "": (L,)}
    types = {"t": dt, "i": torch.int32, "b": torch.bool}
    for name, (shape, kind) in _LAYOUT.items():
        t = getattr(st, name)
        if (t.shape != shapes[shape] or t.dtype != types[kind]
                or t.device != dev or not t.is_contiguous()):
            raise ValueError(
                f"state field {name}: expected contiguous {types[kind]} "
                f"{shapes[shape]} on {dev}, got {t.dtype} "
                f"{tuple(t.shape)} on {t.device}")
    return L, d, m


def _check_status(status: torch.Tensor, dev):
    if (status.shape != (2,) or status.dtype != torch.int32
            or status.device != dev):
        raise ValueError("status must be int32 [2] (live count, error "
                         "word) on the state's device")


def _flag_bad_lanes(st: _BState, m: int, status: torch.Tensor):
    """Plain counterpart of the kernels' index check: a lane that is not
    done with ``head`` outside [0, m) or ``hist_len`` outside [0, m] sets
    the error word to 1 + its index (the lowest such lane here). Returns
    the state the plain versions run on, with those lanes marked done so
    that they are left as they are, as the kernels leave them, and every
    out-of-range head at 0 so that no lane indexes outside the history."""
    out = (st.head < 0) | (st.head >= m)
    bad = ~st.done & (out | (st.hist_len < 0) | (st.hist_len > m))
    if bad.numel():
        first = torch.argmax(bad.to(torch.int8)).to(torch.int32) + 1
        status[1] = torch.where((status[1] == 0) & bad.any(), first,
                                status[1])
    return st._replace(done=st.done | bad,
                       head=torch.where(out, torch.zeros_like(st.head),
                                        st.head))


def _assign(st: _BState, new: _BState, held: _BState):
    """Write ``new`` into ``st`` in place, with ``done`` and ``head`` kept
    from ``st`` on the lanes that ``held`` altered (and held)."""
    altered = (held.done != st.done) | (held.head != st.head)
    new = new._replace(done=torch.where(altered, st.done, new.done),
                       head=torch.where(altered, st.head, new.head))
    for old, upd in zip(st, new):
        if old is not upd:
            old.copy_(upd)


def _open_plain_inplace(st, config, status):
    held = _flag_bad_lanes(st, config.history, status)
    status[0] = 0
    new, x_try = lbfgs_open_plain(held, config)
    _assign(st, new, held)
    return x_try


def _update_plain_inplace(st, x_try, f_try, g_try, config, status):
    held = _flag_bad_lanes(st, config.history, status)
    _assign(st, lbfgs_update_plain(held, x_try, f_try, g_try, config), held)
    status[0] = torch.count_nonzero(~st.done).to(torch.int32)


class FusedTrial(NamedTuple):
    """What the fused entries take besides the state, from the objective
    that binds them (``ops/loss_kernel.py::BatchValueAndGrad.bind_trip``):
    the buffers around K2, ``params_try [L, 13]`` (fused K4 writes it, K2
    reads it), K2's ``price [L, n]`` and ``g_price [L, 13]`` (fused K5
    reads them) and the lanes' market prices ``mkt [L, n]``; the Feller
    weight and the sentinel; the transform's ``exp_mask`` and
    ``tanh_mask`` (bit c: coordinate c); ``feller``, each variance
    factor's (sigma, kappa, theta) indices; and ``mean_width`` and
    ``mean_factor``, the block width and factor of ``torch.mean`` over
    ``[L, n]`` on the card, n < 128."""
    params_try: torch.Tensor
    price: torch.Tensor
    g_price: torch.Tensor
    mkt: torch.Tensor
    weight: float
    bad_loss: float
    exp_mask: int
    tanh_mask: int
    feller: tuple
    mean_width: int
    mean_factor: float


def _check_buffer(name, t, shape, dt, dev):
    if (tuple(t.shape) != shape or t.dtype != dt or t.device != dev
            or not t.is_contiguous()):
        raise ValueError(f"{name}: expected contiguous {dt} {shape} on "
                         f"{dev}, got {t.dtype} {tuple(t.shape)} on "
                         f"{t.device}")


def _check_fused(st: _BState, trial: FusedTrial):
    """Raises unless ``trial`` fits the state for the fused kernels."""
    L, d = st.x.shape
    dt, dev = st.x.dtype, st.x.device
    if d != N_PARAMS:
        raise ValueError(f"the fused trip takes d = {N_PARAMS}, got d={d}")
    if trial.mkt.dim() != 2 or not 1 <= trial.mkt.shape[1] < MAX_ROWS:
        raise ValueError(f"the fused trip takes market prices [L, n], "
                         f"1 <= n < {MAX_ROWS}")
    n = trial.mkt.shape[1]
    w = trial.mean_width
    if not (1 <= w <= min(n, 64) and w & (w - 1) == 0):
        raise ValueError(f"mean_width {w}: a power of two, at most "
                         f"min(n, 64)")
    if (trial.exp_mask | trial.tanh_mask) >> N_PARAMS or (
            trial.exp_mask & trial.tanh_mask):
        raise ValueError("exp_mask and tanh_mask: disjoint coordinate "
                         f"masks below bit {N_PARAMS}")
    idx = [c for factor in trial.feller for c in factor]
    if len(idx) != 6 or not all(0 <= c < N_PARAMS for c in idx):
        raise ValueError("feller: two (sigma, kappa, theta) index triples")
    for name, shape in (("params_try", (L, N_PARAMS)), ("price", (L, n)),
                        ("g_price", (L, N_PARAMS)), ("mkt", (L, n))):
        _check_buffer(name, getattr(trial, name), shape, dt, dev)


_OPEN_ARGTYPES = [ctypes.POINTER(ctypes.c_void_p), ctypes.c_void_p,
                  ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                  ctypes.c_void_p]
# state, x_try, params_try; exp_mask, tanh_mask; status; L, d, m; stream
_OPEN_FUSED_ARGTYPES = ([ctypes.POINTER(ctypes.c_void_p)]
                        + [ctypes.c_void_p] * 2 + [ctypes.c_uint] * 2
                        + [ctypes.c_void_p] + [ctypes.c_int] * 3
                        + [ctypes.c_void_p])
# state, x_try, f_try, g_try, status; c1, c2, ftol, gtol; max_linesearch,
# max_restarts, maxiter, maxeval, L, d, m; stream
_UPDATE_ARGTYPES = ([ctypes.POINTER(ctypes.c_void_p)] + [ctypes.c_void_p] * 4
                    + [ctypes.c_double] * 4 + [ctypes.c_int] * 7
                    + [ctypes.c_void_p])
# state, x_try, params_try, price, g_price, mkt, status; c1, c2, ftol, gtol,
# weight, bad_loss, mean_factor; max_linesearch, max_restarts, maxiter,
# maxeval, n_opt, mean_width; exp_mask, tanh_mask; feller; L, d, m; stream
_UPDATE_FUSED_ARGTYPES = ([ctypes.POINTER(ctypes.c_void_p)]
                          + [ctypes.c_void_p] * 6 + [ctypes.c_double] * 7
                          + [ctypes.c_int] * 6 + [ctypes.c_uint] * 2
                          + [ctypes.c_int] * 4 + [ctypes.c_void_p])


def _suffix(dt):
    return "f32" if dt == torch.float32 else "f64"


def _count_key(kind, dt, fused=False):
    return (f"lbfgs_{kind}" + ("_fused" if fused else "")
            + ("" if dt == torch.float32 else "_f64"))


def _pointers(st: _BState):
    return (ctypes.c_void_p * len(st))(*(t.data_ptr() for t in st))


class TripKernels:
    """K4 and K5 bound once to the state ``st`` (which they update in
    place), its status word and the trial buffers, CUDA tensors only:
    every check, the pointer array, the C entries, the stream and the
    scalar arguments are prepared here, so each launch is one ctypes call.

    Unfused (``fused=None``): ``open()`` writes ``x_try``;
    ``update(f_try, g_try)`` takes the evaluation at ``x_try``. Fused
    (``fused`` a ``FusedTrial``, d = 13): ``open()`` also writes
    ``fused.params_try``; ``update()`` assembles the evaluation from
    ``fused``'s K2 outputs and market prices."""

    def __init__(self, st: _BState, config: LBFGSConfig, status, x_try,
                 fused: FusedTrial = None):
        L, d, m = _check_state(st, config)
        dt, dev = st.x.dtype, st.x.device
        _check_status(status, dev)
        if dev.type != "cuda":
            raise ValueError(f"K4/K5 launch on CUDA tensors, got {dev}")
        _check_buffer("x_try", x_try, (L, d), dt, dev)
        if fused is not None:
            _check_fused(st, fused)
        self._st, self._x_try = st, x_try
        self._keep = (status, fused)
        self._fused = fused is not None
        ptrs = _pointers(st)                 # the fields are updated in place
        stream = torch.cuda.current_stream(dev).cuda_stream
        sfx = ("fused_" if fused is not None else "") + _suffix(dt)
        self._open_key = _count_key("open", dt, fused is not None)
        self._update_key = _count_key("update", dt, fused is not None)
        wolfe = (float(config.wolfe_c1), float(config.wolfe_c2),
                 float(config.ftol), float(config.gtol))
        caps = (int(config.max_linesearch), int(config.max_restarts),
                int(config.maxiter), int(config.maxeval))
        if fused is None:
            self._open_fn = kernel_build.entry(
                "lbfgs_trip", f"lbfgs_open_{sfx}", _OPEN_ARGTYPES)
            self._open_args = (ptrs, x_try.data_ptr(), status.data_ptr(),
                               L, d, m, stream)
            self._update_fn = kernel_build.entry(
                "lbfgs_trip", f"lbfgs_update_{sfx}", _UPDATE_ARGTYPES)
            self._update_args = ((ptrs, x_try.data_ptr()),
                                 (status.data_ptr(), *wolfe, *caps, L, d, m,
                                  stream))
        else:
            self._open_fn = kernel_build.entry(
                "lbfgs_trip", f"lbfgs_open_{sfx}", _OPEN_FUSED_ARGTYPES)
            self._open_args = (ptrs, x_try.data_ptr(),
                               fused.params_try.data_ptr(), fused.exp_mask,
                               fused.tanh_mask, status.data_ptr(), L, d, m,
                               stream)
            feller = sum(c << (4 * i) for i, c in enumerate(
                c for factor in fused.feller for c in factor))
            self._update_fn = kernel_build.entry(
                "lbfgs_trip", f"lbfgs_update_{sfx}", _UPDATE_FUSED_ARGTYPES)
            self._update_args = (
                ptrs, x_try.data_ptr(), fused.params_try.data_ptr(),
                fused.price.data_ptr(), fused.g_price.data_ptr(),
                fused.mkt.data_ptr(), status.data_ptr(), *wolfe,
                float(fused.weight), float(fused.bad_loss),
                float(fused.mean_factor), *caps, fused.mkt.shape[1],
                fused.mean_width, fused.exp_mask, fused.tanh_mask, feller,
                L, d, m, stream)

    def open(self) -> None:
        """K4: one launch."""
        kernel_build.check(self._open_fn(*self._open_args), self._open_key)
        LAUNCHES[self._open_key] += 1

    def update(self, f_try=None, g_try=None) -> None:
        """K5: one launch, on ``(f_try, g_try)`` (unfused) or on the fused
        buffers."""
        if self._fused:
            args = self._update_args
        else:
            _, f_try, g_try = _trial(self._st, self._x_try, f_try, g_try)
            head, tail = self._update_args
            args = (*head, f_try.data_ptr(), g_try.data_ptr(), *tail)
        kernel_build.check(self._update_fn(*args), self._update_key)
        LAUNCHES[self._update_key] += 1


def lbfgs_open(st: _BState, config: LBFGSConfig,
               status: torch.Tensor) -> torch.Tensor:
    """K4: open the lanes that start an iteration, in place, and return
    ``x_try [L, d]``; zero the live count ``status[0]``. A lane that is not
    done whose ``head`` or ``hist_len`` lies outside [0, m) / [0, m] sets
    the error word ``status[1]`` to 1 + its index and is left as it is.
    CUDA tensors launch the kernel; CPU tensors run ``lbfgs_open_plain``."""
    L, d, m = _check_state(st, config)
    _check_status(status, st.x.device)
    if st.x.device.type == "cpu":
        return _open_plain_inplace(st, config, status)
    x_try = torch.empty_like(st.x)
    if L == 0:
        status[0] = 0
        return x_try
    TripKernels(st, config, status, x_try).open()
    return x_try


def _trial(st: _BState, x_try, f_try, g_try):
    """The evaluation's tensors, checked against the state; contiguous."""
    L, d = st.x.shape
    dt, dev = st.x.dtype, st.x.device
    for name, t, shape in (("x_try", x_try, (L, d)), ("f_try", f_try, (L,)),
                           ("g_try", g_try, (L, d))):
        if t.shape != shape or t.dtype != dt or t.device != dev:
            raise ValueError(f"{name}: expected {dt} {shape} on {dev}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    return x_try.contiguous(), f_try.contiguous(), g_try.contiguous()


def lbfgs_update(st: _BState, x_try, f_try, g_try, config: LBFGSConfig,
                 status: torch.Tensor) -> None:
    """K5: advance every lane that is not done by the evaluation
    ``(f_try [L], g_try [L, d])`` at ``x_try``, in place, and add the count
    of lanes not done afterwards to ``status[0]``; the index check of
    ``lbfgs_open`` sets ``status[1]``. CUDA tensors launch the kernel; CPU
    tensors run ``lbfgs_update_plain``."""
    L, d, m = _check_state(st, config)
    _check_status(status, st.x.device)
    x_try, f_try, g_try = _trial(st, x_try, f_try, g_try)
    if st.x.device.type == "cpu":
        _update_plain_inplace(st, x_try, f_try, g_try, config, status)
        return
    if L == 0:
        return
    TripKernels(st, config, status, x_try).update(f_try, g_try)


def read_live(status: torch.Tensor) -> int:
    """The live count of the last trip, read with the error word in one
    host read; raises, naming the lane, if the error word is set."""
    live, err = status.tolist()
    if err:
        raise RuntimeError(
            f"L-BFGS lane {err - 1}: head or hist_len outside [0, m) / "
            f"[0, m] (the circular history is corrupt)")
    return live


def _bind_trip(vg_fn: Callable, st: _BState, config: LBFGSConfig,
               status: torch.Tensor, plain: bool) -> Callable:
    """One trip of the engine, ``trip(live=None)``, bound once: everything
    checked here raises before the first trip; ``live``, the lanes not
    done as the trip starts, reaches a bound K2 (its blocks' width). An
    objective
    with a ``bind_trip(st, config, status, plain)`` method binds its own
    trip (it returns None where its fused kernels do not take it). Else on
    CUDA tensors (unless ``plain``) K4, ``vg_fn`` and K5; otherwise the
    plain versions in place."""
    _check_state(st, config)
    _check_status(status, st.x.device)
    card = st.x.device.type == "cuda" and not plain
    bind = getattr(vg_fn, "bind_trip", None)
    trip = None if bind is None else bind(st, config, status, plain)
    if trip is not None:
        return trip
    if card:
        x_try = torch.empty_like(st.x)
        kernels = TripKernels(st, config, status, x_try)

        def trip(live=None):
            kernels.open()
            kernels.update(*vg_fn(x_try))
        return trip

    def trip(live=None):
        x_try = _open_plain_inplace(st, config, status)
        _, f_try, g_try = _trial(st, x_try, *vg_fn(x_try))
        _update_plain_inplace(st, x_try, f_try, g_try, config, status)
    return trip


def _run(vg_fn: Callable, x0: torch.Tensor, config: LBFGSConfig,
         plain: bool = False) -> LBFGSResult:
    """The engine's loop: the trip bound once (``_bind_trip``), then one
    trip and one host read of the live count until no lane is live
    (``tracing.trips``, which inside a recorded entry adds its span and
    counters, ``utils/tracing.py``). With ``plain`` the trip runs the
    plain versions on any device, which the card's checks hold the
    kernels to."""
    st = init_state(x0, config.history)
    status = torch.zeros(2, dtype=torch.int32, device=x0.device)
    trip = _bind_trip(vg_fn, st, config, status, plain)
    lanes = x0.shape[0]
    tracing.trips("lbfgs", lanes, lanes, trip, lambda: read_live(status))
    return LBFGSResult(x=st.x, f=st.f, grad=st.g, n_iters=st.n_iters,
                       n_evals=st.n_evals, converged=st.converged)


def lbfgs_minimize_batched(vg_fn: Callable, x0: torch.Tensor,
                           config: LBFGSConfig = LBFGSConfig()
                           ) -> LBFGSResult:
    """Minimize every lane of ``x0 [L, d]`` with the flat state machine.

    Non-finite gradient entries returned by ``vg_fn`` are zeroed and
    non-finite values count as +inf. On CUDA tensors every trip runs K4
    and K5 around ``vg_fn``, or, when ``vg_fn`` is the calibration
    objective (``ops/loss_kernel.py::BatchValueAndGrad``, n < 128 rows a
    lane), fused K4, K2 and fused K5; on CPU tensors their plain
    versions.
    """
    return _run(vg_fn, x0, config)
