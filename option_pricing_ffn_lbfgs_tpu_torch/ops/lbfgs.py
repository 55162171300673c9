"""Per-lane L-BFGS with a strong-Wolfe line search: the JAX package's
``ops/lbfgs.py`` API.

``lbfgs_minimize(fun, x0, config)`` minimizes one objective
``fun: [d] -> scalar`` (plain torch code, differentiated with
``torch.func.grad_and_value``) and dispatches on ``config.flat``:

  * ``flat=True`` (the default): ``lbfgs_minimize_flat``, the batched flat
    state machine of ``ops/lbfgs_batched.py`` on one lane;
  * ``flat=False``: ``lbfgs_minimize_nested``, the two-loop oracle (an
    outer iteration loop around a bracket/zoom line search, Nocedal &
    Wright Alg. 3.5/3.6), which walks the same per-lane trajectory: the
    same decisions, step counts and iterates.

The nested oracle branches in Python on values it reads from the device
at every step. It exists for tests and API parity; no calibration path
calls it (the calibrator runs the batched engine over all its lanes).
Non-finite gradient entries are zeroed, as in JAX.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from ..utils.config import LBFGSConfig
from .lbfgs_batched import LBFGSResult, _dot, lbfgs_minimize_batched


def _value_and_grad(fun: Callable) -> Callable:
    """``x [d] -> (f, g)`` with non-finite gradient entries zeroed."""
    grad_and_value = torch.func.grad_and_value(fun)

    def vg(x):
        g, f = grad_and_value(x)
        return f, torch.where(torch.isfinite(g), g, torch.zeros_like(g))

    return vg


def lbfgs_minimize(fun: Callable, x0: torch.Tensor,
                   config: LBFGSConfig = LBFGSConfig()) -> LBFGSResult:
    """Minimize ``fun`` (R^d -> R) from ``x0 [d]``; the result's fields
    have no lane axis. ``config.flat`` picks the engine (module
    docstring)."""
    if config.flat:
        return lbfgs_minimize_flat(fun, x0, config)
    return lbfgs_minimize_nested(fun, x0, config)


def lbfgs_minimize_flat(fun: Callable, x0: torch.Tensor,
                        config: LBFGSConfig = LBFGSConfig()) -> LBFGSResult:
    """The batched flat engine on one lane: one evaluation per loop trip,
    ``config.maxeval`` honoured."""
    vg = _value_and_grad(fun)

    def vg_lane(x):
        f, g = vg(x[0])
        return f[None], g[None]

    res = lbfgs_minimize_batched(vg_lane, x0[None], config)
    return LBFGSResult(*(a[0] for a in res))


class _LSState(NamedTuple):
    stage: int              # 0 bracketing, 1 zoom, 2 done
    alpha: torch.Tensor     # next trial step
    a_lo: torch.Tensor
    a_hi: torch.Tensor
    f_lo: torch.Tensor
    a_prev: torch.Tensor
    f_prev: torch.Tensor
    a_star: torch.Tensor    # accepted (or best fallback) step
    f_star: torch.Tensor
    g_star: torch.Tensor
    x_star: torch.Tensor
    n_evals: int
    ok: bool                # found an acceptable point


def _wolfe_line_search(vg, x0, f0, g0, direction, cfg: LBFGSConfig,
                       init_step) -> _LSState:
    """Strong-Wolfe line search (``ops/lbfgs.py:108-222`` of the JAX
    package): expansion bracketing, then zoom by safeguarded quadratic
    interpolation, at most ``cfg.max_linesearch`` evaluations. The best
    improving point seen is kept as a fallback accept."""
    dg0 = _dot(g0, direction)
    c1, c2 = cfg.wolfe_c1, cfg.wolfe_c2
    zero = torch.zeros_like(f0)
    st = _LSState(stage=0, alpha=init_step, a_lo=zero, a_hi=zero, f_lo=f0,
                  a_prev=zero, f_prev=f0, a_star=zero, f_star=f0, g_star=g0,
                  x_star=x0, n_evals=0, ok=False)
    while st.stage < 2 and st.n_evals < cfg.max_linesearch:
        x = x0 + st.alpha * direction
        f, g = vg(x)
        f = torch.where(torch.isfinite(f), f, torch.full_like(f, float("inf")))
        dg = _dot(g, direction)
        n_evals = st.n_evals + 1
        armijo_fail = bool(f > f0 + c1 * st.alpha * dg0)
        wolfe_ok = (not armijo_fail) and bool(torch.abs(dg) <= -c2 * dg0)
        if st.stage == 0:
            hi_from_fail = armijo_fail or (bool(f >= st.f_prev)
                                           and n_evals > 1)
            accept = wolfe_ok and not hi_from_fail
            stage = (2 if accept else 1 if hi_from_fail or bool(dg >= 0)
                     else 0)
            a_lo = st.a_prev if hi_from_fail else st.alpha
            f_lo = st.f_prev if hi_from_fail else f
            a_hi = st.alpha if hi_from_fail else st.a_prev
            alpha = (0.5 * (a_lo + a_hi) if stage == 1
                     else st.alpha * 2.0 if stage == 0 else st.alpha)
            st2 = st._replace(a_prev=st.alpha, f_prev=f)
        else:
            accept = wolfe_ok
            shrink_hi = armijo_fail or bool(f >= st.f_lo)
            flip = (not shrink_hi) and bool(dg * (st.a_hi - st.a_lo) >= 0)
            a_hi = st.alpha if shrink_hi else st.a_lo if flip else st.a_hi
            a_lo = st.a_lo if shrink_hi else st.alpha
            f_lo = st.f_lo if shrink_hi else f
            dead = bool(torch.abs(a_hi - a_lo)
                        * torch.clamp(torch.abs(dg0), min=1.0) < 1e-14)
            stage = 2 if accept or dead else 1
            span = a_lo - st.alpha
            denom = torch.where(torch.abs(span) > 1e-30, span,
                                torch.ones_like(span))
            curv = (f_lo - f - dg * span) / (denom * denom)
            t_interp = st.alpha - dg / (2.0 * torch.clamp(curv, min=1e-30))
            lo_b, hi_b = torch.minimum(a_lo, a_hi), torch.maximum(a_lo, a_hi)
            width = hi_b - lo_b
            interp_ok = bool((curv > 0) & torch.isfinite(t_interp)
                             & (t_interp > lo_b + 0.1 * width)
                             & (t_interp < hi_b - 0.1 * width))
            alpha = t_interp if interp_ok else 0.5 * (a_lo + a_hi)
            st2 = st
        st2 = st2._replace(stage=stage, alpha=alpha, a_lo=a_lo, a_hi=a_hi,
                           f_lo=f_lo, n_evals=n_evals, ok=st.ok or accept)
        if accept or (bool(f < st2.f_star) and stage != 2):
            st2 = st2._replace(a_star=st.alpha, f_star=f, g_star=g,
                               x_star=x, ok=True)
        st = st2
    return st


def lbfgs_minimize_nested(fun: Callable, x0: torch.Tensor,
                          config: LBFGSConfig = LBFGSConfig()
                          ) -> LBFGSResult:
    """Nested-loop L-BFGS (``ops/lbfgs.py:242-362`` of the JAX package):
    outer iterations, each one Wolfe line search along the two-loop
    direction; a curvature-safe circular (s, y) history; on a failed line
    search the history resets, and the solve stops after
    ``config.max_restarts`` consecutive failures. ``config.maxeval`` is a
    flat-engine knob and is not read here."""
    vg = _value_and_grad(fun)
    dt, dev = x0.dtype, x0.device
    d, m = x0.shape[-1], config.history
    x, (f, g) = x0, vg(x0)
    s_hist = torch.zeros((m, d), dtype=dt, device=dev)
    y_hist = torch.zeros((m, d), dtype=dt, device=dev)
    rho_hist = torch.zeros((m,), dtype=dt, device=dev)
    hist_len = head = n_iters = n_fail = 0
    n_evals = 1
    gamma = torch.ones((), dtype=dt, device=dev)
    converged = False
    while True:
        # two-loop recursion: direction = -H g
        q = g
        alphas = torch.zeros((m,), dtype=dt, device=dev)
        for j in range(hist_len):
            idx = (head - 1 - j) % m
            alphas[idx] = rho_hist[idx] * _dot(s_hist[idx], q)
            q = q - alphas[idx] * y_hist[idx]
        r = gamma * q
        for j in range(hist_len):
            idx = (head - hist_len + j) % m
            beta = rho_hist[idx] * _dot(y_hist[idx], r)
            r = r + (alphas[idx] - beta) * s_hist[idx]
        direction = -r
        dgn = _dot(direction, g)
        if bool((dgn >= 0) | ~torch.isfinite(dgn)):
            direction = -g
        if hist_len == 0:
            init_step = torch.clamp(
                1.0 / torch.clamp(torch.amax(torch.abs(g)), min=1e-8),
                max=1.0)
        else:
            init_step = torch.ones((), dtype=dt, device=dev)

        ls = _wolfe_line_search(vg, x, f, g, direction, config, init_step)
        s, y = ls.x_star - x, ls.g_star - g
        sy, yy = _dot(s, y), _dot(y, y)
        if ls.ok and bool(sy > 1e-10 * torch.sqrt(_dot(s, s) * yy + 1e-300)):
            s_hist[head], y_hist[head] = s, y
            rho_hist[head] = 1.0 / torch.clamp(sy, min=1e-300)
            head = (head + 1) % m
            hist_len = min(hist_len + 1, m)
            gamma = sy / torch.clamp(yy, min=1e-300)
        n_iters += 1
        n_evals += ls.n_evals
        gconv = bool(torch.amax(torch.abs(ls.g_star)) <= config.gtol)
        fconv = bool((f - ls.f_star) <= config.ftol * torch.clamp(
            torch.maximum(torch.abs(f), torch.abs(ls.f_star)), min=1.0))
        converged = gconv or (fconv and ls.ok)
        n_fail = 0 if ls.ok else n_fail + 1
        give_up = n_fail > config.max_restarts
        if not ls.ok and not give_up:
            hist_len = head = 0
            gamma = torch.ones((), dtype=dt, device=dev)
        if ls.ok:
            x, f, g = ls.x_star, ls.f_star, ls.g_star
        if converged or give_up or n_iters >= config.maxiter:
            break
    i32 = lambda v: torch.tensor(v, dtype=torch.int32, device=dev)
    return LBFGSResult(x=x, f=f, grad=g, n_iters=i32(n_iters),
                       n_evals=i32(n_evals),
                       converged=torch.tensor(converged, device=dev))
