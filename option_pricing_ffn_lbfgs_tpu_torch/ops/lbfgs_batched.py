"""Batched flat L-BFGS with an explicit lane axis.

Port of the JAX package's ``ops/lbfgs_batched.py::lbfgs_minimize_batched``
(the per-lane algorithm is ``ops/lbfgs.py::lbfgs_minimize_flat``): every
state tensor carries a leading ``[L]`` lane axis and the objective is one
batch-level call ``vg_fn(x: [L, d]) -> (f: [L], g: [L, d])`` per loop trip
— on the calibration path the K2 kernel (``ops/loss_kernel.py``).

Per trip each lane advances its strong-Wolfe bracket/zoom line search by
exactly one evaluation (curvature-safe circular (s, y) history,
restart-on-failure, ftol/gtol/maxiter/maxeval stops); lanes that are done
hold their state. The loop runs while any lane is not done, which reads
one flag from the device per trip.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from ..utils.config import LBFGSConfig


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


def _dot(a, b):
    return torch.sum(a * b, dim=-1)


def _col(v):
    return v[:, None]


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


def lbfgs_minimize_batched(vg_fn: Callable, x0: torch.Tensor,
                           config: LBFGSConfig = LBFGSConfig()
                           ) -> LBFGSResult:
    """Minimize every lane of ``x0 [L, d]`` with the flat state machine.

    Non-finite gradient entries returned by ``vg_fn`` are zeroed and
    non-finite values count as +inf.
    """
    dt, dev = x0.dtype, x0.device
    L, d = x0.shape
    m = config.history
    c1, c2 = config.wolfe_c1, config.wolfe_c2
    zeros = torch.zeros((L,), dtype=dt, device=dev)
    ones = torch.ones((L,), dtype=dt, device=dev)
    infs = torch.full((L,), float("inf"), dtype=dt, device=dev)
    i0 = torch.zeros((L,), dtype=torch.int32, device=dev)
    false = torch.zeros((L,), dtype=torch.bool, device=dev)
    lanes = torch.arange(L, device=dev)
    where = torch.where

    def safe_vg(x):
        f, g = vg_fn(x)
        return f, where(torch.isfinite(g), g, torch.zeros_like(g))

    st = _BState(
        x=x0, f=infs, g=torch.zeros_like(x0),
        s_hist=torch.zeros((L, m, d), dtype=dt, device=dev),
        y_hist=torch.zeros((L, m, d), dtype=dt, device=dev),
        rho_hist=torch.zeros((L, m), dtype=dt, device=dev), hist_len=i0,
        head=i0, gamma=ones, n_iters=i0, n_evals=i0, n_fail=i0, done=false,
        converged=false, bootstrap=~false, starting=false,
        direction=torch.zeros_like(x0), dg0=zeros, stage=i0, alpha=zeros,
        a_lo=zeros, a_hi=zeros, f_lo=infs, a_prev=zeros, f_prev=infs,
        ls_evals=i0, a_star=zeros, f_star=infs, g_star=torch.zeros_like(x0),
        x_star=x0, ok=false)

    while bool(torch.any(~st.done)):
        direction = _two_loop_direction(st.g, st.s_hist, st.y_hist,
                                        st.rho_hist, st.hist_len, st.head,
                                        st.gamma)
        dgn = _dot(direction, st.g)
        bad_dir = (dgn >= 0) | ~torch.isfinite(dgn)
        direction = where(_col(bad_dir), -st.g, direction)
        gmax = torch.amax(torch.abs(st.g), dim=-1)
        first = st.hist_len == 0
        init_step = where(first, torch.clamp(1.0 / torch.clamp(gmax, min=1e-8),
                                             max=1.0), ones)

        opening = st.starting
        direction = where(_col(opening), direction, st.direction)
        dg0 = where(opening, _dot(direction, st.g), st.dg0)
        alpha = where(opening, init_step, st.alpha)
        stage = where(opening, i0, st.stage)
        a_lo = where(opening, zeros, st.a_lo)
        a_hi = where(opening, zeros, st.a_hi)
        f_lo = where(opening, st.f, st.f_lo)
        a_prev = where(opening, zeros, st.a_prev)
        f_prev = where(opening, st.f, st.f_prev)
        ls_evals = where(opening, i0, st.ls_evals)
        a_star = where(opening, zeros, st.a_star)
        f_star = where(opening, st.f, st.f_star)
        g_star = where(_col(opening), st.g, st.g_star)
        x_star = where(_col(opening), st.x, st.x_star)
        ok = where(opening, false, st.ok)

        # ---- the one batch-level evaluation of this trip ----
        x_try = where(_col(st.bootstrap), st.x, st.x + _col(alpha) * direction)
        f_try, g_try = safe_vg(x_try)
        f_try = where(torch.isfinite(f_try), f_try, infs)
        dg_try = _dot(g_try, direction)
        n_evals = st.n_evals + 1
        ls_evals = ls_evals + 1

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

        in_zoom = stage == 1
        accept = where(in_zoom, zm_accept, br_accept)
        new_stage = where(in_zoom, zm_stage, br_stage)
        new_a_lo = where(in_zoom, zm_a_lo, br_a_lo)
        new_a_hi = where(in_zoom, zm_a_hi, br_a_hi)
        new_f_lo = where(in_zoom, zm_f_lo, br_f_lo)
        next_alpha = where(in_zoom, zm_alpha, br_alpha)

        take_star = accept | ((f_try < f_star) & (new_stage != 2))
        a_star = where(take_star, alpha, a_star)
        f_star = where(take_star, f_try, f_star)
        g_star = where(_col(take_star), g_try, g_star)
        x_star = where(_col(take_star), x_try, x_star)
        ok = ok | take_star

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
            direction=direction, dg0=dg0,
            stage=new_stage, alpha=next_alpha,
            a_lo=new_a_lo, a_hi=new_a_hi, f_lo=new_f_lo,
            a_prev=alpha, f_prev=f_try, ls_evals=ls_evals,
            a_star=a_star, f_star=f_star, g_star=g_star, x_star=x_star,
            ok=ok)
        # Done lanes hold their state.
        st = _BState(*(where(st.done.view(-1, *([1] * (old.dim() - 1))),
                             old, upd) for old, upd in zip(st, new)))

    return LBFGSResult(x=st.x, f=st.f, grad=st.g, n_iters=st.n_iters,
                       n_evals=st.n_evals, converged=st.converged)
