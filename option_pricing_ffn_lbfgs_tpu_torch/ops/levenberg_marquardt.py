"""Levenberg–Marquardt for the 13-parameter least-squares polish.

Port of the JAX package's ``ops/levenberg_marquardt.py``:
``lm_minimize_batched`` (the engine) and ``lm_minimize`` (one lane, a
thin layer over the engine). Each lane solves the damped normal equations
``(J^T J + lam diag(J^T J)) dx = -J^T r`` by Cholesky and accepts a step
only if the true (high-precision) cost decreases; the stopping tests
(gtol, ftol incl. the rejected-step stall, xtol incl. the rejection-side
stall, cost_target, lambda_max, maxiter) are the JAX ones. The loop runs
while any lane is not done, reading one flag from the device per trip.

A lane whose damped matrix is not positive definite (``cholesky_ex``
``info != 0``) takes ``dx = 0``, which is what JAX's NaN factor followed
by ``where(isfinite(dx), dx, 0)`` gives.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from ..utils.config import LMConfig


class LMResult(NamedTuple):
    x: torch.Tensor          # final iterates [L, d]
    f: torch.Tensor          # final cost sum(r^2) [L]
    grad: torch.Tensor       # final gradient 2 J^T r [L, d]
    r: torch.Tensor          # final residuals [L, m]
    n_iters: torch.Tensor    # outer iterations (incl. the bootstrap trip) [L]
    n_evals: torch.Tensor    # residual (+Jacobian) evaluations [L]
    converged: torch.Tensor  # hit gtol/ftol/xtol/cost_target [L]
    lam: torch.Tensor        # final damping, the warm start of a continuation


def lm_minimize(residual_fn: Callable, x0: torch.Tensor,
                config: LMConfig = LMConfig(),
                jac_residual_fn: Callable = None,
                lam0=None) -> LMResult:
    """Minimize ``sum(residual_fn(x)**2)`` from ``x0 [d]`` (one lane; the
    result's fields have no lane axis).

    ``residual_fn`` maps ``[d] -> [m]`` (plain torch code); its Jacobian is
    ``torch.func.jacfwd`` of it. ``jac_residual_fn``: an optional
    lower-precision twin of ``residual_fn`` used only for the Jacobian,
    evaluated at ``x`` cast to float32 and cast back, as in JAX.
    ``lam0``: an optional initial damping (a previous result's ``lam``, to
    continue that solve).
    """
    if jac_residual_fn is None:
        jac = lambda x: torch.func.jacfwd(residual_fn)(x)
    else:
        jac = lambda x: torch.func.jacfwd(jac_residual_fn)(
            x.to(torch.float32))
    if lam0 is not None:
        lam0 = torch.as_tensor(lam0, dtype=x0.dtype,
                               device=x0.device).reshape(1)
    res = lm_minimize_batched(lambda x: residual_fn(x[0])[None], x0[None],
                              config, jac_fn=lambda x: jac(x[0])[None],
                              lam0=lam0)
    return LMResult(*(a[0] for a in res))


class _State(NamedTuple):
    x: torch.Tensor
    r: torch.Tensor
    J: torch.Tensor
    cost: torch.Tensor
    lam: torch.Tensor
    n_iters: torch.Tensor
    n_evals: torch.Tensor
    done: torch.Tensor
    converged: torch.Tensor


def lm_minimize_batched(residual_fn: Callable, x0: torch.Tensor,
                        config: LMConfig = LMConfig(),
                        jac_fn: Callable = None,
                        lam0: torch.Tensor = None) -> LMResult:
    """Minimize ``sum(residual_fn(x)**2, -1)`` for every lane of ``x0``.

    Args:
      residual_fn: ``[L, d] -> [L, m]`` at the precision of ``x0``; each
        lane's residuals depend on that lane's row only.
      jac_fn: ``[L, d] -> [L, m, d]`` (any dtype; cast to ``x0``'s). The
        default is ``torch.func.jacfwd`` of ``residual_fn`` (plain tensor
        code only); the calibrator passes the K3 Jacobian.
      lam0: optional ``[L]`` initial damping (continuation warm start).
    The first trip only evaluates ``r(x0)`` (zero Jacobian, zero step,
    accepted against an infinite cost), as in the JAX engine.
    """
    if jac_fn is None:
        def jac_fn(x):
            # d r / d delta for a delta shared by all lanes is the per-lane
            # Jacobian, since lanes are independent.
            zero = torch.zeros(x.shape[-1], dtype=x.dtype, device=x.device)
            return torch.func.jacfwd(lambda dl: residual_fn(x + dl))(zero)

    dt, dev = x0.dtype, x0.device
    L, d = x0.shape
    where = torch.where
    r0 = residual_fn(x0)
    m_res = r0.shape[-1]
    lam_init = (torch.full((L,), config.lambda_init, dtype=dt, device=dev)
                if lam0 is None else lam0.to(dt))
    i0 = torch.zeros((L,), dtype=torch.int32, device=dev)
    false = torch.zeros((L,), dtype=torch.bool, device=dev)
    st = _State(
        x=x0, r=torch.full((L, m_res), float("nan"), dtype=dt, device=dev),
        J=torch.zeros((L, m_res, d), dtype=dt, device=dev),
        cost=torch.full((L,), float("inf"), dtype=dt, device=dev),
        lam=lam_init, n_iters=i0, n_evals=i0, done=false, converged=false)
    eye = torch.eye(d, dtype=dt, device=dev)
    first = True

    while bool(torch.any(~st.done)):
        jtj = torch.einsum("lmd,lme->lde", st.J, st.J)
        g = torch.einsum("lmd,lm->ld", st.J, st.r)
        diag = torch.clamp(torch.diagonal(jtj, dim1=-2, dim2=-1), min=1e-32)
        A = jtj + st.lam[:, None, None] * (diag[:, :, None] * eye)
        chol, info = torch.linalg.cholesky_ex(A)
        dx = -torch.cholesky_solve(g[..., None], chol)[..., 0]
        dx = where(torch.isfinite(dx) & (info == 0)[:, None], dx,
                   torch.zeros_like(dx))

        x_try = st.x + dx
        # The bootstrap trip's step is exactly zero: reuse r(x0).
        r_try = r0 if first else residual_fn(x_try)
        first = False
        j_try = jac_fn(x_try).to(dt)
        cost_try = torch.sum(torch.square(
            where(torch.isfinite(r_try), r_try,
                  torch.full_like(r_try, float("inf")))), dim=-1)
        accept = cost_try < st.cost

        col = accept[:, None]
        x_new = where(col, x_try, st.x)
        r_new = where(col, r_try, st.r)
        J_new = where(accept[:, None, None], j_try, st.J)
        cost_new = where(accept, cost_try, st.cost)
        lam = where(accept,
                    torch.clamp(st.lam * config.lambda_down,
                                min=config.lambda_min),
                    st.lam * config.lambda_up)

        step_small = torch.amax(torch.abs(dx), dim=-1) <= config.xtol * \
            torch.clamp(torch.amax(torch.abs(st.x), dim=-1), min=1.0)
        xconv_stall = ((~accept) & step_small
                       & (st.lam > 10.0 * config.lambda_init))
        fscale = torch.clamp(torch.maximum(st.cost, cost_try), min=1.0)
        fconv_accept = accept & ((st.cost - cost_try) <= config.ftol * fscale)
        fconv_stall = (~accept) & (torch.abs(cost_try - st.cost)
                                   <= config.ftol * fscale)
        gconv = torch.amax(torch.abs(g), dim=-1) <= config.gtol
        bootstrap = ~torch.isfinite(st.cost)
        tconv = ((cost_new <= config.cost_target) if config.cost_target > 0
                 else false)
        converged = (gconv | fconv_accept | fconv_stall | (accept & step_small)
                     | xconv_stall | tconv) & ~bootstrap
        give_up = (lam > config.lambda_max) & ~bootstrap
        n_iters = st.n_iters + 1
        done = converged | give_up | (n_iters >= config.maxiter + 1)

        new = _State(x=x_new, r=r_new, J=J_new, cost=cost_new, lam=lam,
                     n_iters=n_iters, n_evals=st.n_evals + 1, done=done,
                     converged=st.converged | converged)
        st = _State(*(where(st.done.view(-1, *([1] * (old.dim() - 1))),
                            old, upd) for old, upd in zip(st, new)))

    grad = 2.0 * torch.einsum("lmd,lm->ld", st.J, st.r)
    return LMResult(x=st.x, f=st.cost, grad=grad, r=st.r,
                    n_iters=st.n_iters, n_evals=st.n_evals,
                    converged=st.converged, lam=st.lam)
