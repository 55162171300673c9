"""Levenberg–Marquardt for the 13-parameter least-squares polish.

Port of the JAX package's ``ops/levenberg_marquardt.py``:
``lm_minimize_batched`` (the engine) and ``lm_minimize`` (one lane, a
thin layer over the engine). Each lane solves the damped normal equations
``(J^T J + lam diag(J^T J)) dx = -J^T r`` by Cholesky and accepts a step
only if the true (high-precision) cost decreases; the stopping tests
(gtol, ftol incl. the rejected-step stall, xtol incl. the rejection-side
stall, cost_target, lambda_max, maxiter) are the JAX ones. A trip is
split at its one evaluation::

    x_try = lm_open(st, config, status)                  # K6
    r_try, j_try = residual_fn(x_try), jac_fn(x_try)     # K1<double>, K3
    lm_update(st, x_try, r_try, j_try, config, status)   # K7

  * K6, ``lm_open``: for every lane that is not done, ``J^T J`` and
    ``J^T r`` accumulated over the residual rows in order, the diagonal
    floored at 1e-32 and damped by ``lam``, a column-by-column Cholesky
    factor, forward then back substitution, and ``x_try = x + dx``. A lane
    whose factor meets a pivot that is not positive and finite, or whose
    step has a non-finite entry, takes 0 there (JAX's NaN factor followed
    by ``where(isfinite(dx), dx, 0)``). It keeps ``max |dx|`` and
    ``max |J^T r|`` in the state for K7; a done lane's ``x_try`` is its
    ``x``.
  * K7, ``lm_update``: the trial cost (non-finite residuals count as
    +inf), the accept test and the ``x/r/J/cost/lam`` update, every
    stopping test, the counters; done lanes hold. It counts the lanes not
    done.

On CUDA tensors the wrappers launch the hand-written kernels of
``csrc/lm_trip.cu``, which update the state tensors in place; K6 zeroes a
device ``int32`` live count that K7 adds to, and the loop reads it once a
trip (where the JAX package evaluates its ``while_loop`` condition on the
device). On CPU tensors the wrappers run the plain versions
``lm_open_plain`` / ``lm_update_plain``, which build new state tensors and
hold the kernels' order of operations (sums over rows in sequence, the
factor's inner sums in sequence, forward then back substitution), and copy
the result into the state. There is no other path: a CUDA tensor launches
the kernels or raises.

The first trip only evaluates ``r(x0)`` (zero Jacobian, so a zero step,
accepted against an infinite cost), as in the JAX engine.
"""
from __future__ import annotations

import ctypes
from typing import Callable, NamedTuple

import torch

from ..utils.config import LMConfig
from . import kernel_build

# Launches of each kernel, counted where it is launched.
LAUNCHES = {"lm_open": 0, "lm_update": 0, "lm_open_f64": 0,
            "lm_update_f64": 0}
# The kernels give a lane one warp, a thread per coordinate.
MAX_DIM = 32


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
    dx_max: torch.Tensor      # K6's max |dx| for K7's step tests
    g_max: torch.Tensor       # K6's max |J^T r| for K7's gtol test


# Each field's trailing shape ("d": [L, d]; "m": [L, m]; "md": [L, m, d];
# "": [L]) and kind ("t": the working dtype, "i": int32, "b": bool), in
# the order csrc/lm_trip.cu's State<T> takes the pointers.
_LAYOUT = {
    "x": ("d", "t"), "r": ("m", "t"), "J": ("md", "t"), "cost": ("", "t"),
    "lam": ("", "t"), "n_iters": ("", "i"), "n_evals": ("", "i"),
    "done": ("", "b"), "converged": ("", "b"), "dx_max": ("", "t"),
    "g_max": ("", "t"),
}
assert tuple(_LAYOUT) == _State._fields


def init_state(x0: torch.Tensor, m: int, config: LMConfig,
               lam0: torch.Tensor = None) -> _State:
    """The engine's state before its first (bootstrap) trip: residuals
    NaN, a zero Jacobian, an infinite cost. Every field is a tensor of its
    own, so the kernels may update them in place; ``x0`` is copied."""
    dt, dev = x0.dtype, x0.device
    L, d = x0.shape
    shapes = {"d": (L, d), "m": (L, m), "md": (L, m, d), "": (L,)}
    types = {"t": dt, "i": torch.int32, "b": torch.bool}
    fill = {"r": float("nan"), "cost": float("inf"),
            "lam": config.lambda_init}
    st = {name: torch.full(shapes[shape], fill.get(name, 0),
                           dtype=types[kind], device=dev)
          for name, (shape, kind) in _LAYOUT.items()}
    st["x"] = x0.clone()
    if lam0 is not None:
        st["lam"] = lam0.to(dtype=dt, device=dev).clone().reshape(L)
    return _State(**st)


def damped_normal_equations(J, r, lam):
    """``(A [L, d, d], g [L, d])``: ``J^T J`` and ``g = J^T r``, each entry
    summed over the m rows in order from 0, and ``A = J^T J + lam
    diag(max(diag(J^T J), 1e-32))`` (zero damping off the diagonal)."""
    L, m, d = J.shape
    jtj = torch.zeros((L, d, d), dtype=J.dtype, device=J.device)
    g = torch.zeros((L, d), dtype=J.dtype, device=J.device)
    for k in range(m):
        row = J[:, k]
        jtj = jtj + row[:, :, None] * row[:, None, :]
        g = g + row * r[:, k:k + 1]
    diag = torch.clamp(torch.diagonal(jtj, dim1=-2, dim2=-1), min=1e-32)
    return jtj + lam[:, None, None] * torch.diag_embed(diag), g


def cholesky(A):
    """Column-by-column Cholesky factor ``C`` (lower, zero above) of
    ``A [L, d, d]`` and ``ok [L]``: every pivot positive and finite. Column
    j's entries are ``A[i, j] - C[i, 0] C[j, 0] - C[i, 1] C[j, 1] - ...``
    in that order, the diagonal's square root, the rest divided by it."""
    L, d = A.shape[0], A.shape[-1]
    C = torch.zeros_like(A)
    ok = torch.ones(L, dtype=torch.bool, device=A.device)
    for j in range(d):
        s = A[:, j:, j]
        for k in range(j):
            s = s - C[:, j:, k] * C[:, j, k:k + 1]
        pivot = s[:, 0]
        ok = ok & (pivot > 0) & torch.isfinite(pivot)
        root = torch.sqrt(pivot)
        C[:, j, j] = root
        C[:, j + 1:, j] = s[:, 1:] / root[:, None]
    return C, ok


def _cho_solve(C, g):
    """``z`` with ``C C^T z = g``: forward substitution (row i takes
    ``C[i, j] y_j`` off for j = 0, 1, ...), then back substitution (row i
    takes ``C[k, i] z_k`` off for k = d-1, d-2, ...)."""
    d = g.shape[-1]
    y = torch.empty_like(g)
    s = g
    for j in range(d):
        y[:, j] = s[:, j] / C[:, j, j]
        s = s - C[:, :, j] * y[:, j:j + 1]
    z = torch.empty_like(g)
    u = y
    for k in reversed(range(d)):
        z[:, k] = u[:, k] / C[:, k, k]
        u = u - C[:, k, :] * z[:, k:k + 1]
    return z


def _hold(done, old: _State, new: _State) -> _State:
    return _State(*(torch.where(done.view(-1, *([1] * (o.dim() - 1))), o, u)
                    for o, u in zip(old, new)))


def lm_open_plain(st: _State, config: LMConfig):
    """Plain K6: ``(state, x_try)``. For lanes not done: the damped
    normal equations solved by Cholesky, ``dx_max`` and ``g_max`` set;
    ``x_try = x + dx``. Done lanes keep every field and ``x_try`` is their
    ``x``. Builds new tensors."""
    A, g = damped_normal_equations(st.J, st.r, st.lam)
    C, ok = cholesky(A)
    dx = -_cho_solve(C, g)
    dx = torch.where(torch.isfinite(dx) & ok[:, None], dx,
                     torch.zeros_like(dx))
    new = st._replace(dx_max=torch.amax(torch.abs(dx), dim=-1),
                      g_max=torch.amax(torch.abs(g), dim=-1))
    x_try = torch.where(st.done[:, None], st.x, st.x + dx)
    return _hold(st.done, st, new), x_try


def trial_cost(r_try):
    """``sum(r^2)`` over the rows in order, a non-finite entry as +inf."""
    r = torch.where(torch.isfinite(r_try), r_try,
                    torch.full_like(r_try, float("inf")))
    cost = torch.zeros_like(r[:, 0])
    for k in range(r.shape[-1]):
        cost = cost + r[:, k] * r[:, k]
    return cost


def stop_tests(st: _State, cost_try, config: LMConfig) -> dict:
    """The accept test, the new damping and every stopping test of a trip
    whose trial cost is ``cost_try``, as ``[L]`` tensors by name."""
    accept = cost_try < st.cost
    cost_new = torch.where(accept, cost_try, st.cost)
    lam = torch.where(accept,
                      torch.clamp(st.lam * config.lambda_down,
                                  min=config.lambda_min),
                      st.lam * config.lambda_up)
    step_small = st.dx_max <= config.xtol * torch.clamp(
        torch.amax(torch.abs(st.x), dim=-1), min=1.0)
    xconv_stall = ((~accept) & step_small
                   & (st.lam > 10.0 * config.lambda_init))
    fscale = torch.clamp(torch.maximum(st.cost, cost_try), min=1.0)
    fconv_accept = accept & ((st.cost - cost_try) <= config.ftol * fscale)
    fconv_stall = (~accept) & (torch.abs(cost_try - st.cost)
                               <= config.ftol * fscale)
    gconv = st.g_max <= config.gtol
    bootstrap = ~torch.isfinite(st.cost)
    tconv = ((cost_new <= config.cost_target) if config.cost_target > 0
             else torch.zeros_like(accept))
    converged = (gconv | fconv_accept | fconv_stall | (accept & step_small)
                 | xconv_stall | tconv) & ~bootstrap
    give_up = (lam > config.lambda_max) & ~bootstrap
    n_iters = st.n_iters + 1
    maxiter = n_iters >= config.maxiter + 1
    return dict(accept=accept, cost_new=cost_new, lam=lam,
                step_small=step_small, xconv_stall=xconv_stall,
                fconv_accept=fconv_accept, fconv_stall=fconv_stall,
                gconv=gconv, tconv=tconv, bootstrap=bootstrap,
                converged=converged, give_up=give_up, n_iters=n_iters,
                maxiter=maxiter, done=converged | give_up | maxiter)


def lm_update_plain(st: _State, x_try, r_try, j_try,
                    config: LMConfig) -> _State:
    """Plain K7: the state after the evaluation ``(r_try, j_try)`` at
    ``x_try`` of a state opened by ``lm_open_plain``; lanes that were
    done keep every field. Builds new tensors."""
    t = stop_tests(st, trial_cost(r_try), config)
    accept = t["accept"]
    new = st._replace(
        x=torch.where(accept[:, None], x_try, st.x),
        r=torch.where(accept[:, None], r_try, st.r),
        J=torch.where(accept[:, None, None], j_try, st.J),
        cost=t["cost_new"], lam=t["lam"], n_iters=t["n_iters"],
        n_evals=st.n_evals + 1, done=t["done"],
        converged=st.converged | t["converged"])
    return _hold(st.done, st, new)


# ------------------------------------------------------------- wrappers --

def _check_state(st: _State):
    """(L, m, d) of a state the kernels take; raises on anything else."""
    if not isinstance(st, _State):
        raise TypeError("the LM trip takes a _State")
    L, d = st.x.shape
    m = st.r.shape[-1] if st.r.dim() == 2 else 0
    dt, dev = st.x.dtype, st.x.device
    if dt not in (torch.float32, torch.float64):
        raise ValueError(f"K6/K7 take float32 or float64, got {dt}")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"K6/K7 take CUDA or CPU tensors, got {dev}")
    if not 1 <= d <= MAX_DIM or m < 1:
        raise ValueError(f"K6/K7 take 1 <= d <= {MAX_DIM} and m >= 1 "
                         f"residual rows, got d={d}, m={m}")
    shapes = {"d": (L, d), "m": (L, m), "md": (L, m, d), "": (L,)}
    types = {"t": dt, "i": torch.int32, "b": torch.bool}
    for name, (shape, kind) in _LAYOUT.items():
        t = getattr(st, name)
        if (t.shape != shapes[shape] or t.dtype != types[kind]
                or t.device != dev or not t.is_contiguous()):
            raise ValueError(
                f"state field {name}: expected contiguous {types[kind]} "
                f"{shapes[shape]} on {dev}, got {t.dtype} "
                f"{tuple(t.shape)} on {t.device}")
    return L, m, d


def _check_status(status: torch.Tensor, dev):
    if (status.shape != (1,) or status.dtype != torch.int32
            or status.device != dev or not status.is_contiguous()):
        raise ValueError("status must be int32 [1] (the live count) on the "
                         "state's device")


def _trial(st: _State, x_try, r_try, j_try):
    """The evaluation's tensors, checked against the state; contiguous."""
    L, d = st.x.shape
    m = st.r.shape[-1]
    dt, dev = st.x.dtype, st.x.device
    for name, t, shape in (("x_try", x_try, (L, d)), ("r_try", r_try, (L, m)),
                           ("j_try", j_try, (L, m, d))):
        if t.shape != shape or t.dtype != dt or t.device != dev:
            raise ValueError(f"{name}: expected {dt} {shape} on {dev}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    return x_try.contiguous(), r_try.contiguous(), j_try.contiguous()


def _assign(st: _State, new: _State):
    for old, upd in zip(st, new):
        if old is not upd:
            old.copy_(upd)


def _open_plain_inplace(st, config, status):
    new, x_try = lm_open_plain(st, config)
    _assign(st, new)
    status[0] = 0
    return x_try


def _update_plain_inplace(st, x_try, r_try, j_try, config, status):
    _assign(st, lm_update_plain(st, x_try, r_try, j_try, config))
    status[0] = torch.count_nonzero(~st.done).to(torch.int32)


# state, x_try, status, L, m, d, stream
_OPEN_ARGTYPES = [ctypes.POINTER(ctypes.c_void_p), ctypes.c_void_p,
                  ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                  ctypes.c_void_p]
# state, x_try, r_try, j_try, status; ftol, gtol, xtol, lambda_down,
# lambda_up, lambda_min, lambda_max, 10 lambda_init, cost_target; maxiter,
# L, m, d; stream
_UPDATE_ARGTYPES = ([ctypes.POINTER(ctypes.c_void_p)] + [ctypes.c_void_p] * 4
                    + [ctypes.c_double] * 9 + [ctypes.c_int] * 4
                    + [ctypes.c_void_p])


def _suffix(dt):
    return "f32" if dt == torch.float32 else "f64"


def _count_key(kind, dt):
    return f"lm_{kind}" + ("" if dt == torch.float32 else "_f64")


def _pointers(st: _State):
    return (ctypes.c_void_p * len(st))(*(t.data_ptr() for t in st))


def lm_open(st: _State, config: LMConfig,
            status: torch.Tensor) -> torch.Tensor:
    """K6: solve every lane that is not done, in place (``dx_max``,
    ``g_max``), and return ``x_try [L, d]``; zero the live count
    ``status[0]``. CUDA tensors launch the kernel; CPU tensors run
    ``lm_open_plain``."""
    L, m, d = _check_state(st)
    _check_status(status, st.x.device)
    if st.x.device.type == "cpu":
        return _open_plain_inplace(st, config, status)
    x_try = torch.empty_like(st.x)
    if L == 0:
        status[0] = 0
        return x_try
    dt = st.x.dtype
    err = kernel_build.entry("lm_trip", f"lm_open_{_suffix(dt)}",
                             _OPEN_ARGTYPES)(
        _pointers(st), x_try.data_ptr(), status.data_ptr(), L, m, d,
        torch.cuda.current_stream(st.x.device).cuda_stream)
    kernel_build.check(err, _count_key("open", dt))
    LAUNCHES[_count_key("open", dt)] += 1
    return x_try


def lm_update(st: _State, x_try, r_try, j_try, config: LMConfig,
              status: torch.Tensor) -> None:
    """K7: advance every lane that is not done by the evaluation
    ``(r_try [L, m], j_try [L, m, d])`` at ``x_try``, in place, and add the
    count of lanes not done afterwards to ``status[0]``. CUDA tensors
    launch the kernel; CPU tensors run ``lm_update_plain``."""
    L, m, d = _check_state(st)
    _check_status(status, st.x.device)
    x_try, r_try, j_try = _trial(st, x_try, r_try, j_try)
    if st.x.device.type == "cpu":
        _update_plain_inplace(st, x_try, r_try, j_try, config, status)
        return
    if L == 0:
        return
    dt = st.x.dtype
    c = config
    err = kernel_build.entry("lm_trip", f"lm_update_{_suffix(dt)}",
                             _UPDATE_ARGTYPES)(
        _pointers(st), x_try.data_ptr(), r_try.data_ptr(), j_try.data_ptr(),
        status.data_ptr(), float(c.ftol), float(c.gtol), float(c.xtol),
        float(c.lambda_down), float(c.lambda_up), float(c.lambda_min),
        float(c.lambda_max), float(10.0 * c.lambda_init),
        float(c.cost_target), int(c.maxiter), L, m, d,
        torch.cuda.current_stream(st.x.device).cuda_stream)
    kernel_build.check(err, _count_key("update", dt))
    LAUNCHES[_count_key("update", dt)] += 1


def read_live(status: torch.Tensor) -> int:
    """The live count of the last trip: the one host read of a trip."""
    return int(status.item())


def _run(residual_fn: Callable, jac_fn: Callable, x0: torch.Tensor,
         config: LMConfig, lam0: torch.Tensor = None,
         open_fn: Callable = lm_open,
         update_fn: Callable = lm_update) -> LMResult:
    """The engine's loop over one pair of trip functions with the
    wrappers' in-place signatures: the kernels (the default) or
    ``_open_plain_inplace`` / ``_update_plain_inplace``, which the card's
    checks run to hold the kernels against the plain pair. The bootstrap
    trip's step is exactly zero, so it reuses ``r(x0)``."""
    dt = x0.dtype
    r0 = residual_fn(x0)
    st = init_state(x0, r0.shape[-1], config, lam0)
    status = torch.zeros(1, dtype=torch.int32, device=x0.device)
    live, first = x0.shape[0], True
    while live:
        x_try = open_fn(st, config, status)
        r_try = r0 if first else residual_fn(x_try)
        first = False
        update_fn(st, x_try, r_try, jac_fn(x_try).to(dt), config, status)
        live = read_live(status)
    grad = 2.0 * torch.einsum("lmd,lm->ld", st.J, st.r)
    return LMResult(x=st.x, f=st.cost, grad=grad, r=st.r,
                    n_iters=st.n_iters, n_evals=st.n_evals,
                    converged=st.converged, lam=st.lam)


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
    On CUDA tensors every trip runs K6 and K7; on CPU tensors their plain
    versions.
    """
    if jac_fn is None:
        def jac_fn(x):
            # d r / d delta for a delta shared by all lanes is the per-lane
            # Jacobian, since lanes are independent.
            zero = torch.zeros(x.shape[-1], dtype=x.dtype, device=x.device)
            return torch.func.jacfwd(lambda dl: residual_fn(x + dl))(zero)
    return _run(residual_fn, jac_fn, x0, config, lam0)
