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

The engine binds its trip once a run (``_bind_trip``; ``LMTripKernels``
prepares the launches). The LM polish's objective
(``calibration/calibrator.py::PolishObjective``) binds a fused trip::

    open(boot)      # fused K6: x_try, params64, params32
    k1()            # K1<double> prices params64 into a bound buffer
    k3()            # K3 differentiates params32 into a bound buffer
    update()        # fused K7: assembles (r, J), then K7

and one read; on CPU tensors the plain pair ``lm_open_fused_plain`` /
``lm_update_fused_plain`` around the plain K1 and K3. The fused entries
take float64 states with d = 13 and m = n + 2 <= ``MAX_FUSED_ROWS`` rows;
the objective binds no fused trip on other shapes, and the engine runs
the unfused trip around its host assembly.

The first trip only evaluates ``r(x0)`` (zero Jacobian, so a zero step,
accepted against an infinite cost), as in the JAX engine: the unfused
trip reuses the residuals it took at x0, the fused K6 gives K1 the
parameters of x (not of x_try = x + 0, whose -0.0 coordinates would be
+0.0).
"""
from __future__ import annotations

import ctypes
import math
from typing import Callable, NamedTuple

import torch

from ..calibration.transforms import transform
from ..utils import tracing
from ..utils.config import LMConfig
from . import kernel_build
from .loss_kernel import polish_assembly_plain

# Launches of each kernel, counted where it is launched.
LAUNCHES = {"lm_open": 0, "lm_update": 0, "lm_open_f64": 0,
            "lm_update_f64": 0, "lm_open_fused_f64": 0,
            "lm_update_fused_f64": 0}
# The kernels give a lane one warp, a thread per coordinate.
MAX_DIM = 32
# The fused mode: the model's 13 parameters and at most 128 residual rows
# a lane (n options + the two Feller rows; csrc/lm_trip.cu kMaxFusedRows).
N_PARAMS = 13
MAX_FUSED_ROWS = 128


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
               lam0: torch.Tensor = None, live: int = None) -> _State:
    """The engine's state before its first (bootstrap) trip: residuals
    NaN, a zero Jacobian, an infinite cost. Every field is a tensor of its
    own, so the kernels may update them in place; ``x0`` is copied. With
    ``live`` the lanes from ``live`` on start done (padding): every trip
    holds them, and the live count leaves them out."""
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
    if live is not None:
        st["done"][live:] = True
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


def lm_open_fused_plain(st: _State, config: LMConfig, boot: bool):
    """Plain fused K6: ``(state, x_try, params64, params32)`` with
    ``params64 = transform(x_try)`` (``transform(x)`` on the bootstrap
    trip, ``boot``, whose residuals the host path takes at x0) and
    ``params32 = transform(float32(x_try))``. Builds new tensors."""
    new, x_try = lm_open_plain(st, config)
    params64 = transform(st.x if boot else x_try)
    return new, x_try, params64, transform(x_try.to(torch.float32))


def lm_update_fused_plain(st: _State, x_try, params64, params32, price,
                          j_price, mkt, weight: float, bad_loss: float,
                          config: LMConfig) -> _State:
    """Plain fused K7: the polish's host assembly
    (``loss_kernel.polish_assembly_plain``) from K1's prices and K3's rows,
    then ``lm_update_plain`` on its (r, J)."""
    r_try, j_try = polish_assembly_plain(price, j_price, mkt, params64,
                                         params32, weight, bad_loss)
    return lm_update_plain(st, x_try, r_try, j_try, config)


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


def _open_fused_plain_inplace(st, config, status, boot):
    new, x_try, params64, params32 = lm_open_fused_plain(st, config, boot)
    _assign(st, new)
    status[0] = 0
    return x_try, params64, params32


def _update_fused_plain_inplace(st, x_try, params64, params32, price,
                                j_price, trial, config, status):
    _assign(st, lm_update_fused_plain(
        st, x_try, params64, params32, price, j_price, trial.mkt,
        trial.weight, trial.bad_loss, config))
    status[0] = torch.count_nonzero(~st.done).to(torch.int32)


class LMFusedTrial(NamedTuple):
    """What the fused entries take besides the state, from the objective
    that binds them (``calibration/calibrator.py::PolishObjective``): the
    buffers around K1 and K3, ``params64 [L, 13]`` (double; fused K6 writes
    it, K1 reads it), ``params32 [L, 13]`` (float; fused K6 writes it, K3
    reads it), K1's ``price [L, n]`` and K3's rows ``jac [L, n, 13]``
    (float), which fused K7 reads with the lanes' market prices ``mkt
    [L, n]``; the Feller weight and ``bad_loss``; the transform's
    ``exp_mask`` and ``tanh_mask`` (bit c: coordinate c); ``feller``, each
    variance factor's (sigma, kappa, theta) indices."""
    params64: torch.Tensor
    params32: torch.Tensor
    price: torch.Tensor
    jac: torch.Tensor
    mkt: torch.Tensor
    weight: float
    bad_loss: float
    exp_mask: int
    tanh_mask: int
    feller: tuple


def _check_buffer(name, t, shape, dt, dev):
    if (tuple(t.shape) != shape or t.dtype != dt or t.device != dev
            or not t.is_contiguous()):
        raise ValueError(f"{name}: expected contiguous {dt} {shape} on "
                         f"{dev}, got {t.dtype} {tuple(t.shape)} on "
                         f"{t.device}")


def _check_fused(st: _State, trial: LMFusedTrial):
    """Raises unless ``trial`` fits the state for the fused kernels: a
    float64 state with d = 13 and m = n + 2 <= ``MAX_FUSED_ROWS`` rows."""
    L, m, d = _check_state(st)
    dev = st.x.device
    if st.x.dtype != torch.float64 or d != N_PARAMS:
        raise ValueError(f"the fused LM trip takes a float64 state with "
                         f"d = {N_PARAMS}, got {st.x.dtype}, d={d}")
    if trial.mkt.dim() != 2 or trial.mkt.shape[1] + 2 != m \
            or not 3 <= m <= MAX_FUSED_ROWS:
        raise ValueError(f"the fused LM trip takes market prices [L, n] "
                         f"with m = n + 2 <= {MAX_FUSED_ROWS} residual "
                         f"rows, n >= 1; got m={m}, market prices "
                         f"{tuple(trial.mkt.shape)}")
    if (trial.exp_mask | trial.tanh_mask) >> N_PARAMS or (
            trial.exp_mask & trial.tanh_mask):
        raise ValueError("exp_mask and tanh_mask: disjoint coordinate "
                         f"masks below bit {N_PARAMS}")
    idx = [c for factor in trial.feller for c in factor]
    if len(idx) != 6 or not all(0 <= c < N_PARAMS for c in idx):
        raise ValueError("feller: two (sigma, kappa, theta) index triples")
    n = m - 2
    f32, f64 = torch.float32, torch.float64
    for name, shape, dt in (("params64", (L, N_PARAMS), f64),
                            ("params32", (L, N_PARAMS), f32),
                            ("price", (L, n), f64),
                            ("jac", (L, n, N_PARAMS), f32),
                            ("mkt", (L, n), f64)):
        _check_buffer(name, getattr(trial, name), shape, dt, dev)


# state, x_try, status, L, m, d, stream
_OPEN_ARGTYPES = [ctypes.POINTER(ctypes.c_void_p), ctypes.c_void_p,
                  ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                  ctypes.c_void_p]
# state, x_try, params64, params32; exp_mask, tanh_mask; boot; status; L,
# m, d; stream
_OPEN_FUSED_ARGTYPES = ([ctypes.POINTER(ctypes.c_void_p)]
                        + [ctypes.c_void_p] * 3 + [ctypes.c_uint] * 2
                        + [ctypes.c_int] + [ctypes.c_void_p]
                        + [ctypes.c_int] * 3 + [ctypes.c_void_p])
# state, x_try, r_try, j_try, status; ftol, gtol, xtol, lambda_down,
# lambda_up, lambda_min, lambda_max, 10 lambda_init, cost_target; maxiter,
# L, m, d; stream
_UPDATE_ARGTYPES = ([ctypes.POINTER(ctypes.c_void_p)] + [ctypes.c_void_p] * 4
                    + [ctypes.c_double] * 9 + [ctypes.c_int] * 4
                    + [ctypes.c_void_p])
# state, x_try, params64, params32, price, jac, mkt, status; the 9 config
# doubles, weight, sentinel, row_scale; maxiter, n_opt; exp_mask,
# tanh_mask; feller, L, m, d; stream
_UPDATE_FUSED_ARGTYPES = ([ctypes.POINTER(ctypes.c_void_p)]
                          + [ctypes.c_void_p] * 7 + [ctypes.c_double] * 12
                          + [ctypes.c_int] * 2 + [ctypes.c_uint] * 2
                          + [ctypes.c_int] * 4 + [ctypes.c_void_p])


def _suffix(dt):
    return "f32" if dt == torch.float32 else "f64"


def _count_key(kind, dt, fused=False):
    return (f"lm_{kind}" + ("_fused" if fused else "")
            + ("" if dt == torch.float32 else "_f64"))


def _pointers(st: _State):
    return (ctypes.c_void_p * len(st))(*(t.data_ptr() for t in st))


class LMTripKernels:
    """K6 and K7 bound once to the state ``st`` (which they update in
    place), its status word and the trial buffers, CUDA tensors only:
    every check, the pointer array, the C entries, the stream and the
    scalar arguments are prepared here, so each launch is one ctypes call.

    Unfused (``fused=None``): ``open()`` writes ``x_try``; ``update(r_try,
    j_try)`` takes the evaluation at ``x_try``. Fused (``fused`` an
    ``LMFusedTrial``: float64, d = 13, m = n + 2 <= ``MAX_FUSED_ROWS``):
    ``open(boot)`` also writes ``fused.params64`` (at x on the bootstrap
    trip) and ``fused.params32``; ``update()`` assembles the evaluation
    from ``fused``'s K1 prices, K3 rows and market prices."""

    def __init__(self, st: _State, config: LMConfig, status, x_try,
                 fused: LMFusedTrial = None):
        L, m, d = _check_state(st)
        dt, dev = st.x.dtype, st.x.device
        _check_status(status, dev)
        if dev.type != "cuda":
            raise ValueError(f"K6/K7 launch on CUDA tensors, got {dev}")
        _check_buffer("x_try", x_try, (L, d), dt, dev)
        if fused is not None:
            _check_fused(st, fused)
        self._st, self._x_try = st, x_try
        self._keep = (status, fused)
        self._fused = fused is not None
        ptrs = _pointers(st)                 # the fields are updated in place
        stream = torch.cuda.current_stream(dev).cuda_stream
        self._open_key = _count_key("open", dt, self._fused)
        self._update_key = _count_key("update", dt, self._fused)
        c = config
        doubles = (float(c.ftol), float(c.gtol), float(c.xtol),
                   float(c.lambda_down), float(c.lambda_up),
                   float(c.lambda_min), float(c.lambda_max),
                   float(10.0 * c.lambda_init), float(c.cost_target))
        if fused is None:
            self._open_fn = kernel_build.entry(
                "lm_trip", f"lm_open_{_suffix(dt)}", _OPEN_ARGTYPES)
            self._open_args = {False: (ptrs, x_try.data_ptr(),
                                       status.data_ptr(), L, m, d, stream)}
            self._update_fn = kernel_build.entry(
                "lm_trip", f"lm_update_{_suffix(dt)}", _UPDATE_ARGTYPES)
            self._update_args = ((ptrs, x_try.data_ptr()),
                                 (status.data_ptr(), *doubles,
                                  int(c.maxiter), L, m, d, stream))
        else:
            self._open_fn = kernel_build.entry(
                "lm_trip", "lm_open_fused_f64", _OPEN_FUSED_ARGTYPES)
            self._open_args = {
                boot: (ptrs, x_try.data_ptr(), fused.params64.data_ptr(),
                       fused.params32.data_ptr(), fused.exp_mask,
                       fused.tanh_mask, int(boot), status.data_ptr(), L, m,
                       d, stream)
                for boot in (False, True)}
            n = m - 2
            feller = sum(i << (4 * k) for k, i in enumerate(
                i for factor in fused.feller for i in factor))
            self._update_fn = kernel_build.entry(
                "lm_trip", "lm_update_fused_f64", _UPDATE_FUSED_ARGTYPES)
            self._update_args = (
                ptrs, x_try.data_ptr(), fused.params64.data_ptr(),
                fused.params32.data_ptr(), fused.price.data_ptr(),
                fused.jac.data_ptr(), fused.mkt.data_ptr(),
                status.data_ptr(), *doubles, float(fused.weight),
                math.sqrt(fused.bad_loss / m), 1.0 / math.sqrt(n),
                int(c.maxiter), n, fused.exp_mask, fused.tanh_mask, feller,
                L, m, d, stream)

    def open(self, boot: bool = False) -> None:
        """K6: one launch (``boot``: the fused mode's bootstrap trip)."""
        kernel_build.check(self._open_fn(*self._open_args[
            boot and self._fused]), self._open_key)
        LAUNCHES[self._open_key] += 1

    def update(self, r_try=None, j_try=None) -> None:
        """K7: one launch, on ``(r_try, j_try)`` (unfused) or on the fused
        buffers."""
        if self._fused:
            args = self._update_args
        else:
            _, r_try, j_try = _trial(self._st, self._x_try, r_try, j_try)
            head, tail = self._update_args
            args = (*head, r_try.data_ptr(), j_try.data_ptr(), *tail)
        kernel_build.check(self._update_fn(*args), self._update_key)
        LAUNCHES[self._update_key] += 1


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
    LMTripKernels(st, config, status, x_try).open()
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
    LMTripKernels(st, config, status, x_try).update(r_try, j_try)


def read_live(status: torch.Tensor) -> int:
    """The live count of the last trip: the one host read of a trip."""
    return int(status.item())


def _bind_trip(residual_fn: Callable, jac_fn: Callable, x0: torch.Tensor,
               config: LMConfig, lam0, status: torch.Tensor,
               plain: bool, live: int = None):
    """``(state, trip)``: the engine's state before its bootstrap trip
    (``init_state``, with ``live``) and one trip, ``trip(live=None)``,
    bound once, so that everything checked here raises before the first
    trip (``live``, the lanes not done as the trip starts, reaches a bound
    K3: its blocks' width). An objective with
    ``bind_trip(st, config, status, plain)`` and ``n_rows`` binds its own
    trip (it returns None where its fused kernels do not take it). Else
    the residuals are taken at x0 first (the bootstrap trip's step is
    exactly zero, so that trip reuses them), and a trip is, on CUDA tensors
    (unless ``plain``), K6, ``residual_fn`` and ``jac_fn`` at x_try, K7;
    otherwise the plain versions in place."""
    bind = getattr(residual_fn, "bind_trip", None)
    if bind is not None:
        st = init_state(x0, residual_fn.n_rows, config, lam0, live)
        trip = bind(st, config, status, plain)
        if trip is not None:
            return st, trip
    dt = x0.dtype
    r0 = [residual_fn(x0)]
    st = init_state(x0, r0[0].shape[-1], config, lam0, live)
    _check_state(st)
    _check_status(status, st.x.device)

    def evaluate(x_try):
        r_try = r0.pop() if r0 else residual_fn(x_try)
        return r_try, jac_fn(x_try).to(dt)
    if st.x.device.type == "cuda" and not plain:
        x_try = torch.empty_like(st.x)
        kernels = LMTripKernels(st, config, status, x_try)

        def trip(live=None):
            kernels.open()
            kernels.update(*evaluate(x_try))
        return st, trip

    def trip(live=None):
        x_try = _open_plain_inplace(st, config, status)
        _, r_try, j_try = _trial(st, x_try, *evaluate(x_try))
        _update_plain_inplace(st, x_try, r_try, j_try, config, status)
    return st, trip


def _result(st: _State) -> LMResult:
    """The engine's result from its final state."""
    grad = 2.0 * torch.einsum("lmd,lm->ld", st.J, st.r)
    return LMResult(x=st.x, f=st.cost, grad=grad, r=st.r,
                    n_iters=st.n_iters, n_evals=st.n_evals,
                    converged=st.converged, lam=st.lam)


def _run(residual_fn: Callable, jac_fn: Callable, x0: torch.Tensor,
         config: LMConfig, lam0: torch.Tensor = None,
         plain: bool = False, live: int = None) -> LMResult:
    """The engine's loop: the trip bound once (``_bind_trip``), then one
    trip and one host read of the live count until no lane is live
    (``tracing.trips``, which inside a recorded entry adds its span and
    counters, ``utils/tracing.py``). With ``plain`` the trip runs the
    plain versions on any device, which the card's checks hold the
    kernels to. With ``live`` only the first ``live`` lanes are solved."""
    status = torch.zeros(1, dtype=torch.int32, device=x0.device)
    st, trip = _bind_trip(residual_fn, jac_fn, x0, config, lam0, status,
                          plain, live)
    lanes = x0.shape[0]
    tracing.trips("lm", lanes, lanes if live is None else live, trip,
                  lambda: read_live(status))
    return _result(st)


def lm_minimize_batched(residual_fn: Callable, x0: torch.Tensor,
                        config: LMConfig = LMConfig(),
                        jac_fn: Callable = None,
                        lam0: torch.Tensor = None,
                        live: int = None) -> LMResult:
    """Minimize ``sum(residual_fn(x)**2, -1)`` for every lane of ``x0``.

    Args:
      residual_fn: ``[L, d] -> [L, m]`` at the precision of ``x0``; each
        lane's residuals depend on that lane's row only. The LM polish's
        objective (``calibration/calibrator.py::PolishObjective``) binds
        its own trip: on CUDA tensors fused K6, K1<double>, K3 and fused
        K7 with n + 2 <= ``MAX_FUSED_ROWS`` residual rows a lane (else the
        unfused trip around its host assembly); on CPU tensors their plain
        versions.
      jac_fn: ``[L, d] -> [L, m, d]`` (any dtype; cast to ``x0``'s). The
        default is ``torch.func.jacfwd`` of ``residual_fn`` (plain tensor
        code only); the calibrator passes the K3 Jacobian.
      lam0: optional ``[L]`` initial damping (continuation warm start).
      live: solve only the first ``live`` lanes; the rest are padding to a
        bucketed size, start done and keep ``x0`` (their other fields
        are the bootstrap's: NaN residuals, an infinite cost).
    On CUDA tensors every trip runs K6 and K7; on CPU tensors their plain
    versions.
    """
    if jac_fn is None:
        def jac_fn(x):
            # d r / d delta for a delta shared by all lanes is the per-lane
            # Jacobian, since lanes are independent.
            zero = torch.zeros(x.shape[-1], dtype=x.dtype, device=x.device)
            return torch.func.jacfwd(lambda dl: residual_fn(x + dl))(zero)
    return _run(residual_fn, jac_fn, x0, config, lam0, live=live)
