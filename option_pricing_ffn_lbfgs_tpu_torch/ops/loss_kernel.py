"""K2/K3: fused per-row COS price + weighted parameter gradient.

One CUDA kernel (``csrc/cos_vg.cu``: one block per lane, each maturity's
characteristic function shared by its strikes, structured derivatives)
serves the two consumers of the JAX package's ``ops/loss_pallas.py``:

  * K2, ``rows_value_and_grad`` (mode "loss"): per lane the prices and
    ``sum_rows w * dP/dparams`` with ``w = 2 (P - mkt) / (mkt^2 n_opt)`` —
    the pricing part of the search loss gradient, one launch per L-BFGS
    trip; the kernel sums the rows itself. Float32 (``cos_vg_f32``: the
    search and the hybrid refine) or float64 (``cos_vg_f64``:
    ``calibrate_surface`` and ``hybrid_calibrate`` at float64, where JAX ran
    XLA autodiff of its loss), chosen by the dtype of the inputs;
  * K3, ``rows_jacobian`` (mode "jac"): per row ``w * dP/dparams`` with
    ``w = 1 / (mkt sqrt(n_opt))`` — the pricing rows of the LM residual
    Jacobian, one launch per LM trip, float32 only (the polish's Jacobian).

Both take the rows' maturity groups (``maturity_groups``), which the host
assemblies compute once per problem; the wrappers compute them when they
are not given. On a CPU tensor each wrapper runs its plain PyTorch version
instead (K2: ``torch.autograd`` of the plain loss rows; K3:
``torch.func.jacfwd`` of the plain residual rows); on a CUDA tensor it
launches the kernel or raises.

``make_batch_value_and_grad`` and ``make_batch_residual_jacobian`` are the
host assemblies of ``loss_pallas.py:205-231`` and ``:273-285``: the
validity mask, the Feller penalty (and its two Jacobian rows from the
masked sqrt), the exp/tanh chain rule and the sentinel. The first
returns a ``BatchValueAndGrad``, which is callable and also binds its own
L-BFGS trip for ``ops/lbfgs_batched.py::lbfgs_minimize_batched``
(``bind_trip``): fused K4, K2 bound once per run
(``bind_rows_value_and_grad``) and fused K5, which takes over this
assembly in its order, so on the card the fused trip gives the bits of K4,
K2, this assembly and K5. Its plain versions are
``lbfgs_open_fused_plain`` and ``lbfgs_update_fused_plain``.

A bound K2 or K3 takes the trip's done flags (the engine state's ``done``,
which K5 or K7 of the previous trip wrote): a done lane's block exits at
once and its rows keep what they held, which nothing reads, since K5 and
K7 touch only lanes that are not done. The one-shot wrappers price every
lane.

Each launch picks the width of a lane's block (``launch_warps``; 4 or 8
warps in float, 2, 4 or 8 in double, ``WARPS``): the widest whose resident
blocks hold the lanes the launch prices (inside a bound trip the live
count of the engine's last read, else the launched lanes), and the
narrowest when none does. Every width gives the same bits
(``csrc/cos_vg.cu``); a wider block shortens one lane's path where the
lanes do not fill the card.
"""
from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from ..calibration.loss import feller_penalty, residual_rows
from ..calibration.transforms import _EXP_IDX, _TANH_IDX, transform
from ..models.double_heston import DHParams, price_options
from ..utils import tracing
from ..utils.config import CalibrationConfig, LBFGSConfig
from . import kernel_build
from . import lbfgs_batched as lb

# Launches of each (mode, dtype), counted where the kernel is launched.
LAUNCHES = {"cos_vg_loss": 0, "cos_vg_jac": 0, "cos_vg_loss_f64": 0}

# (mode, dtype) -> (C entry, mode number, launch count key)
_ENTRIES = {
    ("loss", torch.float32): ("cos_vg_f32", 0, "cos_vg_loss"),
    ("jac", torch.float32): ("cos_vg_f32", 1, "cos_vg_jac"),
    ("loss", torch.float64): ("cos_vg_f64", 0, "cos_vg_loss_f64"),
}
# params, spots, strikes, mats, is_call, mkt, groups, done (or NULL),
# price_out, grad_out; rate, q, L; n_lanes, n_opt, n_terms, mode, warps;
# stream
ARGTYPES = ([ctypes.c_void_p] * 10 + [ctypes.c_double] * 3
            + [ctypes.c_int] * 5 + [ctypes.c_void_p])
# The widths of a lane's block, in warps, by C entry; the first is the one
# of launches that fill the card (csrc/cos_vg.cu).
WARPS = {"cos_vg_f32": (4, 8), "cos_vg_f64": (2, 4, 8)}
# (C entry, n_opt, n_terms, device index) -> {warps: lanes resident}
_SLOTS = {}
# Each variance factor's (sigma, kappa, theta) in the parameter vector.
FELLER_IDX = tuple(tuple(DHParams._fields.index(f"{name}{i}")
                         for name in ("sigma", "kappa", "theta"))
                   for i in (1, 2))
# The transform's coordinates, as bit masks for the fused kernels.
EXP_MASK = sum(1 << c for c in _EXP_IDX)
TANH_MASK = sum(1 << c for c in _TANH_IDX)


def maturity_groups(maturities: torch.Tensor) -> torch.Tensor:
    """``[L, n]`` int32 maturity-group ids: per lane, the rows with equal
    maturities share an id, numbered 0, 1, ... in order of first
    appearance. The kernel evaluates each group's characteristic function
    once for all its rows."""
    eq = maturities[..., :, None] == maturities[..., None, :]     # [L, n, n]
    first = torch.argmax(eq.to(torch.int8), dim=-1)               # first equal
    n = maturities.shape[-1]
    is_first = first == torch.arange(n, device=maturities.device)
    dense = torch.cumsum(is_first.to(torch.int32), dim=-1) - 1
    return torch.gather(dense, -1, first).to(torch.int32)


def _inputs(mode, params, spots, strikes, maturities, is_call, mkt, groups):
    """(C entry, mode number, launch count key, contiguous inputs) of a
    cos_vg launch on CUDA tensors; raises on what the kernel does not
    take. ``groups`` is computed when None."""
    dt, dev = params.dtype, params.device
    if dev.type != "cuda" or (mode, dt) not in _ENTRIES:
        raise ValueError(f"K2 takes float32/float64 and K3 float32 CUDA or "
                         f"CPU tensors, got {mode} {dt} on {dev}")
    symbol, mode_no, count = _ENTRIES[mode, dt]
    lanes, n_opt = strikes.shape
    if params.shape != (lanes, 13) or spots.shape != (lanes,):
        raise ValueError(f"shape mismatch: params {tuple(params.shape)}, "
                         f"spots {tuple(spots.shape)}, strikes "
                         f"{(lanes, n_opt)}")
    ins = [params, spots, strikes, maturities]
    for t in ins + [mkt]:
        if t.dtype != dt or t.device != dev:
            raise ValueError("K2/K3 inputs must share dtype and device")
    if is_call.dtype != torch.bool or is_call.shape != strikes.shape \
            or maturities.shape != strikes.shape or mkt.shape != strikes.shape:
        raise ValueError("is_call (bool), maturities and market prices must "
                         "be shaped like strikes")
    if groups is None:
        groups = maturity_groups(maturities)
    if groups.dtype != torch.int32 or groups.shape != strikes.shape \
            or groups.device != dev:
        raise ValueError("groups must be int32, shaped like strikes, on the "
                         "inputs' device")
    ins = [t.contiguous() for t in ins] + [
        is_call.contiguous(), mkt.contiguous(), groups.contiguous()]
    return symbol, mode_no, count, ins


def launch_warps(lanes: int, slots: dict) -> int:
    """The width of a launch's blocks, in warps: the widest of ``slots``
    (warps -> lanes the card holds at once at that width) whose lanes hold
    ``lanes``, else the narrowest, the width of launches that fill the
    card."""
    return max((w for w, n in slots.items() if lanes <= n),
               default=min(slots))


def slots(symbol: str, n_opt: int, n_terms: int, device) -> dict:
    """``{warps: lanes}``: for each width, the lanes a launch of ``n_opt``
    rows at N = ``n_terms`` holds resident on ``device`` (SMs x
    ``cudaOccupancyMaxActiveBlocksPerMultiprocessor`` at its shared
    memory), queried once and cached."""
    index = torch.device(device).index
    key = (symbol, n_opt, n_terms,
           torch.cuda.current_device() if index is None else index)
    if key not in _SLOTS:
        query = kernel_build.entry(
            "cos_vg", symbol.replace("cos_vg_", "cos_vg_slots_"),
            [ctypes.c_int] * 3)
        with torch.cuda.device(key[3]):
            got = {w: query(n_opt, n_terms, w) for w in WARPS[symbol]}
        for w, n in got.items():
            if n < 0:
                kernel_build.check(-n, f"{symbol} slots at {w} warps")
        _SLOTS[key] = got
    return _SLOTS[key]


def _count(key: str, wide: bool) -> None:
    """Count a launch: ``LAUNCHES[key]`` always; inside a recorded entry
    also ``cos_vg.launches`` and, if its blocks are ``wide`` (wider than
    those of launches that fill the card), ``cos_vg.launches_wide``
    (``utils/tracing.py``)."""
    LAUNCHES[key] += 1
    tracing.count("cos_vg.launches")
    if wide:
        tracing.count("cos_vg.launches_wide")


def _launcher(symbol, mode_no, count, ins, price, grad, rate, q, L,
              n_terms, done=None):
    """``launch(live=None, warps=None)``: one launch into ``price`` and
    ``grad``, skipping the lanes that ``done`` flags (None: none), at the
    width ``launch_warps`` picks for ``live`` lanes (None: every lane the
    launch covers), or at ``warps``."""
    lanes, n_opt = price.shape
    fn = kernel_build.entry("cos_vg", symbol, ARGTYPES)
    table = slots(symbol, n_opt, n_terms, price.device)
    head = (*(t.data_ptr() for t in ins),
            None if done is None else done.data_ptr(), price.data_ptr(),
            grad.data_ptr(), float(rate), float(q), float(L), lanes, n_opt,
            n_terms, mode_no)
    stream = torch.cuda.current_stream(price.device).cuda_stream
    narrowest = min(table)

    def launch(live=None, warps=None, _keep=(ins, price, grad, done)):
        if warps is None:
            warps = launch_warps(lanes if live is None else live, table)
        kernel_build.check(fn(*head, warps, stream), count)
        _count(count, warps > narrowest)
    return launch


def _check_done(done, lanes: int, device):
    """Raises unless ``done`` is None or a contiguous bool ``[lanes]`` on
    ``device``: the done flags a bound K2/K3 reads each launch."""
    if done is not None and (
            done.dtype != torch.bool or done.shape != (lanes,)
            or done.device != device or not done.is_contiguous()):
        raise ValueError(f"done: expected contiguous torch.bool ({lanes},) "
                         f"on {device}, got {done.dtype} "
                         f"{tuple(done.shape)} on {done.device}")


def _launch(mode, params, spots, rate, strikes, maturities, is_call, mkt,
            n_terms, L, q, groups):
    """Launch cos_vg on CUDA tensors: (price [L, n], grad [L, 13] in mode
    "loss" or rows [L, n, 13] in mode "jac")."""
    symbol, mode_no, count, ins = _inputs(mode, params, spots, strikes,
                                          maturities, is_call, mkt, groups)
    lanes, n_opt = strikes.shape
    dt, dev = params.dtype, params.device
    price = torch.empty((lanes, n_opt), dtype=dt, device=dev)
    grad = torch.empty((lanes, 13) if mode_no == 0 else (lanes, n_opt, 13),
                       dtype=dt, device=dev)
    if lanes * n_opt == 0:
        return price, grad.zero_()
    _launcher(symbol, mode_no, count, ins, price, grad, rate, q, L,
              n_terms)()
    return price, grad


def bind_rows_value_and_grad(params, spots, rate, strikes, maturities,
                             is_call, mkt, n_terms: int, L: float, q: float,
                             groups, price, grad, done=None):
    """K2 bound once, for the fused L-BFGS trip: a launcher,
    ``launch(live=None, warps=None)``, that prices ``params [L, 13]``
    (rewritten in place between launches) into the preallocated ``price
    [L, n]`` and ``grad [L, 13]``, skipping the lanes that ``done`` (bool
    ``[L]``, rewritten in place between launches; None: no lane) flags,
    whose rows it leaves as they are. ``live``, the lanes not done, sets
    the blocks' width (``launch_warps``; None: all L lanes), unless
    ``warps`` gives it. Every check of ``rows_value_and_grad`` runs here,
    once; CUDA tensors only, at least one row."""
    symbol, mode_no, count, ins = _inputs("loss", params, spots, strikes,
                                          maturities, is_call, mkt, groups)
    lanes, n_opt = strikes.shape
    for name, t, shape in (("price", price, (lanes, n_opt)),
                           ("grad", grad, (lanes, 13))):
        if (t.shape != shape or t.dtype != params.dtype
                or t.device != params.device or not t.is_contiguous()):
            raise ValueError(f"{name}: expected contiguous {params.dtype} "
                             f"{shape} on {params.device}")
    if n_opt == 0:
        raise ValueError("K2 needs at least one option a lane")
    if not params.is_contiguous():
        raise ValueError("params must be contiguous: K2 reads it in place")
    _check_done(done, lanes, params.device)
    return _launcher(symbol, mode_no, count, ins, price, grad, rate, q, L,
                     n_terms, done)


def bind_rows_jacobian(params, spots, rate, strikes, maturities, is_call,
                       mkt, n_terms: int, L: float, q: float, groups, price,
                       jac, done=None):
    """K3 bound once, for the fused LM trip: a launcher, ``launch(live=None,
    warps=None)`` as K2's binding gives, that differentiates ``params [L,
    13]`` (float32, rewritten in place between launches) into the
    preallocated ``price [L, n]`` and ``jac [L, n, 13]``, skipping the
    lanes that ``done`` flags, as K2's binding does. Every check of
    ``rows_jacobian`` runs here, once; CUDA tensors only, at least one
    row."""
    symbol, mode_no, count, ins = _inputs("jac", params, spots, strikes,
                                          maturities, is_call, mkt, groups)
    lanes, n_opt = strikes.shape
    for name, t, shape in (("price", price, (lanes, n_opt)),
                           ("jac", jac, (lanes, n_opt, 13))):
        if (t.shape != shape or t.dtype != params.dtype
                or t.device != params.device or not t.is_contiguous()):
            raise ValueError(f"{name}: expected contiguous {params.dtype} "
                             f"{shape} on {params.device}")
    if n_opt == 0:
        raise ValueError("K3 needs at least one option a lane")
    if not params.is_contiguous():
        raise ValueError("params must be contiguous: K3 reads it in place")
    _check_done(done, lanes, params.device)
    return _launcher(symbol, mode_no, count, ins, price, jac, rate, q, L,
                     n_terms, done)


def rows_value_and_grad_plain(params, spots, rate, strikes, maturities,
                              is_call, mkt, n_terms, L=10.0, q=0.0):
    """Plain K2: prices ``[L, n]`` and ``sum_rows w * dP/dparams``
    ``[L, 13]`` by ``torch.autograd`` (w held constant, as in the kernel)."""
    n_opt = strikes.shape[-1]
    with torch.enable_grad():
        p = params.detach().requires_grad_(True)
        price = price_options(DHParams.from_vector(p), spots, rate, strikes,
                              maturities, is_call, n_terms=n_terms, L=L, q=q)
        w = (2.0 * (price - mkt) / (mkt * mkt * float(n_opt))).detach()
        grad, = torch.autograd.grad((w * price).sum(), p)
    return price.detach(), grad


def rows_jacobian_plain(params, spots, rate, strikes, maturities, is_call,
                        mkt, n_terms, L=10.0, q=0.0):
    """Plain K3: prices ``[L, n]`` and rows ``w * dP/dparams`` ``[L, n, 13]``
    by ``torch.func.jacfwd`` (13 forward tangents, as ``jax.jacfwd``)."""
    def price_of(delta):
        # delta [13] is added to every lane; each lane's prices depend on
        # its own parameters only, so d price / d delta is the per-lane
        # Jacobian.
        price = price_options(DHParams.from_vector(params + delta), spots,
                              rate, strikes, maturities, is_call,
                              n_terms=n_terms, L=L, q=q)
        return price, price

    zero = torch.zeros(13, dtype=params.dtype, device=params.device)
    jac, price = torch.func.jacfwd(price_of, has_aux=True)(zero)
    n_opt = strikes.shape[-1]
    w = (1.0 / math.sqrt(float(n_opt))) / mkt
    return price, jac * w[..., None]


def rows_value_and_grad(params, spots, rate, strikes, maturities, is_call,
                        mkt, n_terms: int, L: float = 10.0, q: float = 0.0,
                        groups=None):
    """K2: ``(price [L, n], sum_rows w * dP/dparams [L, 13])``, float32 or
    float64. ``groups``: ``maturity_groups(maturities)``, computed here when
    None."""
    if params.device.type == "cpu":
        return rows_value_and_grad_plain(params, spots, rate, strikes,
                                         maturities, is_call, mkt, n_terms,
                                         L, q)
    return _launch("loss", params, spots, rate, strikes, maturities, is_call,
                   mkt, n_terms, L, q, groups)


def rows_jacobian(params, spots, rate, strikes, maturities, is_call, mkt,
                  n_terms: int, L: float = 10.0, q: float = 0.0, groups=None):
    """K3: ``(price [L, n], w * dP/dparams [L, n, 13])``, float32.
    ``groups`` as for ``rows_value_and_grad``."""
    if params.device.type == "cpu":
        return rows_jacobian_plain(params, spots, rate, strikes, maturities,
                                   is_call, mkt, n_terms, L, q)
    return _launch("jac", params, spots, rate, strikes, maturities, is_call,
                   mkt, n_terms, L, q, groups)


def _feller_value_and_grad(params: torch.Tensor, weight: float):
    """Per-lane Feller penalty and its gradient wrt the 13 parameters."""
    p = DHParams.from_vector(params)
    pen = feller_penalty(p, weight)
    grad = torch.zeros_like(params)
    for (s, k, t), viol in zip(FELLER_IDX, (
            p.sigma1**2 - 2.0 * p.kappa1 * p.theta1,
            p.sigma2**2 - 2.0 * p.kappa2 * p.theta2)):
        on = (viol > 0.0).to(params.dtype) * weight
        grad[:, s] = on * 2.0 * params[:, s]
        grad[:, k] = -on * 2.0 * params[:, t]
        grad[:, t] = -on * 2.0 * params[:, k]
    return pen, grad


def feller_violation(params: torch.Tensor, s: int, k: int, t: int):
    """``sigma^2 - 2 kappa theta`` of a float32 or float64 parameter tensor
    ``[L, 13]``, evaluated in float64 and returned in the parameters'
    dtype, with the activity ``viol > 0`` taken in float64.

    Products of two float32 numbers are exact in float64, so for float32
    parameters the float64 difference has the sign of the exact one. In
    float32 both products round first, and near the Feller boundary (where
    the polish often converges) they round to the same value at about 1
    point in 4: the violation reads exactly 0, the row is inactive and the
    LM step walks across the boundary, is rejected at any damping, and the
    lane gives up. (XLA on the CPU contracts the difference into one fused
    multiply-add, so the JAX package's float32 Jacobian there keeps the
    exact sign at about 8 points in 10.) Returns ``(viol, active)``."""
    p = params.to(torch.float64)
    v = p[:, s] * p[:, s] - 2.0 * p[:, k] * p[:, t]
    return v.to(params.dtype), v > 0.0


def _feller_jacobian(params: torch.Tensor, weight: float):
    """``[L, 2, 13]`` Jacobian of the Feller residual rows
    ``sqrt(weight * max(0, sigma^2 - 2 kappa theta))`` (0 where inactive),
    the violation from ``feller_violation``."""
    jac = torch.zeros(params.shape[0], 2, 13, dtype=params.dtype,
                      device=params.device)
    for row, (s, k, t) in enumerate(FELLER_IDX):
        viol, active = feller_violation(params, s, k, t)
        safe = torch.where(active, viol, torch.ones_like(viol))
        # d sqrt(w v) / dv = w / (2 sqrt(w v)), zero on the inactive side.
        dv = torch.where(active, weight / (2.0 * torch.sqrt(weight * safe)),
                         torch.zeros_like(viol))
        jac[:, row, s] = dv * 2.0 * params[:, s]
        jac[:, row, k] = -dv * 2.0 * params[:, t]
        jac[:, row, t] = -dv * 2.0 * params[:, k]
    return jac


class BatchValueAndGrad:
    """The search objective over ``[L, n]`` surfaces: ``vg(x [L, 13]) ->
    (f [L], g [L, 13])`` in the dtype of the market prices, the pricing
    value and gradient from K2 at that dtype, with the semantics of
    autograd of ``calibration/loss.py::surface_loss`` per lane: invalid
    prices give the sentinel ``config.bad_loss`` with a zero gradient, the
    Feller penalty is added and gradients are in the unconstrained
    coordinates. A call runs K2 and this host assembly
    (``search_assembly_plain``); the object also holds the problem
    (``spots``, ``strikes``, ``maturities``, ``is_call``, ``mkt``, their
    maturity ``groups``, ``rate``, ``config``), from which it binds the
    fused L-BFGS trip (``bind_trip``; ``rows`` and ``bind_rows`` price a
    parameter tensor)."""

    def __init__(self, spots, strikes, maturities, is_call, market_prices,
                 rate, config: CalibrationConfig):
        dt = market_prices.dtype
        self.spots, self.strikes, self.maturities, self.mkt = (
            t.to(dt) for t in (spots, strikes, maturities, market_prices))
        self.is_call = is_call
        self.rate = rate
        self.config = config
        self.groups = maturity_groups(self.maturities)   # fixed across trips

    @property
    def dtype(self):
        return self.mkt.dtype

    def _problem(self):
        pc = self.config.pricer
        return ((self.spots, self.rate, self.strikes, self.maturities,
                 self.is_call, self.mkt, pc.n_terms, pc.trunc_L,
                 pc.dividend_yield), self.groups)

    def rows(self, params):
        """K2 (or its plain version on the CPU): ``(price, g_price)``."""
        problem, groups = self._problem()
        return rows_value_and_grad(params, *problem, groups)

    def bind_rows(self, params, price, grad, done=None):
        """``bind_rows_value_and_grad`` on this problem."""
        problem, groups = self._problem()
        return bind_rows_value_and_grad(params, *problem, groups, price,
                                        grad, done)

    def __call__(self, x):
        params = transform(x.to(self.dtype))
        price, g_price = self.rows(params)
        return search_assembly_plain(price, g_price, self.mkt, params,
                                     self.config.feller_weight,
                                     self.config.bad_loss)

    def fused_trial(self, n_lanes: int, device) -> lb.FusedTrial:
        """The fused entries' buffers and constants for ``n_lanes`` lanes
        of this objective (``n_lanes`` must be its own)."""
        dt = self.dtype
        n = self.mkt.shape[1]
        width, factor = torch_mean_order(n_lanes, n, dt)
        new = lambda *shape: torch.empty(shape, dtype=dt, device=device)
        return lb.FusedTrial(
            params_try=new(n_lanes, lb.N_PARAMS), price=new(n_lanes, n),
            g_price=new(n_lanes, lb.N_PARAMS), mkt=self.mkt.contiguous(),
            weight=float(self.config.feller_weight),
            bad_loss=float(self.config.bad_loss), exp_mask=EXP_MASK,
            tanh_mask=TANH_MASK, feller=FELLER_IDX, mean_width=width,
            mean_factor=factor)

    def bind_trip(self, st, config: LBFGSConfig, status, plain: bool):
        """The fused L-BFGS trip on this objective, bound once for the
        engine's state ``st`` and ``status`` (``lbfgs_batched._bind_trip``):
        on CUDA tensors (unless ``plain``) fused K4, K2 (skipping the lanes
        that ``st.done`` flags as the trip starts; ``trip(live)``'s count
        of them not done sets its blocks' width) and fused K5, else
        ``lbfgs_open_fused_plain``, ``rows`` and ``lbfgs_update_fused_plain``
        in place. None where the fused kernels do not take this objective
        (``lb.MAX_ROWS`` rows a lane or more): the engine then takes its
        unfused trip around ``__call__``. Raises on anything else the
        kernels do not take."""
        n = self.mkt.shape[1]
        if n >= lb.MAX_ROWS:
            return None
        trial = self.fused_trial(st.x.shape[0], st.x.device)
        lb._check_fused(st, trial)
        if st.x.device.type == "cuda" and not plain:
            kernels = lb.TripKernels(st, config, status,
                                     torch.empty_like(st.x), trial)
            k2 = self.bind_rows(trial.params_try, trial.price, trial.g_price,
                                st.done)

            def trip(live=None):
                kernels.open()
                k2(live)
                kernels.update()
            return trip

        def trip(live=None):
            x_try = lb._open_plain_inplace(st, config, status)
            params = transform(x_try)
            price, g_price = self.rows(params)
            f_try, g_try = search_assembly_plain(
                price, g_price, trial.mkt, params, trial.weight,
                trial.bad_loss)
            lb._update_plain_inplace(st, x_try, f_try, g_try, config, status)
        return trip


def torch_mean_order(n_lanes: int, n: int, dtype):
    """``(width, factor)``: how ATen's CUDA reduction computes
    ``torch.mean(v, -1)`` for a contiguous ``[n_lanes, n]`` tensor with
    n < 128 (from 128 on it vectorises its loads). ``width`` threads share
    a row (``ReduceConfig::set_block_dimension`` at 512 threads a block
    and a warp of 32); the sum is multiplied by ``factor``, the number of
    outputs over the number of inputs rounded in ``dtype``. Fused K5 sums
    a lane's rows in that order (``csrc/lbfgs_trip.cu``, mean)."""
    pow2 = lambda v: 1 << (v.bit_length() - 1)
    rows, lanes = pow2(n), (pow2(n_lanes) if n_lanes < 512 else 512)
    width = min(rows, 32)
    height = min(lanes, 512 // width)
    width = min(rows, 512 // height)
    real = np.float32 if dtype == torch.float32 else np.float64
    return width, float(real(n_lanes) / real(n_lanes * n))


def _dtransform(params):
    """``dtransform_dx(x)`` from ``params = transform(x)``, in its bits:
    exp coordinates the parameter itself, tanh ``1 - p^2``, 1 elsewhere."""
    dtr = torch.ones_like(params)
    dtr[:, _EXP_IDX] = params[:, _EXP_IDX]
    dtr[:, _TANH_IDX] = 1.0 - params[:, _TANH_IDX] * params[:, _TANH_IDX]
    return dtr


def search_assembly_plain(price, g_price, mkt, params, weight: float,
                          bad_loss: float):
    """The search loss ``f [L]`` and its gradient in the unconstrained
    coordinates ``g [L, 13]`` from K2's prices ``[L, n]`` and row-summed
    gradient ``g_price [L, 13]`` at ``params = transform(x)``: the mean of
    the rows' squared relative errors (0 on a row whose price is not finite
    and positive; ``torch.mean``, whose order fused K5 follows on the
    card), plus the Feller penalty, with a zero gradient at its kink;
    ``bad_loss`` with a zero gradient if any row is invalid or the loss is
    not finite; ``(g_price + pen_g) * dtransform/dx``, the derivative taken
    from ``params`` (exp: itself, tanh: 1 - p^2, the bits of
    ``dtransform_dx(x)``), and non-finite entries set to 0. The host
    assembly of ``BatchValueAndGrad`` and the plain version of fused K5's
    prologue."""
    valid = torch.isfinite(price) & (price > 0.0)
    rel = torch.where(valid, (price - mkt) / mkt, torch.zeros_like(mkt))
    pen, pen_g = _feller_value_and_grad(params, weight)
    loss = torch.mean(rel * rel, dim=-1) + pen
    any_bad = torch.any(~valid, dim=-1)
    bad = torch.full_like(loss, bad_loss)
    loss = torch.where(any_bad, bad, loss)
    loss = torch.where(torch.isfinite(loss), loss, bad)
    gx = (g_price + pen_g) * _dtransform(params)
    gx = torch.where(any_bad[:, None], torch.zeros_like(gx), gx)
    gx = torch.where(torch.isfinite(gx), gx, torch.zeros_like(gx))
    return loss, gx


def lbfgs_open_fused_plain(st, config: LBFGSConfig):
    """Plain fused K4: ``(state, x_try, params_try = transform(x_try))``."""
    st, x_try = lb.lbfgs_open_plain(st, config)
    return st, x_try, transform(x_try)


def lbfgs_update_fused_plain(st, x_try, params_try, price, g_price, mkt,
                             weight: float, bad_loss: float,
                             config: LBFGSConfig):
    """Plain fused K5: ``search_assembly_plain``, then
    ``lbfgs_update_plain`` on its (f, g)."""
    f_try, g_try = search_assembly_plain(price, g_price, mkt, params_try,
                                         weight, bad_loss)
    return lb.lbfgs_update_plain(st, x_try, f_try, g_try, config)


def make_batch_value_and_grad(spots, strikes, maturities, is_call,
                              market_prices, rate,
                              config: CalibrationConfig) -> BatchValueAndGrad:
    """The search objective ``vg(x: [L, 13]) -> (f: [L], g: [L, 13])`` in
    the dtype of ``market_prices`` (float32 or float64, K2 at that dtype):
    a ``BatchValueAndGrad``."""
    return BatchValueAndGrad(spots, strikes, maturities, is_call,
                             market_prices, rate, config)


def polish_jacobian_plain(j_price, params, weight: float):
    """``[L, n + 2, 13]`` in the dtype of ``params = transform(x)``: K3's
    pricing rows ``j_price [L, n, 13]``, then the two Feller rows, every
    entry times ``dtransform_dx(x)`` (taken from ``params``): ``jacfwd`` of
    ``surface_residuals`` in the unconstrained coordinates."""
    J = torch.cat([j_price, _feller_jacobian(params, weight)], dim=1)
    return J * _dtransform(params)[:, None, :]


def polish_assembly_plain(price, j_price, mkt, params64, params32,
                          weight: float, bad_loss: float):
    """The LM polish's evaluation ``(r [L, n + 2], J [L, n + 2, 13])`` at
    float64 from K1<double>'s prices ``[L, n]`` at ``params64 =
    transform(x)`` and K3's float32 rows ``[L, n, 13]`` at ``params32 =
    transform(float32(x))``: the residuals of
    ``calibration/loss.py::residual_rows`` (the sentinel on every row of a
    lane with an invalid price) and ``polish_jacobian_plain`` at float32
    (a sentinel lane's rows left as computed), cast to float64. The host
    assembly of the polish's objective and the plain version of fused
    K7's prologue."""
    r = residual_rows(price, DHParams.from_vector(params64), mkt, weight,
                      bad_loss)
    J = polish_jacobian_plain(j_price, params32, weight)
    return r, J.to(params64.dtype)


def make_batch_residual_jacobian(spots, strikes, maturities, is_call,
                                 market_prices, rate,
                                 config: CalibrationConfig):
    """``jac(x: [L, 13]) -> J: [L, n_opt + 2, 13]`` in the dtype of
    ``market_prices`` (float32 on the card, where K3 is float32): the K3
    pricing rows, then the two Feller rows, times the transform's diagonal
    chain rule — ``jacfwd`` of ``surface_residuals`` in the unconstrained
    coordinates. As in the JAX kernel path, a sentinel lane's rows are left
    as computed (``jacfwd`` would zero them)."""
    dt = market_prices.dtype
    spots, strikes, maturities, mkt = (
        t.to(dt) for t in (spots, strikes, maturities, market_prices))
    pc = config.pricer
    weight = config.feller_weight
    groups = maturity_groups(maturities)    # fixed across optimizer trips

    def jac(x):
        params = transform(x.to(dt))
        _, j_price = rows_jacobian(params, spots, rate, strikes, maturities,
                                   is_call, mkt, pc.n_terms, pc.trunc_L,
                                   pc.dividend_yield, groups)
        return polish_jacobian_plain(j_price, params, weight)

    return jac
