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
masked sqrt), the exp/tanh chain rule and the sentinel.
"""
from __future__ import annotations

import ctypes
import math

import torch

from ..calibration.loss import feller_penalty
from ..calibration.transforms import dtransform_dx, transform
from ..models.double_heston import DHParams, price_options
from ..utils.config import CalibrationConfig
from . import kernel_build

# Launches of each (mode, dtype), counted where the kernel is launched.
LAUNCHES = {"cos_vg_loss": 0, "cos_vg_jac": 0, "cos_vg_loss_f64": 0}

# (mode, dtype) -> (C entry, mode number, launch count key)
_ENTRIES = {
    ("loss", torch.float32): ("cos_vg_f32", 0, "cos_vg_loss"),
    ("jac", torch.float32): ("cos_vg_f32", 1, "cos_vg_jac"),
    ("loss", torch.float64): ("cos_vg_f64", 0, "cos_vg_loss_f64"),
}
# params, spots, strikes, mats, is_call, mkt, groups, price_out, grad_out;
# rate, q, L; n_lanes, n_opt, n_terms, mode; stream
ARGTYPES = ([ctypes.c_void_p] * 9 + [ctypes.c_double] * 3
            + [ctypes.c_int] * 4 + [ctypes.c_void_p])


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


def _launch(mode, params, spots, rate, strikes, maturities, is_call, mkt,
            n_terms, L, q, groups):
    """Launch cos_vg on CUDA tensors: (price [L, n], grad [L, 13] in mode
    "loss" or rows [L, n, 13] in mode "jac")."""
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
    price = torch.empty((lanes, n_opt), dtype=dt, device=dev)
    grad = torch.empty((lanes, 13) if mode_no == 0 else (lanes, n_opt, 13),
                       dtype=dt, device=dev)
    if lanes * n_opt == 0:
        return price, grad.zero_()
    err = kernel_build.entry("cos_vg", symbol, ARGTYPES)(
        *(t.data_ptr() for t in ins), price.data_ptr(), grad.data_ptr(),
        float(rate), float(q), float(L), lanes, n_opt, n_terms, mode_no,
        torch.cuda.current_stream(dev).cuda_stream)
    kernel_build.check(err, count)
    LAUNCHES[count] += 1
    return price, grad


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
    for (s, k, t), viol in (((3, 1, 2), p.sigma1**2 - 2.0 * p.kappa1 * p.theta1),
                            ((8, 6, 7), p.sigma2**2 - 2.0 * p.kappa2 * p.theta2)):
        on = (viol > 0.0).to(params.dtype) * weight
        grad[:, s] = on * 2.0 * params[:, s]
        grad[:, k] = -on * 2.0 * params[:, t]
        grad[:, t] = -on * 2.0 * params[:, k]
    return pen, grad


def _feller_jacobian(params: torch.Tensor, weight: float):
    """``[L, 2, 13]`` Jacobian of the Feller residual rows
    ``sqrt(weight * max(0, sigma^2 - 2 kappa theta))`` (0 where inactive)."""
    p = DHParams.from_vector(params)
    jac = torch.zeros(params.shape[0], 2, 13, dtype=params.dtype,
                      device=params.device)
    for row, (s, k, t), viol in (
            (0, (3, 1, 2), p.sigma1**2 - 2.0 * p.kappa1 * p.theta1),
            (1, (8, 6, 7), p.sigma2**2 - 2.0 * p.kappa2 * p.theta2)):
        active = viol > 0.0
        safe = torch.where(active, viol, torch.ones_like(viol))
        # d sqrt(w v) / dv = w / (2 sqrt(w v)), zero on the inactive side.
        dv = torch.where(active, weight / (2.0 * torch.sqrt(weight * safe)),
                         torch.zeros_like(viol))
        jac[:, row, s] = dv * 2.0 * params[:, s]
        jac[:, row, k] = -dv * 2.0 * params[:, t]
        jac[:, row, t] = -dv * 2.0 * params[:, k]
    return jac


def make_batch_value_and_grad(spots, strikes, maturities, is_call,
                              market_prices, rate,
                              config: CalibrationConfig):
    """``vg(x: [L, 13]) -> (f: [L], g: [L, 13])`` in the dtype of
    ``market_prices`` (float32 or float64, K2 at that dtype) whose pricing
    value and gradient come from K2, with the semantics of autograd of
    ``calibration/loss.py::surface_loss`` per lane: invalid prices give the
    sentinel ``config.bad_loss`` with a zero gradient, the Feller penalty
    is added and gradients are in the unconstrained coordinates."""
    dt = market_prices.dtype
    spots, strikes, maturities, mkt = (
        t.to(dt) for t in (spots, strikes, maturities, market_prices))
    pc = config.pricer
    weight, bad_loss = config.feller_weight, config.bad_loss
    groups = maturity_groups(maturities)    # fixed across optimizer trips

    def vg(x):
        x = x.to(dt)
        params = transform(x)
        price, g_price = rows_value_and_grad(
            params, spots, rate, strikes, maturities, is_call, mkt,
            pc.n_terms, pc.trunc_L, pc.dividend_yield, groups)
        valid = torch.isfinite(price) & (price > 0.0)
        rel = torch.where(valid, (price - mkt) / mkt, torch.zeros_like(mkt))
        pen, pen_g = _feller_value_and_grad(params, weight)
        loss = torch.mean(rel * rel, dim=-1) + pen
        any_bad = torch.any(~valid, dim=-1)
        bad = torch.full_like(loss, bad_loss)
        loss = torch.where(any_bad, bad, loss)
        loss = torch.where(torch.isfinite(loss), loss, bad)
        gx = (g_price + pen_g) * dtransform_dx(x)
        gx = torch.where(any_bad[:, None], torch.zeros_like(gx), gx)
        gx = torch.where(torch.isfinite(gx), gx, torch.zeros_like(gx))
        return loss, gx

    return vg


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
        x = x.to(dt)
        params = transform(x)
        _, j_price = rows_jacobian(params, spots, rate, strikes, maturities,
                                   is_call, mkt, pc.n_terms, pc.trunc_L,
                                   pc.dividend_yield, groups)
        J = torch.cat([j_price, _feller_jacobian(params, weight)], dim=1)
        return J * dtransform_dx(x)[:, None, :]

    return jac
