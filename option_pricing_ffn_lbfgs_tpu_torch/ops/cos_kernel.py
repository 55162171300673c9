"""K1: batched COS surface pricing, float32 and float64.

``price_surfaces`` prices ``[B, n_opt]`` (surface, option) rows under
per-surface parameters. On a CUDA tensor it launches the hand-written
kernel ``csrc/cos_price.cu``: one block per surface finds the surface's
maturity groups itself (equal tau), computes each maturity's truncation
range once and each group's characteristic-function items once, in
shared memory; a row whose range widening binds is a group of its own.
Each warp then prices a row, the N COS terms strided over its lanes and
summed by a shuffle tree, in the order of a row priced alone (with fewer
surfaces than SMs, a surface's rows are split over blocks). On a CPU
tensor it runs the plain PyTorch version, ``price_surfaces_plain`` (the
batched ``price_options``). There is no fallback between the two: a CUDA
tensor either launches the kernel or raises. No grouping is computed on
the host.

Replaces ``option_pricing_ffn_lbfgs_tpu/ops/cos_pallas.py::
price_surfaces_pallas`` (float32 only there). On the calibration path
K1<double> prices the LM polish residuals and the generator's surfaces,
K1<float> reprices the search winner.
"""
from __future__ import annotations

import ctypes

import torch

from ..models.double_heston import DHParams, price_options
from . import kernel_build

# Launches of each instantiation, counted where the kernel is launched.
LAUNCHES = {"cos_price_f32": 0, "cos_price_f64": 0}

_ENTRY = {torch.float32: "cos_price_f32", torch.float64: "cos_price_f64"}


def price_surfaces_plain(params, spots, rate, strikes, maturities, is_call,
                         n_terms: int = 128, L: float = 10.0, q: float = 0.0):
    """Plain PyTorch K1: ``price_options`` batched over surfaces."""
    return price_options(DHParams.from_vector(params), spots, rate, strikes,
                         maturities, is_call, n_terms=n_terms, L=L, q=q)


# params, spots, strikes, mats, is_call, out; rate, q, L; n_rows, n_opt,
# n_terms; stream
_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_double] * 3
             + [ctypes.c_int] * 3 + [ctypes.c_void_p])


def _inputs(params, spots, strikes, maturities, is_call):
    """(C entry, contiguous inputs) of a K1 launch on CUDA tensors; raises
    on what the kernel does not take."""
    dt, dev = params.dtype, params.device
    if dev.type != "cuda" or dt not in _ENTRY:
        raise ValueError(f"K1 takes float32/float64 CUDA tensors, got {dt} "
                         f"on {dev}")
    b, n_opt = strikes.shape
    if params.shape != (b, 13) or spots.shape != (b,):
        raise ValueError(f"shape mismatch: params {tuple(params.shape)}, "
                         f"spots {tuple(spots.shape)}, strikes {(b, n_opt)}")
    ins = [params, spots, strikes, maturities]
    for t in ins:
        if t.dtype != dt or t.device != dev:
            raise ValueError("K1 inputs must share dtype and device")
    if is_call.dtype != torch.bool or maturities.shape != strikes.shape \
            or is_call.shape != strikes.shape:
        raise ValueError("is_call must be a bool tensor shaped like strikes")
    return _ENTRY[dt], [t.contiguous() for t in ins] + [is_call.contiguous()]


def _args(entry, ins, out, rate, q, L, n_terms):
    """The C entry and its argument tuple for a launch into ``out``."""
    b, n_opt = out.shape
    return kernel_build.entry("cos_price", entry, _ARGTYPES), (
        *(t.data_ptr() for t in ins), out.data_ptr(),
        float(rate), float(q), float(L), b * n_opt, n_opt, n_terms,
        torch.cuda.current_stream(out.device).cuda_stream)


def price_surfaces(params, spots, rate, strikes, maturities, is_call,
                   n_terms: int = 128, L: float = 10.0, q: float = 0.0):
    """Price ``[B, n_opt]`` options; ``params [B, 13]``, ``spots [B]``,
    scalar ``rate``, ``is_call`` bool. Computes in ``params.dtype``
    (float32 or float64) and returns ``[B, n_opt]``."""
    if params.device.type == "cpu":
        return price_surfaces_plain(params, spots, rate, strikes, maturities,
                                    is_call, n_terms, L, q)
    entry, ins = _inputs(params, spots, strikes, maturities, is_call)
    out = torch.empty(strikes.shape, dtype=params.dtype, device=params.device)
    if out.numel() == 0:
        return out
    fn, args = _args(entry, ins, out, rate, q, L, n_terms)
    kernel_build.check(fn(*args), entry)
    LAUNCHES[entry] += 1
    return out


def bind_price_surfaces(params, spots, rate, strikes, maturities, is_call,
                        n_terms: int, L: float, q: float, out):
    """K1 bound once, for the fused LM trip: a launcher with no arguments
    that prices ``params [B, 13]`` (rewritten in place between launches)
    into the preallocated ``out [B, n_opt]``. Every check of
    ``price_surfaces`` runs here, once; CUDA tensors only, at least one
    option."""
    entry, ins = _inputs(params, spots, strikes, maturities, is_call)
    if (out.shape != strikes.shape or out.dtype != params.dtype
            or out.device != params.device or not out.is_contiguous()):
        raise ValueError(f"out: expected contiguous {params.dtype} "
                         f"{tuple(strikes.shape)} on {params.device}")
    if out.numel() == 0:
        raise ValueError("K1 needs at least one option to price")
    if not params.is_contiguous():
        raise ValueError("params must be contiguous: K1 reads it in place")
    fn, args = _args(entry, ins, out, rate, q, L, n_terms)

    def launch(_keep=(ins, out)):
        kernel_build.check(fn(*args), entry)
        LAUNCHES[entry] += 1
    return launch
