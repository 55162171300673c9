"""Split-complex arithmetic on (real, imag) tensor pairs.

The pricer keeps the JAX package's split real/imag formulation
(``option_pricing_ffn_lbfgs_tpu/ops/complex_math.py``) so that the plain
PyTorch pricer, its autograd/forward-mode derivatives and the CUDA kernels
(``csrc/cos_math.cuh``) evaluate the same formulas in the same order, at
float32 or float64. Sqrt and log follow NumPy's principal branches.
"""
from __future__ import annotations

from typing import Tuple

import torch

Cplx = Tuple[torch.Tensor, torch.Tensor]


def cadd(a: Cplx, b: Cplx) -> Cplx:
    return a[0] + b[0], a[1] + b[1]


def csub(a: Cplx, b: Cplx) -> Cplx:
    return a[0] - b[0], a[1] - b[1]


def cmul(a: Cplx, b: Cplx) -> Cplx:
    ar, ai = a
    br, bi = b
    return ar * br - ai * bi, ar * bi + ai * br


def cscale(a: Cplx, s) -> Cplx:
    """Multiply a complex pair by a real scalar or tensor."""
    return a[0] * s, a[1] * s


def cabs(a: Cplx) -> torch.Tensor:
    return torch.hypot(a[0], a[1])


def cdiv(a: Cplx, b: Cplx) -> Cplx:
    """a / b via Smith's algorithm (scale-robust against over/underflow)."""
    ar, ai = a
    br, bi = b
    swap = torch.abs(br) < torch.abs(bi)
    br_s = torch.where(swap, bi, br)
    bi_s = torch.where(swap, br, bi)
    t = bi_s / br_s
    den = br_s + bi_s * t
    re1 = (ar + ai * t) / den
    im1 = (ai - ar * t) / den
    re2 = (ai + ar * t) / den
    im2 = (-ar + ai * t) / den
    return torch.where(swap, re2, re1), torch.where(swap, im2, im1)


def cexp(a: Cplx) -> Cplx:
    ar, ai = a
    e = torch.exp(ar)
    return e * torch.cos(ai), e * torch.sin(ai)


def clog(a: Cplx) -> Cplx:
    """Principal branch: log|a| + i*atan2(im, re), as np.log(complex)."""
    return torch.log(cabs(a)), torch.atan2(a[1], a[0])


def csqrt(a: Cplx) -> Cplx:
    """Principal-branch sqrt, grad-safe.

    For ar >= 0, t = sqrt((|a|+ar)/2) and sqrt(a) = t + i*ai/(2t); for
    ar < 0, t = sqrt((|a|-ar)/2) and sqrt(a) = |ai|/(2t) + i*sign(ai)*t.
    Both sqrt arguments are guarded with a double where, so the untaken
    branch never sees sqrt(0) and its derivative stays finite:
    ``torch.where`` leaks a NaN gradient from the untaken branch exactly as
    ``jnp.where`` does.
    """
    ar, ai = a
    m = torch.hypot(ar, ai)
    pos = ar >= 0.0
    one = torch.ones_like(ar)
    x1 = torch.where(pos, (m + ar) * 0.5, one)
    x2 = torch.where(pos, one, (m - ar) * 0.5)
    t1 = torch.sqrt(x1)
    t2 = torch.sqrt(x2)
    sgn = torch.where(ai < 0.0, -one, one)
    re = torch.where(pos, t1, torch.abs(ai) / (2.0 * t2))
    im = torch.where(pos, ai / (2.0 * t1), sgn * t2)
    return re, im
