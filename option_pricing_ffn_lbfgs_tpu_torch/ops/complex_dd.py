"""Split-complex arithmetic over double-float (two-float32) reals.

Port of the JAX package's ``ops/complex_dd.py``, the DD twin of
``ops/complex_math.py``: a complex number is a pair ``(re, im)`` whose
parts are ``(hi, lo)`` DD pairs (``ops/doublefloat.py``). Branch
conventions (principal sqrt and log) are complex_math's, so the DD pricer
agrees with the float64 one to ~1e-12.
"""
from __future__ import annotations

from typing import Tuple

import torch

from . import doublefloat as df

CDD = Tuple[df.DD, df.DD]  # (re, im), each a (hi, lo) float32 pair


def cconst(re: float, im: float, like) -> CDD:
    return df.dd_const(re, like=like), df.dd_const(im, like=like)


def from_f32(re, im=None) -> CDD:
    re = torch.as_tensor(re, dtype=df.F32)
    if im is None:
        im = torch.zeros_like(re)
    return df.dd(re), df.dd(torch.as_tensor(im, dtype=df.F32,
                                            device=re.device))


def cadd(a: CDD, b: CDD) -> CDD:
    return df.add(a[0], b[0]), df.add(a[1], b[1])


def csub(a: CDD, b: CDD) -> CDD:
    return df.sub(a[0], b[0]), df.sub(a[1], b[1])


def cneg(a: CDD) -> CDD:
    return df.neg(a[0]), df.neg(a[1])


def cmul(a: CDD, b: CDD) -> CDD:
    ar, ai = a
    br, bi = b
    return (df.sub(df.mul(ar, br), df.mul(ai, bi)),
            df.add(df.mul(ar, bi), df.mul(ai, br)))


def cscale(a: CDD, s: df.DD) -> CDD:
    """Multiply by a real DD."""
    return df.mul(a[0], s), df.mul(a[1], s)


def cscale_f(a: CDD, s) -> CDD:
    """Multiply by a real float32."""
    return df.mul_f(a[0], s), df.mul_f(a[1], s)


def cdiv(a: CDD, b: CDD) -> CDD:
    """Smith's algorithm on DD reals (complex_math.cdiv's structure)."""
    ar, ai = a
    br, bi = b
    swap = torch.abs(br[0]) < torch.abs(bi[0])
    br_s = df.where(swap, bi, br)
    bi_s = df.where(swap, br, bi)
    t = df.div(bi_s, br_s)
    den = df.add(br_s, df.mul(bi_s, t))
    re1 = df.div(df.add(ar, df.mul(ai, t)), den)
    im1 = df.div(df.sub(ai, df.mul(ar, t)), den)
    re2 = df.div(df.add(ai, df.mul(ar, t)), den)
    im2 = df.div(df.sub(df.mul(ai, t), ar), den)
    return df.where(swap, re2, re1), df.where(swap, im2, im1)


def cexp(a: CDD) -> CDD:
    e = df.exp(a[0])
    s, c = df.sincos(a[1])
    return df.mul(e, c), df.mul(e, s)


def cabs(a: CDD) -> df.DD:
    return df.hypot(a[0], a[1])


def clog(a: CDD) -> CDD:
    """Principal branch: (log|a|, atan2(im, re))."""
    return df.log(cabs(a)), df.atan2(a[1], a[0])


def csqrt(a: CDD) -> CDD:
    """Principal-branch sqrt, complex_math.csqrt's branch-stable form."""
    ar, ai = a
    m = cabs(a)
    pos = ar[0] >= 0.0
    one = df.dd_const(1.0, like=ar)
    x1 = df.where(pos, df.mul_f(df.add(m, ar), 0.5), one)
    x2 = df.where(pos, one, df.mul_f(df.sub(m, ar), 0.5))
    t1 = df.sqrt(x1)
    t2 = df.sqrt(x2)
    sgn = torch.where(ai[0] < 0.0, -1.0, 1.0).to(df.F32)
    abs_ai = df.abs_(ai)
    re = df.where(pos, t1, df.div(abs_ai, df.mul_f(t2, 2.0)))
    im = df.where(pos, df.div(ai, df.mul_f(t1, 2.0)), df.mul_f(t2, sgn))
    return re, im
