"""Double-float (two-float32 compensated) arithmetic in PyTorch.

Port of the JAX package's ``ops/doublefloat.py``. A DD is a pair ``(hi,
lo)`` of same-shape float32 tensors with ``|lo| <= ulp(hi)/2``; it carries
about 49 mantissa bits (~1.5e-15 relative) while every operation is a
native float32 one. The algorithms are the classical error-free
transformations (Dekker 1971, Knuth TAOCP 4.2.2, Hida-Li-Bailey's QD
library) without a fused multiply-add: the Dekker split masks the low 12
mantissa bits, and ``two_prod`` adds four exact partial products with
``two_sum`` chains.

In this package the DD path is an oracle, not a route: the card has native
float64, and the calibration's LM polish prices its residuals on
K1<double> (``ops/cos_kernel.py``). ``models/double_heston_dd.py`` prices
the same options from float32 operations alone, so the float64 pricer and
its kernel can be checked against arithmetic that shares neither their
formulas' rounding nor their float64 units.

Contraction hazard. These identities are exact only if no rounded product
is fused into a following add. Every step here is one eager ATen
elementwise op, which is its own kernel on the CPU and on the card, so
``a * b`` then ``+ c`` rounds twice, as the algorithms need. Do not rewrite
a step with ``addcmul``, ``addcdiv``, ``lerp``, ``add``/``sub`` with
``alpha=``, ``baddbmm``, ``torch.compile`` or ``torch.jit``: each may fuse
the product into the sum. ``a + b`` and ``a - b`` themselves run as ``a +
1 * b`` in ATen, whose product by one is exact.

Constants enter as 0-d float32 tensors on the operands' device
(``dd_const``, ``_f32``): on the card ATen divides a tensor by a Python
number as a product with its reciprocal, which is not the quotient.

Not ported from the JAX module (workarounds for XLA on a TPU):
  * ``_pin`` (``optimization_barrier``): eager PyTorch has no algebraic
    simplifier that could fold ``(c + y) - c`` into ``y``;
  * ``_taylor_unroll``: the Taylor series are Python loops;
  * ``sum_``'s ``lax.scan``: a loop over the axis in the same order.
"""
from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

DD = Tuple[torch.Tensor, torch.Tensor]
F32 = torch.float32

# Clears the low 12 stored-mantissa bits of a float32 (the uint32 mask
# 0xFFFFF000 as an int32): keeps sign, exponent and 12 significant bits.
_SPLIT_MASK = -4096


def _f32(b, like: torch.Tensor) -> torch.Tensor:
    """``b`` as float32 on ``like``'s device: a tensor is cast, a Python
    number becomes a 0-d tensor (rounded to float32 first)."""
    if isinstance(b, torch.Tensor):
        return b.to(dtype=F32, device=like.device)
    return torch.full((), float(np.float32(b)), dtype=F32,
                      device=like.device)


# ---------------------------------------------------------------------------
# Error-free transformations
# ---------------------------------------------------------------------------

def two_sum(a, b) -> DD:
    """a + b = s + e exactly (Knuth). a, b: float32 tensors."""
    s = a + b
    bb = s - a
    e = (a - (s - bb)) + (b - bb)
    return s, e


def quick_two_sum(a, b) -> DD:
    """a + b = s + e exactly, REQUIRES |a| >= |b| (Dekker)."""
    s = a + b
    e = b - (s - a)
    return s, e


def _split(a) -> DD:
    """a = hi + lo, each with <= 12 significant mantissa bits, by integer
    mantissa masking (no multiply); ``a - hi`` is exact (Sterbenz)."""
    hi = (a.view(torch.int32) & _SPLIT_MASK).view(F32)
    return hi, a - hi


def two_prod(a, b) -> DD:
    """a * b = p + e exactly: the four partial products of the split
    halves are exact in float32 and are combined with error-free add
    chains. Residual error <= ~2^-58 |ab|."""
    ahi, alo = _split(a)
    bhi, blo = _split(b)
    h1 = ahi * bhi
    h2 = ahi * blo
    h3 = alo * bhi
    h4 = alo * blo
    s23, e23 = two_sum(h2, h3)
    p1, e1 = two_sum(h1, s23)
    t1, t2 = two_sum(e23, h4)
    u1, u2 = two_sum(e1, t1)
    p, e = quick_two_sum(p1, u1)
    e = e + (u2 + t2)
    return quick_two_sum(p, e)


# ---------------------------------------------------------------------------
# Constructors / converters
# ---------------------------------------------------------------------------

def dd(hi, lo=None) -> DD:
    """Make a DD from float32 value(s)."""
    hi = torch.as_tensor(hi, dtype=F32)
    if lo is None:
        lo = torch.zeros_like(hi)
    return hi, torch.as_tensor(lo, dtype=F32, device=hi.device)


def dd_const(x: float, shape=(), like=None) -> DD:
    """DD constant from a Python float, split exactly on the host. With
    ``like`` (a DD or a tensor) it takes that shape and device, else
    ``shape`` on the CPU; the halves are 0-d tensors expanded, not
    copies."""
    hi = np.float32(x)
    lo = np.float32(x - float(hi))
    dev = None
    if like is not None:
        ref = like[0] if isinstance(like, tuple) else like
        shape, dev = ref.shape, ref.device
    mk = lambda v: torch.full((), float(v), dtype=F32,
                              device=dev).expand(shape)
    return mk(hi), mk(lo)


def from_f64(x) -> DD:
    """Split a float64 tensor into a DD (for program boundaries only)."""
    x = torch.as_tensor(x)
    hi = x.to(F32)
    lo = (x - hi.to(x.dtype)).to(F32)
    return hi, lo


def to_f64(a: DD) -> torch.Tensor:
    """Recombine to float64 (for program boundaries only)."""
    return a[0].to(torch.float64) + a[1].to(torch.float64)


# ---------------------------------------------------------------------------
# Ring ops
# ---------------------------------------------------------------------------

def neg(a: DD) -> DD:
    return -a[0], -a[1]


def add(a: DD, b: DD) -> DD:
    """Full (IEEE-style) DD addition, for any sign combination."""
    s, e = two_sum(a[0], b[0])
    t, f = two_sum(a[1], b[1])
    e = e + t
    s, e = quick_two_sum(s, e)
    e = e + f
    return quick_two_sum(s, e)


def add_f(a: DD, b) -> DD:
    """DD + float32 (a tensor or a Python number)."""
    s, e = two_sum(a[0], _f32(b, a[0]))
    e = e + a[1]
    return quick_two_sum(s, e)


def sub(a: DD, b: DD) -> DD:
    return add(a, neg(b))


def mul(a: DD, b: DD) -> DD:
    p, e = two_prod(a[0], b[0])
    e = e + (a[0] * b[1] + a[1] * b[0])
    return quick_two_sum(p, e)


def mul_f(a: DD, b) -> DD:
    """DD * float32 (exact-product path); ``b`` a tensor or a number."""
    b = _f32(b, a[0])
    p, e = two_prod(a[0], b)
    e = e + a[1] * b
    return quick_two_sum(p, e)


def sqr(a: DD) -> DD:
    p, e = two_prod(a[0], a[0])
    e = e + 2.0 * (a[0] * a[1])
    return quick_two_sum(p, e)


def div(a: DD, b: DD) -> DD:
    """DD / DD via one Newton-corrected long division."""
    q1 = a[0] / b[0]
    r = sub(a, mul_f(b, q1))
    q2 = r[0] / b[0]
    r = sub(r, mul_f(b, q2))
    q3 = r[0] / b[0]
    s, e = quick_two_sum(q1, q2)
    return add_f((s, e), q3)


def recip(b: DD) -> DD:
    return div(dd_const(1.0, like=b), b)


def sqrt(a: DD) -> DD:
    """sqrt by one Newton correction of the float32 root; a must be >= 0.
    Guarded at a == 0 (returns 0)."""
    pos = a[0] > 0
    x = torch.where(pos, a[0], 1.0)
    r0 = torch.sqrt(x)                       # ~f32 accurate
    # One Newton step in DD: r = r0 + (a - r0^2) / (2 r0)
    r0_dd = (r0, torch.zeros_like(r0))
    diff = sub((x, torch.where(pos, a[1], 0.0)), sqr(r0_dd))
    corr = diff[0] / (2.0 * r0)
    r = add_f(r0_dd, corr)
    zero = torch.zeros_like(r0)
    return torch.where(pos, r[0], zero), torch.where(pos, r[1], zero)


def abs_(a: DD) -> DD:
    flip = a[0] < 0
    return torch.where(flip, -a[0], a[0]), torch.where(flip, -a[1], a[1])


def max_(a: DD, b: DD) -> DD:
    return where(gt(a, b), a, b)


def min_(a: DD, b: DD) -> DD:
    return where(lt(a, b), a, b)


def tanh(a: DD) -> DD:
    """tanh(a) = (e^{2a} - 1)/(e^{2a} + 1), clamped for |a| > 20 (where
    tanh is +/-1 to 2^-57, beyond DD resolution)."""
    big = torch.abs(a[0]) > 20.0
    safe = where(big, dd_const(0.0, like=a), a)
    e2 = exp(mul_f(safe, 2.0))
    t = div(add_f(e2, -1.0), add_f(e2, 1.0))
    sign = torch.where(a[0] < 0, -1.0, 1.0).to(F32)
    return where(big, (sign, torch.zeros_like(sign)), t)


def where(c, a: DD, b: DD) -> DD:
    return torch.where(c, a[0], b[0]), torch.where(c, a[1], b[1])


def gt(a: DD, b: DD):
    return (a[0] > b[0]) | ((a[0] == b[0]) & (a[1] > b[1]))


def lt(a: DD, b: DD):
    return (a[0] < b[0]) | ((a[0] == b[0]) & (a[1] < b[1]))


def sum_(a: DD, axis=None) -> DD:
    """Compensated sum of a DD tensor along ``axis``: a sequential DD
    ``add`` over the axis, from zero, in index order (the JAX module's
    ``lax.scan``), vectorised over the other axes."""
    hi, lo = a
    if axis is None:
        hi, lo, axis = hi.reshape(-1), lo.reshape(-1), 0
    hi_m = torch.movedim(hi, axis, 0)
    lo_m = torch.movedim(lo, axis, 0)
    acc = (torch.zeros_like(hi_m[0]), torch.zeros_like(lo_m[0]))
    for i in range(hi_m.shape[0]):
        acc = add(acc, (hi_m[i], lo_m[i]))
    return acc


# ---------------------------------------------------------------------------
# Transcendentals (~1e-14-1e-15 relative over the pricer's argument ranges)
# ---------------------------------------------------------------------------

_LN2 = math.log(2.0)
_EXP_MAX_TERMS = 14


def _dd_coef_table(values):
    """Split Python floats into a ``[terms, 2]`` float32 DD table (hi, lo);
    the Taylor loops take row j as a DD constant."""
    v64 = np.asarray(values, np.float64)
    hi = np.asarray(v64, np.float32)
    lo = np.asarray(v64 - hi, np.float32)
    return np.stack([hi, lo], axis=-1)


_TABLES = {}   # (table id, device) -> the table as a float32 tensor


def _table(tab: np.ndarray, like: torch.Tensor):
    """The coefficient table on ``like``'s device, copied there once."""
    key = (id(tab), like.device)
    if key not in _TABLES:
        _TABLES[key] = torch.as_tensor(tab, device=like.device)
    return _TABLES[key]


def _pow2(k):
    """Exact 2^k for integer-valued float32 k, clamped to [-126, 127],
    built from the exponent bits (an exp2 is an approximation); ``exp``
    handles the true under/overflow before calling this."""
    ki = torch.clamp(k.to(torch.int32), -126, 127)
    return ((ki + 127) << 23).view(F32)


# float32 exp domain: exp(-87.3) ~ 2^-126 (smallest normal), exp(88.7) ~
# 2^128 (overflow). Outside these, exp() returns exact 0 / +inf.
_EXP_UNDERFLOW = -87.0
_EXP_OVERFLOW = 88.0


def exp(a: DD) -> DD:
    """exp(a): exact 0 below the float32 underflow cliff, +inf above
    overflow; k = round(a/ln2) reduction and a DD Taylor series between.

    Accuracy contract (tests/test_torch_doublefloat.py): relative error <=
    max(~2^-47, 1.2e-38 / exp(a)); below ~1e-26 the lo word leaves the
    float32 normal range and results taper to float32 precision.
    """
    under = a[0] < _EXP_UNDERFLOW
    over = a[0] > _EXP_OVERFLOW
    bad = under | over
    # The reduced path runs on a safe argument so no intermediate wraps.
    a_hi = torch.where(bad, 0.0, a[0])
    a_lo = torch.where(bad, 0.0, a[1])
    k = torch.round(a_hi / _f32(_LN2, a_hi))
    # r = a - k*ln2 in DD (ln2 as a DD constant); |r| <= ln2/2
    ln2 = dd_const(_LN2, like=a_hi)
    r = sub((a_hi, a_lo), mul_f(ln2, k))
    acc = _exp_taylor(r)
    # scale by 2^k exactly, in two factors in case acc*2^k spans the range
    k1 = torch.trunc(k * 0.5)
    s1 = _pow2(k1)
    s2 = _pow2(k - k1)
    hi = (acc[0] * s1) * s2
    lo = (acc[1] * s1) * s2
    zero = torch.zeros_like(hi)
    hi = torch.where(under, zero, torch.where(over, math.inf, hi))
    lo = torch.where(bad, zero, lo)
    return hi, lo


_EXP_COEFS = _dd_coef_table(
    [1.0 / n for n in range(_EXP_MAX_TERMS, 0, -1)])


def _exp_taylor(r: DD) -> DD:
    """exp(r) for |r| <= ln2/2: Horner-evaluated DD Taylor series with DD
    reciprocal coefficients, 1 + r(1 + r/2(1 + r/3(...)))."""
    tab = _table(_EXP_COEFS, r[0])
    acc = (torch.ones_like(r[0]), torch.zeros_like(r[0]))
    for j in range(tab.shape[0]):
        acc = mul(acc, mul(r, (tab[j, 0], tab[j, 1])))
        acc = add_f(acc, 1.0)
    return acc


def log(a: DD) -> DD:
    """log(a) for a > 0: float32 seed y0 and one exact Newton step,
    y1 = y0 + c - c^2/2 with c = a*exp(-y0) - 1."""
    y0 = torch.log(a[0])
    zero = torch.zeros_like(y0)
    e = exp((-y0, zero))
    corr = add_f(mul(a, e), -1.0)
    c2 = mul_f(sqr(corr), -0.5)
    return add(add((y0, zero), corr), c2)


_PI = math.pi
_PIO2 = math.pi / 2.0


_SIN_COEFS = _dd_coef_table(
    list(reversed([1.0 / ((2 * n) * (2 * n + 1)) for n in range(1, 9)])))
_COS_COEFS = _dd_coef_table(
    list(reversed([1.0 / ((2 * n - 1) * (2 * n)) for n in range(2, 10)])))


def _horner_alt(r2: DD, coefs: np.ndarray) -> DD:
    """1 - c_0 r2 (1 - c_1 r2 (1 - ...)) over the table, innermost first."""
    tab = _table(coefs, r2[0])
    one = dd_const(1.0, like=r2)
    acc = (torch.ones_like(r2[0]), torch.zeros_like(r2[0]))
    for j in range(tab.shape[0]):
        acc = sub(one, mul(mul(r2, (tab[j, 0], tab[j, 1])), acc))
    return acc


def _sin_taylor(r: DD) -> DD:
    """sin(r), |r| <= pi/4: r(1 - r2/6(1 - r2/20(1 - ...))), 8 odd terms."""
    return mul(r, _horner_alt(sqr(r), _SIN_COEFS))


def _cos_taylor(r: DD) -> DD:
    """cos(r), |r| <= pi/4: 1 - r2/2 (1 - r2/12(1 - ...))."""
    r2 = sqr(r)
    acc = _horner_alt(r2, _COS_COEFS)
    return sub(dd_const(1.0, like=r), mul(mul_f(r2, 0.5), acc))


def sincos(a: DD) -> Tuple[DD, DD]:
    """(sin a, cos a) with DD range reduction mod pi/2; valid for |a| up
    to ~2e4 (the COS pricer's phases stay well inside)."""
    # k = round(a / (pi/2)); r = a - k*pi/2 computed in DD
    k = torch.round(a[0] * float(np.float32(1.0 / _PIO2)))
    pio2 = dd_const(_PIO2, like=a)
    r = sub(a, mul_f(pio2, k))
    quad = torch.remainder(k, 4.0).to(torch.int32)  # 0..3
    s, c = _sin_taylor(r), _cos_taylor(r)
    # sin(a) = [s, c, -s, -c][quad]; cos(a) = [c, -s, -c, s][quad]
    sin_out = where(quad == 0, s,
                    where(quad == 1, c,
                          where(quad == 2, neg(s), neg(c))))
    cos_out = where(quad == 0, c,
                    where(quad == 1, neg(s),
                          where(quad == 2, neg(c), s)))
    return sin_out, cos_out


def sin(a: DD) -> DD:
    return sincos(a)[0]


def cos(a: DD) -> DD:
    return sincos(a)[1]


def atan2(b: DD, a: DD) -> DD:
    """atan2(b, a): float32 seed y0 and one trigonometric Newton step,
    theta = y0 + e with e = (b cos y0 - a sin y0) / (a cos y0 + b sin y0)
    = tan(theta - y0) ~ 1e-7; y0 already lands in the right quadrant."""
    y0 = torch.atan2(b[0], a[0])
    zero = torch.zeros_like(y0)
    s, c = sincos((y0, zero))
    num = sub(mul(b, c), mul(a, s))
    den = add(mul(a, c), mul(b, s))
    return add((y0, zero), div(num, den))


def hypot(a: DD, b: DD) -> DD:
    """sqrt(a^2 + b^2); the pricer's ranges don't approach f32 overflow."""
    return sqrt(add(sqr(a), sqr(b)))
