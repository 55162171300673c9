// Double Heston + Merton COS formulas, written once for every scalar type.
//
// The kernels of this package evaluate the same formulas as the plain
// PyTorch pricer (models/double_heston.py, ops/complex_math.py), in the
// same order of operations, as __device__ templates over a scalar type S:
//   * float and double      -> K1 (cos_price.cu, cos_price_terms.cuh), the
//                              forward price;
//   * Dual<T, 5>, Dual<T, 4>, Dual<T, 2>
//                           -> K2/K3 (cos_vg.cu, cos_vg_terms.cuh): each
//                              Heston factor with its derivatives in
//                              (kappa, theta, sigma, rho, u), the jump factor
//                              in (lambda, mu_J, sigma_J, u), the payoff in
//                              the range (a, b).
// Built for the host (without nvcc), the same templates count operations
// (op_count.cpp).
// R = RealOf<S> is the underlying real type; per-row inputs that do not
// depend on the parameters (strike, maturity, spot, rate) are R, so they
// carry no tangent. Every literal is written R(...) so a float kernel never
// promotes to double.
//
// Branches (Smith's division, the principal-branch sqrt, the k = 0 payoff
// limits, min/max of the truncation range) select on the primal value and
// evaluate only the taken side, so no untaken branch can leak a NaN into a
// tangent: that is what the double-where guards do in the plain version.
#pragma once

#ifdef __CUDACC__
#include <cuda_runtime.h>
#else  // host build (op_count.cpp): the qualifiers mean nothing there
#define __device__
#define __host__
#define __forceinline__ inline
#endif
#include <math.h>

namespace cosm {

// ---------------------------------------------------------------- Dual --
template <typename T, int D>
struct Dual {
  T v;
  T d[D];
  __device__ __forceinline__ Dual() {}
  __device__ __forceinline__ explicit Dual(T c) : v(c) {
#pragma unroll
    for (int i = 0; i < D; ++i) d[i] = T(0);
  }
};

template <typename S> struct RealOf { using type = S; };
template <typename T, int D> struct RealOf<Dual<T, D>> { using type = T; };

__device__ __forceinline__ float val(float x) { return x; }
__device__ __forceinline__ double val(double x) { return x; }
template <typename T, int D>
__device__ __forceinline__ T val(const Dual<T, D>& x) { return x.v; }

#define COSM_DUAL template <typename T, int D> __device__ __forceinline__
#define COSM_EACH _Pragma("unroll") for (int i = 0; i < D; ++i)

COSM_DUAL Dual<T, D> operator-(const Dual<T, D>& a) {
  Dual<T, D> r; r.v = -a.v; COSM_EACH r.d[i] = -a.d[i]; return r;
}
COSM_DUAL Dual<T, D> operator+(const Dual<T, D>& a, const Dual<T, D>& b) {
  Dual<T, D> r; r.v = a.v + b.v; COSM_EACH r.d[i] = a.d[i] + b.d[i]; return r;
}
COSM_DUAL Dual<T, D> operator+(const Dual<T, D>& a, T b) {
  Dual<T, D> r; r.v = a.v + b; COSM_EACH r.d[i] = a.d[i]; return r;
}
COSM_DUAL Dual<T, D> operator+(T a, const Dual<T, D>& b) {
  Dual<T, D> r; r.v = a + b.v; COSM_EACH r.d[i] = b.d[i]; return r;
}
COSM_DUAL Dual<T, D> operator-(const Dual<T, D>& a, const Dual<T, D>& b) {
  Dual<T, D> r; r.v = a.v - b.v; COSM_EACH r.d[i] = a.d[i] - b.d[i]; return r;
}
COSM_DUAL Dual<T, D> operator-(const Dual<T, D>& a, T b) {
  Dual<T, D> r; r.v = a.v - b; COSM_EACH r.d[i] = a.d[i]; return r;
}
COSM_DUAL Dual<T, D> operator-(T a, const Dual<T, D>& b) {
  Dual<T, D> r; r.v = a - b.v; COSM_EACH r.d[i] = -b.d[i]; return r;
}
COSM_DUAL Dual<T, D> operator*(const Dual<T, D>& a, const Dual<T, D>& b) {
  Dual<T, D> r; r.v = a.v * b.v;
  COSM_EACH r.d[i] = a.d[i] * b.v + a.v * b.d[i];
  return r;
}
COSM_DUAL Dual<T, D> operator*(const Dual<T, D>& a, T b) {
  Dual<T, D> r; r.v = a.v * b; COSM_EACH r.d[i] = a.d[i] * b; return r;
}
COSM_DUAL Dual<T, D> operator*(T a, const Dual<T, D>& b) {
  Dual<T, D> r; r.v = a * b.v; COSM_EACH r.d[i] = a * b.d[i]; return r;
}
COSM_DUAL Dual<T, D> operator/(const Dual<T, D>& a, const Dual<T, D>& b) {
  Dual<T, D> r; r.v = a.v / b.v;
  COSM_EACH r.d[i] = (a.d[i] - r.v * b.d[i]) / b.v;
  return r;
}
COSM_DUAL Dual<T, D> operator/(const Dual<T, D>& a, T b) {
  Dual<T, D> r; r.v = a.v / b; COSM_EACH r.d[i] = a.d[i] / b; return r;
}
COSM_DUAL Dual<T, D> operator/(T a, const Dual<T, D>& b) {
  Dual<T, D> r; r.v = a / b.v;
  COSM_EACH r.d[i] = -r.v * b.d[i] / b.v;
  return r;
}

// ------------------------------------------------------ real functions --
__device__ __forceinline__ float s_exp(float x) { return expf(x); }
__device__ __forceinline__ double s_exp(double x) { return exp(x); }
__device__ __forceinline__ float s_log(float x) { return logf(x); }
__device__ __forceinline__ double s_log(double x) { return log(x); }
__device__ __forceinline__ float s_sqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ double s_sqrt(double x) { return sqrt(x); }
__device__ __forceinline__ float s_abs(float x) { return fabsf(x); }
__device__ __forceinline__ double s_abs(double x) { return fabs(x); }
__device__ __forceinline__ float s_hypot(float a, float b) { return hypotf(a, b); }
__device__ __forceinline__ double s_hypot(double a, double b) { return hypot(a, b); }
__device__ __forceinline__ float s_atan2(float y, float x) { return atan2f(y, x); }
__device__ __forceinline__ double s_atan2(double y, double x) { return atan2(y, x); }
__device__ __forceinline__ void s_sincos(float x, float& s, float& c) { sincosf(x, &s, &c); }
__device__ __forceinline__ void s_sincos(double x, double& s, double& c) { sincos(x, &s, &c); }

COSM_DUAL Dual<T, D> s_exp(const Dual<T, D>& x) {
  Dual<T, D> r; r.v = s_exp(x.v); COSM_EACH r.d[i] = r.v * x.d[i]; return r;
}
COSM_DUAL Dual<T, D> s_log(const Dual<T, D>& x) {
  Dual<T, D> r; r.v = s_log(x.v); COSM_EACH r.d[i] = x.d[i] / x.v; return r;
}
COSM_DUAL Dual<T, D> s_sqrt(const Dual<T, D>& x) {
  Dual<T, D> r; r.v = s_sqrt(x.v);
  const T h = T(0.5) / r.v;
  COSM_EACH r.d[i] = x.d[i] * h;
  return r;
}
COSM_DUAL Dual<T, D> s_abs(const Dual<T, D>& x) { return x.v < T(0) ? -x : x; }
COSM_DUAL Dual<T, D> s_hypot(const Dual<T, D>& a, const Dual<T, D>& b) {
  Dual<T, D> r; r.v = s_hypot(a.v, b.v);
  COSM_EACH r.d[i] = (a.v * a.d[i] + b.v * b.d[i]) / r.v;
  return r;
}
COSM_DUAL Dual<T, D> s_atan2(const Dual<T, D>& y, const Dual<T, D>& x) {
  Dual<T, D> r; r.v = s_atan2(y.v, x.v);
  const T den = x.v * x.v + y.v * y.v;
  COSM_EACH r.d[i] = (x.v * y.d[i] - y.v * x.d[i]) / den;
  return r;
}
COSM_DUAL void s_sincos(const Dual<T, D>& x, Dual<T, D>& s, Dual<T, D>& c) {
  s_sincos(x.v, s.v, c.v);
  COSM_EACH { s.d[i] = c.v * x.d[i]; c.d[i] = -s.v * x.d[i]; }
}

#undef COSM_DUAL
#undef COSM_EACH

// ---------------------------------------------------- split complex --
template <typename S> struct Cx { S re, im; };

template <typename S>
__device__ __forceinline__ Cx<S> cadd(const Cx<S>& a, const Cx<S>& b) {
  return {a.re + b.re, a.im + b.im};
}
template <typename S>
__device__ __forceinline__ Cx<S> csub(const Cx<S>& a, const Cx<S>& b) {
  return {a.re - b.re, a.im - b.im};
}
template <typename S>
__device__ __forceinline__ Cx<S> cmul(const Cx<S>& a, const Cx<S>& b) {
  return {a.re * b.re - a.im * b.im, a.re * b.im + a.im * b.re};
}
template <typename S, typename X>
__device__ __forceinline__ Cx<S> cscale(const Cx<S>& a, const X& s) {
  return {a.re * s, a.im * s};
}
// Smith's algorithm; only the branch chosen by |Re b| < |Im b| is evaluated.
template <typename S>
__device__ __forceinline__ Cx<S> cdiv(const Cx<S>& a, const Cx<S>& b) {
  if (s_abs(val(b.re)) < s_abs(val(b.im))) {
    const S t = b.re / b.im;
    const S den = b.im + b.re * t;
    return {(a.im + a.re * t) / den, (a.im * t - a.re) / den};
  }
  const S t = b.im / b.re;
  const S den = b.re + b.im * t;
  return {(a.re + a.im * t) / den, (a.im - a.re * t) / den};
}
template <typename S>
__device__ __forceinline__ Cx<S> cexp(const Cx<S>& a) {
  const S e = s_exp(a.re);
  S s, c;
  s_sincos(a.im, s, c);
  return {e * c, e * s};
}
template <typename S>
__device__ __forceinline__ Cx<S> clog(const Cx<S>& a) {
  return {s_log(s_hypot(a.re, a.im)), s_atan2(a.im, a.re)};
}
// Principal branch, as np.sqrt(complex): the argument of the real sqrt is
// kept away from 0 on the positive real axis (u = 0), where a naive form
// would have an infinite derivative.
template <typename S>
__device__ __forceinline__ Cx<S> csqrt(const Cx<S>& a) {
  using R = typename RealOf<S>::type;
  const S m = s_hypot(a.re, a.im);
  if (val(a.re) >= R(0)) {
    const S t = s_sqrt((m + a.re) * R(0.5));
    return {t, a.im / (R(2) * t)};
  }
  const S t = s_sqrt((m - a.re) * R(0.5));
  const R sgn = val(a.im) < R(0) ? R(-1) : R(1);
  return {s_abs(a.im) / (R(2) * t), sgn * t};
}

// ------------------------------------------------------------- model --
// Parameter order: v1_0 kappa1 theta1 sigma1 rho1 v2_0 kappa2 theta2
// sigma2 rho2 lambda_j mu_j sigma_j.

// One Heston factor's (B, A_term): it adds A_term + B * v0 to the exponent.
template <typename S>
__device__ __forceinline__ void heston_factor(
    const S& u, typename RealOf<S>::type tau, const S& kappa, const S& theta,
    const S& sigma, const S& rho, Cx<S>& B, Cx<S>& A) {
  using R = typename RealOf<S>::type;
  const S sig2 = sigma * sigma;
  const Cx<S> xi = {kappa, (-rho) * sigma * u};
  const S inner_re = kappa * kappa + sig2 * u * u * (R(1) - rho * rho);
  const S inner_im = sig2 * u - R(2) * kappa * rho * sigma * u;
  const Cx<S> d = csqrt(Cx<S>{inner_re, inner_im});
  const Cx<S> xmd = csub(xi, d);
  const Cx<S> xpd = cadd(xi, d);
  const Cx<S> g = cdiv(xmd, xpd);
  const Cx<S> e = cexp(Cx<S>{(-d.re) * tau, (-d.im) * tau});
  const Cx<S> ge = cmul(g, e);
  const Cx<S> one_m_ge = {R(1) - ge.re, R(0) - ge.im};
  B = cmul(cscale(xmd, R(1) / sig2),
           cdiv(Cx<S>{R(1) - e.re, R(0) - e.im}, one_m_ge));
  const Cx<S> lr = clog(cdiv(one_m_ge, Cx<S>{R(1) - g.re, R(0) - g.im}));
  const Cx<S> inner = {xmd.re * tau - lr.re * R(2), xmd.im * tau - lr.im * R(2)};
  A = cscale(inner, kappa * theta / sig2);
}

// Characteristic function of log(S_T/S_0) at the real frequency u.
template <typename S>
__device__ __forceinline__ Cx<S> char_fn(
    const S& u, typename RealOf<S>::type tau, const S* p,
    typename RealOf<S>::type r, typename RealOf<S>::type q) {
  using R = typename RealOf<S>::type;
  Cx<S> B1, A1, B2, A2;
  heston_factor(u, tau, p[1], p[2], p[3], p[4], B1, A1);
  heston_factor(u, tau, p[6], p[7], p[8], p[9], B2, A2);
  const S compensator = s_exp(p[11] + R(0.5) * p[12] * p[12]) - R(1);
  const S drift = (r - q) - p[10] * compensator;
  const Cx<S> A = {A1.re + A2.re, drift * u * tau + A1.im + A2.im};
  const Cx<S> expo = cadd(A, cadd(cscale(B1, p[0]), cscale(B2, p[5])));
  const Cx<S> cf_heston = cexp(expo);
  const S jamp = s_exp(R(-0.5) * p[12] * p[12] * u * u);
  S sn, cs;
  s_sincos(u * p[11], sn, cs);
  const S lt = p[10] * tau;
  const Cx<S> cf_jump = cexp(Cx<S>{lt * (jamp * cs - R(1)), lt * (jamp * sn)});
  return cmul(cf_heston, cf_jump);
}

// Fang-Oosterlee c1/c2 of one factor; r*tau is counted per factor, as in
// the reference.
template <typename S>
__device__ __forceinline__ void factor_cumulants(
    typename RealOf<S>::type tau, typename RealOf<S>::type r, const S& v0,
    const S& lm, const S& vb, const S& vv, const S& rho, S& c1, S& c2) {
  using R = typename RealOf<S>::type;
  const S e1 = s_exp((-lm) * tau);
  const S lm2 = lm * lm;
  c1 = r * tau + (R(1) - e1) * (vb - v0) / (R(2) * lm) - vb * tau / R(2);
  c2 = (R(1) / (R(8) * (lm * lm2))) * (
      vv * tau * lm * e1 * (v0 - vb) * (R(8) * lm * rho - R(4) * vv)
      + lm * rho * vv * (R(1) - e1) * (R(16) * vb - R(8) * v0)
      + R(2) * vb * lm * tau * (R(-4) * lm * rho * vv + vv * vv + R(4) * lm2)
      + vv * vv * ((vb - R(2) * v0) * s_exp(R(-2) * lm * tau)
                   + vb * (R(6) * e1 - R(7)) + R(2) * v0)
      + R(8) * lm2 * (v0 - vb) * (R(1) - e1));
}

}  // namespace cosm
