// The per-item formulas of K1 (cos_price.cu), apart from the kernel so
// that op_count.cpp can count their operations on the host.
//
//   cumulant_range: a maturity's range [a, b] before the per-row widening;
//   widen:          one row's range, widened to log(K/S0) -/+ 0.1;
//   cf_item:        one (group, k) item Re[phi(u_k) exp(-i u_k a)];
//   PayoffRow:      one row's payoff coefficients V_k;
//   add_term:       one (row, k) term added to the row's running sum;
//   discounted:     the row's price from its sum.
// Put together per row they are the COS series of the plain pricer
// (models/double_heston.py::price_options), in its order of operations.
#pragma once

#include "cos_math.cuh"

namespace cosk1 {

using namespace cosm;

// Fang-Oosterlee range c1 -/+ L sqrt|c2| of one maturity.
template <typename S>
__device__ __forceinline__ void cumulant_range(const S* p, S tau, S r, S L,
                                               S& a, S& b) {
  S c1f1, c2f1, c1f2, c2f2;
  factor_cumulants(tau, r, p[0], p[1], p[2], p[3], p[4], c1f1, c2f1);
  factor_cumulants(tau, r, p[5], p[6], p[7], p[8], p[9], c1f2, c2f2);
  const S c1 = c1f1 + c1f2 + p[10] * tau * p[11];
  const S c2 = c2f1 + c2f2 + p[10] * tau * (p[12] * p[12] + p[11] * p[11]);
  const S spread = L * s_sqrt(s_abs(c2));
  a = c1 - spread;
  b = c1 + spread;
}

// The row's range: the maturity's [ga, gb] widened to log(K/S0) -/+ 0.1.
// True when neither end moved, so the row can share its maturity's items.
template <typename S>
__device__ __forceinline__ bool widen(S ga, S gb, S log_k, S& a, S& b) {
  const S lo = log_k - S(0.1), hi = log_k + S(0.1);
  const bool a_on = ga < lo, b_on = gb > hi;
  a = a_on ? ga : lo;
  b = b_on ? gb : hi;
  return a_on && b_on;
}

// Re[phi(u_k) exp(-i u_k a)] with u_k = k pi / (b - a): the factor of the
// k-th term that does not depend on the strike.
template <typename S>
__device__ __forceinline__ S cf_item(const S* p, S tau, S r, S q, S a, S b,
                                     int k) {
  const S width = b - a;
  const S step = S(3.141592653589793) / width;
  const S u = S(k) * step;
  const Cx<S> phi = char_fn(u, tau, p, r, q);
  S sua, cua;
  s_sincos(u * a, sua, cua);
  return phi.re * cua + phi.im * sua;
}

// One row's payoff coefficients V_k over [a, b] (calls integrate over
// [log K, b], puts over [a, log K]; k = 0 takes the chi/psi limits).
template <typename S>
struct PayoffRow {
  S step, two_over, c, d, ed, ec, dma, cma, spot, strike;
  bool call;
  __device__ __forceinline__ PayoffRow(S a, S b, S log_k, S spot_,
                                       S strike_, bool call_)
      : spot(spot_), strike(strike_), call(call_) {
    const S width = b - a;
    step = S(3.141592653589793) / width;
    c = call ? log_k : a;
    d = call ? b : log_k;
    ed = s_exp(d);
    ec = s_exp(c);
    dma = d - a;
    cma = c - a;
    two_over = S(2) / width;
  }
  __device__ __forceinline__ S v(int k) const {
    const S u = S(k) * step;
    S chi, psi;
    if (k == 0) {
      chi = ed - ec;
      psi = d - c;
    } else {
      S sd, cd, sc, cc;
      s_sincos(u * dma, sd, cd);
      s_sincos(u * cma, sc, cc);
      chi = (cd * ed - cc * ec + u * (sd * ed - sc * ec)) / (S(1) + u * u);
      psi = (sd - sc) / u;
    }
    return call ? two_over * (spot * chi - strike * psi)
                : two_over * (strike * psi - spot * chi);
  }
};

// acc + item_k V_k, the k = 0 term at half weight.
template <typename S>
__device__ __forceinline__ S add_term(S acc, S item, S v, int k) {
  const S term = item * v;
  return acc + (k == 0 ? term * S(0.5) : term);
}

template <typename S>
__device__ __forceinline__ S discounted(S sum, S r, S tau) {
  return s_exp(-r * tau) * sum;
}

}  // namespace cosk1
