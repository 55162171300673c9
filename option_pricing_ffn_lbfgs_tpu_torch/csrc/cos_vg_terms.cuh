// The per-item formulas of K2/K3 (cos_vg.cu), apart from the kernel so
// that op_count.cpp can count their operations on the host.
//
//   group_range:  a maturity's cumulant range and its 13-wide derivative;
//   cf_item:      one (group, k) characteristic-function item;
//   PayoffRow:    one row's payoff V_k in Dual<T, 2> over (a, b);
//   add_row_term: one (row, k) item's addition to the row's 16 sums.
// Calls are unqualified (with the cosm names in scope) so that a scalar
// type of another namespace finds its own exp, log, ... by lookup.
#pragma once

#include "cos_math.cuh"

namespace cosvg {

using namespace cosm;

constexpr int kParams = 13;
constexpr int kItem = 3 + kParams;        // F, dF/da, dF/db, Q_0..Q_12
constexpr int kScratch = kItem + kParams;  // + Im d log phi / d theta_j

// Cumulant range [a, b] of one maturity (before the per-row widening) and
// its derivative in the 13 parameters: each factor's cumulants in
// Dual<T, 5> over (v0, kappa, theta, sigma, rho), the jump terms in closed
// form; the primal in cosk1::cumulant_range's order.
template <typename T>
__device__ void group_range(const T* p, T tau, T rate, T L, T* a, T* b,
                            T* da, T* db) {
  using D5 = Dual<T, 5>;
  D5 c1f[2], c2f[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    D5 v[5];
#pragma unroll
    for (int j = 0; j < 5; ++j) {
      v[j] = D5(p[5 * i + j]);
      v[j].d[j] = T(1);
    }
    factor_cumulants(tau, rate, v[0], v[1], v[2], v[3], v[4], c1f[i],
                           c2f[i]);
  }
  const T c1 = c1f[0].v + c1f[1].v + p[10] * tau * p[11];
  const T c2 = c2f[0].v + c2f[1].v
      + p[10] * tau * (p[12] * p[12] + p[11] * p[11]);
  const T sq = s_sqrt(s_abs(c2));
  const T spread = L * sq;
  *a = c1 - spread;
  *b = c1 + spread;
  const T h = (c2 < T(0) ? -L : L) * (T(0.5) / sq);   // d spread / d c2
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 5; ++j) {
      da[5 * i + j] = c1f[i].d[j] - h * c2f[i].d[j];
      db[5 * i + j] = c1f[i].d[j] + h * c2f[i].d[j];
    }
  }
  // c1_J = lambda tau mu, c2_J = lambda tau (sigma_J^2 + mu^2)
  const T d1[3] = {tau * p[11], p[10] * tau, T(0)};
  const T d2[3] = {tau * (p[12] * p[12] + p[11] * p[11]),
                   p[10] * tau * T(2) * p[11], p[10] * tau * T(2) * p[12]};
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    da[10 + j] = d1[j] - h * d2[j];
    db[10 + j] = d1[j] + h * d2[j];
  }
}

// One CF item (group, k): F = w_k Re[phi E], its total derivatives in a and
// b, and Q_j = w_k Re[dphi/dtheta_j E] (at fixed u), written to
// item[f * n_terms + k] for the 16 fields f. Fields 3..28 first hold
// d log phi / d theta_j (real, then imaginary parts): shared memory, not
// registers, carries them while the two Heston factors are evaluated.
template <typename T>
__device__ __forceinline__ void cf_item(const T* p, T tau, T rate, T q, T a,
                                        T width, T step, int k, int n_terms,
                                        T* item) {
  using D5 = Dual<T, 5>;
  using D4 = Dual<T, 4>;
  const T u = T(k) * step;
  T* dre = item + 3 * n_terms + k;              // [j * n_terms]
  T* dim = item + (3 + kParams) * n_terms + k;
  // The jump factor and the drift: Dual<T, 4> over (lambda, mu_J,
  // sigma_J, u), in char_fn's order of operations.
  T jr, ji, dv, du_re, du_im;
  {
    D4 lam(p[10]), mu(p[11]), sj(p[12]), u4(u);
    lam.d[0] = T(1);
    mu.d[1] = T(1);
    sj.d[2] = T(1);
    u4.d[3] = T(1);
    const D4 compensator = s_exp(mu + T(0.5) * sj * sj) - T(1);
    const D4 drift = (rate - q) - lam * compensator;
    const D4 dut = drift * u4 * tau;
    const D4 jamp = s_exp(T(-0.5) * sj * sj * u4 * u4);
    D4 sn, cs;
    s_sincos(u4 * mu, sn, cs);
    const D4 lt = lam * tau;
    const D4 jre = lt * (jamp * cs - T(1));
    const D4 jim = lt * (jamp * sn);
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      dre[(10 + j) * n_terms] = jre.d[j];
      dim[(10 + j) * n_terms] = jim.d[j] + dut.d[j];
    }
    du_re = jre.d[3];
    du_im = jim.d[3] + dut.d[3];
    jr = jre.v;
    ji = jim.v;
    dv = dut.v;
  }
  // The Heston factors: Dual<T, 5> over (kappa, theta, sigma, rho, u);
  // d log phi / d v0 = B.
  Cx<T> Bv[2], Av[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int o = 5 * i;
    D5 uu(u), kap(p[o + 1]), th(p[o + 2]), sg(p[o + 3]), rh(p[o + 4]);
    kap.d[0] = T(1);
    th.d[1] = T(1);
    sg.d[2] = T(1);
    rh.d[3] = T(1);
    uu.d[4] = T(1);
    Cx<D5> B, A;
    heston_factor(uu, tau, kap, th, sg, rh, B, A);
    const T v0 = p[o];
    dre[o * n_terms] = B.re.v;
    dim[o * n_terms] = B.im.v;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      dre[(o + 1 + j) * n_terms] = A.re.d[j] + v0 * B.re.d[j];
      dim[(o + 1 + j) * n_terms] = A.im.d[j] + v0 * B.im.d[j];
    }
    du_re += A.re.d[4] + v0 * B.re.d[4];
    du_im += A.im.d[4] + v0 * B.im.d[4];
    Bv[i] = {B.re.v, B.im.v};
    Av[i] = {A.re.v, A.im.v};
  }

  // phi in char_fn's order of operations.
  const Cx<T> A = {Av[0].re + Av[1].re, dv + Av[0].im + Av[1].im};
  const Cx<T> expo = cadd(A, cadd(cscale(Bv[0], p[0]),
                                              cscale(Bv[1], p[5])));
  const Cx<T> phi = cmul(cexp(expo), cexp(Cx<T>{jr, ji}));
  T sua, cua;
  s_sincos(u * a, sua, cua);
  const T pr = phi.re * cua + phi.im * sua;   // Re[phi E]
  const T pi = phi.im * cua - phi.re * sua;   // Im[phi E]
  const T wk = k == 0 ? T(0.5) : T(1);
  // d Re[phi E] / du at fixed a, then the chain through u = k pi / (b - a).
  const T gu = pr * du_re - pi * du_im + a * pi;
  const T du_da = u / width;                  // du/db = -du_da
  item[k] = wk * pr;
  item[n_terms + k] = wk * (gu * du_da + u * pi);
  item[2 * n_terms + k] = wk * (-gu * du_da);
#pragma unroll
  for (int j = 0; j < kParams; ++j)
    dre[j * n_terms] = wk * (pr * dre[j * n_terms] - pi * dim[j * n_terms]);
}

// One row's payoff coefficients V_k(a, b) with their derivatives in a and
// b: Dual<T, 2> seeded on (a, b), in cosk1::PayoffRow's order.
template <typename T>
struct PayoffRow {
  using D2 = Dual<T, 2>;
  D2 two_over, step, c, d, ed, ec, dma, cma;
  T spot, strike;
  bool call;
  __device__ __forceinline__ PayoffRow(T a, T b, T log_k, T spot_, T strike_,
                                       bool call_)
      : spot(spot_), strike(strike_), call(call_) {
    D2 ad(a), bd(b);
    ad.d[0] = T(1);
    bd.d[1] = T(1);
    const D2 width = bd - ad;
    step = T(3.141592653589793) / width;
    c = call ? D2(log_k) : ad;
    d = call ? bd : D2(log_k);
    ed = s_exp(d);
    ec = s_exp(c);
    dma = d - ad;
    cma = c - ad;
    two_over = T(2) / width;
  }
  __device__ __forceinline__ D2 v(int k) const {
    const D2 u = T(k) * step;
    D2 chi, psi;
    if (k == 0) {
      chi = ed - ec;
      psi = d - c;
    } else {
      D2 sd, cd, sc, cc;
      s_sincos(u * dma, sd, cd);
      s_sincos(u * cma, sc, cc);
      chi = (cd * ed - cc * ec + u * (sd * ed - sc * ec)) / (T(1) + u * u);
      psi = (sd - sc) / u;
    }
    return call ? two_over * (spot * chi - strike * psi)
                : two_over * (strike * psi - spot * chi);
  }
};

// acc[16] += the (row, k) item: the price term F V, the total derivatives
// in a and b (dF/da V + F dV/da, ...), and the 13 CF terms Q_j V.
template <typename T>
__device__ __forceinline__ void add_row_term(T* acc, const T* item,
                                             int n_terms, int k,
                                             const Dual<T, 2>& v) {
  const T F = item[k];
  acc[0] += F * v.v;
  acc[1] += item[n_terms + k] * v.v + F * v.d[0];
  acc[2] += item[2 * n_terms + k] * v.v + F * v.d[1];
#pragma unroll
  for (int j = 0; j < kParams; ++j)
    acc[3 + j] += item[(3 + j) * n_terms + k] * v.v;
}

}  // namespace cosvg
