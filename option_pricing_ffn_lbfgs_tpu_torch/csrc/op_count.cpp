// Operation counts of the kernels' formulas, for the bounds that
// chip_smoke.py reports. ops/opcount.py keeps this program's output as
// constants (ITEM_OPS), and tests/test_torch_opcount.py builds it with the
// host C++ compiler and holds them to it; it is never built for the card.
//
// The templates of cos_price_terms.cuh (K1) and cos_vg_terms.cuh (K2/K3) are
// instantiated with Cnt, a scalar that carries its value, so that every
// branch takes the side the given data takes, and whether it is a constant
// the compiler knows, so that what the compiler folds is not counted: a
// product with a zero tangent or a unit seed, a sum with a zero, an
// operation on literals. Each remaining +, -, *, / counts one operation
// (a fused multiply-add two), and so does each exp, log, sqrt, hypot,
// atan2, sin and cos, which are also counted apart as "special". A libm
// call costs many instructions, so a bound built on this count is a lower
// bound.
//
//   op_count N tau spot strike rate q L p0 .. p12
//
// prints one JSON object: for K2/K3, operations per CF item, per (row, k)
// payoff item (call and put), per row set-up and per maturity group range;
// for K1 (cos_price_terms.cuh), per maturity range, per CF item, per row
// (log-moneyness, widening, payoff set-up, discount) and per (row, k)
// payoff term.
#include <cstdio>
#include <cstdlib>

namespace opc {

long g_ops = 0, g_special = 0;

enum Kind { kZero, kOne, kConst, kVar };

struct Cnt {
  double v = 0.0;
  Kind k = kZero;
  Cnt() = default;
  Cnt(double x) : v(x), k(x == 0.0 ? kZero : x == 1.0 ? kOne : kConst) {}
};

inline Cnt var(double x) {
  Cnt c;
  c.v = x;
  c.k = kVar;
  return c;
}
inline Cnt as(double v, Kind k) {
  Cnt c;
  c.v = v;
  c.k = k;
  return c;
}
inline bool known(const Cnt& a) { return a.k != kVar; }
inline Cnt counted(double v) {
  ++g_ops;
  return var(v);
}

inline Cnt operator+(const Cnt& a, const Cnt& b) {
  if (a.k == kZero) return as(a.v + b.v, b.k);
  if (b.k == kZero) return as(a.v + b.v, a.k);
  if (known(a) && known(b)) return Cnt(a.v + b.v);
  return counted(a.v + b.v);
}
inline Cnt operator-(const Cnt& a) {
  return known(a) ? Cnt(-a.v) : var(-a.v);   // a sign modifier: free
}
inline Cnt operator-(const Cnt& a, const Cnt& b) {
  if (b.k == kZero) return as(a.v - b.v, a.k);
  if (a.k == kZero) return -b;
  if (known(a) && known(b)) return Cnt(a.v - b.v);
  return counted(a.v - b.v);
}
inline Cnt operator*(const Cnt& a, const Cnt& b) {
  if (a.k == kZero || b.k == kZero) return Cnt(0.0);
  if (a.k == kOne) return as(a.v * b.v, b.k);
  if (b.k == kOne) return as(a.v * b.v, a.k);
  if (known(a) && known(b)) return Cnt(a.v * b.v);
  return counted(a.v * b.v);
}
inline Cnt operator/(const Cnt& a, const Cnt& b) {
  if (a.k == kZero) return Cnt(0.0);
  if (b.k == kOne) return as(a.v / b.v, a.k);
  if (known(a) && known(b)) return Cnt(a.v / b.v);
  return counted(a.v / b.v);
}
inline Cnt& operator+=(Cnt& a, const Cnt& b) { return a = a + b; }
inline bool operator<(const Cnt& a, const Cnt& b) { return a.v < b.v; }
inline bool operator>(const Cnt& a, const Cnt& b) { return a.v > b.v; }
inline bool operator>=(const Cnt& a, const Cnt& b) { return a.v >= b.v; }

inline Cnt special(double v, const Cnt& x) {
  if (known(x)) return Cnt(v);
  ++g_special;
  return counted(v);
}
inline Cnt val(const Cnt& x) { return x; }
inline Cnt s_exp(const Cnt& x) { return special(__builtin_exp(x.v), x); }
inline Cnt s_log(const Cnt& x) { return special(__builtin_log(x.v), x); }
inline Cnt s_sqrt(const Cnt& x) { return special(__builtin_sqrt(x.v), x); }
inline Cnt s_abs(const Cnt& x) {
  return known(x) ? Cnt(__builtin_fabs(x.v)) : var(__builtin_fabs(x.v));
}
inline Cnt s_hypot(const Cnt& a, const Cnt& b) {
  return special(__builtin_hypot(a.v, b.v), known(a) ? b : a);
}
inline Cnt s_atan2(const Cnt& y, const Cnt& x) {
  return special(__builtin_atan2(y.v, x.v), known(y) ? x : y);
}
inline void s_sincos(const Cnt& x, Cnt& s, Cnt& c) {
  s = special(__builtin_sin(x.v), x);
  c = special(__builtin_cos(x.v), x);
}

}  // namespace opc

#include "cos_price_terms.cuh"
#include "cos_vg_terms.cuh"

namespace {

using opc::Cnt;

struct Tally {
  long ops = 0, special = 0;
  void start() { opc::g_ops = opc::g_special = 0; }
  void stop() {
    ops += opc::g_ops;
    special += opc::g_special;
  }
};

}  // namespace

int main(int argc, char** argv) {
  if (argc != 21) {
    std::fprintf(stderr,
                 "usage: op_count N tau spot strike rate q L p0 .. p12\n");
    return 2;
  }
  const int n = std::atoi(argv[1]);
  double in[19];
  for (int i = 0; i < 19; ++i) in[i] = std::atof(argv[2 + i]);
  const Cnt tau = opc::var(in[0]), spot = opc::var(in[1]),
            strike = opc::var(in[2]), rate = opc::var(in[3]),
            q = opc::var(in[4]), L = opc::var(in[5]);
  Cnt p[cosvg::kParams];
  for (int i = 0; i < cosvg::kParams; ++i) p[i] = opc::var(in[6 + i]);

  Tally range, item, setup[2], term[2];
  Tally k1_range, k1_item, k1_setup[2], k1_term[2];
  Cnt a, b, da[cosvg::kParams], db[cosvg::kParams];
  range.start();
  cosvg::group_range(p, tau, rate, L, &a, &b, da, db);
  range.stop();
  const Cnt log_k = opc::s_log(strike / spot);
  if (!(a < log_k - Cnt(0.1))) a = opc::var((log_k - Cnt(0.1)).v);
  if (!(b > log_k + Cnt(0.1))) b = opc::var((log_k + Cnt(0.1)).v);
  const Cnt width = b - a;
  const Cnt step = Cnt(3.141592653589793) / width;
  Cnt* items = new Cnt[cosvg::kScratch * n];
  item.start();
  for (int k = 0; k < n; ++k)
    cosvg::cf_item(p, tau, rate, q, a, width, step, k, n, items);
  item.stop();
  for (int call = 0; call < 2; ++call) {
    setup[call].start();
    const cosvg::PayoffRow<Cnt> pay(a, b, log_k, spot, strike, call != 0);
    setup[call].stop();
    Cnt acc[cosvg::kItem];
    for (int f = 0; f < cosvg::kItem; ++f) acc[f] = opc::var(0.0);
    term[call].start();
    for (int k = 0; k < n; ++k)
      cosvg::add_row_term(acc, items, n, k, pay.v(k));
    term[call].stop();
  }
  delete[] items;

  // K1: a maturity's range, its CF items, and each row's own work.
  Cnt ga, gb, ka, kb;
  k1_range.start();
  cosk1::cumulant_range(p, tau, rate, L, ga, gb);
  k1_range.stop();
  opc::g_ops = 0;
  const Cnt k1_log_k = opc::s_log(strike / spot);
  cosk1::widen(ga, gb, k1_log_k, ka, kb);
  const long row_ops = opc::g_ops;
  ka = opc::var(ka.v);                   // a stored range: not a constant
  kb = opc::var(kb.v);
  Cnt* k1_items = new Cnt[n];
  k1_item.start();
  for (int k = 0; k < n; ++k)
    k1_items[k] = cosk1::cf_item(p, tau, rate, q, ka, kb, k);
  k1_item.stop();
  for (int call = 0; call < 2; ++call) {
    k1_setup[call].start();
    const cosk1::PayoffRow<Cnt> pay(ka, kb, k1_log_k, spot, strike,
                                    call != 0);
    k1_setup[call].stop();
    Cnt sum = opc::var(0.0);
    k1_term[call].start();
    for (int k = 0; k < n; ++k)
      sum = cosk1::add_term(sum, k1_items[k], pay.v(k), k);
    k1_term[call].stop();
    k1_setup[call].start();
    cosk1::discounted(sum, rate, tau);
    k1_setup[call].stop();
    k1_setup[call].ops += row_ops;
  }
  delete[] k1_items;
  std::printf(
      "{\"n_terms\": %d, \"group_range\": %ld, \"group_range_special\": %ld, "
      "\"cf_item\": %.6f, \"cf_item_special\": %.6f, "
      "\"row_setup_put\": %ld, \"row_setup_call\": %ld, "
      "\"payoff_term_put\": %.6f, \"payoff_term_call\": %.6f, "
      "\"payoff_term_special\": %.6f, "
      "\"k1_range\": %ld, \"k1_range_special\": %ld, "
      "\"k1_cf_item\": %.6f, \"k1_cf_item_special\": %.6f, "
      "\"k1_row_setup_put\": %ld, \"k1_row_setup_call\": %ld, "
      "\"k1_payoff_term_put\": %.6f, \"k1_payoff_term_call\": %.6f, "
      "\"k1_payoff_term_special\": %.6f}\n",
      n, range.ops, range.special, double(item.ops) / n,
      double(item.special) / n, setup[0].ops, setup[1].ops,
      double(term[0].ops) / n, double(term[1].ops) / n,
      double(term[1].special) / n, k1_range.ops, k1_range.special,
      double(k1_item.ops) / n, double(k1_item.special) / n,
      k1_setup[0].ops, k1_setup[1].ops, double(k1_term[0].ops) / n,
      double(k1_term[1].ops) / n, double(k1_term[1].special) / n);
  return 0;
}
