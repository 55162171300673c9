// K4 (lbfgs_open) and K5 (lbfgs_update): one trip of the batched flat
// L-BFGS, split at its one evaluation, float and double.
//
// Replace the body of the JAX package's jax.lax.while_loop in
// option_pricing_ffn_lbfgs_tpu/ops/lbfgs_batched.py::lbfgs_minimize_batched
// (:160-334) and the two-loop recursion's lax.fori_loops
// (_two_loop_direction_batched, :80-114). XLA compiled those into one
// device program; neither has a Pallas twin. The plain PyTorch versions are
// ops/lbfgs_batched.py::lbfgs_open_plain / lbfgs_update_plain, which this
// file follows line by line:
//   K4, before the evaluation (JAX :163-193): for a lane that starts an
//     iteration, the two-loop direction d = -H g over its circular (s, y)
//     history, the bad-direction fallback -g, the initial step and the line
//     search's opening resets; for every lane the trial point x_try (x for
//     bootstrap and done lanes). Block 0 zeroes the live count.
//   K5, after it (JAX :194-334): safe_vg's zeroing of non-finite gradient
//     entries and +inf for a non-finite value; one bracket or zoom step;
//     the best point so far; the curvature-safe history write at head; the
//     gtol/ftol, restart, give-up, maxiter and maxeval tests; commit and
//     bootstrap. Each block adds its count of lanes not done afterwards to
//     the live count, which the host reads once a trip.
// Both update the state in place (the plain versions build new tensors)
// and leave done lanes untouched: K4 writes only their x_try.
//
// Fused mode, for the calibration objective (d = 13; the _fused entries):
// the search loss's host assembly (ops/loss_kernel.py's value-and-grad,
// JAX's ops/loss_pallas.py:205-231) moves into the two kernels, so that a
// trip is K4, K2 (csrc/cos_vg.cu, unchanged) and K5 with no other launch:
//   K4 also writes params_try = transform(x_try) (exp or tanh where the
//     caller's masks say, identity elsewhere), which K2 prices; bootstrap
//     and done lanes get the transform of x;
//   K5 first assembles f and g from K2's prices and row-summed gradient:
//     the validity mask (finite, positive prices), the mean of the squared
//     relative errors in the order torch.mean sums them on the card (mean
//     below), the Feller penalty and its gradient (zero at the kink) at the
//     caller's parameter indices, the sentinel bad_loss with a zero
//     gradient where any row is invalid or the loss is not finite, the
//     chain rule (g_price + pen_g) * dtransform/dx (from params_try), and
//     non-finite entries set to 0; then the update above. The plain
//     versions are ops/loss_kernel.py::lbfgs_open_fused_plain and
//     lbfgs_update_fused_plain. The transform's masks and the Feller
//     indices are arguments, taken from calibration/transforms.py and the
//     parameter vector's layout, so this file holds no second copy of them.
//
// What bounds them on the H100: bytes. Per lane they do a few hundred
// operations on a few kilobytes (K4 reads hist_len pairs of 2d + 1 values
// of an opening lane's history), far below the card's operation rate; the
// least time is the state they read and write over the memory rate
// (ops/opcount.py::lbfgs_open_work, lbfgs_update_work). At the calibration
// shapes that is under a microsecond, so a launch costs its latency, and
// what the design is for is to replace ~600 host-issued launches a trip
// with two, and, fused, the ~40 of the loss's assembly as well; the
// wrappers bind a run's trip once (ops/lbfgs_batched.py::TripKernels), so
// a launch is one prepared ctypes call. The fused K5 adds 2 n + 26 values
// a live lane to its reads (prices, market prices, K2's sums,
// params_try) and fused K4 13 a lane to its writes: still bytes.
//
// Design: a group of 16 threads (half a warp) serves one lane, thread t
// holding coordinates t, t + 16, ... (K = 1, 2 or 4 of them, a template
// parameter: d <= 16 K <= 64), so a history row is read coalesced; dot
// products and max-abs are xor-butterfly shuffles within the group, which
// give every thread the same bits; the per-lane scalars (stage, step,
// bracket, counters) are computed redundantly by the group and written by
// its thread 0, and fused K5's loss likewise (the group shares the rows
// as ATen's reduction shares them among its threads, then every thread
// holds the sum); thread t assembles coordinate t of the gradient. The
// two-loop's alphas
// sit in shared memory. The circular indices are computed in registers:
// a lane that is not done and whose head is outside [0, m) or hist_len
// outside [0, m] sets the error word to 1 + its index and is left as it
// is; nothing is clamped.
//
// Matching the plain version in bits: the file is built with -fmad=false
// (eager PyTorch rounds a * b + c twice); torch.clamp / maximum / minimum /
// amax propagate NaN where fmax / fmin do not, so those are written out;
// each Python constant becomes T(constant) as PyTorch casts it to the
// tensor's dtype (1e-300 is 0 in float); division and square root are the
// correctly rounded ones, exp and tanh the libm ones PyTorch's kernels
// call (csrc/trip_transform.cuh, shared with the fused LM trip). The plain versions sum in this file's order on the card: a dot
// product as the butterfly below (ops/lbfgs_batched.py::_dot), the loss's
// row mean as torch.mean does. So on the card the fused trip gives the
// bits of the unfused trip around the host assembly.
#include <cuda_runtime.h>
#include <math.h>

#include "trip_transform.cuh"

namespace {

constexpr int kGroup = 16;                // threads a lane
constexpr int kLanesPerBlock = 8;
constexpr int kThreads = kGroup * kLanesPerBlock;
constexpr int kParams = 13;               // the fused mode's d

template <typename T>
struct State {                            // ops/lbfgs_batched.py::_BState
  T *x, *f, *g, *s_hist, *y_hist, *rho_hist;
  int *hist_len, *head;
  T* gamma;
  int *n_iters, *n_evals, *n_fail;
  unsigned char *done, *converged, *bootstrap, *starting;
  T *direction, *dg0;
  int* stage;
  T *alpha, *a_lo, *a_hi, *f_lo, *a_prev, *f_prev;
  int* ls_evals;
  T *a_star, *f_star, *g_star, *x_star;
  unsigned char* ok;
};

template <typename T>
State<T> unpack(void* const* p) {
  State<T> s;
  int i = 0;
  s.x = static_cast<T*>(p[i++]); s.f = static_cast<T*>(p[i++]);
  s.g = static_cast<T*>(p[i++]); s.s_hist = static_cast<T*>(p[i++]);
  s.y_hist = static_cast<T*>(p[i++]); s.rho_hist = static_cast<T*>(p[i++]);
  s.hist_len = static_cast<int*>(p[i++]); s.head = static_cast<int*>(p[i++]);
  s.gamma = static_cast<T*>(p[i++]); s.n_iters = static_cast<int*>(p[i++]);
  s.n_evals = static_cast<int*>(p[i++]); s.n_fail = static_cast<int*>(p[i++]);
  s.done = static_cast<unsigned char*>(p[i++]);
  s.converged = static_cast<unsigned char*>(p[i++]);
  s.bootstrap = static_cast<unsigned char*>(p[i++]);
  s.starting = static_cast<unsigned char*>(p[i++]);
  s.direction = static_cast<T*>(p[i++]); s.dg0 = static_cast<T*>(p[i++]);
  s.stage = static_cast<int*>(p[i++]); s.alpha = static_cast<T*>(p[i++]);
  s.a_lo = static_cast<T*>(p[i++]); s.a_hi = static_cast<T*>(p[i++]);
  s.f_lo = static_cast<T*>(p[i++]); s.a_prev = static_cast<T*>(p[i++]);
  s.f_prev = static_cast<T*>(p[i++]); s.ls_evals = static_cast<int*>(p[i++]);
  s.a_star = static_cast<T*>(p[i++]); s.f_star = static_cast<T*>(p[i++]);
  s.g_star = static_cast<T*>(p[i++]); s.x_star = static_cast<T*>(p[i++]);
  s.ok = static_cast<unsigned char*>(p[i++]);
  return s;
}

__device__ __forceinline__ float t_abs(float v) { return fabsf(v); }
__device__ __forceinline__ double t_abs(double v) { return fabs(v); }
__device__ __forceinline__ float t_sqrt(float v) { return sqrtf(v); }
__device__ __forceinline__ double t_sqrt(double v) { return sqrt(v); }
// torch.clamp(v, min=lo) / clamp(v, max=hi) / maximum / minimum: NaN in,
// NaN out.
template <typename T>
__device__ __forceinline__ T clamp_min(T v, T lo) {
  return isnan(v) ? v : (v < lo ? lo : v);
}
template <typename T>
__device__ __forceinline__ T clamp_max(T v, T hi) {
  return isnan(v) ? v : (v > hi ? hi : v);
}
template <typename T>
__device__ __forceinline__ T nan_max(T a, T b) {
  return (isnan(a) || a > b) ? a : b;
}
template <typename T>
__device__ __forceinline__ T nan_min(T a, T b) {
  return (isnan(a) || a < b) ? a : b;
}

// Butterfly over the 16 threads of a lane: a + b == b + a in IEEE, so all
// threads end with the same bits.
template <typename T>
__device__ __forceinline__ T group_sum(T v, unsigned mask) {
#pragma unroll
  for (int o = kGroup / 2; o > 0; o >>= 1) v += __shfl_xor_sync(mask, v, o);
  return v;
}
template <typename T>
__device__ __forceinline__ T group_max(T v, unsigned mask) {
#pragma unroll
  for (int o = kGroup / 2; o > 0; o >>= 1)
    v = nan_max(v, __shfl_xor_sync(mask, v, o));
  return v;
}

// sum_c a[c] b[c] over the lane's d coordinates (0 past d): thread t's
// products in order from 0, then the butterfly (ops/lbfgs_batched.py::
// _dot is the plain version).
template <typename T, int K>
__device__ __forceinline__ T dot(const T (&a)[K], const T (&b)[K],
                                 unsigned mask) {
  T p = T(0);
#pragma unroll
  for (int k = 0; k < K; ++k) p += a[k] * b[k];
  return group_sum(p, mask);
}

template <typename T, int K>
__device__ __forceinline__ void load(T (&v)[K], const T* row, int t, int d) {
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int c = t + k * kGroup;
    v[k] = c < d ? row[c] : T(0);
  }
}

template <typename T, int K>
__device__ __forceinline__ void store(T* row, const T (&v)[K], int t, int d) {
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int c = t + k * kGroup;
    if (c < d) row[c] = v[k];
  }
}

__device__ __forceinline__ int wrap(int i, int m) {   // torch.remainder
  const int r = i % m;
  return r < 0 ? r + m : r;
}

__device__ __forceinline__ void flag_lane(int* status, int lane) {
  atomicCAS(status + 1, 0, lane + 1);
}

// x_try's row, and in fused mode (d = 13) params_try = transform(x_try).
template <typename T, int K, bool Fused>
__device__ __forceinline__ void store_trial(T* x_try, T* params_try,
                                            const Transform& tf, size_t row,
                                            const T (&x)[K], int t, int d) {
  store(x_try + row, x, t, d);
  if constexpr (Fused) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int c = t + k * kGroup;
      if (c >= d) continue;
      params_try[row + c] = transform_coord(tf, c, x[k]);
    }
  }
}

// __launch_bounds__'s one block an SM lets ptxas use the registers it
// needs: without it, it kept K4<double> (fused, and unfused at K = 2) at
// 40-48 registers and spilled 4 bytes.
template <typename T, int K, bool Fused>
__global__ void __launch_bounds__(kThreads, 1)
lbfgs_open_kernel(State<T> st, T* __restrict__ x_try,
                  T* __restrict__ params_try, Transform tf, int* status,
                  int L, int d, int m) {
  extern __shared__ unsigned char smem_raw[];
  const int t = threadIdx.x % kGroup;
  const int grp = threadIdx.x / kGroup;
  const int lane = blockIdx.x * kLanesPerBlock + grp;
  const unsigned mask = 0xFFFFu << (kGroup * (grp & 1));
  if (blockIdx.x == 0 && threadIdx.x == 0) status[0] = 0;
  if (lane >= L) return;
  const size_t row = static_cast<size_t>(lane) * d;
  T x[K];
  load(x, st.x + row, t, d);
  if (st.done[lane]) {                    // done lanes hold: x_try = x
    store_trial<T, K, Fused>(x_try, params_try, tf, row, x, t, d);
    return;
  }
  const int head = st.head[lane];
  const int hl = st.hist_len[lane];
  if (head < 0 || head >= m || hl < 0 || hl > m) {
    if (t == 0) flag_lane(status, lane);
    store_trial<T, K, Fused>(x_try, params_try, tf, row, x, t, d);
    return;
  }
  const bool boot = st.bootstrap[lane] != 0;
  T dir[K];
  T alpha;
  if (!st.starting[lane]) {               // mid line search
    alpha = st.alpha[lane];
    load(dir, st.direction + row, t, d);
  } else {                                // opening an iteration
    T g[K], q[K];
    load(g, st.g + row, t, d);
#pragma unroll
    for (int k = 0; k < K; ++k) q[k] = g[k];
    T* alphas = reinterpret_cast<T*>(smem_raw) + grp * m;
    const T* s_lane = st.s_hist + static_cast<size_t>(lane) * m * d;
    const T* y_lane = st.y_hist + static_cast<size_t>(lane) * m * d;
    const T* rho_lane = st.rho_hist + static_cast<size_t>(lane) * m;
    for (int j = 0; j < hl; ++j) {        // newest pair first
      const int idx = wrap(head - 1 - j, m);
      T s[K], y[K];
      load(s, s_lane + static_cast<size_t>(idx) * d, t, d);
      load(y, y_lane + static_cast<size_t>(idx) * d, t, d);
      const T a = rho_lane[idx] * dot(s, q, mask);
#pragma unroll
      for (int k = 0; k < K; ++k) q[k] = q[k] - a * y[k];
      if (t == 0) alphas[j] = a;
    }
    __syncwarp(mask);
    const T gamma = st.gamma[lane];
    T r[K];
#pragma unroll
    for (int k = 0; k < K; ++k) r[k] = gamma * q[k];
    for (int j = 0; j < hl; ++j) {        // oldest pair first
      const int idx = wrap(head - hl + j, m);
      T s[K], y[K];
      load(s, s_lane + static_cast<size_t>(idx) * d, t, d);
      load(y, y_lane + static_cast<size_t>(idx) * d, t, d);
      const T beta = rho_lane[idx] * dot(y, r, mask);
      const T a = alphas[hl - 1 - j];     // the first loop's alpha of idx
#pragma unroll
      for (int k = 0; k < K; ++k) r[k] = r[k] + (a - beta) * s[k];
    }
#pragma unroll
    for (int k = 0; k < K; ++k) dir[k] = -r[k];
    const T dgn = dot(dir, g, mask);
    if (dgn >= T(0) || !isfinite(dgn)) {
#pragma unroll
      for (int k = 0; k < K; ++k) dir[k] = -g[k];
    }
    T gabs[K];
#pragma unroll
    for (int k = 0; k < K; ++k) gabs[k] = t_abs(g[k]);
    T gmax = gabs[0];
#pragma unroll
    for (int k = 1; k < K; ++k) gmax = nan_max(gmax, gabs[k]);
    gmax = group_max(gmax, mask);
    alpha = hl == 0 ? clamp_max(T(1.0) / clamp_min(gmax, T(1e-8)), T(1.0))
                    : T(1.0);
    const T dg0 = dot(dir, g, mask);
    store(st.direction + row, dir, t, d);
    store(st.g_star + row, g, t, d);
    store(st.x_star + row, x, t, d);
    if (t == 0) {
      const T f = st.f[lane];
      st.dg0[lane] = dg0;
      st.alpha[lane] = alpha;
      st.stage[lane] = 0;
      st.a_lo[lane] = T(0);
      st.a_hi[lane] = T(0);
      st.f_lo[lane] = f;
      st.a_prev[lane] = T(0);
      st.f_prev[lane] = f;
      st.ls_evals[lane] = 0;
      st.a_star[lane] = T(0);
      st.f_star[lane] = f;
      st.ok[lane] = 0;
    }
  }
  if (!boot) {
#pragma unroll
    for (int k = 0; k < K; ++k) x[k] = x[k] + alpha * dir[k];
  }
  store_trial<T, K, Fused>(x_try, params_try, tf, row, x, t, d);
}

struct Config {
  double c1, c2, ftol, gtol;
  int max_linesearch, max_restarts, maxiter, maxeval;
};

// The evaluation K5 reads: f_try [L] and g_try [L, d] (unfused), or the
// fused mode's K2 outputs and the lane's market prices, from which it
// assembles them (assemble below).
template <typename T>
struct Trial {
  const T* x_try;                         // [L, d]
  const T* f_try;                         // [L]        (unfused)
  const T* g_try;                         // [L, d]     (unfused)
  const T* params;                        // [L, 13]    (fused: params_try)
  const T* price;                         // [L, n]     (fused: K2's prices)
  const T* g_price;                       // [L, 13]    (fused: K2's sums)
  const T* mkt;                           // [L, n]     (fused)
  double weight, bad_loss;                // Feller weight, sentinel
  double mean_factor;                     // torch.mean's factor, 1/n rounded
  int n;                                  // rows a lane, n < 128
  int block_width;                        // torch.mean's threads a row
  int feller;                             // (sigma, kappa, theta) x 2, 4 bits
  Transform tf;
};

// ATen thread u's share of a row mean (Reduce.cuh's thread_reduce_impl at
// stride bw) over the squared errors sq: four accumulators take rows u,
// u + bw, u + 2 bw, u + 3 bw in turn, four at a time, then the rest;
// combined in order.
template <typename T>
__device__ __forceinline__ T aten_thread(const T* sq, int n, int bw, int u) {
  T a0 = T(0), a1 = T(0), a2 = T(0), a3 = T(0);
  int idx = u;
  while (idx + 3 * bw < n) {
    a0 = a0 + sq[idx];
    a1 = a1 + sq[idx + bw];
    a2 = a2 + sq[idx + 2 * bw];
    a3 = a3 + sq[idx + 3 * bw];
    idx += 4 * bw;
  }
  if (idx < n) a0 = a0 + sq[idx];         // at most three left
  if (idx + bw < n) a1 = a1 + sq[idx + bw];
  if (idx + 2 * bw < n) a2 = a2 + sq[idx + 2 * bw];
  return ((a0 + a1) + a2) + a3;
}

// The mean of a lane's n squared relative errors as torch.mean(v, -1) sums
// them on the card (ATen's Reduce.cuh for a contiguous [L, n] input with
// n < 128, where it does not vectorise its loads): with block width bw
// (the host's ops/loss_kernel.py::torch_mean_order), ATen thread u sums
// its rows (aten_thread); threads 32 and above fold onto the first 32
// (bw = 64); a tree with offsets 16, 8, ..., 1 sums the first min(bw, 32);
// the sum times mean_factor. The group first writes the rows' squared
// errors to its shared-memory row `sq` (thread t: rows t, t + 16, ...);
// then thread t takes ATen threads t and t + 16 (and t + 32, t + 48),
// adding from 0 (exact), and the tree runs as the butterfly. `bad`: some
// row is not a finite positive price.
template <typename T>
__device__ __forceinline__ T mean(const Trial<T>& tr, const T* price,
                                  const T* mkt, T* sq, int t, unsigned mask,
                                  bool& bad) {
  const int n = tr.n, bw = tr.block_width;
  bool mine = false;
  for (int j = t; j < n; j += kGroup) {
    const T p = price[j], mk = mkt[j];
    const bool valid = isfinite(p) && p > T(0);
    mine = mine || !valid;
    const T rel = valid ? (p - mk) / mk : T(0);
    sq[j] = rel * rel;
  }
  bad = __any_sync(mask, mine);
  __syncwarp(mask);                       // sq written before it is read
  const int width = bw < 32 ? bw : 32;
  const int halves = width == 32 ? 2 : (t < width ? 1 : 0);
  const int folds = bw > 32 ? 2 : 1;
  T v = T(0);
  for (int h = 0; h < halves; ++h) {      // the tree's offset 16
    T z = T(0);
    for (int k = 0; k < folds; ++k)       // the shared-memory fold
      z = z + aten_thread(sq, n, bw, t + kGroup * h + 32 * k);
    v = v + z;
  }
  for (int o = (width == 32 ? kGroup : width) / 2; o > 0; o >>= 1)
    v += __shfl_xor_sync(mask, v, o);
  return __shfl_sync(mask, v, 0, kGroup) * T(tr.mean_factor);
}

// The search loss and its gradient in the unconstrained coordinates, per
// lane, from K2's outputs: ops/loss_kernel.py::search_assembly_plain.
// Every thread of the group holds the same f; thread t assembles its
// coordinates of g.
template <typename T, int K>
__device__ __forceinline__ void assemble(const Trial<T>& tr, int lane, int t,
                                         int d, unsigned mask, T* sq, T& f,
                                         T (&g)[K]) {
  bool any_bad;
  const T mse = mean(tr, tr.price + static_cast<size_t>(lane) * tr.n,
                     tr.mkt + static_cast<size_t>(lane) * tr.n, sq, t, mask,
                     any_bad);
  const T* q = tr.params + static_cast<size_t>(lane) * kParams;
  const T weight = T(tr.weight);
  const int s1 = tr.feller & 15, k1 = (tr.feller >> 4) & 15,
            t1 = (tr.feller >> 8) & 15, s2 = (tr.feller >> 12) & 15,
            k2 = (tr.feller >> 16) & 15, t2 = (tr.feller >> 20) & 15;
  // sigma^2 - 2 kappa theta of the two factors; max(0, v) with NaN kept
  const T v1 = q[s1] * q[s1] - T(2.0) * q[k1] * q[t1];
  const T v2 = q[s2] * q[s2] - T(2.0) * q[k2] * q[t2];
  const T p1 = (v1 > T(0) || isnan(v1)) ? v1 : T(0);
  const T p2 = (v2 > T(0) || isnan(v2)) ? v2 : T(0);
  const T on1 = v1 > T(0) ? weight : T(0);             // 0 at the kink
  const T on2 = v2 > T(0) ? weight : T(0);
  T loss = mse + weight * (p1 + p2);
  if (any_bad || !isfinite(loss)) loss = T(tr.bad_loss);
  f = loss;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int c = t + k * kGroup;
    g[k] = T(0);
    if (c >= d) continue;
    T pen_g = T(0);
    if (c == s1) pen_g = on1 * T(2.0) * q[s1];
    else if (c == k1) pen_g = -on1 * T(2.0) * q[t1];
    else if (c == t1) pen_g = -on1 * T(2.0) * q[k1];
    else if (c == s2) pen_g = on2 * T(2.0) * q[s2];
    else if (c == k2) pen_g = -on2 * T(2.0) * q[t2];
    else if (c == t2) pen_g = -on2 * T(2.0) * q[k2];
    const T dtr = dtransform_coord(tr.tf, c, q[c]);
    T gx = (tr.g_price[static_cast<size_t>(lane) * kParams + c] + pen_g) * dtr;
    if (any_bad || !isfinite(gx)) gx = T(0);
    g[k] = gx;
  }
}

template <typename T, int K, bool Fused>
__device__ __forceinline__ bool update_lane(
    const State<T>& st, const Trial<T>& tr, const Config& cfg, int lane,
    int t, int d, int m, int head, int hl, unsigned mask, T* sq) {
  const size_t row = static_cast<size_t>(lane) * d;
  T x[K], g[K], dir[K], xt[K], gt[K], xs[K], gs[K];
  T ft;
  if constexpr (Fused) {
    assemble(tr, lane, t, d, mask, sq, ft, gt);
  } else {
    ft = tr.f_try[lane];
    load(gt, tr.g_try + row, t, d);
  }
  load(x, st.x + row, t, d);
  load(g, st.g + row, t, d);
  load(dir, st.direction + row, t, d);
  load(xt, tr.x_try + row, t, d);
  load(xs, st.x_star + row, t, d);
  load(gs, st.g_star + row, t, d);
  const T f0 = st.f[lane], alpha = st.alpha[lane], dg0 = st.dg0[lane];
  const T a_lo = st.a_lo[lane], a_hi = st.a_hi[lane], f_lo = st.f_lo[lane];
  const T a_prev = st.a_prev[lane], f_prev = st.f_prev[lane];
  T a_star = st.a_star[lane], f_star = st.f_star[lane];
  const T gamma0 = st.gamma[lane];
  const int stage = st.stage[lane];
  const int n_iters0 = st.n_iters[lane], n_fail0 = st.n_fail[lane];
  const int n_evals = st.n_evals[lane] + 1;
  const int ls_evals = st.ls_evals[lane] + 1;
  bool ok = st.ok[lane] != 0;
  const bool boot = st.bootstrap[lane] != 0;
  const bool converged0 = st.converged[lane] != 0;
  __syncwarp(mask);       // every read of the lane precedes thread 0's writes
  const T inf = T(INFINITY);
  if (!isfinite(ft)) ft = inf;
#pragma unroll
  for (int k = 0; k < K; ++k)
    if (!isfinite(gt[k])) gt[k] = T(0);

  const T c1 = T(cfg.c1), c2 = T(cfg.c2);
  const T dg_try = dot(gt, dir, mask);
  const bool armijo_fail = ft > f0 + c1 * alpha * dg0;
  const bool wolfe_ok = !armijo_fail && (t_abs(dg_try) <= -c2 * dg0);

  const bool br_hi_from_fail = armijo_fail || (ft >= f_prev && ls_evals > 1);
  const bool br_enter_zoom =
      br_hi_from_fail || (!br_hi_from_fail && !wolfe_ok && dg_try >= T(0));
  const bool br_accept = wolfe_ok && !br_hi_from_fail;
  const int br_stage = br_accept ? 2 : (br_enter_zoom ? 1 : 0);
  const T br_a_lo = br_hi_from_fail ? a_prev : alpha;
  const T br_f_lo = br_hi_from_fail ? f_prev : ft;
  const T br_a_hi = br_hi_from_fail ? alpha : a_prev;
  const T br_alpha = br_stage == 1 ? T(0.5) * (br_a_lo + br_a_hi)
                                   : (br_stage == 0 ? alpha * T(2.0) : alpha);

  const bool zm_accept = wolfe_ok;
  const bool zm_shrink_hi = armijo_fail || ft >= f_lo;
  const bool zm_flip = !zm_shrink_hi && (dg_try * (a_hi - a_lo) >= T(0));
  const T zm_a_hi = zm_shrink_hi ? alpha : (zm_flip ? a_lo : a_hi);
  const T zm_a_lo = zm_shrink_hi ? a_lo : alpha;
  const T zm_f_lo = zm_shrink_hi ? f_lo : ft;
  const bool interval_dead =
      t_abs(zm_a_hi - zm_a_lo) * clamp_min(t_abs(dg0), T(1.0)) < T(1e-14);
  const int zm_stage = (zm_accept || interval_dead) ? 2 : 1;
  const T span = zm_a_lo - alpha;
  const T denom = t_abs(span) > T(1e-30) ? span : T(1.0);
  const T curv = (zm_f_lo - ft - dg_try * span) / (denom * denom);
  const T t_interp = alpha - dg_try / (T(2.0) * clamp_min(curv, T(1e-30)));
  const T lo_b = nan_min(zm_a_lo, zm_a_hi);
  const T hi_b = nan_max(zm_a_lo, zm_a_hi);
  const T width = hi_b - lo_b;
  const bool interp_ok = curv > T(0) && isfinite(t_interp) &&
                         t_interp > lo_b + T(0.1) * width &&
                         t_interp < hi_b - T(0.1) * width;
  const T zm_alpha = interp_ok ? t_interp : T(0.5) * (zm_a_lo + zm_a_hi);

  const bool in_zoom = stage == 1;
  const bool accept = in_zoom ? zm_accept : br_accept;
  const int new_stage = in_zoom ? zm_stage : br_stage;
  const T new_a_lo = in_zoom ? zm_a_lo : br_a_lo;
  const T new_a_hi = in_zoom ? zm_a_hi : br_a_hi;
  const T new_f_lo = in_zoom ? zm_f_lo : br_f_lo;
  const T next_alpha = in_zoom ? zm_alpha : br_alpha;

  const bool take_star = accept || (ft < f_star && new_stage != 2);
  if (take_star) {
    a_star = alpha;
    f_star = ft;
#pragma unroll
    for (int k = 0; k < K; ++k) { gs[k] = gt[k]; xs[k] = xt[k]; }
  }
  ok = ok || take_star;
  const bool end_iter = new_stage == 2 || ls_evals >= cfg.max_linesearch;

  T s[K], y[K];
#pragma unroll
  for (int k = 0; k < K; ++k) { s[k] = xs[k] - x[k]; y[k] = gs[k] - g[k]; }
  const T sy = dot(s, y, mask);
  const T yy = dot(y, y, mask);
  const T ss = dot(s, s, mask);
  const bool good_pair = end_iter && ok &&
                         sy > T(1e-10) * t_sqrt(ss * yy + T(1e-300));
  int head_n = head, hl_n = hl;
  T gamma_n = gamma0;
  if (good_pair) {
    head_n = wrap(head + 1, m);
    hl_n = hl + 1 < m ? hl + 1 : m;
    gamma_n = sy / clamp_min(yy, T(1e-300));
  }
  if (good_pair && !boot) {
    const size_t h = (static_cast<size_t>(lane) * m + head) * d;
    store(st.s_hist + h, s, t, d);
    store(st.y_hist + h, y, t, d);
    if (t == 0)
      st.rho_hist[static_cast<size_t>(lane) * m + head] =
          T(1.0) / clamp_min(sy, T(1e-300));
  }

  int n_iters = n_iters0 + (end_iter ? 1 : 0);
  T gsabs = T(0);
#pragma unroll
  for (int k = 0; k < K; ++k)
    if (t + k * kGroup < d) gsabs = nan_max(gsabs, t_abs(gs[k]));
  const bool gconv = group_max(gsabs, mask) <= T(cfg.gtol);
  const bool fconv =
      (f0 - f_star) <=
      T(cfg.ftol) * clamp_min(nan_max(t_abs(f0), t_abs(f_star)), T(1.0));
  const bool ls_failed = end_iter && !ok;
  const bool conv = end_iter && (gconv || (fconv && ok));
  int n_fail = end_iter ? (ok ? 0 : n_fail0 + 1) : n_fail0;
  const bool give_up = end_iter && n_fail > cfg.max_restarts;
  if (ls_failed && !give_up) {
    hl_n = 0;
    head_n = 0;
    gamma_n = T(1.0);
  }
  const bool eval_cap = cfg.maxeval > 0 && n_evals >= cfg.maxeval;
  bool done = conv || give_up || n_iters >= cfg.maxiter || eval_cap;

  const bool commit = end_iter && ok;
  T f_c = commit ? f_star : f0;
  if (boot) {
    f_c = ft;
    n_iters = 0;
    n_fail = 0;
    done = false;
  }
#pragma unroll
  for (int k = 0; k < K; ++k) {
    if (boot) {
      x[k] = xt[k];
      g[k] = gt[k];
    } else if (commit) {
      x[k] = xs[k];
      g[k] = gs[k];
    }
  }
  store(st.x + row, x, t, d);
  store(st.g + row, g, t, d);
  store(st.g_star + row, gs, t, d);
  store(st.x_star + row, xs, t, d);
  if (t == 0) {
    st.f[lane] = f_c;
    if (!boot) {
      st.hist_len[lane] = hl_n;
      st.head[lane] = head_n;
      st.gamma[lane] = gamma_n;
    }
    st.n_iters[lane] = n_iters;
    st.n_evals[lane] = n_evals;
    st.n_fail[lane] = n_fail;
    st.done[lane] = done;
    st.converged[lane] = boot ? false : (converged0 || conv);
    st.bootstrap[lane] = 0;
    st.starting[lane] = end_iter || boot;
    st.stage[lane] = new_stage;
    st.alpha[lane] = next_alpha;
    st.a_lo[lane] = new_a_lo;
    st.a_hi[lane] = new_a_hi;
    st.f_lo[lane] = new_f_lo;
    st.a_prev[lane] = alpha;
    st.f_prev[lane] = ft;
    st.ls_evals[lane] = ls_evals;
    st.a_star[lane] = a_star;
    st.f_star[lane] = f_star;
    st.ok[lane] = ok;
  }
  return !done;
}

// As for K4: without one block an SM, ptxas kept fused K5<float> at 48
// registers and spilled 12 bytes.
template <typename T, int K, bool Fused>
__global__ void __launch_bounds__(kThreads, 1)
lbfgs_update_kernel(State<T> st, Trial<T> tr, int* status, Config cfg, int L,
                    int d, int m) {
  extern __shared__ unsigned char smem_raw[];
  const int t = threadIdx.x % kGroup;
  const int grp = threadIdx.x / kGroup;
  const int lane = blockIdx.x * kLanesPerBlock + grp;
  const unsigned mask = 0xFFFFu << (kGroup * (grp & 1));
  T* sq = Fused ? reinterpret_cast<T*>(smem_raw) + grp * tr.n : nullptr;
  bool live = false;
  if (lane < L && !st.done[lane]) {
    const int head = st.head[lane];
    const int hl = st.hist_len[lane];
    if (head < 0 || head >= m || hl < 0 || hl > m) {
      if (t == 0) flag_lane(status, lane);
      live = true;
    } else {
      live = update_lane<T, K, Fused>(st, tr, cfg, lane, t, d, m, head, hl,
                                      mask, sq);
    }
  }
  const int n = __syncthreads_count(live && t == 0);
  if (threadIdx.x == 0 && n > 0) atomicAdd(status, n);
}

template <typename T, int K, bool Fused>
int launch_open(void* const* ptrs, void* x_try, void* params_try,
                Transform tf, void* status, int L, int d, int m,
                cudaStream_t stream) {
  const int blocks = (L + kLanesPerBlock - 1) / kLanesPerBlock;
  const size_t smem = static_cast<size_t>(kLanesPerBlock) * m * sizeof(T);
  lbfgs_open_kernel<T, K, Fused><<<blocks, kThreads, smem, stream>>>(
      unpack<T>(ptrs), static_cast<T*>(x_try), static_cast<T*>(params_try),
      tf, static_cast<int*>(status), L, d, m);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int K, bool Fused>
int launch_update(void* const* ptrs, const Trial<T>& tr, void* status,
                  const Config& cfg, int L, int d, int m,
                  cudaStream_t stream) {
  const int blocks = (L + kLanesPerBlock - 1) / kLanesPerBlock;
  // fused: a shared-memory row of squared errors a lane (n < 128)
  const size_t smem =
      Fused ? static_cast<size_t>(kLanesPerBlock) * tr.n * sizeof(T) : 0;
  lbfgs_update_kernel<T, K, Fused><<<blocks, kThreads, smem, stream>>>(
      unpack<T>(ptrs), tr, static_cast<int*>(status), cfg, L, d, m);
  return static_cast<int>(cudaGetLastError());
}

// Coordinates a thread: d <= 16, 32, 64. (At 8 a thread, d <= 128, ptxas
// spilled K4<double>.)
inline int per_thread(int d) {
  return d <= 16 ? 1 : d <= 32 ? 2 : d <= 64 ? 4 : 0;
}

inline bool bad_shape(int L, int d, int m) {
  return L <= 0 || m <= 0 || m > 512 || d <= 0;
}

inline bool bad_masks(unsigned exp_mask, unsigned tanh_mask) {
  return ((exp_mask | tanh_mask) >> kParams) != 0u ||
         (exp_mask & tanh_mask) != 0u;
}

template <typename T>
int open_entry(void* const* ptrs, void* x_try, void* status, int L, int d,
               int m, void* stream) {
  if (bad_shape(L, d, m)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Transform none{0u, 0u};
  switch (per_thread(d)) {
    case 1: return launch_open<T, 1, false>(ptrs, x_try, nullptr, none,
                                            status, L, d, m, s);
    case 2: return launch_open<T, 2, false>(ptrs, x_try, nullptr, none,
                                            status, L, d, m, s);
    case 4: return launch_open<T, 4, false>(ptrs, x_try, nullptr, none,
                                            status, L, d, m, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int open_fused_entry(void* const* ptrs, void* x_try, void* params_try,
                     unsigned exp_mask, unsigned tanh_mask, void* status,
                     int L, int d, int m, void* stream) {
  if (bad_shape(L, d, m) || d != kParams || bad_masks(exp_mask, tanh_mask))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_open<T, 1, true>(ptrs, x_try, params_try,
                                 Transform{exp_mask, tanh_mask}, status, L,
                                 d, m, static_cast<cudaStream_t>(stream));
}

template <typename T>
int update_entry(void* const* ptrs, const void* x_try, const void* f_try,
                 const void* g_try, void* status, double c1, double c2,
                 double ftol, double gtol, int max_linesearch,
                 int max_restarts, int maxiter, int maxeval, int L, int d,
                 int m, void* stream) {
  if (bad_shape(L, d, m)) return static_cast<int>(cudaErrorInvalidValue);
  const Config cfg{c1, c2, ftol, gtol, max_linesearch, max_restarts, maxiter,
                   maxeval};
  Trial<T> tr{};
  tr.x_try = static_cast<const T*>(x_try);
  tr.f_try = static_cast<const T*>(f_try);
  tr.g_try = static_cast<const T*>(g_try);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (per_thread(d)) {
    case 1: return launch_update<T, 1, false>(ptrs, tr, status, cfg, L, d, m,
                                              s);
    case 2: return launch_update<T, 2, false>(ptrs, tr, status, cfg, L, d, m,
                                              s);
    case 4: return launch_update<T, 4, false>(ptrs, tr, status, cfg, L, d, m,
                                              s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int update_fused_entry(void* const* ptrs, const void* x_try,
                       const void* params_try, const void* price,
                       const void* g_price, const void* mkt, void* status,
                       double c1, double c2, double ftol, double gtol,
                       double weight, double bad_loss, double mean_factor,
                       int max_linesearch, int max_restarts, int maxiter,
                       int maxeval, int n_opt, int block_width,
                       unsigned exp_mask, unsigned tanh_mask, int feller,
                       int L, int d, int m, void* stream) {
  const bool bad_width = block_width < 1 || block_width > 64 ||
                         (block_width & (block_width - 1)) != 0 ||
                         block_width > n_opt;
  if (bad_shape(L, d, m) || d != kParams || n_opt <= 0 || n_opt >= 128 ||
      bad_width || bad_masks(exp_mask, tanh_mask))
    return static_cast<int>(cudaErrorInvalidValue);
  const Config cfg{c1, c2, ftol, gtol, max_linesearch, max_restarts, maxiter,
                   maxeval};
  Trial<T> tr{};
  tr.x_try = static_cast<const T*>(x_try);
  tr.params = static_cast<const T*>(params_try);
  tr.price = static_cast<const T*>(price);
  tr.g_price = static_cast<const T*>(g_price);
  tr.mkt = static_cast<const T*>(mkt);
  tr.weight = weight;
  tr.bad_loss = bad_loss;
  tr.mean_factor = mean_factor;
  tr.n = n_opt;
  tr.block_width = block_width;
  for (int i = 0; i < 6; ++i)
    if (((feller >> (4 * i)) & 15) >= kParams)
      return static_cast<int>(cudaErrorInvalidValue);
  tr.feller = feller;
  tr.tf = Transform{exp_mask, tanh_mask};
  return launch_update<T, 1, true>(ptrs, tr, status, cfg, L, d, m,
                                   static_cast<cudaStream_t>(stream));
}

}  // namespace

// ptrs: the 31 state tensors' device pointers in _BState's field order
// (row-major, [L], [L, d], [L, m] or [L, m, d]; int32 counters, 1-byte
// bools); x_try, g_try [L, d]; f_try [L]; status int32 [2] (live count,
// error word). Fused entries (d = 13): params_try, g_price [L, 13]; price,
// mkt [L, n_opt], n_opt < 128; weight and bad_loss from CalibrationConfig;
// mean_factor and block_width of torch.mean over [L, n_opt]
// (ops/loss_kernel.py::torch_mean_order); exp_mask and tanh_mask, bit c
// for coordinate c; feller, the two factors' (sigma, kappa, theta)
// indices, 4 bits each from the lowest. Return the launch's cudaError_t.
extern "C" int lbfgs_open_f32(void* const* ptrs, void* x_try, void* status,
                              int L, int d, int m, void* stream) {
  return open_entry<float>(ptrs, x_try, status, L, d, m, stream);
}

extern "C" int lbfgs_open_f64(void* const* ptrs, void* x_try, void* status,
                              int L, int d, int m, void* stream) {
  return open_entry<double>(ptrs, x_try, status, L, d, m, stream);
}

extern "C" int lbfgs_open_fused_f32(void* const* ptrs, void* x_try,
                                    void* params_try, unsigned exp_mask,
                                    unsigned tanh_mask, void* status, int L,
                                    int d, int m, void* stream) {
  return open_fused_entry<float>(ptrs, x_try, params_try, exp_mask,
                                 tanh_mask, status, L, d, m, stream);
}

extern "C" int lbfgs_open_fused_f64(void* const* ptrs, void* x_try,
                                    void* params_try, unsigned exp_mask,
                                    unsigned tanh_mask, void* status, int L,
                                    int d, int m, void* stream) {
  return open_fused_entry<double>(ptrs, x_try, params_try, exp_mask,
                                  tanh_mask, status, L, d, m, stream);
}

extern "C" int lbfgs_update_f32(void* const* ptrs, const void* x_try,
                                const void* f_try, const void* g_try,
                                void* status, double c1, double c2,
                                double ftol, double gtol, int max_linesearch,
                                int max_restarts, int maxiter, int maxeval,
                                int L, int d, int m, void* stream) {
  return update_entry<float>(ptrs, x_try, f_try, g_try, status, c1, c2, ftol,
                             gtol, max_linesearch, max_restarts, maxiter,
                             maxeval, L, d, m, stream);
}

extern "C" int lbfgs_update_f64(void* const* ptrs, const void* x_try,
                                const void* f_try, const void* g_try,
                                void* status, double c1, double c2,
                                double ftol, double gtol, int max_linesearch,
                                int max_restarts, int maxiter, int maxeval,
                                int L, int d, int m, void* stream) {
  return update_entry<double>(ptrs, x_try, f_try, g_try, status, c1, c2, ftol,
                              gtol, max_linesearch, max_restarts, maxiter,
                              maxeval, L, d, m, stream);
}

extern "C" int lbfgs_update_fused_f32(
    void* const* ptrs, const void* x_try, const void* params_try,
    const void* price, const void* g_price, const void* mkt, void* status,
    double c1, double c2, double ftol, double gtol, double weight,
    double bad_loss, double mean_factor, int max_linesearch,
    int max_restarts, int maxiter, int maxeval, int n_opt, int block_width,
    unsigned exp_mask, unsigned tanh_mask, int feller, int L, int d, int m,
    void* stream) {
  return update_fused_entry<float>(
      ptrs, x_try, params_try, price, g_price, mkt, status, c1, c2, ftol,
      gtol, weight, bad_loss, mean_factor, max_linesearch, max_restarts,
      maxiter, maxeval, n_opt, block_width, exp_mask, tanh_mask, feller, L,
      d, m, stream);
}

extern "C" int lbfgs_update_fused_f64(
    void* const* ptrs, const void* x_try, const void* params_try,
    const void* price, const void* g_price, const void* mkt, void* status,
    double c1, double c2, double ftol, double gtol, double weight,
    double bad_loss, double mean_factor, int max_linesearch,
    int max_restarts, int maxiter, int maxeval, int n_opt, int block_width,
    unsigned exp_mask, unsigned tanh_mask, int feller, int L, int d, int m,
    void* stream) {
  return update_fused_entry<double>(
      ptrs, x_try, params_try, price, g_price, mkt, status, c1, c2, ftol,
      gtol, weight, bad_loss, mean_factor, max_linesearch, max_restarts,
      maxiter, maxeval, n_opt, block_width, exp_mask, tanh_mask, feller, L,
      d, m, stream);
}
