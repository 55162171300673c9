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
// What bounds them on the H100: bytes. Per lane they do a few hundred
// operations on a few kilobytes (K4 reads hist_len pairs of 2d + 1 values
// of an opening lane's history), far below the card's operation rate; the
// least time is the state they read and write over the memory rate
// (ops/opcount.py::lbfgs_open_work, lbfgs_update_work). At the calibration
// shapes that is under a microsecond, so a launch costs its latency, and
// what the design is for is to replace ~600 host-issued launches a trip
// with two.
//
// Design: a group of 16 threads (half a warp) serves one lane, thread t
// holding coordinates t, t + 16, ... (K = 1, 2 or 4 of them, a template
// parameter: d <= 16 K <= 64), so a history row is read coalesced; dot
// products and max-abs are xor-butterfly shuffles within the group, which
// give every thread the same bits; the per-lane scalars (stage, step,
// bracket, counters) are computed redundantly by the group and written by
// its thread 0. The two-loop's alphas sit in shared memory. The circular indices are computed
// in registers: a lane that is not done and whose head is outside [0, m) or
// hist_len outside [0, m] sets the error word to 1 + its index and is left
// as it is; nothing is clamped.
//
// Matching the plain version: the file is built with -fmad=false (eager
// PyTorch rounds a * b + c twice); torch.clamp / maximum / minimum / amax
// propagate NaN where fmax / fmin do not, so those are written out; each
// Python constant becomes T(constant) as PyTorch casts it to the tensor's
// dtype (1e-300 is 0 in float). Sums run in another order than PyTorch's
// reductions, so continuous fields agree to rounding.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kGroup = 16;                // threads a lane
constexpr int kLanesPerBlock = 8;
constexpr int kThreads = kGroup * kLanesPerBlock;

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

// sum_c a[c] b[c] over the lane's d coordinates (0 past d).
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

template <typename T, int K>
__global__ void __launch_bounds__(kThreads)
lbfgs_open_kernel(State<T> st, T* __restrict__ x_try, int* status, int L,
                  int d, int m) {
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
    store(x_try + row, x, t, d);
    return;
  }
  const int head = st.head[lane];
  const int hl = st.hist_len[lane];
  if (head < 0 || head >= m || hl < 0 || hl > m) {
    if (t == 0) flag_lane(status, lane);
    store(x_try + row, x, t, d);
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
  store(x_try + row, x, t, d);
}

struct Config {
  double c1, c2, ftol, gtol;
  int max_linesearch, max_restarts, maxiter, maxeval;
};

template <typename T, int K>
__device__ __forceinline__ bool update_lane(
    const State<T>& st, const T* __restrict__ x_try_all,
    const T* __restrict__ f_try_all, const T* __restrict__ g_try_all,
    const Config& cfg, int lane, int t, int d, int m, int head, int hl,
    unsigned mask) {
  const size_t row = static_cast<size_t>(lane) * d;
  T x[K], g[K], dir[K], xt[K], gt[K], xs[K], gs[K];
  load(x, st.x + row, t, d);
  load(g, st.g + row, t, d);
  load(dir, st.direction + row, t, d);
  load(xt, x_try_all + row, t, d);
  load(gt, g_try_all + row, t, d);
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
  T ft = f_try_all[lane];
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

template <typename T, int K>
__global__ void __launch_bounds__(kThreads)
lbfgs_update_kernel(State<T> st, const T* __restrict__ x_try,
                    const T* __restrict__ f_try, const T* __restrict__ g_try,
                    int* status, Config cfg, int L, int d, int m) {
  const int t = threadIdx.x % kGroup;
  const int grp = threadIdx.x / kGroup;
  const int lane = blockIdx.x * kLanesPerBlock + grp;
  const unsigned mask = 0xFFFFu << (kGroup * (grp & 1));
  bool live = false;
  if (lane < L && !st.done[lane]) {
    const int head = st.head[lane];
    const int hl = st.hist_len[lane];
    if (head < 0 || head >= m || hl < 0 || hl > m) {
      if (t == 0) flag_lane(status, lane);
      live = true;
    } else {
      live = update_lane<T, K>(st, x_try, f_try, g_try, cfg, lane, t, d, m,
                               head, hl, mask);
    }
  }
  const int n = __syncthreads_count(live && t == 0);
  if (threadIdx.x == 0 && n > 0) atomicAdd(status, n);
}

template <typename T, int K>
int launch_open(void* const* ptrs, void* x_try, void* status, int L, int d,
                int m, cudaStream_t stream) {
  const int blocks = (L + kLanesPerBlock - 1) / kLanesPerBlock;
  const size_t smem = static_cast<size_t>(kLanesPerBlock) * m * sizeof(T);
  lbfgs_open_kernel<T, K><<<blocks, kThreads, smem, stream>>>(
      unpack<T>(ptrs), static_cast<T*>(x_try), static_cast<int*>(status), L,
      d, m);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int K>
int launch_update(void* const* ptrs, const void* x_try, const void* f_try,
                  const void* g_try, void* status, const Config& cfg, int L,
                  int d, int m, cudaStream_t stream) {
  const int blocks = (L + kLanesPerBlock - 1) / kLanesPerBlock;
  lbfgs_update_kernel<T, K><<<blocks, kThreads, 0, stream>>>(
      unpack<T>(ptrs), static_cast<const T*>(x_try),
      static_cast<const T*>(f_try), static_cast<const T*>(g_try),
      static_cast<int*>(status), cfg, L, d, m);
  return static_cast<int>(cudaGetLastError());
}

// Coordinates a thread: d <= 16, 32, 64. (At 8 a thread, d <= 128, ptxas
// spilled K4<double>.)
inline int per_thread(int d) {
  return d <= 16 ? 1 : d <= 32 ? 2 : d <= 64 ? 4 : 0;
}

template <typename T>
int open_entry(void* const* ptrs, void* x_try, void* status, int L, int d,
               int m, void* stream) {
  if (L <= 0 || m <= 0 || m > 512 || d <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (per_thread(d)) {
    case 1: return launch_open<T, 1>(ptrs, x_try, status, L, d, m, s);
    case 2: return launch_open<T, 2>(ptrs, x_try, status, L, d, m, s);
    case 4: return launch_open<T, 4>(ptrs, x_try, status, L, d, m, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int update_entry(void* const* ptrs, const void* x_try, const void* f_try,
                 const void* g_try, void* status, double c1, double c2,
                 double ftol, double gtol, int max_linesearch,
                 int max_restarts, int maxiter, int maxeval, int L, int d,
                 int m, void* stream) {
  if (L <= 0 || m <= 0 || m > 512 || d <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Config cfg{c1, c2, ftol, gtol, max_linesearch, max_restarts, maxiter,
                   maxeval};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (per_thread(d)) {
    case 1: return launch_update<T, 1>(ptrs, x_try, f_try, g_try, status, cfg,
                                       L, d, m, s);
    case 2: return launch_update<T, 2>(ptrs, x_try, f_try, g_try, status, cfg,
                                       L, d, m, s);
    case 4: return launch_update<T, 4>(ptrs, x_try, f_try, g_try, status, cfg,
                                       L, d, m, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// ptrs: the 31 state tensors' device pointers in _BState's field order
// (row-major, [L], [L, d], [L, m] or [L, m, d]; int32 counters, 1-byte
// bools); x_try, g_try [L, d]; f_try [L]; status int32 [2] (live count,
// error word). Return the launch's cudaError_t.
extern "C" int lbfgs_open_f32(void* const* ptrs, void* x_try, void* status,
                              int L, int d, int m, void* stream) {
  return open_entry<float>(ptrs, x_try, status, L, d, m, stream);
}

extern "C" int lbfgs_open_f64(void* const* ptrs, void* x_try, void* status,
                              int L, int d, int m, void* stream) {
  return open_entry<double>(ptrs, x_try, status, L, d, m, stream);
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
