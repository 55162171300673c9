// K6 (lm_open) and K7 (lm_update): one trip of the batched
// Levenberg-Marquardt, split at its one evaluation, float and double.
//
// Replace the body of the JAX package's jax.lax.while_loop in
// option_pricing_ffn_lbfgs_tpu/ops/levenberg_marquardt.py::
// lm_minimize_batched (:257-314), whose damped normal equations are a
// vmapped cho_factor / cho_solve (:267-268). XLA compiled that body into
// one device program; it has no Pallas twin. The plain PyTorch versions are
// ops/levenberg_marquardt.py::lm_open_plain / lm_update_plain, which this
// file follows operation by operation:
//   K6, before the evaluation (JAX :258-270): for a lane that is not done,
//     J^T J and J^T r summed over the m residual rows in order, the
//     diagonal floored at 1e-32 and damped by lam, a column-by-column
//     Cholesky factor (inner sums in order), forward then back
//     substitution; dx = 0 where a pivot is not positive and finite or
//     where dx is not finite (JAX's NaN factor and isfinite); x_try = x +
//     dx, and max |dx|, max |J^T r| kept for K7. A done lane's x_try is its
//     x. Block 0 zeroes the live count.
//   K7, after it (JAX :271-314): the trial cost (sum of r_try^2 over the
//     rows in order, a non-finite entry as +inf), the accept test, the
//     x/r/J/cost/lam update, every stopping test (step_small, xconv_stall,
//     fconv_accept, fconv_stall, gconv, tconv, give_up, the bootstrap guard,
//     maxiter + 1), the counters; done lanes are left as they are. Each
//     block adds its count of lanes not done afterwards to the live count,
//     which the host reads once a trip.
// Both update the state in place (the plain versions build new tensors).
//
// Fused mode, for the LM polish's objective (double, d = 13, m = n + 2
// residual rows with n + 2 <= kMaxFusedRows; the _fused entries): the
// polish's host assembly (calibration/calibrator.py::PolishObjective, JAX's
// calibration/loss.py::surface_residuals and ops/loss_pallas.py:259-285)
// moves into the two kernels, so that a trip is K6, K1<double>
// (csrc/cos_price.cu) and K3 (csrc/cos_vg.cu mode 1), both unchanged, and
// K7 with no other launch:
//   K6 also writes params64 = transform(x_try) at double, which K1 prices
//     (transform(x) on the bootstrap trip, whose residuals the host path
//     took at x0, and for done lanes), and params32 =
//     transform(float(x_try)) at float, which K3 differentiates;
//   K7 first assembles the evaluation, then runs the unfused K7 on it:
//     r at double from K1's prices, in the host's order: a row's price is
//     valid if finite and positive, the pricing rows are (safe - mkt) /
//     mkt times row_scale (ATen divides by a Python scalar on the card as a
//     multiplication by its reciprocal), then the two Feller rows
//     sqrt(w max(0, sigma^2 - 2 kappa theta)) from params64, and the
//     sentinel sqrt(bad_loss / m) on every row of a lane with an invalid
//     price; J at float from K3's rows and the Feller rows taken from
//     params32 (dv = (1 / (2 sqrt(w v))) w, which is ATen's w / y, then
//     dv 2 p_sigma, (-dv) 2 p_theta, (-dv) 2 p_kappa), every entry times
//     dtransform/dx (csrc/trip_transform.cuh), cast to double. A sentinel
//     lane's J is left as computed, as the host path leaves it. The lane's
//     residuals are staged in shared memory; J is assembled where K7
//     copies it, on an accepted step.
// The plain versions are ops/levenberg_marquardt.py::lm_open_fused_plain /
// lm_update_fused_plain (the host assembly, ops/loss_kernel.py::
// polish_assembly_plain, then lm_update_plain).
//
// What bounds them on the H100: bytes. Per lane K6 does about m d^2 + d^3/3
// operations on the lane's m x d Jacobian (13 x 17 x 13 in the polish); at
// 1536 lanes in double the Jacobian alone is 2.7 MB, under a microsecond
// at 3.35 TB/s, and the operations over 34 TFLOP/s take less
// (ops/opcount.py::lm_open_work, lm_update_work). A launch costs its
// latency: what the design is for is to replace ~300 host-issued launches a
// trip with two, and, fused, the assembly's ~100 as well; the wrappers bind
// a run's trip once (ops/levenberg_marquardt.py::LMTripKernels), so a
// launch is one prepared ctypes call. Fused K6 adds 13 values a lane at
// each precision to its writes, fused K7 reads n prices and market prices
// and the lane's parameters in place of r_try, and K3's float rows in
// place of j_try where it accepts: still bytes.
//
// Design: one warp per lane, thread t holding coordinate t (d <= 32). J^T J
// is accumulated in registers, row t by thread t, each row of J broadcast
// by shuffles; the damped matrix is factored in shared memory, column j's
// pivot broadcast from thread j, rows below it computed in parallel; the
// substitutions run a column (forward) or a row (back) a step, every row
// taking its term off in parallel. Nothing here is a matrix product large
// enough for the tensor cores.
//
// Matching the plain version in bits: the file is built with -fmad=false
// (eager PyTorch rounds a * b + c twice); each sum runs in the plain
// version's order; torch.clamp / maximum / amax propagate NaN where fmax
// does not, so those are written out; each Python constant becomes
// T(constant) as PyTorch casts it to the tensor's dtype.
#include <cuda_runtime.h>
#include <math.h>

#include "trip_transform.cuh"

namespace {

constexpr int kWarp = 32;
constexpr int kMaxDim = 32;               // a thread per coordinate
constexpr int kParams = 13;               // the fused mode's d
constexpr int kMaxFusedRows = 128;        // the fused mode's m = n + 2
constexpr int kLanesPerBlock = 4;
constexpr int kThreads = kWarp * kLanesPerBlock;
constexpr unsigned kFull = 0xFFFFFFFFu;

template <typename T>
struct State {                            // ops/levenberg_marquardt.py::_State
  T *x, *r, *J, *cost, *lam;
  int *n_iters, *n_evals;
  unsigned char *done, *converged;
  T *dx_max, *g_max;
};

template <typename T>
State<T> unpack(void* const* p) {
  State<T> s;
  int i = 0;
  s.x = static_cast<T*>(p[i++]); s.r = static_cast<T*>(p[i++]);
  s.J = static_cast<T*>(p[i++]); s.cost = static_cast<T*>(p[i++]);
  s.lam = static_cast<T*>(p[i++]); s.n_iters = static_cast<int*>(p[i++]);
  s.n_evals = static_cast<int*>(p[i++]);
  s.done = static_cast<unsigned char*>(p[i++]);
  s.converged = static_cast<unsigned char*>(p[i++]);
  s.dx_max = static_cast<T*>(p[i++]); s.g_max = static_cast<T*>(p[i++]);
  return s;
}

__device__ __forceinline__ float t_abs(float v) { return fabsf(v); }
__device__ __forceinline__ double t_abs(double v) { return fabs(v); }
__device__ __forceinline__ float t_sqrt(float v) { return sqrtf(v); }
__device__ __forceinline__ double t_sqrt(double v) { return sqrt(v); }

// torch.clamp(v, min=lo) / torch.maximum: NaN in, NaN out.
template <typename T>
__device__ __forceinline__ T clamp_min(T v, T lo) {
  return isnan(v) ? v : (v < lo ? lo : v);
}
template <typename T>
__device__ __forceinline__ T nan_max(T a, T b) {
  return (isnan(a) || a > b) ? a : b;
}

// torch.amax over the warp (NaN-propagating; exact in any order).
template <typename T>
__device__ __forceinline__ T warp_max(T v) {
#pragma unroll
  for (int o = kWarp / 2; o > 0; o >>= 1)
    v = nan_max(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// What fused K6 writes besides x_try: the trial parameters at both
// precisions (d = 13, double state).
struct OpenParams {
  double* params64;                       // [L, 13] transform(x_try)
  float* params32;                        // [L, 13] transform(float(x_try))
  Transform tf;
  int boot;                               // the bootstrap trip: params64 at x
};

// Thread t's coordinate of x_try, and in fused mode of the trial
// parameters (``x`` the lane's iterate, ``xt`` its x_try).
template <typename T, bool Fused>
__device__ __forceinline__ void store_trial(T* x_try, const OpenParams& op,
                                            size_t row, int t, T x, T xt) {
  x_try[row + t] = xt;
  if constexpr (Fused) {
    op.params64[row + t] = transform_coord(op.tf, t, op.boot ? x : xt);
    op.params32[row + t] =
        transform_coord(op.tf, t, static_cast<float>(xt));
  }
}

template <typename T, bool Fused>
__global__ void __launch_bounds__(kThreads)
lm_open_kernel(State<T> st, T* __restrict__ x_try, OpenParams op,
               int* status, int L, int m, int d) {
  extern __shared__ unsigned char smem_raw[];
  const int t = threadIdx.x % kWarp;
  const int w = threadIdx.x / kWarp;
  const int lane = blockIdx.x * kLanesPerBlock + w;
  if (blockIdx.x == 0 && threadIdx.x == 0) status[0] = 0;
  if (lane >= L) return;
  const bool mine = t < d;                // thread t holds coordinate t
  const size_t row = static_cast<size_t>(lane) * d;
  const T x = mine ? st.x[row + t] : T(0);
  if (st.done[lane]) {                    // done lanes hold: x_try = x
    if (mine) store_trial<T, Fused>(x_try, op, row, t, x, x);
    return;
  }
  // J^T J (row t in thread t's registers) and g = J^T r, over the rows in
  // order from 0.
  const T* J = st.J + static_cast<size_t>(lane) * m * d;
  const T* r = st.r + static_cast<size_t>(lane) * m;
  T acc[kMaxDim];
#pragma unroll
  for (int j = 0; j < kMaxDim; ++j) acc[j] = T(0);
  T g = T(0);
  for (int k = 0; k < m; ++k) {
    const T jk = mine ? J[static_cast<size_t>(k) * d + t] : T(0);
#pragma unroll
    for (int j = 0; j < kMaxDim; ++j)
      if (j < d) acc[j] = acc[j] + jk * __shfl_sync(kFull, jk, j);
    g = g + jk * r[k];
  }
  // The damped matrix's lower triangle: jtj + lam * diag(max(jtj_ii,
  // 1e-32)), zero damping off the diagonal.
  T* A = reinterpret_cast<T*>(smem_raw) + static_cast<size_t>(w) * d * d;
  const T lam = st.lam[lane];
  if (mine) {
#pragma unroll
    for (int j = 0; j < kMaxDim; ++j)
      if (j <= t) {
        const T damp = j == t ? clamp_min(acc[j], T(1e-32)) : T(0);
        A[t * d + j] = acc[j] + lam * damp;
      }
  }
  __syncwarp();
  // Cholesky, column by column, in place: A[i][j] becomes C[i][j] (i >= j).
  bool ok = true;
  for (int j = 0; j < d; ++j) {
    T s = T(0);
    if (mine && t >= j) {
      s = A[t * d + j];
      for (int k = 0; k < j; ++k) s = s - A[t * d + k] * A[j * d + k];
    }
    const T pivot = __shfl_sync(kFull, s, j);
    if (!(pivot > T(0)) || !isfinite(pivot)) {
      ok = false;                         // the same on every thread
      break;
    }
    const T root = t_sqrt(pivot);
    if (t == j) A[j * d + j] = root;
    else if (mine && t > j) A[t * d + j] = s / root;
    __syncwarp();
  }
  T dx = T(0);
  if (ok) {
    T s = g, y = T(0);                    // forward: C y = g
    for (int j = 0; j < d; ++j) {
      const T yj = __shfl_sync(kFull, s, j) / A[j * d + j];
      if (t == j) y = yj;
      if (mine && t > j) s = s - A[t * d + j] * yj;
    }
    T u = y, z = T(0);                    // back: C^T z = y
    for (int k = d - 1; k >= 0; --k) {
      const T zk = __shfl_sync(kFull, u, k) / A[k * d + k];
      if (t == k) z = zk;
      if (t < k) u = u - A[k * d + t] * zk;
    }
    dx = -z;
    if (!mine || !isfinite(dx)) dx = T(0);
  }
  const T dx_max = warp_max(t_abs(dx));
  const T g_max = warp_max(mine ? t_abs(g) : T(0));
  if (mine) store_trial<T, Fused>(x_try, op, row, t, x, x + dx);
  if (t == 0) {
    st.dx_max[lane] = dx_max;
    st.g_max[lane] = g_max;
  }
}

struct Config {
  double ftol, gtol, xtol, lambda_down, lambda_up, lambda_min, lambda_max;
  double xstall_lam;                      // 10 lambda_init
  double cost_target;
  int maxiter;
};

// The evaluation's Jacobian entry i (row-major [m, d]) of a lane, read
// from j_try (unfused).
template <typename T>
struct JacRows {
  const T* j;                             // the lane's [m, d]
  __device__ __forceinline__ T operator()(size_t i) const { return j[i]; }
};

// One lane that is not done, on the evaluation at x_try (the lane's row)
// with residuals r_try (the lane's m) and Jacobian entries jac(i); returns
// whether it is still not done.
template <typename T, typename Jac>
__device__ __forceinline__ bool update_lane(
    const State<T>& st, const T* __restrict__ x_try, const T* r_try,
    const Jac& jac, const Config& cfg, int lane, int t, int m, int d) {
  const bool mine = t < d;
  const size_t row = static_cast<size_t>(lane) * d;
  T cost_try = T(0);
  for (int k = 0; k < m; ++k) {           // every thread, rows in order
    T v = r_try[k];
    if (!isfinite(v)) v = T(INFINITY);
    cost_try = cost_try + v * v;
  }
  const T cost = st.cost[lane], lam = st.lam[lane];
  const T x = mine ? st.x[row + t] : T(0);
  const T x_max = warp_max(t_abs(x));
  const bool accept = cost_try < cost;
  if (accept) {
    if (mine) st.x[row + t] = x_try[t];
    T* r = st.r + static_cast<size_t>(lane) * m;
    for (int k = t; k < m; k += kWarp) r[k] = r_try[k];
    const size_t n = static_cast<size_t>(m) * d;
    T* J = st.J + static_cast<size_t>(lane) * n;
    for (size_t i = t; i < n; i += kWarp) J[i] = jac(i);
  }
  const T cost_new = accept ? cost_try : cost;
  const T lam_new = accept
      ? clamp_min(lam * T(cfg.lambda_down), T(cfg.lambda_min))
      : lam * T(cfg.lambda_up);
  const bool step_small =
      st.dx_max[lane] <= T(cfg.xtol) * clamp_min(x_max, T(1.0));
  const bool xconv_stall = !accept && step_small && lam > T(cfg.xstall_lam);
  const T fscale = clamp_min(nan_max(cost, cost_try), T(1.0));
  const bool fconv_accept =
      accept && (cost - cost_try) <= T(cfg.ftol) * fscale;
  const bool fconv_stall =
      !accept && t_abs(cost_try - cost) <= T(cfg.ftol) * fscale;
  const bool gconv = st.g_max[lane] <= T(cfg.gtol);
  const bool bootstrap = !isfinite(cost);
  const bool tconv = cfg.cost_target > 0.0 && cost_new <= T(cfg.cost_target);
  const bool conv = (gconv || fconv_accept || fconv_stall ||
                     (accept && step_small) || xconv_stall || tconv) &&
                    !bootstrap;
  const bool give_up = lam_new > T(cfg.lambda_max) && !bootstrap;
  const int n_iters = st.n_iters[lane] + 1;
  const bool done = conv || give_up || n_iters >= cfg.maxiter + 1;
  __syncwarp();           // every read of the lane precedes thread 0's writes
  if (t == 0) {
    st.cost[lane] = cost_new;
    st.lam[lane] = lam_new;
    st.n_iters[lane] = n_iters;
    st.n_evals[lane] = st.n_evals[lane] + 1;
    st.done[lane] = done;
    st.converged[lane] = st.converged[lane] || conv;
  }
  return !done;
}

// What fused K7 assembles the evaluation from (double state, d = 13).
struct Assembly {
  const double* params64;                 // [L, 13] K1's parameters
  const float* params32;                  // [L, 13] K3's parameters
  const double* price;                    // [L, n] K1's prices
  const float* jac;                       // [L, n, 13] K3's rows
  const double* mkt;                      // [L, n] market prices
  double weight;                          // the Feller weight
  double sentinel;                        // sqrt(bad_loss / m)
  double row_scale;                       // 1 / sqrt(n), rounded in double
  int n;                                  // options a lane; m = n + 2
  int feller;                             // (sigma, kappa, theta) x 2, 4 bits
  Transform tf;
};

__device__ __forceinline__ int feller_index(int feller, int f, int which) {
  return (feller >> (4 * (3 * f + which))) & 15;
}

// The lane's residuals into r (shared memory, m = n + 2 values): the
// pricing rows, the Feller rows, or the sentinel on all of them where a
// price is not finite and positive (calibration/loss.py::residual_rows).
__device__ __forceinline__ void assemble_residuals(const Assembly& a,
                                                   int lane, int t,
                                                   double* r) {
  const int n = a.n;
  const double* price = a.price + static_cast<size_t>(lane) * n;
  const double* mkt = a.mkt + static_cast<size_t>(lane) * n;
  bool invalid = false;
  for (int k = t; k < n; k += kWarp) {
    const double p = price[k];
    invalid = invalid || !(isfinite(p) && p > 0.0);
  }
  const bool bad = __any_sync(kFull, invalid);
  const double* q = a.params64 + static_cast<size_t>(lane) * kParams;
  for (int k = t; k < n + 2; k += kWarp) {
    double v;
    if (bad) {
      v = a.sentinel;
    } else if (k < n) {                   // every price here is valid
      v = (price[k] - mkt[k]) / mkt[k] * a.row_scale;
    } else {
      const int f = k - n;
      const int s = feller_index(a.feller, f, 0),
                kk = feller_index(a.feller, f, 1),
                th = feller_index(a.feller, f, 2);
      const double viol = q[s] * q[s] - 2.0 * q[kk] * q[th];
      const bool active = viol > 0.0;
      v = active ? sqrt(a.weight * viol) : 0.0;
    }
    r[k] = v;
  }
  __syncwarp();                           // r written before it is read
}

// The lane's Jacobian entry i (row-major [n + 2, 13]) at float, times
// dtransform/dx, cast to double: K3's rows, then the Feller rows from
// params32 (ops/loss_kernel.py::polish_jacobian_plain).
struct AssembledJac {
  Assembly a;
  int lane;
  __device__ __forceinline__ double operator()(size_t i) const {
    const int n = a.n;
    const int k = static_cast<int>(i / kParams);
    const int c = static_cast<int>(i % kParams);
    const float* q = a.params32 + static_cast<size_t>(lane) * kParams;
    float v;
    if (k < n) {
      v = a.jac[static_cast<size_t>(lane) * n * kParams + i];
    } else {
      const int f = k - n;
      const int s = feller_index(a.feller, f, 0),
                kk = feller_index(a.feller, f, 1),
                th = feller_index(a.feller, f, 2);
      const float w = static_cast<float>(a.weight);
      const float viol = q[s] * q[s] - 2.0f * q[kk] * q[th];
      const bool active = viol > 0.0f;
      const float safe = active ? viol : 1.0f;
      // weight / (2 sqrt(weight safe)): ATen's reciprocal, then times w
      const float dv =
          active ? (1.0f / (sqrtf(safe * w) * 2.0f)) * w : 0.0f;
      v = c == s ? (dv * 2.0f) * q[s]
        : c == kk ? (-dv * 2.0f) * q[th]
        : c == th ? (-dv * 2.0f) * q[kk] : 0.0f;
    }
    return static_cast<double>(v * dtransform_coord(a.tf, c, q[c]));
  }
};

template <typename T, bool Fused>
__global__ void __launch_bounds__(kThreads)
lm_update_kernel(State<T> st, const T* __restrict__ x_try,
                 const T* __restrict__ r_try, const T* __restrict__ j_try,
                 Assembly asm_, int* status, Config cfg, int L, int m,
                 int d) {
  extern __shared__ unsigned char smem_raw[];   // fused: a lane's residuals
  const int t = threadIdx.x % kWarp;
  const int w = threadIdx.x / kWarp;
  const int lane = blockIdx.x * kLanesPerBlock + w;
  bool live = false;
  if (lane < L && !st.done[lane]) {
    const T* xt = x_try + static_cast<size_t>(lane) * d;
    if constexpr (Fused) {
      double* r = reinterpret_cast<double*>(smem_raw) +
                  static_cast<size_t>(w) * m;
      assemble_residuals(asm_, lane, t, r);
      live = update_lane<T>(st, xt, r, AssembledJac{asm_, lane}, cfg, lane,
                            t, m, d);
    } else {
      const size_t lm = static_cast<size_t>(lane) * m;
      live = update_lane<T>(st, xt, r_try + lm, JacRows<T>{j_try + lm * d},
                            cfg, lane, t, m, d);
    }
  }
  const int n = __syncthreads_count(live && t == 0);
  if (threadIdx.x == 0 && n > 0) atomicAdd(status, n);
}

inline bool bad_shape(int L, int m, int d) {
  return L <= 0 || m <= 0 || d <= 0 || d > kMaxDim;
}

// The fused entries' shapes and constants: d = 13, m = n + 2 rows with
// n >= 1 and m <= kMaxFusedRows, disjoint masks below bit 13, Feller
// indices below 13.
inline bool bad_fused(int L, int m, int d, int n, unsigned exp_mask,
                      unsigned tanh_mask, int feller) {
  if (bad_shape(L, m, d) || d != kParams || n < 1 || m != n + 2 ||
      m > kMaxFusedRows || ((exp_mask | tanh_mask) >> kParams) != 0u ||
      (exp_mask & tanh_mask) != 0u)
    return true;
  for (int i = 0; i < 6; ++i)
    if (((feller >> (4 * i)) & 15) >= kParams) return true;
  return false;
}

template <typename T, bool Fused>
int launch_open(void* const* ptrs, void* x_try, const OpenParams& op,
                void* status, int L, int m, int d, void* stream) {
  const int blocks = (L + kLanesPerBlock - 1) / kLanesPerBlock;
  const size_t smem = static_cast<size_t>(kLanesPerBlock) * d * d * sizeof(T);
  lm_open_kernel<T, Fused><<<blocks, kThreads, smem,
                             static_cast<cudaStream_t>(stream)>>>(
      unpack<T>(ptrs), static_cast<T*>(x_try), op, static_cast<int*>(status),
      L, m, d);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool Fused>
int launch_update(void* const* ptrs, const void* x_try, const void* r_try,
                  const void* j_try, const Assembly& a, void* status,
                  const Config& cfg, int L, int m, int d, void* stream) {
  const int blocks = (L + kLanesPerBlock - 1) / kLanesPerBlock;
  // fused: a lane's residuals in shared memory
  const size_t smem =
      Fused ? static_cast<size_t>(kLanesPerBlock) * m * sizeof(double) : 0;
  lm_update_kernel<T, Fused><<<blocks, kThreads, smem,
                               static_cast<cudaStream_t>(stream)>>>(
      unpack<T>(ptrs), static_cast<const T*>(x_try),
      static_cast<const T*>(r_try), static_cast<const T*>(j_try), a,
      static_cast<int*>(status), cfg, L, m, d);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int open_entry(void* const* ptrs, void* x_try, void* status, int L, int m,
               int d, void* stream) {
  if (bad_shape(L, m, d)) return static_cast<int>(cudaErrorInvalidValue);
  return launch_open<T, false>(ptrs, x_try, OpenParams{}, status, L, m, d,
                               stream);
}

template <typename T>
int update_entry(void* const* ptrs, const void* x_try, const void* r_try,
                 const void* j_try, void* status, const Config& cfg, int L,
                 int m, int d, void* stream) {
  if (bad_shape(L, m, d)) return static_cast<int>(cudaErrorInvalidValue);
  return launch_update<T, false>(ptrs, x_try, r_try, j_try, Assembly{},
                                 status, cfg, L, m, d, stream);
}

}  // namespace

// ptrs: the 11 state tensors' device pointers in _State's field order
// (row-major [L], [L, d], [L, m] or [L, m, d]; int32 counters, 1-byte
// bools); x_try [L, d]; r_try [L, m]; j_try [L, m, d]; status int32 [1]
// (the live count). Fused entries (double, d = 13, m = n + 2 <= 128):
// params64 [L, 13] double, params32 [L, 13] float; price, mkt [L, n]
// double; jac [L, n, 13] float (K3's rows); boot: 1 on the bootstrap trip;
// weight, the Feller weight; sentinel, sqrt(bad_loss / m); row_scale,
// 1 / sqrt(n) in double; exp_mask and tanh_mask, bit c for coordinate c;
// feller, the two factors' (sigma, kappa, theta) indices, 4 bits each from
// the lowest. Return the launch's cudaError_t.
extern "C" int lm_open_f32(void* const* ptrs, void* x_try, void* status,
                           int L, int m, int d, void* stream) {
  return open_entry<float>(ptrs, x_try, status, L, m, d, stream);
}

extern "C" int lm_open_f64(void* const* ptrs, void* x_try, void* status,
                           int L, int m, int d, void* stream) {
  return open_entry<double>(ptrs, x_try, status, L, m, d, stream);
}

extern "C" int lm_open_fused_f64(void* const* ptrs, void* x_try,
                                 void* params64, void* params32,
                                 unsigned exp_mask, unsigned tanh_mask,
                                 int boot, void* status, int L, int m,
                                 int d, void* stream) {
  if (bad_fused(L, m, d, m - 2, exp_mask, tanh_mask, 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const OpenParams op{static_cast<double*>(params64),
                      static_cast<float*>(params32),
                      Transform{exp_mask, tanh_mask}, boot != 0};
  return launch_open<double, true>(ptrs, x_try, op, status, L, m, d, stream);
}

#define LM_UPDATE_ENTRY(NAME, T)                                             \
  extern "C" int NAME(void* const* ptrs, const void* x_try,                  \
                      const void* r_try, const void* j_try, void* status,    \
                      double ftol, double gtol, double xtol,                 \
                      double lambda_down, double lambda_up,                  \
                      double lambda_min, double lambda_max,                  \
                      double xstall_lam, double cost_target, int maxiter,    \
                      int L, int m, int d, void* stream) {                   \
    const Config cfg{ftol,       gtol,       xtol,       lambda_down,        \
                     lambda_up,  lambda_min, lambda_max, xstall_lam,         \
                     cost_target, maxiter};                                  \
    return update_entry<T>(ptrs, x_try, r_try, j_try, status, cfg, L, m, d,  \
                           stream);                                          \
  }

LM_UPDATE_ENTRY(lm_update_f32, float)
LM_UPDATE_ENTRY(lm_update_f64, double)

extern "C" int lm_update_fused_f64(
    void* const* ptrs, const void* x_try, const void* params64,
    const void* params32, const void* price, const void* jac,
    const void* mkt, void* status, double ftol, double gtol, double xtol,
    double lambda_down, double lambda_up, double lambda_min,
    double lambda_max, double xstall_lam, double cost_target, double weight,
    double sentinel, double row_scale, int maxiter, int n_opt,
    unsigned exp_mask, unsigned tanh_mask, int feller, int L, int m, int d,
    void* stream) {
  if (bad_fused(L, m, d, n_opt, exp_mask, tanh_mask, feller))
    return static_cast<int>(cudaErrorInvalidValue);
  const Config cfg{ftol,       gtol,       xtol,       lambda_down,
                   lambda_up,  lambda_min, lambda_max, xstall_lam,
                   cost_target, maxiter};
  const Assembly a{static_cast<const double*>(params64),
                   static_cast<const float*>(params32),
                   static_cast<const double*>(price),
                   static_cast<const float*>(jac),
                   static_cast<const double*>(mkt),
                   weight, sentinel, row_scale, n_opt, feller,
                   Transform{exp_mask, tanh_mask}};
  return launch_update<double, true>(ptrs, x_try, nullptr, nullptr, a,
                                     status, cfg, L, m, d, stream);
}
