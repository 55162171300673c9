// K2/K3: per-row COS price and weighted parameter gradient, float and double.
//
// Replaces option_pricing_ffn_lbfgs_tpu/ops/loss_pallas.py::
// _rows_price_and_grad (kernel body _kernel_vg), where the gradient was a
// jax.vjp traced inside the Pallas kernel. For each (lane, option) row it
// computes the price P and w * dP/dtheta for the 13 constrained parameters,
// the dependence of the truncation range [a, b] on theta included:
//   mode 0 (K2, the search's value-and-grad): w = 2 (P - mkt) / (mkt^2 n_opt),
//     the exact dLoss/dP of the relative-MSE loss; the kernel writes the
//     prices and each lane's sum over its rows, [L, 13];
//   mode 1 (K3, the LM Jacobian):             w = 1 / (mkt sqrt(n_opt)),
//     so the rows [L, n_opt, 13] are the residual Jacobian d r_j / dtheta.
// The host (ops/loss_kernel.py) adds the Feller terms, the transform chain
// rule and the sentinel. Two instantiations: float (cos_vg_f32: the float32
// search, the hybrid refine and the polish Jacobian) and double (cos_vg_f64:
// the float64 value-and-grad of calibrate_surface and hybrid_calibrate).
//
// What bounds it on the H100: arithmetic, chiefly the transcendentals of the
// characteristic function (CF): two Heston factors (csqrt, three cdiv,
// cexp, clog) and the jump factor, each term. Its inputs and outputs are
// about 90 B a row, so memory traffic is negligible; nothing in it is a
// matrix product, so tensor cores, wgmma and TMA do not apply. The first
// design carried all 13 tangents through every operation (Dual<T, 13>):
// 14x the primal arithmetic, 255 registers and spills, at most 8 warps an SM.
//
// This design:
//   * Structured derivatives. log phi = A1 + A2 + B1 v1 + B2 v2 + i drift u
//     tau + jump(u). Each Heston factor is evaluated in Dual<T, 5> over
//     (kappa_i, theta_i, sigma_i, rho_i, u); d log phi / d v0_i = B_i is the
//     factor's own primal; the jump factor and the drift run in Dual<T, 4>
//     over (lambda, mu_J, sigma_J, u). Then d phi = phi d log phi.
//   * Range chain rule. With E_k = exp(-i u_k a), term_k = Re[phi E_k] V_k
//     and u_k = k pi / (b - a), so
//       dP/dtheta_j = e^{-r tau} sum_k { Re[dphi/dtheta_j E_k] V_k
//                     + dterm_k/da da/dtheta_j + dterm_k/db db/dtheta_j },
//     where the total derivatives in (a, b) take u_k's dependence through
//     dphi/du; the payoff V_k runs in Dual<T, 2> over (a, b). A row keeps 16
//     running sums (P, d/da, d/db, 13 CF terms) and applies da/dtheta and
//     db/dtheta once at the end.
//   * Shared CF. One block per lane. phi(u_k) depends on the row only
//     through tau and [a, b], so rows of one maturity share it: the block
//     computes each maturity group's cumulant range and its 13-wide
//     derivative once; a row whose widening to log(K/S0) -/+ 0.1 binds gets
//     its own range and becomes its own group, so the result stays exact.
//     For each group the threads evaluate the N CF items (phi, its
//     derivatives, E_k) into shared memory; then each warp takes a row of
//     the group, its lanes stride over k for the payoff, and a shuffle
//     reduces the 16 sums. Every sum runs in a fixed order without atomics,
//     so two launches give identical bits. Shared memory is the card
//     feature this design uses.
//   * __launch_bounds__ keeps the float kernel at 16 resident warps an SM
//     (at most 128 registers a thread).
//   * Done lanes. Inside a bound trip (the fused L-BFGS trip K4, K2, K5;
//     the fused LM trip K6, K1<double>, K3, K7) the kernel takes the
//     state's done flags, done [L]: K5 or K7 of the previous trip wrote
//     them on the same stream, and K4 and K6 leave them as they are. The
//     block of a done lane returns before its first shared-memory write
//     and its first __syncthreads (the test is uniform across the block),
//     so its price and gradient rows keep what they held: nothing reads
//     them, since K5 and K7 of the same trip touch only lanes that are not
//     done. A lane that is not done runs the same code in the same order,
//     so its bits are those of the unmasked launch. done = nullptr (the
//     one-shot wrappers, the unfused trips) prices every lane.
// Branches select on the primal (cos_math.cuh), and there is no
// --use_fast_math: the double kernel needs the accurate libm.
#include "cos_vg_terms.cuh"

namespace {

using namespace cosvg;

constexpr int kThreads = 64;              // two warps per lane's block
constexpr int kWarps = kThreads / 32;

// Blocks an SM must hold: 8 blocks of 2 warps = 16 warps for float.
template <typename T> struct MinBlocks { static constexpr int value = 8; };
template <> struct MinBlocks<double> { static constexpr int value = 4; };

// Shared memory of one block, in T then int units; host and device agree.
struct Layout {
  int logk, ga, gb, gda, gdb, ea, eb, etau, item, rowg, n_t;
  int first, gidx, grow, eff, erows, estart, flags, count, n_i;
  __host__ __device__ Layout(int n, int n_terms) {
    logk = kParams;                       // params occupy [0, 13)
    ga = logk + n;
    gb = ga + n;
    gda = gb + n;
    gdb = gda + n * kParams;
    ea = gdb + n * kParams;
    eb = ea + n;
    etau = eb + n;
    item = etau + n;
    rowg = item + kScratch * n_terms;
    n_t = rowg + n * kParams;
    first = 0;
    gidx = first + n;
    grow = gidx + n;
    eff = grow + n;
    erows = eff + n;
    estart = erows + n;
    flags = estart + n + 1;
    count = flags + n;
    n_i = count + 2;
  }
  template <typename T> size_t bytes() const {
    return sizeof(T) * n_t + sizeof(int) * n_i;
  }
};

template <typename T>
__global__ void __launch_bounds__(kThreads, MinBlocks<T>::value)
cos_vg_kernel(const T* __restrict__ params, const T* __restrict__ spots,
              const T* __restrict__ strikes, const T* __restrict__ mats,
              const unsigned char* __restrict__ is_call,
              const T* __restrict__ mkt, const int* __restrict__ groups,
              const unsigned char* __restrict__ done,
              T* __restrict__ price_out, T* __restrict__ grad_out, T rate,
              T q, T L, int n_opt, int n_terms, int mode) {
  const int lane = blockIdx.x;
  if (done != nullptr && done[lane]) return;   // its rows are never read
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout lay(n_opt, n_terms);
  T* st = reinterpret_cast<T*>(smem);
  int* si = reinterpret_cast<int*>(st + lay.n_t);
  T* s_item = st + lay.item;
  const int tid = threadIdx.x, warp = tid >> 5, wl = tid & 31;
  const int row0 = lane * n_opt;
  const T spot = spots[lane];

  // Parameters, log-moneyness, first row of each row's group label.
  if (tid < kParams) st[tid] = params[lane * kParams + tid];
  for (int r = tid; r < n_opt; r += kThreads) {
    st[lay.logk + r] = cosm::s_log(strikes[row0 + r] / spot);
    const int label = groups[row0 + r];
    int f = r;
    for (int r2 = 0; r2 < r; ++r2)
      if (groups[row0 + r2] == label) { f = r2; break; }
    si[lay.first + r] = f;
  }
  __syncthreads();
  if (tid == 0) {                         // dense maturity-group ids
    int ng = 0;
    for (int r = 0; r < n_opt; ++r) {
      const int f = si[lay.first + r];
      if (f == r) {
        si[lay.grow + ng] = r;
        si[lay.gidx + r] = ng++;
      } else {
        si[lay.gidx + r] = si[lay.gidx + f];
      }
    }
    si[lay.count] = ng;
  }
  __syncthreads();
  const T* p = st;                        // the lane's parameters
  const int n_groups = si[lay.count];
  for (int g = tid; g < n_groups; g += kThreads)
    group_range(p, mats[row0 + si[lay.grow + g]], rate, L, st + lay.ga + g,
                st + lay.gb + g, st + lay.gda + g * kParams,
                st + lay.gdb + g * kParams);
  __syncthreads();
  if (tid == 0) {
    // Effective groups: the rows of a maturity whose widening does not
    // bind share its range; every other row is a group of its own.
    int* shared_of = si + lay.first;      // reused: maturity -> group, -1
    for (int g = 0; g < n_groups; ++g) shared_of[g] = -1;
    int ne = 0;
    for (int r = 0; r < n_opt; ++r) {
      const int g = si[lay.gidx + r];
      const T ga = st[lay.ga + g], gb = st[lay.gb + g];
      const T log_k = st[lay.logk + r];
      const T lo = log_k - T(0.1), hi = log_k + T(0.1);
      const bool a_on = ga < lo, b_on = gb > hi;
      si[lay.flags + r] = (a_on ? 1 : 0) | (b_on ? 2 : 0);
      int e;
      if (a_on && b_on && shared_of[g] >= 0) {
        e = shared_of[g];
      } else {
        e = ne++;
        if (a_on && b_on) shared_of[g] = e;
        st[lay.ea + e] = a_on ? ga : lo;
        st[lay.eb + e] = b_on ? gb : hi;
        st[lay.etau + e] = mats[row0 + r];
      }
      si[lay.eff + r] = e;
    }
    // Rows ordered by group, ascending within a group.
    int pos = 0;
    for (int e = 0; e < ne; ++e) {
      si[lay.estart + e] = pos;
      for (int r = 0; r < n_opt; ++r)
        if (si[lay.eff + r] == e) si[lay.erows + pos++] = r;
    }
    si[lay.estart + ne] = pos;
    si[lay.count + 1] = ne;
  }
  __syncthreads();
  const int n_eff = si[lay.count + 1];

  for (int e = 0; e < n_eff; ++e) {
    const T a = st[lay.ea + e], b = st[lay.eb + e], tau = st[lay.etau + e];
    const T width = b - a;
    const T step = T(3.141592653589793) / width;
    for (int k = tid; k < n_terms; k += kThreads)
      cf_item(p, tau, rate, q, a, width, step, k, n_terms, s_item);
    __syncthreads();

    const int beg = si[lay.estart + e], cnt = si[lay.estart + e + 1] - beg;
    for (int i = warp; i < cnt; i += kWarps) {
      const int r = si[lay.erows + beg + i];
      const int row = row0 + r;
      const PayoffRow<T> pay(a, b, st[lay.logk + r], spot, strikes[row],
                             is_call[row] != 0);
      T acc[kItem];
#pragma unroll
      for (int f = 0; f < kItem; ++f) acc[f] = T(0);
      for (int k = wl; k < n_terms; k += 32)
        add_row_term(acc, s_item, n_terms, k, pay.v(k));
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
        for (int f = 0; f < kItem; ++f)
          acc[f] += __shfl_down_sync(0xffffffffu, acc[f], off);
      }
      if (wl == 0) {
        const T disc = cosm::s_exp(-rate * mats[row]);
        const T price = disc * acc[0];
        const T m = mkt[row];
        const T w = mode == 0
            ? T(2) * (price - m) / (m * m * static_cast<T>(n_opt))
            : static_cast<T>(1.0 / sqrt(static_cast<double>(n_opt))) / m;
        const T wd = w * disc;
        const int flags = si[lay.flags + r];
        const T sa = (flags & 1) ? acc[1] : T(0);
        const T sb = (flags & 2) ? acc[2] : T(0);
        const T* gda = st + lay.gda + si[lay.gidx + r] * kParams;
        const T* gdb = st + lay.gdb + si[lay.gidx + r] * kParams;
        T* out = mode == 0 ? st + lay.rowg + r * kParams
                           : grad_out + static_cast<size_t>(row) * kParams;
#pragma unroll
        for (int j = 0; j < kParams; ++j)
          out[j] = wd * (acc[3 + j] + sa * gda[j] + sb * gdb[j]);
        price_out[row] = price;
      }
    }
    __syncthreads();
  }
  if (mode == 0 && tid < kParams) {        // the lane's sum, in row order
    T s = T(0);
    for (int r = 0; r < n_opt; ++r) s += st[lay.rowg + r * kParams + tid];
    grad_out[lane * kParams + tid] = s;
  }
}

template <typename T>
int launch(const void* params, const void* spots, const void* strikes,
           const void* mats, const void* is_call, const void* mkt,
           const void* groups, const void* done, void* price_out,
           void* grad_out, double rate, double q, double L, int n_lanes,
           int n_opt, int n_terms, int mode, void* stream) {
  if (n_lanes <= 0 || n_opt <= 0 || n_terms <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t bytes = Layout(n_opt, n_terms).bytes<T>();
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        cos_vg_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  cos_vg_kernel<T><<<n_lanes, kThreads, bytes,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(params), static_cast<const T*>(spots),
      static_cast<const T*>(strikes), static_cast<const T*>(mats),
      static_cast<const unsigned char*>(is_call), static_cast<const T*>(mkt),
      static_cast<const int*>(groups),
      static_cast<const unsigned char*>(done), static_cast<T*>(price_out),
      static_cast<T*>(grad_out), static_cast<T>(rate), static_cast<T>(q),
      static_cast<T>(L), n_opt, n_terms, mode);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// params [L,13], spots [L], strikes/mats/is_call/mkt/price_out [L*n_opt],
// groups [L*n_opt] int32 labels (rows of a lane with equal labels must have
// equal maturities; ops/loss_kernel.py::maturity_groups), all row-major;
// done [L] bytes or nullptr: a lane whose byte is set is skipped, its rows
// left as they are; grad_out [L, 13] (mode 0, the lane's row sum: K2) or
// [L*n_opt, 13] (mode 1, every row: K3). Returns the launch's cudaError_t.
extern "C" int cos_vg_f32(const void* params, const void* spots,
                          const void* strikes, const void* mats,
                          const void* is_call, const void* mkt,
                          const void* groups, const void* done,
                          void* price_out, void* grad_out, double rate,
                          double q, double L, int n_lanes, int n_opt,
                          int n_terms, int mode, void* stream) {
  return launch<float>(params, spots, strikes, mats, is_call, mkt, groups,
                       done, price_out, grad_out, rate, q, L, n_lanes, n_opt,
                       n_terms, mode, stream);
}

extern "C" int cos_vg_f64(const void* params, const void* spots,
                          const void* strikes, const void* mats,
                          const void* is_call, const void* mkt,
                          const void* groups, const void* done,
                          void* price_out, void* grad_out, double rate,
                          double q, double L, int n_lanes, int n_opt,
                          int n_terms, int mode, void* stream) {
  return launch<double>(params, spots, strikes, mats, is_call, mkt, groups,
                        done, price_out, grad_out, rate, q, L, n_lanes, n_opt,
                        n_terms, mode, stream);
}
