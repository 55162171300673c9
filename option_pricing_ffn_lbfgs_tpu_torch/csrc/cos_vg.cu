// K2/K3: per-row COS price and weighted parameter gradient, float and double.
//
// Replaces option_pricing_ffn_lbfgs_tpu/ops/loss_pallas.py::
// _rows_price_and_grad (kernel body _kernel_vg), where the gradient was a
// jax.vjp traced inside the Pallas kernel. For each (lane, option) row it
// writes the price P and w * dP/dtheta for the 13 constrained parameters:
//   mode 0 (K2, the search's value-and-grad): w = 2 (P - mkt) / (mkt^2 n_opt),
//     the exact dLoss/dP of the relative-MSE loss;
//   mode 1 (K3, the LM Jacobian):             w = 1 / (mkt sqrt(n_opt)),
//     so the rows are the residual Jacobian d r_j / dtheta.
// The host (ops/loss_kernel.py) sums/assembles rows, adds the Feller terms,
// the transform chain rule and the sentinel.
//
// Two instantiations: float (cos_vg_f32: the float32 search, the hybrid
// refine and the polish Jacobian) and double (cos_vg_f64: the float64
// value-and-grad of calibrate_surface and hybrid_calibrate, which JAX ran as
// XLA autodiff of its loss, with no Pallas twin).
//
// What bounds it: the same ~25 special functions per COS term as K1, each
// now followed by the 13-tangent update of forward mode (a multiply-add per
// tangent for every operation), so it is about 14x K1's arithmetic, and the
// 13-wide dual numbers exceed the register file: ptxas spills them to local
// memory (L1-resident at this occupancy). The double dual is twice as wide
// again and runs on the FP64 units.
//
// Simple design: the formulas of cos_math.cuh instantiated with
// S = Dual<T, 13> -- forward mode with the 13 tangents in registers,
// seeded with the identity on the parameters. The tangent flows through the
// truncation range a, b into u_k = k pi / (b - a), so the range's parameter
// dependence is kept. One warp per row, lanes over the N terms, a shuffle
// reduction of the price and its 13 tangents, then the scale by w.
#include "cos_math.cuh"

namespace {

constexpr int kWarpsPerBlock = 4;
constexpr int kParams = 13;

template <typename T>
__global__ void cos_vg_kernel(const T* __restrict__ params,
                              const T* __restrict__ spots,
                              const T* __restrict__ strikes,
                              const T* __restrict__ mats,
                              const unsigned char* __restrict__ is_call,
                              const T* __restrict__ mkt,
                              T* __restrict__ price_out,
                              T* __restrict__ grad_out, T rate, T q, T L,
                              int n_rows, int n_opt, int n_terms, int mode) {
  using DT = cosm::Dual<T, kParams>;
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= n_rows) return;  // whole warp leaves together
  const int surf = row / n_opt;
  DT p[kParams];
#pragma unroll
  for (int i = 0; i < kParams; ++i) {
    p[i] = DT(params[surf * kParams + i]);
    p[i].d[i] = T(1);
  }
  const T tau = mats[row];
  DT part = cosm::cos_series_share<DT>(p, spots[surf], rate, q, strikes[row],
                                       tau, is_call[row] != 0, n_terms, L,
                                       lane, 32);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    part.v += __shfl_down_sync(0xffffffffu, part.v, off);
#pragma unroll
    for (int i = 0; i < kParams; ++i)
      part.d[i] += __shfl_down_sync(0xffffffffu, part.d[i], off);
  }
  if (lane != 0) return;
  const T disc = cosm::s_exp(-rate * tau);
  const T price = disc * part.v;
  const T m = mkt[row];
  const T w = mode == 0
      ? T(2) * (price - m) / (m * m * static_cast<T>(n_opt))
      : static_cast<T>(1.0 / sqrt(static_cast<double>(n_opt))) / m;
  price_out[row] = price;
  const T wd = w * disc;
#pragma unroll
  for (int i = 0; i < kParams; ++i)
    grad_out[row * kParams + i] = wd * part.d[i];
}

template <typename T>
int launch(const void* params, const void* spots, const void* strikes,
           const void* mats, const void* is_call, const void* mkt,
           void* price_out, void* grad_out, double rate, double q, double L,
           int n_rows, int n_opt, int n_terms, int mode, void* stream) {
  const int blocks = (n_rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  cos_vg_kernel<T><<<blocks, 32 * kWarpsPerBlock, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(params), static_cast<const T*>(spots),
      static_cast<const T*>(strikes), static_cast<const T*>(mats),
      static_cast<const unsigned char*>(is_call), static_cast<const T*>(mkt),
      static_cast<T*>(price_out), static_cast<T*>(grad_out),
      static_cast<T>(rate), static_cast<T>(q), static_cast<T>(L), n_rows,
      n_opt, n_terms, mode);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// params [L,13], spots [L], strikes/mats/is_call/mkt/price_out [L*n_opt],
// grad_out [L*n_opt, 13], all row-major; n_rows = L * n_opt; mode 0 = loss
// weights (K2), 1 = Jacobian weights (K3). Returns the launch's
// cudaError_t.
extern "C" int cos_vg_f32(const void* params, const void* spots,
                          const void* strikes, const void* mats,
                          const void* is_call, const void* mkt,
                          void* price_out, void* grad_out, double rate,
                          double q, double L, int n_rows, int n_opt,
                          int n_terms, int mode, void* stream) {
  return launch<float>(params, spots, strikes, mats, is_call, mkt, price_out,
                       grad_out, rate, q, L, n_rows, n_opt, n_terms, mode,
                       stream);
}

extern "C" int cos_vg_f64(const void* params, const void* spots,
                          const void* strikes, const void* mats,
                          const void* is_call, const void* mkt,
                          void* price_out, void* grad_out, double rate,
                          double q, double L, int n_rows, int n_opt,
                          int n_terms, int mode, void* stream) {
  return launch<double>(params, spots, strikes, mats, is_call, mkt, price_out,
                        grad_out, rate, q, L, n_rows, n_opt, n_terms, mode,
                        stream);
}
