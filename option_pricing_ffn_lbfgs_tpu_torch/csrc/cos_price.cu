// K1: batched COS pricing of (surface, option) rows, float and double.
//
// Replaces option_pricing_ffn_lbfgs_tpu/ops/cos_pallas.py::
// price_surfaces_pallas (kernel body _kernel/_price_tile), which was float32
// only. On the calibration path K1<double> prices every LM polish residual
// and K1<float> reprices the search winner.
//
// What bounds it: transcendentals. Each row evaluates N COS terms, and each
// term costs two Heston factors (csqrt, 2 cdiv, cexp, clog: hypot, sqrt,
// exp, sincos, log, atan2) plus the jump factor (exp, sincos, cexp) and the
// payoff (2 sincos) -- roughly 25 special-function calls per term, against
// 60 bytes of input and 4-8 bytes of output per row. At float64 these run on
// the FP64 units, which is what the polish pays for its precision.
//
// Simple design: one warp per row; the 32 lanes stride over the N terms
// (N = 64 on the calibration path, 2 terms a lane), each lane recomputing
// the row's truncation range (a few exps, negligible against the terms),
// then a shuffle reduction. Parameters are read per surface as row / n_opt
// -- no per-row replication and no padding, which were TPU layout needs.
#include "cos_math.cuh"

namespace {

constexpr int kWarpsPerBlock = 4;

template <typename S>
__global__ void cos_price_kernel(const S* __restrict__ params,
                                 const S* __restrict__ spots,
                                 const S* __restrict__ strikes,
                                 const S* __restrict__ mats,
                                 const unsigned char* __restrict__ is_call,
                                 S* __restrict__ out, S rate, S q, S L,
                                 int n_rows, int n_opt, int n_terms) {
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= n_rows) return;  // whole warp leaves together
  const int surf = row / n_opt;
  S p[13];
#pragma unroll
  for (int i = 0; i < 13; ++i) p[i] = params[surf * 13 + i];
  const S tau = mats[row];
  S part = cosm::cos_series_share<S>(p, spots[surf], rate, q, strikes[row],
                                     tau, is_call[row] != 0, n_terms, L,
                                     lane, 32);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    part += __shfl_down_sync(0xffffffffu, part, off);
  if (lane == 0) out[row] = cosm::s_exp(-rate * tau) * part;
}

template <typename S>
int launch(const void* params, const void* spots, const void* strikes,
           const void* mats, const void* is_call, void* out, double rate,
           double q, double L, int n_rows, int n_opt, int n_terms,
           void* stream) {
  const int blocks = (n_rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  cos_price_kernel<S><<<blocks, 32 * kWarpsPerBlock, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const S*>(params), static_cast<const S*>(spots),
      static_cast<const S*>(strikes), static_cast<const S*>(mats),
      static_cast<const unsigned char*>(is_call), static_cast<S*>(out),
      static_cast<S>(rate), static_cast<S>(q), static_cast<S>(L), n_rows,
      n_opt, n_terms);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// params [B,13], spots [B], strikes/mats/is_call/out [B*n_opt] row-major;
// n_rows = B * n_opt. Returns the cudaError_t of the launch.
extern "C" int cos_price_f32(const void* params, const void* spots,
                             const void* strikes, const void* mats,
                             const void* is_call, void* out, double rate,
                             double q, double L, int n_rows, int n_opt,
                             int n_terms, void* stream) {
  return launch<float>(params, spots, strikes, mats, is_call, out, rate, q, L,
                       n_rows, n_opt, n_terms, stream);
}

extern "C" int cos_price_f64(const void* params, const void* spots,
                             const void* strikes, const void* mats,
                             const void* is_call, void* out, double rate,
                             double q, double L, int n_rows, int n_opt,
                             int n_terms, void* stream) {
  return launch<double>(params, spots, strikes, mats, is_call, out, rate, q,
                        L, n_rows, n_opt, n_terms, stream);
}
