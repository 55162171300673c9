// The calibration objective's parameter transform, for the fused trips of
// csrc/lbfgs_trip.cu (K4/K5) and csrc/lm_trip.cu (K6/K7): exp or tanh
// where the caller's masks say, identity elsewhere
// (calibration/transforms.py::transform), and its derivative taken from
// the parameter it gave (exp: the parameter itself, tanh: 1 - p^2, 1
// elsewhere: the bits of transform.py::dtransform_dx). exp and tanh are
// the libm calls PyTorch's CUDA kernels make, so a coordinate has the bits
// of torch.exp / torch.tanh on the card. Built with -fmad=false, as both
// trip files are.
#pragma once
#include <math.h>

namespace {

__device__ __forceinline__ float t_exp(float v) { return expf(v); }
__device__ __forceinline__ double t_exp(double v) { return exp(v); }
__device__ __forceinline__ float t_tanh(float v) { return tanhf(v); }
__device__ __forceinline__ double t_tanh(double v) { return tanh(v); }

// The transform's coordinate masks (bit c: coordinate c), from
// calibration/transforms.py through the caller.
struct Transform {
  unsigned exp_mask, tanh_mask;
};

// 0: exp, 1: tanh, 2: identity.
__device__ __forceinline__ int coord_kind(const Transform& tf, int c) {
  return ((tf.exp_mask >> c) & 1u) ? 0 : (((tf.tanh_mask >> c) & 1u) ? 1 : 2);
}

// transform(x) at coordinate c.
template <typename T>
__device__ __forceinline__ T transform_coord(const Transform& tf, int c,
                                             T x) {
  const int kind = coord_kind(tf, c);
  return kind == 0 ? t_exp(x) : (kind == 1 ? t_tanh(x) : x);
}

// d transform / dx at coordinate c, from p = transform(x) there.
template <typename T>
__device__ __forceinline__ T dtransform_coord(const Transform& tf, int c,
                                              T p) {
  const int kind = coord_kind(tf, c);
  return kind == 0 ? p : (kind == 1 ? T(1.0) - p * p : T(1.0));
}

}  // namespace
