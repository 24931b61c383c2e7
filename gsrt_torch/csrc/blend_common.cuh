// Per-(pixel, pair) arithmetic shared by the blend kernels
// (splat_packed.cu, splat_subtile.cu, splat_grad.cu).
//
// exp_neg_lut is the JAX package's _exp_neg_lut (gsrt/ops/splat_pallas.py
// :36): the reference's 256-segment piecewise-linear exp(-x) on [0, 8],
// whose table entries (slope -e^{-x0}, intercept e^{-x0} at x0 = qx/32)
// are computed rather than gathered. qx truncates, as astype(int32) does.

#pragma once

#include <cuda_runtime.h>

namespace gsrt {

// left edge of x's LUT segment: x0 = clamp(trunc(32 x), 0, 255) / 32
__device__ __forceinline__ float lut_x0(float x) {
  const int qx = min(max((int)(x * 32.0f), 0), 255);
  return (float)qx * (1.0f / 32.0f);
}

// rounded as written (no contraction into an FMA), as PyTorch and XLA
// round it, so the accept test agrees with theirs at alpha_threshold
__device__ __forceinline__ float exp_neg_lut(float x) {
  const float x0 = lut_x0(x);
  const float e0 = expf(-x0);
  return __fadd_rn(__fmul_rn(-e0, __fsub_rn(x, x0)), e0);
}

// g = 1/2 (a dx^2 + 2 b dx dy + c dy^2) of an f32 conic, rounded as
// written in PyTorch's order with no FMA contraction, so that the kernels
// and their plain versions agree at the edges that step: alpha_threshold
// (hit counts) and the exp LUT's segments.
__device__ __forceinline__ float conic_response(float a, float b, float c,
                                                float dx, float dy) {
  const float ta = __fmul_rn(__fmul_rn(a, dx), dx);
  const float tb = __fmul_rn(__fmul_rn(__fmul_rn(2.0f, b), dx), dy);
  const float tc = __fmul_rn(__fmul_rn(c, dy), dy);
  return __fmul_rn(0.5f, __fadd_rn(__fadd_rn(ta, tb), tc));
}

__device__ __forceinline__ float exp_neg(float x, bool use_lut) {
  return use_lut ? exp_neg_lut(x) : expf(-x);
}

// The forward's accept rule: alpha = min(op exp(-g), alpha_clamp), taken
// when alpha > alpha_threshold and, unless skip_range_check, 0 <= g <=
// g_cutoff (g is then exponentiated as 0 outside the range). Returns
// whether the pixel takes the pair; alpha is its opacity when it does.
__device__ __forceinline__ bool accept_alpha(float gq, float op,
                                             float g_cutoff,
                                             int skip_range_check,
                                             float alpha_threshold,
                                             float alpha_clamp, bool use_lut,
                                             float& alpha) {
  if (skip_range_check) {
    alpha = fminf(op * exp_neg(gq, use_lut), alpha_clamp);
    return alpha > alpha_threshold;
  }
  const bool in_range = gq >= 0.0f && gq <= g_cutoff;
  alpha = fminf(op * exp_neg(in_range ? gq : 0.0f, use_lut), alpha_clamp);
  return in_range && alpha > alpha_threshold;
}

// A block of `threads` threads fits the kernel: its register and static
// shared memory use leave room for one block on an SM.
template <typename Kernel>
__host__ inline cudaError_t check_block_fits(Kernel kernel, int threads) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  return threads <= attr.maxThreadsPerBlock ? cudaSuccess
                                            : cudaErrorInvalidConfiguration;
}

}  // namespace gsrt
