// Per-(pixel, pair) arithmetic shared by the blend kernels
// (splat_packed.cu, splat_subtile.cu, splat_grad.cu), and the bounds of
// their warp culls.
//
// exp_neg_lut is the JAX package's _exp_neg_lut (gsrt/ops/splat_pallas.py
// :36): the reference's 256-segment piecewise-linear exp(-x) on [0, 8],
// whose table entries (slope -e^{-x0}, intercept e^{-x0} at x0 = qx/32)
// are computed rather than gathered. qx truncates, as astype(int32) does.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

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

// Accept rules, a template argument of every blend kernel: bit 0
// skip_range_check, bit 1 the exp LUT.
constexpr int kRuleSkipRange = 1;
constexpr int kRuleLut = 2;
constexpr float kLutEnd = 255.0f / 32.0f;   // the LUT's last segment edge

struct Params {
  float g_cutoff;
  float alpha_threshold;
  float alpha_clamp;
  float term_eps;
  float log_margin;   // 2^-10 - ln(alpha_threshold)
};

inline Params make_params(float g_cutoff, float alpha_threshold,
                          float alpha_clamp, float term_eps) {
  return Params{g_cutoff, alpha_threshold, alpha_clamp, term_eps,
                (float)(0x1p-10 - log((double)alpha_threshold))};
}

inline int rule_of(int skip_range_check, int use_lut) {
  return (skip_range_check ? kRuleSkipRange : 0) | (use_lut ? kRuleLut : 0);
}

// The response above which the accept rule takes the pair at no pixel:
// the range rule's g_cutoff; alpha's rule ln(op / alpha_threshold) +
// 2^-10, the margin covering expf's and logf's errors; under the exp LUT
// one segment (1/32) more, since the LUT never exceeds expf at its
// segment's left edge. The backward floors g at 0 before the exp; a bound
// lb > gs is never negative (below), so the floor changes nothing there.
template <int kRule>
__device__ __forceinline__ float skip_bound(float op, const Params& prm) {
  float gs = logf(op) + prm.log_margin;
  if (kRule & kRuleLut) gs = gs < kLutEnd ? gs + 1.0f / 32.0f : INFINITY;
  if (!(kRule & kRuleSkipRange)) gs = fminf(gs, prm.g_cutoff);
  return gs;
}

// q >= 0 with conic_response(a, b, c, dx, dy) >= fl(q fl(dy dy)) for every
// dx, or NaN where no such bound is proven. The response's computed value
// is within 4.01 u (1 + rho) / (1 - rho) of its exact 0.5 Q, rho = |b| /
// sqrt(ac) (u = 2^-24), and Q >= (c - b²/a) dy²; the two roundings of the
// bound's own product add 2 u more. Taken in double, rounded down. The
// error bound is symmetric in (a, dx) and (c, dy), so
// conic_row_factor(c, b, a) bounds the response by fl(q fl(dx dx)).
__device__ __forceinline__ float conic_row_factor(float a, float b,
                                                  float c) {
  if (!(a > 0.0f && c > 0.0f)) return NAN;
  const double da = a, db = b, dc = c;
  const double rho = fabs(db) / sqrt(da * dc);
  if (!(rho < 0.999)) return NAN;
  const double u = 0x1p-24;
  const double eta = 8.0 * u * (1.0 + rho) / (1.0 - rho) + 4.0 * u;
  return __double2float_rd(0.5 * (dc - db * db / da) * (1.0 - eta));
}

// Build facts of a kernel instance: registers, static shared memory, 0 (no
// dynamic shared memory), local (spill) bytes, resident blocks of
// `threads`.
inline int kernel_info(const void* fn, int threads, int* info) {
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, fn);
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, threads,
                                                        0);
  if (err != cudaSuccess) return (int)err;
  info[0] = a.numRegs;
  info[1] = (int)a.sharedSizeBytes;
  info[2] = 0;
  info[3] = (int)a.localSizeBytes;
  info[4] = blocks;
  return 0;
}

}  // namespace gsrt
