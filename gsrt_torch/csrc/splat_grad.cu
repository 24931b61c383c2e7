// Backward of the f32 tile-stream blend: nine gradients per pair.
//
// Replaces the TPU kernel gsrt/ops/splat_grad.py:_blend_bwd_kernel (:60,
// reached through blend_backward): the exact exp or the reference's exp
// LUT (whose derivative is its segment's slope -e^{-x0}), both accept
// rules, the term_eps stop at chunk boundaries. At 128x8-pixel tiles it is
// the backward of the (128, 8) training path, 1024 threads a block: the
// entry point checks that a block of that size fits the compiled kernel
// (registers and shared memory, all static) and returns
// cudaErrorInvalidConfiguration when it does not.
//
// Contract. payload and tile_start are the forward's (see
// splat_subtile.cu). pixstate is [8, T * npx] float32, tile-major, npx =
// tile_w * tile_h pixels per tile in row-major order: rows 0-2 the
// forward's final colour C, 3 its final transmittance T_N, 4-6 the
// cotangent of C, 7 the cotangent of T_N; padding pixels past the image
// edge hold zeros. grad is [9, L] float32 and must arrive zeroed: rows
// d mean x, d mean y, d conic a, b, c, d opacity, d r, g, b, one column per
// payload column. Columns the walk never reaches (dead slots, pairs behind
// a tile's stop) stay zero.
//
// The math, per pixel and pair i in front-to-back order, with T_i the
// transmittance in front of i and P_i the colour blended up to and
// including i:
//   C = sum_i alpha_i T_i c_i        S_i = C - P_i   (behind i)
//   dL/dalpha_i = dC . (T_i c_i - S_i / (1 - alpha_i))
//                 - dT_N T_N / (1 - alpha_i)
//   dL/dc_i = dC alpha_i T_i
// dalpha is zero where the pair was not accepted or where op exp(-g)
// exceeded alpha_clamp; g is floored at 0 before the exp.
//
// Design. One block per tile, one thread per pixel; the walk and its stop
// are the forward's (chunks of kChunk = 128 pairs decoded into shared
// memory, __syncthreads_or(trans > term_eps) before each). Each pair's
// nine values are then summed over the block's pixels: a warp whose
// pixels all rejected the pair contributes zeros without reducing; the
// others reduce by shuffles, lane 0 leaves the warp's sums in shared
// memory, and after every kSub = 32 pairs the block adds the warps' sums
// in warp order and stores them. A tile-sorted stream gives each column
// to exactly one tile, so these are plain stores: no atomics, and the
// same bits on every run. The TPU kernel accumulated 128-aligned windows
// that overlap between tiles with a serialized read-modify-write through
// a zeros buffer aliased to its output; none of that remains.
//
// Bound. Operations: per (pixel, pair of its tile) 18 f32 operations, the
// exp among them, to decide whether the pixel took the pair, and 65 more
// where it did (the division and the nine sums over pixels among them);
// bytes: the pairs and 32 bytes per pixel read once, 36 bytes per pair
// written.
// Registers are the scarce resource (nine sums and the walk state per
// thread). The wrapper (gsrt_torch/ops/splat_grad.py) checks shapes,
// types and devices; the entry point returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "blend_common.cuh"

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kChunk = 128;
constexpr int kSub = 32;   // pairs per reduction batch
constexpr int kRows = 9;
constexpr float kInvQ = 4.0f / 32767.0f;  // pack15 step

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(0xffffffffu, v, d);
  return v;
}

__global__ void __launch_bounds__(kMaxThreads)
blend_bwd_kernel(const int* __restrict__ payload, long long L,
                 const int* __restrict__ tile_start,
                 const float* __restrict__ pixstate, long long npix_all,
                 int ntx, int tile_w, float g_cutoff, int skip_range_check,
                 float alpha_threshold, float alpha_clamp, float term_eps,
                 int use_lut, float* __restrict__ grad) {
  __shared__ float s_mx[kChunk], s_my[kChunk], s_qa[kChunk], s_qb[kChunk],
      s_qc[kChunk], s_op[kChunk], s_r[kChunk], s_g[kChunk], s_b[kChunk];
  __shared__ float s_part[kMaxWarps][kRows][kSub];

  const int tile = blockIdx.x;
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = nthreads >> 5;
  const int tile_h = nthreads / tile_w;
  const float px = (float)((tile % ntx) * tile_w + tid % tile_w);
  const float py = (float)((tile / ntx) * tile_h + tid / tile_w);

  const int start = tile_start[tile];
  const int end = tile_start[tile + 1];

  const float* ps = pixstate + (size_t)tile * nthreads + tid;
  const float cf_r = ps[0], cf_g = ps[npix_all], cf_b = ps[2 * npix_all];
  const float t_n = ps[3 * npix_all];
  const float dc_r = ps[4 * npix_all], dc_g = ps[5 * npix_all],
              dc_b = ps[6 * npix_all];
  const float dtn_tn = ps[7 * npix_all] * t_n;

  float T_ = 1.0f, p_r = 0.0f, p_g = 0.0f, p_b = 0.0f;

  for (int c0 = start; c0 < end; c0 += kChunk) {
    if (!__syncthreads_or(T_ > term_eps)) break;
    const int n = min(kChunk, end - c0);
    for (int j = tid; j < n; j += nthreads) {
      const int p = c0 + j;
      s_mx[j] = __int_as_float(__ldg(payload + p));
      s_my[j] = __int_as_float(__ldg(payload + L + p));
      s_qa[j] = __int_as_float(__ldg(payload + 2 * L + p));
      s_qb[j] = __int_as_float(__ldg(payload + 3 * L + p));
      s_qc[j] = __int_as_float(__ldg(payload + 4 * L + p));
      const int rg = __ldg(payload + 5 * L + p);
      const int bo = __ldg(payload + 6 * L + p);
      s_r[j] = (float)((rg >> 15) & 0x7FFF) * kInvQ;
      s_g[j] = (float)(rg & 0x7FFF) * kInvQ;
      s_b[j] = (float)((bo >> 15) & 0x7FFF) * kInvQ;
      s_op[j] = (float)(bo & 0x7FFF) * kInvQ;
    }
    __syncthreads();

    for (int b0 = 0; b0 < n; b0 += kSub) {
      const int nb = min(kSub, n - b0);
      for (int j = 0; j < nb; ++j) {
        const int i = b0 + j;
        const float qa = s_qa[i], qb = s_qb[i], qc = s_qc[i], op = s_op[i];
        const float dx = px - s_mx[i], dy = py - s_my[i];
        const float gq = gsrt::conic_response(qa, qb, qc, dx, dy);
        const float gq_c = fmaxf(gq, 0.0f);
        const float expg = use_lut ? gsrt::exp_neg_lut(gq_c) : expf(-gq_c);
        const float raw = op * expg;
        const bool accept =
            raw > alpha_threshold &&
            (skip_range_check || (gq >= 0.0f && gq <= g_cutoff));
        float v[kRows];
#pragma unroll
        for (int k = 0; k < kRows; ++k) v[k] = 0.0f;
        if (accept) {
          const float cr = s_r[i], cg = s_g[i], cb = s_b[i];
          const float alpha = fminf(raw, alpha_clamp);
          const float w = alpha * T_;
          p_r += w * cr;
          p_g += w * cg;
          p_b += w * cb;
          if (raw <= alpha_clamp) {
            const float inv_om = 1.0f / (1.0f - alpha);
            const float d_alpha =
                dc_r * (T_ * cr - (cf_r - p_r) * inv_om) +
                dc_g * (T_ * cg - (cf_g - p_g) * inv_om) +
                dc_b * (T_ * cb - (cf_b - p_b) * inv_om) - dtn_tn * inv_om;
            // d expg / d gq: -expg, or the LUT segment's slope
            const float dexp =
                use_lut ? -expf(-gsrt::lut_x0(gq_c)) : -expg;
            const float d_gq = d_alpha * op * dexp;
            v[0] = -d_gq * (qa * dx + qb * dy);
            v[1] = -d_gq * (qb * dx + qc * dy);
            v[2] = d_gq * (0.5f * dx * dx);
            v[3] = d_gq * (dx * dy);
            v[4] = d_gq * (0.5f * dy * dy);
            v[5] = d_alpha * expg;
          }
          v[6] = dc_r * w;
          v[7] = dc_g * w;
          v[8] = dc_b * w;
          T_ *= 1.0f - alpha;
        }
        // warp-uniform: a warp none of whose pixels took the pair adds 0
        if (__any_sync(0xffffffffu, accept)) {
#pragma unroll
          for (int k = 0; k < kRows; ++k) v[k] = warp_sum(v[k]);
        }
        if (lane == 0) {
#pragma unroll
          for (int k = 0; k < kRows; ++k) s_part[warp][k][j] = v[k];
        }
      }
      __syncthreads();
      for (int e = tid; e < kRows * nb; e += nthreads) {
        const int k = e / nb, j = e - k * nb;
        float sum = 0.0f;
        for (int w = 0; w < nwarps; ++w) sum += s_part[w][k][j];
        grad[(size_t)k * L + c0 + b0 + j] = sum;
      }
      __syncthreads();
    }
  }
}

}  // namespace

extern "C" {

int gsrt_blend_backward(const int* payload, long long L,
                        const int* tile_start, const float* pixstate, int T,
                        int ntx, int tile_w, int tile_h, float g_cutoff,
                        int skip_range_check, float alpha_threshold,
                        float alpha_clamp, float term_eps, int use_lut,
                        float* grad, void* stream) {
  const int threads = tile_w * tile_h;
  if (threads % 32 != 0 || threads > kMaxThreads)
    return (int)cudaErrorInvalidValue;
  const cudaError_t fits = gsrt::check_block_fits(blend_bwd_kernel, threads);
  if (fits != cudaSuccess) return (int)fits;
  if (T > 0)
    blend_bwd_kernel<<<T, threads, 0, (cudaStream_t)stream>>>(
        payload, L, tile_start, pixstate, (long long)T * threads, ntx,
        tile_w, g_cutoff, skip_range_check, alpha_threshold, alpha_clamp,
        term_eps, use_lut, grad);
  return (int)cudaGetLastError();
}

const char* gsrt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
