// Front-to-back f32 blend of the tile-sorted pair stream.
//
// Replaces the TPU kernel gsrt/ops/splat_subtile.py:_blend_subtile_kernel
// (:49, reached through blend_subtiles): the exact exp or the reference's
// exp LUT, the skip-range or the 0 <= g <= g_cutoff accept rule, alpha
// clamp, the term_eps stop at chunk boundaries. Launched at 128x8-pixel
// tiles it also replaces gsrt/ops/splat_pallas.py:_blend_kernel (:65,
// blend_tiles), which computes the same function on those tiles (the JAX
// suite holds the two equal, tests/test_subtile_kernel.py).
//
// Contract. payload is [8, L] int32, row-major, float rows as their bits:
// 0 mean x, 1 mean y (pixels, image frame), 2-4 conic a, b, c,
// 5 pack15(r, g), 6 pack15(b, opacity) (bit 30 | u15 << 15 | u15, value =
// u15 * 4 / 32767); row 7 is not read. Tile t owns the contiguous columns
// [tile_start[t], tile_start[t + 1]), in depth order. Out: color [H, W, 3]
// and trans [H, W] float32, written straight to the framebuffer.
//
// Design. One block per tile, one thread per pixel (tile_w * tile_h <=
// 1024 threads). The block walks its segment in chunks of kChunk = 128
// pairs: the threads decode one pair each into shared memory,
// then every thread blends the chunk in order with its transmittance and
// colour in registers. Before each chunk the block stops if no pixel has
// trans > term_eps (__syncthreads_or): the backward kernel takes the same
// test at the same boundaries, so both agree on the last pair that
// counts. The TPU kernel grouped 8 subtiles per grid step, located each
// chunk's subtile with one-hot carries and fetched 128-aligned windows
// because of its block and DMA rules; a block here addresses its segment
// directly, so none of that remains.
//
// Bound. Operations: per (pixel, pair of its tile) 18 f32 operations, the
// exp among them, to decide whether the pixel takes the pair, and 9 more
// where it does; against 28 bytes per pair read once and 16 bytes per
// pixel written. The wrapper (gsrt_torch/ops/splat_subtile.py) checks shapes,
// types and devices; the entry point returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "blend_common.cuh"

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kChunk = 128;
constexpr float kInvQ = 4.0f / 32767.0f;  // pack15 step

__global__ void __launch_bounds__(kMaxThreads)
blend_subtile_kernel(const int* __restrict__ payload, long long L,
                     const int* __restrict__ tile_start, int ntx, int width,
                     int height, int tile_w, float g_cutoff,
                     int skip_range_check, float alpha_threshold,
                     float alpha_clamp, float term_eps, int use_lut,
                     float* __restrict__ color, float* __restrict__ trans) {
  __shared__ float s_mx[kChunk], s_my[kChunk], s_qa[kChunk], s_qb[kChunk],
      s_qc[kChunk], s_op[kChunk], s_r[kChunk], s_g[kChunk], s_b[kChunk];

  const int tile = blockIdx.x;
  const int tid = threadIdx.x;
  const int tile_h = blockDim.x / tile_w;
  const int x = (tile % ntx) * tile_w + tid % tile_w;
  const int y = (tile / ntx) * tile_h + tid / tile_w;
  const float px = (float)x, py = (float)y;

  const int start = tile_start[tile];
  const int end = tile_start[tile + 1];

  float T_ = 1.0f, cr = 0.0f, cg = 0.0f, cb = 0.0f;

  for (int c0 = start; c0 < end; c0 += kChunk) {
    // also the barrier that guards the shared arrays against the last
    // chunk's readers
    if (!__syncthreads_or(T_ > term_eps)) break;
    const int n = min(kChunk, end - c0);
    for (int j = tid; j < n; j += blockDim.x) {
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
    for (int i = 0; i < n; ++i) {
      const float dx = px - s_mx[i], dy = py - s_my[i];
      const float gq =
          gsrt::conic_response(s_qa[i], s_qb[i], s_qc[i], dx, dy);
      float alpha;
      if (gsrt::accept_alpha(gq, s_op[i], g_cutoff, skip_range_check,
                             alpha_threshold, alpha_clamp, use_lut != 0,
                             alpha)) {
        const float w = alpha * T_;
        cr += w * s_r[i];
        cg += w * s_g[i];
        cb += w * s_b[i];
        T_ *= 1.0f - alpha;
      }
    }
  }

  if (x < width && y < height) {
    const size_t pix = (size_t)y * width + x;
    trans[pix] = T_;
    color[3 * pix] = cr;
    color[3 * pix + 1] = cg;
    color[3 * pix + 2] = cb;
  }
}

}  // namespace

extern "C" {

int gsrt_blend_subtile(const int* payload, long long L,
                       const int* tile_start, int T, int ntx, int width,
                       int height, int tile_w, int tile_h, float g_cutoff,
                       int skip_range_check, float alpha_threshold,
                       float alpha_clamp, float term_eps, int use_lut,
                       float* color, float* trans, void* stream) {
  const int threads = tile_w * tile_h;
  if (threads % 32 != 0 || threads > kMaxThreads)
    return (int)cudaErrorInvalidValue;
  const cudaError_t fits =
      gsrt::check_block_fits(blend_subtile_kernel, threads);
  if (fits != cudaSuccess) return (int)fits;
  if (T > 0)
    blend_subtile_kernel<<<T, threads, 0, (cudaStream_t)stream>>>(
        payload, L, tile_start, ntx, width, height, tile_w, g_cutoff,
        skip_range_check, alpha_threshold, alpha_clamp, term_eps, use_lut,
        color, trans);
  return (int)cudaGetLastError();
}

const char* gsrt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
