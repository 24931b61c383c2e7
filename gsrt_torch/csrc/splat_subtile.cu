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
// Design (f32_stream.cuh). One block per tile, kPix = 4 pixels of one
// column a thread (at most 256 threads a block). The block walks its
// segment in staged batches of 32 pairs, stops only where a 128-pair chunk
// begins, and each warp blends only the pairs its warp cull leaves (a
// ballot, then the set bits in order). A step reads the pair's record with
// three 16-byte shared loads for the thread's four pixels, which share the
// response's dx terms and blend as four independent chains. The kernel is
// instantiated per accept rule. The TPU kernel grouped 8 subtiles per grid
// step, located each chunk's subtile with one-hot carries and fetched
// 128-aligned windows because of its block and DMA rules; a block here
// addresses its segment directly, so none of that remains.
//
// Bound. Operations: per (pixel, pair of its tile) 18 f32 operations, the
// exp among them, to decide whether the pixel takes the pair, and 9 more
// where it does; against 28 bytes per pair read once and 16 bytes per
// pixel written. The response is rounded as written (no FMA), as the plain
// version rounds it. The wrapper (gsrt_torch/ops/splat_subtile.py) checks
// shapes, types and devices; the entry point returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "f32_stream.cuh"

namespace {

using namespace gsrt;

// pixels a thread (ops/splat_subtile.PIXELS_PER_THREAD)
constexpr int kPix = 4;
constexpr int kMaxBlock = kMaxPixels / kPix;

struct Pix {
  float T_[kPix], cr[kPix], cg[kPix], cb[kPix];
};

template <int kRule>
__device__ __forceinline__ void blend_pair(const Rec& r, const Params& prm,
                                           const Place& pl, Pix& s) {
  const float4 A = r.a, B = r.b;
  const Row row = response_row(A.z, A.w, pl.px - A.x);
#pragma unroll
  for (int k = 0; k < kPix; ++k) {
    const float g = response_at(row, B.x, pl.py0 + (float)k - A.y);
    float alpha;
    if (accept_alpha(g, B.y, prm.g_cutoff, kRule & kRuleSkipRange,
                     prm.alpha_threshold, prm.alpha_clamp,
                     (kRule & kRuleLut) != 0, alpha)) {
      const float w = alpha * s.T_[k];
      s.cr[k] += w * B.z;
      s.cg[k] += w * B.w;
      s.cb[k] += w * r.c.x;
      s.T_[k] *= 1.0f - alpha;
    }
  }
}

template <int kRule>
__global__ void __launch_bounds__(kMaxBlock)
subtile_fwd_kernel(const int* __restrict__ payload, long long L,
                   const int* __restrict__ tile_start, int ntx, int width,
                   int height, int tile_w, int tile_h, Params prm,
                   float* __restrict__ color, float* __restrict__ trans) {
  __shared__ Rec st[2][kBatch];
  const int tile = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const Place pl = place<kPix>(tile, ntx, tile_w, tile_h);
  Pix s;
#pragma unroll
  for (int k = 0; k < kPix; ++k) {
    s.T_[k] = k < pl.nvalid ? 1.0f : 0.0f;
    s.cr[k] = s.cg[k] = s.cb[k] = 0.0f;
  }

  const int lo = tile_start[tile], n = tile_start[tile + 1] - lo;
  const int nb = (n + kBatch - 1) / kBatch;
  Words nxt;   // warp 0: the words of the batch after the staged one
  if (warp == 0 && nb > 0) {
    if (lane < n) {
      Words w;
      fetch(payload, L, lo + lane, w);
      decode<kRule>(w, prm, st[0][lane]);
    }
    if (kBatch + lane < n) fetch(payload, L, lo + kBatch + lane, nxt);
  }
  for (int k = 0; k < nb; ++k) {
    if (k % (kChunk / kBatch) == 0) {
      bool live = false;
#pragma unroll
      for (int j = 0; j < kPix; ++j) live |= s.T_[j] > prm.term_eps;
      if (!__syncthreads_or(live)) break;
    } else {
      __syncthreads();
    }
    const int slot = k & 1;
    if (warp == 0 && k + 1 < nb) {
      const int q = (k + 1) * kBatch + lane;
      if (q < n) decode<kRule>(nxt, prm, st[slot ^ 1][lane]);
      if (q + kBatch < n) fetch(payload, L, lo + q + kBatch, nxt);
    }
    unsigned m = cull_ballot(st[slot], min(kBatch, n - k * kBatch), pl);
    while (m) {
      const int i = __ffs(m) - 1;
      m &= m - 1;
      blend_pair<kRule>(st[slot][i], prm, pl, s);
    }
  }

  const int x = (int)pl.px;
#pragma unroll
  for (int k = 0; k < kPix; ++k) {
    const int y = (int)pl.py0 + k;
    if (k < pl.nvalid && x < width && y < height) {
      const size_t pix = (size_t)y * width + x;
      trans[pix] = s.T_[k];
      color[3 * pix] = s.cr[k];
      color[3 * pix + 1] = s.cg[k];
      color[3 * pix + 2] = s.cb[k];
    }
  }
}

using Fn = void (*)(const int*, long long, const int*, int, int, int, int,
                    int, Params, float*, float*);
const Fn kFwd[4] = {subtile_fwd_kernel<0>, subtile_fwd_kernel<1>,
                    subtile_fwd_kernel<2>, subtile_fwd_kernel<3>};

}  // namespace

extern "C" {

int gsrt_blend_subtile(const int* payload, long long L,
                       const int* tile_start, int T, int ntx, int width,
                       int height, int tile_w, int tile_h, int chunk,
                       int pix, float g_cutoff, int skip_range_check,
                       float alpha_threshold, float alpha_clamp,
                       float term_eps, int use_lut, float* color,
                       float* trans, void* stream) {
  const int threads = gsrt::block_threads<kPix>(tile_w, tile_h);
  if (threads == 0 || chunk != gsrt::kChunk || pix != kPix)
    return (int)cudaErrorInvalidValue;
  const gsrt::Params prm =
      gsrt::make_params(g_cutoff, alpha_threshold, alpha_clamp, term_eps);
  if (T > 0)
    kFwd[gsrt::rule_of(skip_range_check, use_lut)]
        <<<T, threads, 0, (cudaStream_t)stream>>>(
            payload, L, tile_start, ntx, width, height, tile_w, tile_h, prm,
            color, trans);
  return (int)cudaGetLastError();
}

// Build facts of the instance a tile_w x tile_h launch under `rule` (bit 0
// skip_range_check, bit 1 the exp LUT) runs: registers, static shared
// memory, 0, spill bytes, resident blocks.
int gsrt_subtile_info(int rule, int tile_w, int tile_h, int* info) {
  const int threads = gsrt::block_threads<kPix>(tile_w, tile_h);
  if (rule < 0 || rule > 3 || threads == 0)
    return (int)cudaErrorInvalidValue;
  return gsrt::kernel_info((const void*)kFwd[rule], threads, info);
}

const char* gsrt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
