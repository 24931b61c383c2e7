// Backward of the f32 tile-stream blend: nine gradients per pair.
//
// Replaces the TPU kernel gsrt/ops/splat_grad.py:_blend_bwd_kernel (:60,
// reached through blend_backward): the exact exp or the reference's exp
// LUT (whose derivative is its segment's slope -e^{-x0}), both accept
// rules, the term_eps stop at chunk boundaries. At 128x8-pixel tiles it is
// the backward of the (128, 8) training path.
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
// including i (the kernel carries S_i, from S = C down):
//   C = sum_i alpha_i T_i c_i        S_i = C - P_i   (behind i)
//   dL/dalpha_i = dC . (T_i c_i - S_i / (1 - alpha_i))
//                 - dT_N T_N / (1 - alpha_i)
//   dL/dc_i = dC alpha_i T_i
// dalpha is zero where the pair was not accepted or where op exp(-g)
// exceeded alpha_clamp; g is floored at 0 before the exp.
//
// Design. The walk, the pixels a thread holds (kPix = 2 of one column),
// the staged records, the stop at 128-pair chunks and the warp cull are the
// forward's (f32_stream.cuh). Each pair's nine values are summed over the
// block's pixels in three steps, in a fixed order:
//   1. a thread adds its own pixels' values in registers;
//   2. a warp sums kGroup = 8 pairs at once by a transposing reduction:
//      pairs 2i and 2i+1 are folded over lane bit 0 (the lane keeps one
//      pair's value, sends the other's to its partner and adds what it
//      gets back: one shuffle a row for two pairs), the results over lane
//      bit 1, then bit 2, so that lane l holds pair (l mod 8) summed over
//      its 8 lanes; two butterfly steps finish the warp. That is 9
//      shuffles a row for 8 pairs, where a butterfly a pair takes 40.
//      Lanes 0-7 leave the warp's sums in shared memory;
//   3. after each batch the block adds the warps' sums in warp order and
//      stores the batch's columns, coalesced, while the next batch blends
//      (double-buffered sums: one barrier a batch in all).
// A pair the warp cull skips adds zeros (no pixel of the warp took it). A
// tile-sorted stream gives each column to exactly one tile, so these are
// plain stores: no atomics, and the same bits on every run. The TPU kernel
// accumulated 128-aligned windows that overlap between tiles with a
// serialized read-modify-write through a zeros buffer aliased to its
// output; none of that remains.
//
// Bound. Operations: per (pixel, pair of its tile) 18 f32 operations, the
// exp among them, to decide whether the pixel took the pair, and 65 more
// where it did (the division and the nine sums over pixels among them);
// bytes: the pairs and 32 bytes per pixel read once, 36 bytes per pair
// written. The kernel is instantiated per accept rule; registers hold the
// nine sums, three levels of held partial sums and two pixels' state (four
// pixels a thread, as in the forward, measured slower here: more registers,
// fewer warps). The wrapper
// (gsrt_torch/ops/splat_grad.py) checks shapes, types and devices; the
// entry point returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "f32_stream.cuh"

namespace {

using namespace gsrt;

// pixels a thread (ops/splat_grad.PIXELS_PER_THREAD)
constexpr int kPix = 2;
constexpr int kMaxBlock = kMaxPixels / kPix;
constexpr int kRows = 9;
constexpr int kGroup = 8;       // pairs a transposing reduction sums
constexpr int kGroupBits = 3;   // log2(kGroup)
static_assert((1 << kGroupBits) == kGroup && kBatch % kGroup == 0,
              "kGroup is a power of two dividing the batch");

struct Pix {
  float T_;                      // transmittance in front of the pair
  float sr, sg, sb;              // S = C - P: the colour behind the pair
  float dc_r, dc_g, dc_b, dtn_tn;
};

// Adds the values of pair r (one record) at the thread's pixels to v.
template <int kRule>
__device__ __forceinline__ void pair_grads(const Rec& r, const Params& prm,
                                           const Place& pl, Pix (&s)[kPix],
                                           float (&v)[kRows]) {
  const float4 A = r.a, B = r.b;
  const float qa = A.z, qb = A.w, qc = B.x, op = B.y;
  const float dx = pl.px - A.x;
  const Row row = response_row(qa, qb, dx);
#pragma unroll
  for (int k = 0; k < kPix; ++k) {
    const float dy = pl.py0 + (float)k - A.y;
    const float gq = response_at(row, qc, dy);
    const float gq_c = fmaxf(gq, 0.0f);
    const float expg = (kRule & kRuleLut) ? exp_neg_lut(gq_c) : expf(-gq_c);
    const float raw = op * expg;
    const bool accept =
        raw > prm.alpha_threshold &&
        ((kRule & kRuleSkipRange) || (gq >= 0.0f && gq <= prm.g_cutoff));
    if (accept) {
      Pix& p = s[k];
      const float cr = B.z, cg = B.w, cb = r.c.x;
      const float alpha = fminf(raw, prm.alpha_clamp);
      const float w = alpha * p.T_;
      p.sr -= w * cr;
      p.sg -= w * cg;
      p.sb -= w * cb;
      if (raw <= prm.alpha_clamp) {
        // alpha <= alpha_clamp < 1: 1 - alpha is far from __fdividef's
        // range limits, and its two ulps stay far inside the tolerance
        const float inv_om = __fdividef(1.0f, 1.0f - alpha);
        const float d_alpha = p.dc_r * (p.T_ * cr - p.sr * inv_om) +
                              p.dc_g * (p.T_ * cg - p.sg * inv_om) +
                              p.dc_b * (p.T_ * cb - p.sb * inv_om) -
                              p.dtn_tn * inv_om;
        // d expg / d gq: -expg, or the LUT segment's slope
        const float dexp =
            (kRule & kRuleLut) ? -expf(-lut_x0(gq_c)) : -expg;
        const float d_gq = d_alpha * op * dexp;
        v[0] -= d_gq * (qa * dx + qb * dy);
        v[1] -= d_gq * (qb * dx + qc * dy);
        v[2] += d_gq * (0.5f * dx * dx);
        v[3] += d_gq * (dx * dy);
        v[4] += d_gq * (0.5f * dy * dy);
        v[5] += d_alpha * expg;
      }
      v[6] += p.dc_r * w;
      v[7] += p.dc_g * w;
      v[8] += p.dc_b * w;
      p.T_ *= 1.0f - alpha;
    }
  }
}

// One level of the transposing reduction: lo and hi hold two blocks of
// pairs, each lane's value standing for the pair its lower `bit` bits
// pick. The lane keeps the block its bit `bit` picks, sends the other to
// the lane across that bit and adds what comes back: lo then stands for the
// pair picked by the lower bit + 1 bits, summed over lanes twice as many.
__device__ __forceinline__ void fold(float (&lo)[kRows],
                                     const float (&hi)[kRows], int bit) {
  const bool up = (threadIdx.x >> bit) & 1;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const float send = up ? lo[r] : hi[r];
    const float keep = up ? hi[r] : lo[r];
    lo[r] = keep + __shfl_xor_sync(kFull, send, 1 << bit);
  }
}

// Pairs j0 .. j0 + kGroup - 1 of the staged batch: the warp's sums, pair
// j0 + l in lane l < kGroup, into part[row][j0 + l]. m: the warp's live
// pairs of the batch.
template <int kRule>
__device__ __forceinline__ void group_grads(const Rec* batch, int j0,
                                            unsigned m, const Params& prm,
                                            const Place& pl, Pix (&s)[kPix],
                                            float (*part)[kBatch]) {
  const int lane = threadIdx.x & 31;
  float held[kGroupBits > 0 ? kGroupBits : 1][kRows];
  float v[kRows];
#pragma unroll
  for (int j = 0; j < kGroup; ++j) {
#pragma unroll
    for (int r = 0; r < kRows; ++r) v[r] = 0.0f;
    if ((m >> (j0 + j)) & 1u) pair_grads<kRule>(batch[j0 + j], prm, pl, s, v);
    // carry up the levels, as a binary counter of the pairs done: level b
    // is reached when j's lower b bits are all set, and holds v when bit
    // b is clear (all compile-time, so held[] stays in registers)
#pragma unroll
    for (int b = 0; b < kGroupBits; ++b) {
      if (((j + 1) & ((1 << b) - 1)) != 0) continue;
      if ((j >> b) & 1) {
        fold(held[b], v, b);
#pragma unroll
        for (int r = 0; r < kRows; ++r) v[r] = held[b][r];
      } else {
#pragma unroll
        for (int r = 0; r < kRows; ++r) held[b][r] = v[r];
      }
    }
  }
#pragma unroll
  for (int b = kGroupBits; b < 5; ++b)
#pragma unroll
    for (int r = 0; r < kRows; ++r)
      v[r] += __shfl_xor_sync(kFull, v[r], 1 << b);
  if (lane < kGroup) {
#pragma unroll
    for (int r = 0; r < kRows; ++r) part[r][j0 + lane] = v[r];
  }
}

// The block's sums of one batch of n pairs (columns col0 ...): each
// warp's in warp order, stored to grad.
__device__ __forceinline__ void store_batch(float (*part)[kRows][kBatch],
                                            int nwarps, int n, int col0,
                                            long long L,
                                            float* __restrict__ grad) {
  for (int e = threadIdx.x; e < kRows * kBatch; e += blockDim.x) {
    const int r = e / kBatch, j = e % kBatch;
    if (j < n) {
      float sum = 0.0f;
      for (int w = 0; w < nwarps; ++w) sum += part[w][r][j];
      grad[(size_t)r * L + col0 + j] = sum;
    }
  }
}

template <int kRule>
__global__ void __launch_bounds__(kMaxBlock)
subtile_bwd_kernel(const int* __restrict__ payload, long long L,
                   const int* __restrict__ tile_start,
                   const float* __restrict__ pixstate, long long npix_all,
                   int ntx, int tile_w, int tile_h, Params prm,
                   float* __restrict__ grad) {
  __shared__ Rec st[2][kBatch];
  __shared__ float part[2][kMaxBlock / 32][kRows][kBatch];
  const int tile = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const Place pl = place<kPix>(tile, ntx, tile_w, tile_h);
  Pix s[kPix];
  const int col = threadIdx.x % tile_w;
  const int row0 = (threadIdx.x / tile_w) * kPix;
#pragma unroll
  for (int k = 0; k < kPix; ++k) {
    Pix& p = s[k];
    p.T_ = p.sr = p.sg = p.sb = 0.0f;
    p.dc_r = p.dc_g = p.dc_b = p.dtn_tn = 0.0f;
    if (k < pl.nvalid) {
      const float* ps = pixstate + (size_t)tile * tile_w * tile_h +
                        (size_t)(row0 + k) * tile_w + col;
      p.T_ = 1.0f;
      p.sr = ps[0];
      p.sg = ps[npix_all];
      p.sb = ps[2 * npix_all];
      p.dc_r = ps[4 * npix_all];
      p.dc_g = ps[5 * npix_all];
      p.dc_b = ps[6 * npix_all];
      p.dtn_tn = ps[7 * npix_all] * ps[3 * npix_all];
    }
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
  int k = 0;
  for (; k < nb; ++k) {
    if (k % (kChunk / kBatch) == 0) {
      bool live = false;
#pragma unroll
      for (int j = 0; j < kPix; ++j) live |= s[j].T_ > prm.term_eps;
      if (!__syncthreads_or(live)) break;
    } else {
      __syncthreads();
    }
    const int slot = k & 1;
    if (k > 0)
      store_batch(part[slot ^ 1], nwarps, kBatch, lo + (k - 1) * kBatch, L,
                  grad);
    if (warp == 0 && k + 1 < nb) {
      const int q = (k + 1) * kBatch + lane;
      if (q < n) decode<kRule>(nxt, prm, st[slot ^ 1][lane]);
      if (q + kBatch < n) fetch(payload, L, lo + q + kBatch, nxt);
    }
    const int nk = min(kBatch, n - k * kBatch);
    const unsigned m = cull_ballot(st[slot], nk, pl);
#pragma unroll 1
    for (int j0 = 0; j0 < nk; j0 += kGroup) {
      if ((m >> j0) & ((1u << kGroup) - 1u)) {
        group_grads<kRule>(st[slot], j0, m, prm, pl, s, part[slot][warp]);
      } else if (lane < kGroup) {
#pragma unroll
        for (int r = 0; r < kRows; ++r) part[slot][warp][r][j0 + lane] = 0.0f;
      }
    }
  }
  // the last batch blended: k - 1 (the stop's barrier, or this one, orders
  // its sums before the reads)
  __syncthreads();
  if (k > 0)
    store_batch(part[(k - 1) & 1], nwarps, min(kBatch, n - (k - 1) * kBatch),
                lo + (k - 1) * kBatch, L, grad);
}

using Fn = void (*)(const int*, long long, const int*, const float*,
                    long long, int, int, int, Params, float*);
const Fn kBwd[4] = {subtile_bwd_kernel<0>, subtile_bwd_kernel<1>,
                    subtile_bwd_kernel<2>, subtile_bwd_kernel<3>};

}  // namespace

extern "C" {

int gsrt_blend_backward(const int* payload, long long L,
                        const int* tile_start, const float* pixstate, int T,
                        int ntx, int tile_w, int tile_h, int chunk, int pix,
                        float g_cutoff, int skip_range_check,
                        float alpha_threshold, float alpha_clamp,
                        float term_eps, int use_lut, float* grad,
                        void* stream) {
  const int threads = gsrt::block_threads<kPix>(tile_w, tile_h);
  if (threads == 0 || chunk != gsrt::kChunk || pix != kPix)
    return (int)cudaErrorInvalidValue;
  const gsrt::Params prm =
      gsrt::make_params(g_cutoff, alpha_threshold, alpha_clamp, term_eps);
  if (T > 0)
    kBwd[gsrt::rule_of(skip_range_check, use_lut)]
        <<<T, threads, 0, (cudaStream_t)stream>>>(
            payload, L, tile_start, pixstate,
            (long long)T * tile_w * tile_h, ntx, tile_w, tile_h, prm, grad);
  return (int)cudaGetLastError();
}

// Build facts of the instance a tile_w x tile_h launch under `rule` runs
// (as gsrt_subtile_info).
int gsrt_grad_info(int rule, int tile_w, int tile_h, int* info) {
  const int threads = gsrt::block_threads<kPix>(tile_w, tile_h);
  if (rule < 0 || rule > 3 || threads == 0)
    return (int)cudaErrorInvalidValue;
  return gsrt::kernel_info((const void*)kBwd[rule], threads, info);
}

const char* gsrt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
