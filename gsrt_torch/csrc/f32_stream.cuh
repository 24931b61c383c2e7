// What the two kernels of the f32 tile stream share (splat_subtile.cu,
// the forward; splat_grad.cu, the backward): the walk's constants, the
// pair record they stage, where a thread's pixels sit and the warp cull.
//
// Walk. A block blends one tile's segment [tile_start[t], tile_start[t +
// 1]) in batches of kBatch = 32 pairs: warp 0 loads one column a lane,
// decodes it into a 48-byte record in shared memory (double-buffered) and
// loads the words of the batch after next while the block blends the
// current one, so a batch costs one block barrier. Only where a 128-pair
// chunk begins (every fourth batch) is that barrier __syncthreads_or(trans
// > term_eps), and the tile stops there when no pixel is above term_eps:
// the stop of the TPU kernels, taken by the forward and the backward
// alike, so that both agree on the last pair that counts.
//
// Pixels. A thread holds kPix pixels of one tile column, on consecutive
// rows (kPix a template argument: the forward takes 4, the backward 2):
// thread t has column t % tile_w and rows (t / tile_w) kPix + k. Its
// pixels share dx and the response's dx terms, their chains of
// transmittance are independent, and one read of a record serves all of
// them. Rows past the tile (tile_h not a multiple of kPix) are dead: they
// start at transmittance 0, so they neither keep a tile alive nor add
// anything. A warp's 32 threads cover the rows [ra, rb] and columns
// [ca, cb] of the tile (all its columns where the warp wraps a row).
//
// Warp cull. Before a warp blends a batch, each lane tests one pair: lb =
// max(fl(qr fl(dy²)), fl(qc fl(dx²))) with dy, dx the offsets of the
// warp's nearest row and column from the mean, qr = conic_row_factor(a, b,
// c), qc = conic_row_factor(c, b, a) (blend_common.cuh: each is a lower
// bound on the computed response over the whole row or column range). The
// warp skips the pairs whose lb > gs = skip_bound: no pixel of it could
// take them, so no output changes (the backward adds zeros for them). lb is
// never negative, so the skipped pairs have g > 0 and the backward's floor
// of g at 0 does not touch them. ops/splat_subtile.warp_cull is the plain
// version; a CPU test holds every skipped step to the accept rules.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "blend_common.cuh"

namespace gsrt {

constexpr int kBatch = 32;   // pairs a staged batch: a lane each
constexpr int kChunk = 128;  // pairs between two stop tests
                             // (ops/splat_subtile.KERNEL_CHUNK)
constexpr int kMaxPixels = 1024;   // pixels of the largest tile
constexpr unsigned kFull = 0xffffffffu;
constexpr float kInvQ = 4.0f / 32767.0f;   // pack15 step

// Threads a block of a tile_w x tile_h tile: kPix rows a thread, whole
// warps. 0 when the tile is not 32k pixels, at most 1024.
template <int kPix>
__host__ __device__ inline int block_threads(int tile_w, int tile_h) {
  const int npx = tile_w * tile_h;
  if (tile_w <= 0 || tile_h <= 0 || npx % 32 != 0 || npx > kMaxPixels)
    return 0;
  const int t = tile_w * ((tile_h + kPix - 1) / kPix);
  return (t + 31) / 32 * 32;
}

// A decoded pair: a = (mean x, mean y, conic a, conic b), b = (conic c,
// opacity, r, g), c = (blue, gs, qr, qc) (the warp cull's bounds).
struct __align__(16) Rec {
  float4 a, b, c;
};

struct Words {
  uint32_t w[7];
};

__device__ __forceinline__ void fetch(const int* __restrict__ pay,
                                      long long L, int col, Words& w) {
#pragma unroll
  for (int r = 0; r < 7; ++r) w.w[r] = (uint32_t)__ldg(pay + r * L + col);
}

template <int kRule>
__device__ __forceinline__ void decode(const Words& w, const Params& prm,
                                       Rec& r) {
  const float qa = __uint_as_float(w.w[2]), qb = __uint_as_float(w.w[3]),
              qc = __uint_as_float(w.w[4]);
  const int rg = (int)w.w[5], bo = (int)w.w[6];
  const float op = (float)(bo & 0x7FFF) * kInvQ;
  r.a = make_float4(__uint_as_float(w.w[0]), __uint_as_float(w.w[1]), qa,
                    qb);
  r.b = make_float4(qc, op, (float)((rg >> 15) & 0x7FFF) * kInvQ,
                    (float)(rg & 0x7FFF) * kInvQ);
  r.c = make_float4((float)((bo >> 15) & 0x7FFF) * kInvQ,
                    skip_bound<kRule>(op, prm), conic_row_factor(qa, qb, qc),
                    conic_row_factor(qc, qb, qa));
}

// This thread's pixels (image frame) and its warp's footprint.
struct Place {
  float px;          // column
  float py0;         // first row; pixel k is on row py0 + k
  int nvalid;        // pixels inside the tile
  float ra, rb, ca, cb;
};

template <int kPix>
__device__ __forceinline__ Place place(int tile, int ntx, int tile_w,
                                       int tile_h) {
  const int tid = threadIdx.x, t0 = tid & ~31;
  const float ox = (float)((tile % ntx) * tile_w),
              oy = (float)((tile / ntx) * tile_h);
  Place p;
  const int row0 = (tid / tile_w) * kPix;
  p.px = (float)(tid % tile_w) + ox;
  p.py0 = (float)row0 + oy;
  p.nvalid = max(0, min(kPix, tile_h - row0));
  p.ra = (float)min((t0 / tile_w) * kPix, tile_h - 1) + oy;
  p.rb = (float)min(((t0 + 31) / tile_w) * kPix + kPix - 1, tile_h - 1) + oy;
  const int c0 = t0 % tile_w;
  const bool wraps = c0 + 31 >= tile_w;
  p.ca = (float)(wraps ? 0 : c0) + ox;
  p.cb = (float)(wraps ? tile_w - 1 : c0 + 31) + ox;
  return p;
}

// The warp's ballot of the n pairs of a staged batch that some pixel of
// it may take (bit i: pair i).
__device__ __forceinline__ unsigned cull_ballot(const Rec* batch, int n,
                                                const Place& p) {
  const int lane = threadIdx.x & 31;
  bool live = lane < n;
  if (live) {
    const float4 A = batch[lane].a, C = batch[lane].c;
    const float dy = __fsub_rn(fminf(fmaxf(A.y, p.ra), p.rb), A.y);
    const float dx = __fsub_rn(fminf(fmaxf(A.x, p.ca), p.cb), A.x);
    const float lb = fmaxf(__fmul_rn(C.z, __fmul_rn(dy, dy)),
                           __fmul_rn(C.w, __fmul_rn(dx, dx)));
    live = !(lb > C.y);
  }
  return __ballot_sync(kFull, live);
}

// The response's terms that depend on dx alone, shared by a thread's
// pixels: g = fl(0.5 fl(fl(ta + fl(bx dy)) + fl(fl(c dy) dy))), which is
// conic_response(a, b, c, dx, dy) bit for bit.
struct Row {
  float ta, bx;
};

__device__ __forceinline__ Row response_row(float a, float b, float dx) {
  return Row{__fmul_rn(__fmul_rn(a, dx), dx),
             __fmul_rn(__fmul_rn(2.0f, b), dx)};
}

__device__ __forceinline__ float response_at(const Row& row, float c,
                                             float dy) {
  const float tb = __fmul_rn(row.bx, dy);
  const float tc = __fmul_rn(__fmul_rn(c, dy), dy);
  return __fmul_rn(0.5f, __fadd_rn(__fadd_rn(row.ta, tb), tc));
}

}  // namespace gsrt
