// Front-to-back EWA blend of the packed pair streams.
//
// Replaces the TPU kernel gsrt/ops/splat_packed.py:_blend_packed_kernel
// (:68) in three parts:
//   partition (part_*_kernel) — group_stream=True: a stable counting sort
//     of the group-contiguous compact stream by tile, writing an index list
//     `order` and per-tile segments `seg`, so that each tile's columns sit
//     at order[seg[t] .. seg[t + 1]) in payload (depth) order;
//   blend_group_kernel — group_stream=True: one block per tile blends the
//     columns of its own segment of `order`, and no others;
//   blend_tile_kernel — group_stream=False: the tile-sorted stream with
//     the compact or the f32 payload, the stream serving reads, with the
//     TPU kernel's chunk gate, its saturation map (track_consumed) and its
//     hit counts (track_hits).
// Both blends take the exact exp or the reference's exp LUT, and the
// skip-range or the 0 <= g <= g_cutoff accept rule (blend_common.cuh), as
// a template argument.
//
// Contract. The compact payload is [5, L] int32, row-major: 0 tile-relative
// two-tier u16 mean (x << 16 | y), 1 bf16 l11 | bf16 l21, 2 bf16 l22 |
// bf16 depth, 3 rgba8 (two-tier 8-bit colors, u8 opacity), 4 tile id. The
// f32 payload is [8, L] int32 holding float bits: 0 mean x, 1 mean y
// (image frame), 2-4 conic a, b, c, 5 pack15(r, g), 6 pack15(b, opacity).
// Out: color [H, W, 3] and trans [H, W] float32, hits [H, W] int32 where
// asked, written straight to the framebuffer; consumed [G * bs] int32.
//
// Partition. Group g (tiles [g0, g1)) owns the columns [tile_start[g0],
// tile_start[g1]); a column's key is its tile id clamped into [g0, g1), so
// that a stream clamped at max_pairs, or one whose ids stray, still gives
// every column of the range a segment. seg[t] = tile_start[g0] + the
// group's columns with key < t; seg[T] = tile_start[T]. On an unclamped
// stream seg equals tile_start. Three launches: per slice of kSlice
// columns of one group, a shared-memory histogram (count); per group, a
// scan over its slices and its tiles (scan); per slice again, a stable
// sort by tile in shared memory, each warp ranking its 512 columns with
// ballots, copied out as one contiguous run a tile (scatter). Bound:
// bytes, the tile ids read (twice) and order written.
//
// Batches and the stop. Both blends stage their pairs in batches of
// kBatch = 32 (ops/splat_packed.BATCH): warp 0 loads one column a lane,
// decodes it into a 48-byte record in shared memory (double-buffered) and
// issues the loads of the batch after next while the block blends the
// current one, so a batch costs one block barrier. The group blend stops
// before a batch of its own pairs when no pixel of the tile has trans >
// term_eps (__syncthreads_or, the barrier itself); the tile blend keeps
// the TPU kernel's chunk gate (below) and cuts chunks into batches.
//
// Row cull. Before a warp blends a batch, each lane tests one pair against
// the warp's pixel rows [ra, rb] (32 consecutive pixels of a tile):
// lb = the response's dy-term at the row nearest the mean, rounded as the
// response rounds it. Compact: g = fl(fl(t1²) + fl(t2²)) >= fl(t2²), and
// fl(t2²) grows with |fl(py - my)|, so lb = fl(fl(l22 dy)²) at the nearest
// row bounds every lane's g from below. f32: the computed conic response is
// at least 0.5 (c - b²/a) dy² (1 - eta) for a positive definite conic with
// |b| / sqrt(ac) < 0.999, eta covering its roundings (conic_row_factor).
// A pair is accepted nowhere once g > gs (skip_bound): the range rule's
// g_cutoff; alpha's rule ln(op / alpha_threshold) + 2^-10, the margin
// covering expf's and logf's errors; under the exp LUT one segment (1/32)
// more, since the LUT never exceeds expf at its segment's left edge. The
// warp skips the pairs whose lb > gs (a ballot, then the set bits in
// order): no pixel of the warp could take them, so no output changes.
//
// Tile stream. Each tile's pairs are one segment [tile_start[t],
// tile_start[t + 1]), so a block reads its own segment and needs no group
// scan. What has to match the TPU kernel exactly is where it stops. That
// kernel walks the group's pairs in chunks of cw columns from astart =
// floor(tile_start[g * bs] / cw) * cw and skips a chunk only when every
// tile present in it has max trans <= term_eps. On a tile-sorted stream
// the tiles present in a chunk that holds pairs of tile t are t, earlier
// tiles (only in t's first chunk, where t itself has trans 1) and later
// tiles, whose first chunk it is (trans 1 as well). So t's pairs in chunk
// j are blended iff t is unsaturated at j's start, or j is t's last chunk
// and the column right after t's segment lies inside j and belongs to a
// column of this group: a later tile of the group, or, in a last group
// padded past T, the dead columns whose sentinel tile id T is a padding
// column with trans 1. The block applies that rule per chunk. consumed[t]
// counts the group's chunk starts at which t's max trans is >= term_eps:
// the index after the chunk in which t saturated, else the group's chunk
// count (also every padding entry). hits count the pairs each pixel
// accepts in the chunks its tile blends.
//
// Bound. Operations: per (pixel, pair its tile blends) about 20 f32
// operations and one exp; bytes: 20 (compact) or 28 (f32) bytes per pair
// read once, 16 (20 with hits) bytes of output per pixel. The SASS loop
// of a (pixel, pair) holds more instructions than that, since nothing is
// fused into an FMA (below). The wrapper (gsrt_torch/ops/splat_packed.py)
// checks shapes, types and devices; each entry point returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "blend_common.cuh"

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kBatch = 32;          // pairs a staged batch: a lane each
constexpr int kSlice = 4096;        // partition: columns a slice
constexpr int kPartThreads = 256;   // partition: threads a slice block
constexpr int kPartWarps = kPartThreads / 32;
constexpr int kPerLane = kSlice / kPartThreads;
constexpr int kKeyBits = 9;
constexpr int kMaxGroup = 1 << kKeyBits;   // partition: tiles a group
constexpr float kRh = 0.7071067811865476f;  // folds the response's 1/2
constexpr float kInvQ = 4.0f / 32767.0f;    // pack15 step
constexpr unsigned kFull = 0xffffffffu;

using gsrt::conic_row_factor;
using gsrt::kRuleLut;
using gsrt::kRuleSkipRange;
using gsrt::make_params;
using gsrt::Params;
using gsrt::rule_of;
using gsrt::skip_bound;

// ---------------------------------------------------------------- partition

struct Slice {
  int g0, g1, c0, c1, index;
};

// Slice b of the numbering "each group's columns cut into kSlice pieces,
// group after group": its group's tiles and its columns. Every warp of the
// block computes it alike, 32 groups at a time. False past the last slice.
__device__ bool find_slice(int b, const int* __restrict__ ts, int T, int bs,
                           Slice& s) {
  const int lane = threadIdx.x & 31;
  const int G = (T + bs - 1) / bs;
  int base = 0;
  for (int g = 0; g < G; g += 32) {
    const int gg = g + lane;
    int n = 0;
    if (gg < G)
      n = (ts[min(gg * bs + bs, T)] - ts[gg * bs] + kSlice - 1) / kSlice;
    int incl = n;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += v;
    }
    const int total = __shfl_sync(kFull, incl, 31);
    if (b < base + total) {
      const unsigned hit = __ballot_sync(kFull, gg < G && b < base + incl);
      const int src = __ffs(hit) - 1;
      const int before = __shfl_sync(kFull, incl - n, src);
      s.g0 = (g + src) * bs;
      s.g1 = min(s.g0 + bs, T);
      const int a = ts[s.g0];
      s.c0 = a + (b - base - before) * kSlice;
      s.c1 = min(ts[s.g1], s.c0 + kSlice);
      s.index = b;
      return true;
    }
    base += total;
  }
  return false;
}

__device__ __forceinline__ int part_key(const int* __restrict__ tile_row,
                                        int p, const Slice& s) {
  return p < s.c1 ? min(max(__ldg(tile_row + p), s.g0), s.g1 - 1) - s.g0
                  : -1;
}

// Slices of the groups before g (find_slice's numbering), summed by the
// warp's lanes.
__device__ int slices_before(int g, const int* __restrict__ ts, int T,
                             int bs) {
  int n = 0;
  for (int h = threadIdx.x & 31; h < g; h += 32)
    n += (ts[min(h * bs + bs, T)] - ts[h * bs] + kSlice - 1) / kSlice;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) n += __shfl_xor_sync(kFull, n, o);
  return n;
}

__global__ void __launch_bounds__(kPartThreads)
part_count_kernel(const int* __restrict__ tile_row,
                  const int* __restrict__ ts, int T, int bs,
                  int* __restrict__ counts) {
  __shared__ int hist[kMaxGroup];
  Slice s;
  if (!find_slice(blockIdx.x, ts, T, bs, s)) return;
  const int nt = s.g1 - s.g0;
  for (int l = threadIdx.x; l < nt; l += blockDim.x) hist[l] = 0;
  int key[kPerLane];   // every load in flight before the first add
#pragma unroll
  for (int k = 0; k < kPerLane; ++k)
    key[k] = part_key(tile_row, s.c0 + k * kPartThreads + threadIdx.x, s);
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kPerLane; ++k)
    if (key[k] >= 0) atomicAdd(&hist[key[k]], 1);
  __syncthreads();
  for (int l = threadIdx.x; l < nt; l += blockDim.x)
    counts[(size_t)s.index * bs + l] = hist[l];
}

// One block per group, a thread per tile: counts[slice][tile] becomes the
// tile's columns in the group's earlier slices, seg the tiles' starts.
__global__ void part_scan_kernel(const int* __restrict__ ts, int T, int bs,
                                 int* __restrict__ counts,
                                 int* __restrict__ seg) {
  __shared__ int warp_sum[32];
  const int g = blockIdx.x, g0 = g * bs, g1 = min(g0 + bs, T);
  const int l = threadIdx.x, lane = l & 31, warp = l >> 5;
  const int sb = slices_before(g, ts, T, bs);
  const int a = ts[g0];
  const int ns = (ts[g1] - a + kSlice - 1) / kSlice;
  int run = 0;
  if (l < g1 - g0) {
    int* c = counts + (size_t)sb * bs + l;
#pragma unroll 4
    for (int j = 0; j < ns; ++j) {
      const int v = c[(size_t)j * bs];
      c[(size_t)j * bs] = run;
      run += v;
    }
  }
  int incl = run;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += v;
  }
  if (lane == 31) warp_sum[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int nw = blockDim.x >> 5;
    const int v = lane < nw ? warp_sum[lane] : 0;
    int x = v;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int u = __shfl_up_sync(kFull, x, o);
      if (lane >= o) x += u;
    }
    if (lane < nw) warp_sum[lane] = x - v;
  }
  __syncthreads();
  if (l < g1 - g0) seg[g0 + l] = a + warp_sum[warp] + incl - run;
  if (g1 == T && l == 0) seg[T] = ts[T];
}

// The lanes of the warp whose key equals this lane's (keys < 2^nbits, or
// -1 for none): one ballot a key bit, where __match_any_sync would cost a
// slow instruction a call.
__device__ __forceinline__ unsigned peers_of(int key, int nbits) {
  const bool valid = key >= 0;
  unsigned m = __ballot_sync(kFull, valid);
  m = valid ? m : ~m;
  for (int b = 0; b < nbits; ++b) {
    const bool bit = (key >> b) & 1;
    const unsigned v = __ballot_sync(kFull, bit);
    m &= bit ? v : ~v;
  }
  return m;
}

// Each warp owns 512 consecutive columns of the slice: it counts them per
// tile, the block turns the counts into places in a slice-local list
// sorted by tile (stable: warp after warp, lane after lane), the warp
// walks its columns again to fill it, and the block copies the list out,
// each tile's run of it contiguous in `order`.
__global__ void __launch_bounds__(kPartThreads)
part_scatter_kernel(const int* __restrict__ tile_row,
                    const int* __restrict__ ts, int T, int bs,
                    const int* __restrict__ counts,
                    const int* __restrict__ seg, int* __restrict__ order) {
  __shared__ int pos[kPartWarps][kMaxGroup];
  __shared__ int local_start[kMaxGroup], global_start[kMaxGroup];
  __shared__ int sorted[kSlice];   // (column - c0) << kKeyBits | key
  Slice s;
  if (!find_slice(blockIdx.x, ts, T, bs, s)) return;
  const int nt = s.g1 - s.g0;
  const int nbits = 32 - __clz(max(nt - 1, 1));
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int i = tid; i < kPartWarps * nt; i += kPartThreads)
    pos[i / nt][i % nt] = 0;
  const int w0 = s.c0 + warp * (kSlice / kPartWarps);
  const unsigned below = (1u << lane) - 1u;
  int key[kPerLane];   // every load in flight before the first ballot
#pragma unroll
  for (int k = 0; k < kPerLane; ++k)
    key[k] = part_key(tile_row, w0 + k * 32 + lane, s);
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kPerLane; ++k) {
    const unsigned peers = peers_of(key[k], nbits);
    if (key[k] >= 0 && (peers & below) == 0)
      pos[warp][key[k]] += __popc(peers);
    __syncwarp();
  }
  __syncthreads();
  // per tile: its columns in earlier warps, and its total in the slice
  for (int l = tid; l < nt; l += kPartThreads) {
    int run = 0;
    for (int w = 0; w < kPartWarps; ++w) {
      const int v = pos[w][l];
      pos[w][l] = run;
      run += v;
    }
    local_start[l] = run;
    global_start[l] = seg[s.g0 + l] + counts[(size_t)s.index * bs + l];
  }
  __syncthreads();
  if (warp == 0) {   // local_start: exclusive prefix of the totals
    int carry = 0;
    for (int l0 = 0; l0 < nt; l0 += 32) {
      const int v = l0 + lane < nt ? local_start[l0 + lane] : 0;
      int x = v;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int u = __shfl_up_sync(kFull, x, o);
        if (lane >= o) x += u;
      }
      if (l0 + lane < nt) local_start[l0 + lane] = carry + x - v;
      carry += __shfl_sync(kFull, x, 31);
    }
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kPerLane; ++k) {
    const unsigned peers = peers_of(key[k], nbits);
    int at = 0;
    if (key[k] >= 0) {
      at = pos[warp][key[k]];
      sorted[local_start[key[k]] + at + __popc(peers & below)] =
          (warp * (kSlice / kPartWarps) + k * 32 + lane) << kKeyBits |
          key[k];
    }
    __syncwarp();
    if (key[k] >= 0 && (peers & below) == 0)
      pos[warp][key[k]] = at + __popc(peers);
    __syncwarp();
  }
  __syncthreads();
  for (int i = tid; i < s.c1 - s.c0; i += kPartThreads) {
    const int e = sorted[i];
    const int l = e & ((1 << kKeyBits) - 1);
    order[global_start[l] + i - local_start[l]] = s.c0 + (e >> kKeyBits);
  }
}

// ---------------------------------------------------------------- blends

__device__ __forceinline__ float mean_axis(uint32_t w16) {
  float mag = (float)(w16 & 0x7FFFu);
  return (w16 & 0x8000u) ? mag * (1.0f / 8.0f) - 2048.0f
                         : mag * (1.0f / 256.0f) - 64.0f;
}

__device__ __forceinline__ float color8(uint32_t c8) {
  float mag = (float)(c8 & 0x7Fu);
  return (c8 & 0x80u) ? __fadd_rn(1.0f, __fmul_rn(mag, 3.0f / 127.0f))
                      : mag * (1.0f / 127.0f);
}

// A decoded pair: a = (mean x, mean y, q0, q1), b = (q2, opacity, r, g),
// c.x = blue. Compact: (q0, q1, q2) = (l11, l21, l22) with the response's
// 1/2 folded in, mean tile-relative; f32: the conic (a, b, c), mean in the
// image frame. Beside it the row cull's (mean y, row factor, gs, -).
struct __align__(16) Rec {
  float4 a, b, c;
};

struct Stage {
  Rec rec[2][kBatch];
  float4 cull[2][kBatch];
};

template <bool kCompact>
struct Words {
  uint32_t w[kCompact ? 4 : 7];
};

template <bool kCompact>
__device__ __forceinline__ void fetch(const int* __restrict__ pay,
                                      long long L, int col,
                                      Words<kCompact>& w) {
#pragma unroll
  for (int r = 0; r < (kCompact ? 4 : 7); ++r)
    w.w[r] = (uint32_t)__ldg(pay + r * L + col);
}

template <bool kCompact, int kRule>
__device__ __forceinline__ void decode(const Words<kCompact>& w,
                                       const Params& prm, Rec& r,
                                       float4& cull) {
  if (kCompact) {
    const float my = mean_axis(w.w[0] & 0xFFFFu);
    const float q2 = __uint_as_float(w.w[2] & 0xFFFF0000u) * kRh;
    const float op = (float)(w.w[3] & 0xFFu) * (1.0f / 255.0f);
    r.a = make_float4(mean_axis(w.w[0] >> 16), my,
                      __uint_as_float(w.w[1] & 0xFFFF0000u) * kRh,
                      __uint_as_float(w.w[1] << 16) * kRh);
    r.b = make_float4(q2, op, color8((w.w[3] >> 24) & 0xFFu),
                      color8((w.w[3] >> 16) & 0xFFu));
    r.c = make_float4(color8((w.w[3] >> 8) & 0xFFu), 0.0f, 0.0f, 0.0f);
    cull = make_float4(my, q2, skip_bound<kRule>(op, prm), 0.0f);
  } else {
    const float qa = __uint_as_float(w.w[2]), qb = __uint_as_float(w.w[3]),
                qc = __uint_as_float(w.w[4]);
    const int rg = (int)w.w[5], bo = (int)w.w[6];
    const float op = (float)(bo & 0x7FFF) * kInvQ;
    const float my = __uint_as_float(w.w[1]);
    r.a = make_float4(__uint_as_float(w.w[0]), my, qa, qb);
    r.b = make_float4(qc, op, (float)((rg >> 15) & 0x7FFF) * kInvQ,
                      (float)(rg & 0x7FFF) * kInvQ);
    r.c = make_float4((float)((bo >> 15) & 0x7FFF) * kInvQ, 0.0f, 0.0f,
                      0.0f);
    cull = make_float4(my, conic_row_factor(qa, qb, qc),
                       skip_bound<kRule>(op, prm), 0.0f);
  }
}

struct Pixel {
  float px, py;   // in the payload's frame
  float ra, rb;   // the warp's first and last pixel row, same frame
  float T_, cr, cg, cb;
  int hits;
};

// The response is rounded as written, in the plain version's order, with
// no FMA contraction: an accept test on the edge of alpha_threshold, or a
// g on the edge of an exp-LUT segment (the LUT steps there), must come out
// as in the plain version, or hit counts and LUT colours drift from it.
template <bool kCompact, int kRule>
__device__ __forceinline__ void blend_one(const Rec& r, const Params& prm,
                                          Pixel& p) {
  const float4 A = r.a, B = r.b;
  const float dx = p.px - A.x, dy = p.py - A.y;
  float g;
  if (kCompact) {
    const float t1 = __fadd_rn(__fmul_rn(A.z, dx), __fmul_rn(A.w, dy));
    const float t2 = __fmul_rn(B.x, dy);
    g = __fadd_rn(__fmul_rn(t1, t1), __fmul_rn(t2, t2));
  } else {
    g = gsrt::conic_response(A.z, A.w, B.x, dx, dy);
  }
  float alpha;
  if (gsrt::accept_alpha(g, B.y, prm.g_cutoff, kRule & kRuleSkipRange,
                         prm.alpha_threshold, prm.alpha_clamp,
                         (kRule & kRuleLut) != 0, alpha)) {
    const float w = alpha * p.T_;
    p.cr += w * B.z;
    p.cg += w * B.w;
    p.cb += w * r.c.x;
    p.T_ *= 1.0f - alpha;
    ++p.hits;
  }
}

// Blend the n pairs of one staged batch in order; lane i first tests pair
// i against the warp's rows, and the warp runs the pairs some pixel of it
// may take.
template <bool kCompact, int kRule>
__device__ __forceinline__ void blend_batch(const Stage& st, int slot, int n,
                                            const Params& prm, Pixel& p) {
  const int lane = threadIdx.x & 31;
  bool live = lane < n;
  if (live) {
    const float4 cu = st.cull[slot][lane];
    const float dy = __fsub_rn(fminf(fmaxf(cu.x, p.ra), p.rb), cu.x);
    float lb;
    if (kCompact) {
      const float t2 = __fmul_rn(cu.y, dy);
      lb = __fmul_rn(t2, t2);
    } else {
      lb = __fmul_rn(cu.y, __fmul_rn(dy, dy));
    }
    live = !(lb > cu.z);
  }
  unsigned m = __ballot_sync(kFull, live);
  while (m) {
    const int i = __ffs(m) - 1;
    m &= m - 1;
    blend_one<kCompact, kRule>(st.rec[slot][i], prm, p);
  }
}

__device__ __forceinline__ void store_pixel(int x, int y, int width,
                                            int height, const Pixel& p,
                                            float* __restrict__ color,
                                            float* __restrict__ trans,
                                            int* __restrict__ hit_map) {
  if (x < width && y < height) {
    const size_t pix = (size_t)y * width + x;
    trans[pix] = p.T_;
    color[3 * pix] = p.cr;
    color[3 * pix + 1] = p.cg;
    color[3 * pix + 2] = p.cb;
    if (hit_map) hit_map[pix] = p.hits;
  }
}

__device__ __forceinline__ Pixel make_pixel(int tile_w, float ox, float oy) {
  const int tid = threadIdx.x, warp = tid >> 5;
  Pixel p;
  p.px = (float)(tid % tile_w) + ox;
  p.py = (float)(tid / tile_w) + oy;
  p.ra = (float)(warp * 32 / tile_w) + oy;
  p.rb = (float)((warp * 32 + 31) / tile_w) + oy;
  p.T_ = 1.0f;
  p.cr = p.cg = p.cb = 0.0f;
  p.hits = 0;
  return p;
}

// One block per tile over its segment of `order`, batches of kBatch. Warp
// 0 holds the next batch's words and the batch after's columns in
// registers: at batch k it decodes batch k + 1 into the other buffer,
// issues batch k + 2's loads and batch k + 3's columns, then blends.
template <int kRule>
__global__ void __launch_bounds__(kMaxThreads)
blend_group_kernel(const int* __restrict__ payload, long long L,
                   const int* __restrict__ order,
                   const int* __restrict__ seg, int ntx, int width,
                   int height, int tile_w, Params prm,
                   float* __restrict__ color, float* __restrict__ trans,
                   int* __restrict__ hit_map) {
  __shared__ Stage st;
  const int tile = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tile_h = blockDim.x / tile_w;
  Pixel p = make_pixel(tile_w, 0.0f, 0.0f);
  const int lo = seg[tile], n = seg[tile + 1] - lo;
  const int nb = (n + kBatch - 1) / kBatch;
  const int* own = order + lo;

  Words<true> nxt;
  int col = -1;
  if (warp == 0 && nb > 0) {
    if (lane < n) {
      Words<true> w;
      fetch<true>(payload, L, __ldg(own + lane), w);
      decode<true, kRule>(w, prm, st.rec[0][lane], st.cull[0][lane]);
    }
    if (kBatch + lane < n) fetch<true>(payload, L, __ldg(own + kBatch + lane),
                                       nxt);
    if (2 * kBatch + lane < n) col = __ldg(own + 2 * kBatch + lane);
  }
  for (int k = 0; k < nb; ++k) {
    if (!__syncthreads_or(p.T_ > prm.term_eps)) break;
    const int slot = k & 1;
    if (warp == 0 && k + 1 < nb) {
      const int q = (k + 1) * kBatch + lane;
      if (q < n)
        decode<true, kRule>(nxt, prm, st.rec[slot ^ 1][lane],
                            st.cull[slot ^ 1][lane]);
      if (col >= 0) fetch<true>(payload, L, col, nxt);
      col = q + 2 * kBatch < n ? __ldg(own + q + 2 * kBatch) : -1;
    }
    blend_batch<true, kRule>(st, slot, min(kBatch, n - k * kBatch), prm, p);
  }
  store_pixel((tile % ntx) * tile_w + tid % tile_w,
              (tile / ntx) * tile_h + tid / tile_w, width, height, p, color,
              trans, hit_map);
}

template <bool kCompact, int kRule>
__global__ void __launch_bounds__(kMaxThreads)
blend_tile_kernel(const int* __restrict__ payload, long long L,
                  const int* __restrict__ tile_start, int T, int ntx, int bs,
                  int cw, int width, int height, int tile_w, Params prm,
                  float* __restrict__ color, float* __restrict__ trans,
                  int* __restrict__ hit_map, int* __restrict__ consumed) {
  __shared__ Stage st;
  const int tile = blockIdx.x;   // grid: every tile of every group, pads too
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g0 = (tile / bs) * bs;
  const int start_g = tile_start[g0];
  const int end_g = tile_start[min(g0 + bs, T)];
  const int astart = (start_g / cw) * cw;
  const int total_chunks = (end_g - astart + cw - 1) / cw;
  if (tile >= T) {                        // a padding column: never blends
    if (consumed && tid == 0) consumed[tile] = total_chunks;
    return;
  }

  const int tile_h = blockDim.x / tile_w;
  const int tx = tile % ntx, ty = tile / ntx;
  // compact means are tile-relative, f32 means in the image frame
  Pixel p = kCompact ? make_pixel(tile_w, 0.0f, 0.0f)
                     : make_pixel(tile_w, (float)(tx * tile_w),
                                  (float)(ty * tile_h));

  const int lo = tile_start[tile], hi = tile_start[tile + 1];
  int cons = total_chunks;

  if (hi > lo) {
    // a batch starts at c and ends at the chunk's end, hi or c + kBatch
    auto batch_end = [&](int c) {
      return min(min(c + kBatch, astart + ((c - astart) / cw + 1) * cw), hi);
    };
    const int jf = (lo - astart) / cw, jl = (hi - 1 - astart) / cw;
    // the column after the segment holds the gate of t's last chunk open
    const bool force_last =
        (hi - astart) % cw != 0 && (hi < end_g || g0 + bs > T);
    bool saturated = false;
    int slot = 0, staged = -1;   // the first column of the batch in `slot`
    Words<kCompact> nxt;         // warp 0: the words of the batch after it
    for (int j = jf; j <= jl; ++j) {
      const bool live = __syncthreads_or(p.T_ > prm.term_eps) != 0;
      if (live || (j == jl && force_last)) {
        const int c_lo = max(lo, astart + j * cw);
        const int c_hi = min(hi, astart + (j + 1) * cw);
        if (staged != c_lo) {   // the first chunk, or the last after a skip
          if (warp == 0) {
            if (c_lo + lane < batch_end(c_lo)) {
              Words<kCompact> w;
              fetch<kCompact>(payload, L, c_lo + lane, w);
              decode<kCompact, kRule>(w, prm, st.rec[slot][lane],
                                      st.cull[slot][lane]);
            }
            const int e = batch_end(c_lo);
            if (e + lane < batch_end(e) && e < hi)
              fetch<kCompact>(payload, L, e + lane, nxt);
          }
          staged = c_lo;
          __syncthreads();
        }
        for (int c = c_lo; c < c_hi;) {
          const int e = batch_end(c);
          if (c != c_lo) __syncthreads();
          if (warp == 0 && e < hi) {
            if (e + lane < batch_end(e))
              decode<kCompact, kRule>(nxt, prm, st.rec[slot ^ 1][lane],
                                      st.cull[slot ^ 1][lane]);
            const int e2 = batch_end(e);
            if (e2 < hi && e2 + lane < batch_end(e2))
              fetch<kCompact>(payload, L, e2 + lane, nxt);
          }
          blend_batch<kCompact, kRule>(st, slot, e - c, prm, p);
          slot ^= 1;
          staged = c = e;
        }
      }
      if (consumed && !saturated &&
          !__syncthreads_or(p.T_ >= prm.term_eps)) {
        saturated = true;
        cons = j + 1;
      }
    }
  }
  store_pixel(tx * tile_w + tid % tile_w, ty * tile_h + tid / tile_w, width,
              height, p, color, trans, hit_map);
  if (consumed && tid == 0) consumed[tile] = cons;
}

// the kernels of one stream, by rule: [rule]
using GroupFn = void (*)(const int*, long long, const int*, const int*, int,
                         int, int, int, Params, float*, float*, int*);
using TileFn = void (*)(const int*, long long, const int*, int, int, int,
                        int, int, int, int, Params, float*, float*, int*,
                        int*);
const GroupFn kGroup[4] = {blend_group_kernel<0>, blend_group_kernel<1>,
                           blend_group_kernel<2>, blend_group_kernel<3>};
const TileFn kTile[2][4] = {
    {blend_tile_kernel<false, 0>, blend_tile_kernel<false, 1>,
     blend_tile_kernel<false, 2>, blend_tile_kernel<false, 3>},
    {blend_tile_kernel<true, 0>, blend_tile_kernel<true, 1>,
     blend_tile_kernel<true, 2>, blend_tile_kernel<true, 3>}};

}  // namespace

extern "C" {

int gsrt_partition_group(const int* tile_row, const int* tile_start, int T,
                         int bs, int slice, int slices, int* counts,
                         int* seg, int* order, void* stream) {
  if (bs <= 0 || bs > kMaxGroup || slice != kSlice)
    return (int)cudaErrorInvalidValue;
  if (T <= 0) return (int)cudaGetLastError();
  const cudaStream_t s = (cudaStream_t)stream;
  const int G = (T + bs - 1) / bs;
  part_count_kernel<<<slices, kPartThreads, 0, s>>>(tile_row, tile_start, T,
                                                     bs, counts);
  part_scan_kernel<<<G, (bs + 31) / 32 * 32, 0, s>>>(tile_start, T, bs,
                                                      counts, seg);
  part_scatter_kernel<<<slices, kPartThreads, 0, s>>>(
      tile_row, tile_start, T, bs, counts, seg, order);
  return (int)cudaGetLastError();
}

int gsrt_blend_group(const int* payload, long long L, const int* order,
                     const int* seg, int T, int ntx, int batch, int width,
                     int height, int tile_w, int tile_h, float g_cutoff,
                     int skip_range_check, float alpha_threshold,
                     float alpha_clamp, float term_eps, int use_lut,
                     float* color, float* trans, int* hits, void* stream) {
  const int threads = tile_w * tile_h;
  if (threads % 32 != 0 || threads > kMaxThreads || batch != kBatch)
    return (int)cudaErrorInvalidValue;
  const Params prm = make_params(g_cutoff, alpha_threshold, alpha_clamp,
                                 term_eps);
  if (T > 0)
    kGroup[rule_of(skip_range_check, use_lut)]<<<T, threads, 0,
                                                 (cudaStream_t)stream>>>(
        payload, L, order, seg, ntx, width, height, tile_w, prm, color,
        trans, hits);
  return (int)cudaGetLastError();
}

int gsrt_blend_tile(const int* payload, long long L, int compact,
                    const int* tile_start, int T, int ntx, int bs, int chunk,
                    int batch, int width, int height, int tile_w, int tile_h,
                    float g_cutoff, int skip_range_check,
                    float alpha_threshold, float alpha_clamp, float term_eps,
                    int use_lut, float* color, float* trans, int* hits,
                    int* consumed, void* stream) {
  const int threads = tile_w * tile_h;
  if (threads % 32 != 0 || threads > kMaxThreads || bs <= 0 || chunk <= 0 ||
      batch != kBatch)
    return (int)cudaErrorInvalidValue;
  const Params prm = make_params(g_cutoff, alpha_threshold, alpha_clamp,
                                 term_eps);
  const int blocks = (T + bs - 1) / bs * bs;
  if (T > 0)
    kTile[compact != 0][rule_of(skip_range_check, use_lut)]<<<
        blocks, threads, 0, (cudaStream_t)stream>>>(
        payload, L, tile_start, T, ntx, bs, chunk, width, height, tile_w,
        prm, color, trans, hits, consumed);
  return (int)cudaGetLastError();
}

// Build facts of one blend kernel: kind 0 the group kernel, 1 the compact
// tile kernel, 2 the f32 tile kernel, under accept rule `rule` (bit 0
// skip_range_check, bit 1 the exp LUT); info = registers, static shared
// memory, 0 (no dynamic shared memory), local (spill) bytes, resident
// blocks of `threads`.
int gsrt_blend_info(int kind, int rule, int threads, int* info) {
  if (kind < 0 || kind > 2 || rule < 0 || rule > 3)
    return (int)cudaErrorInvalidValue;
  const void* fn = kind == 0 ? (const void*)kGroup[rule]
                             : (const void*)kTile[kind == 1][rule];
  return gsrt::kernel_info(fn, threads, info);
}

const char* gsrt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
