// The group-contiguous compact stream's binning (the group route of
// gsrt_torch/ops/tile_binning.py: build_tile_binning) in three launches
// around the depth sort and the two expands.
//
// Replaces no TPU kernel. The JAX package bins with jnp code that XLA
// fuses; the port's plain version of it (_build_group_stream_plain, with
// compute_tile_spans and tile_histogram) is the same composition run op by
// op, about two hundred PyTorch launches of packs, gathers by the depth
// order and by the unit permutation, scatter-adds, sums, scans, stacks and
// concatenations: on a 1080p view of 2.96M splats the card idles while the
// host enqueues them. The plain version stays the CPU's path and this
// chain's reference.
//
// The chain, on PyTorch's current stream (ops/tile_bin.py launches it):
//   bin_prep    one thread a splat, over as many blocks as are resident: the
//               tile spans and touched count as compute_tile_spans gives
//               them, the opacity mask, the depth key, the splat's units,
//               and its 8-word level-1 record (xy0g, w, -, mean x, mean y,
//               qab, qcd, rgba: one 32-byte row, so the gather below reads
//               one sector a splat). The corner marks of tile_histogram go
//               into a block-local copy of the (nty+1) x (ntx+1) grid in
//               shared memory, added to the device grid once a block; the
//               pair and unit totals are block sums. The last block to
//               finish takes both prefix sums of the grid, the counts,
//               tile_start with its clamp, and the overflow flag.
//   (torch.argsort of the key: the plain version's call)
//   bin_gather  one thread a sorted position: the record by the depth
//               order, the units scanned into ubase in the same pass (a
//               decoupled look-back over blocks), tab1 [8, n]; each
//               splat's units that fit the unit buffer added to their
//               groups' counts and pairs, whose exclusive sums the last
//               block takes: each group's first unit slot and first pair.
//   (expand_pairs_fused: splats -> units, csrc/pair_expand.cu)
//   bin_units   a tile of 1024 consecutive unit slots a block: each unit's
//               group, rows and pairs (the key), a stable sort of the
//               tile by key in shared memory (cub::BlockRadixSort), and a
//               decoupled look-back a key over the tiles before (a thread
//               a key); a unit's place is its group's first slot + that
//               key's units in earlier tiles + its rank in the tile, and
//               tab2 [7, max_units] is written there, a key's run of
//               places at a time.
//   (expand_pairs_binned: units -> the compact payload)
// The unit sort is thus a stable counting sort on the group id (at most
// nty + 1 keys; 35 at 1080p) in one pass, the plain version's
// torch.sort(stable=True) of the group ids and its gathers by perm.
//
// Arithmetic. Integer work, bit-equal to the plain version on the card,
// but for the float ops of the spans, the Cholesky factor and the packs,
// each rounded on its own as PyTorch's CUDA ops round it (no FMA
// contraction: __fmul_rn, __fadd_rn, __fsub_rn, __fdiv_rn, __fsqrt_rn): a
// tensor divided by a host scalar is the product with the scalar's float
// reciprocal, clamp and clamp_min keep NaN, round is rintf (half to even),
// a float becomes an int by truncation (NaN gives 0), a float becomes
// bf16 by __float2bfloat16 (round to nearest even, as c10::BFloat16 on
// sm_80 and later), and a Python float constant is rounded to float32.
// Integer sums wrap as int32 sums do, but for a key's units and pairs
// over tiles, which travel in 31 bits each (fewer than 2^31 pairs); the
// counting sort's order is the stable sort's.
//
// Bound. Bytes: bin_prep reads 12 float columns and a mask (49 B a splat)
// and writes the key and the record (36 B); bin_gather reads the order
// (8 B) and a record (32 B) and writes tab1 (32 B) a splat; bin_units
// reads the 8 rows of a unit slot and writes 7 (60 B). There is no
// arithmetic to speak of.
//
// Each entry point returns cudaGetLastError() of its launch; the wrapper
// checks shapes, types and devices and lays out the workspace.

#include <cub/block/block_radix_sort.cuh>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kDead = 1 << 30;        // base of a source that emits nothing
constexpr int kPrepThreads = 1024;
constexpr int kGatherThreads = 1024;
constexpr int kSmemDefault = 48 * 1024;
constexpr int kSmemMax = 227 * 1024;
constexpr unsigned kFull = 0xFFFFFFFFu;

// Python float constants as the plain version rounds them
#define F32(x) static_cast<float>(x)

// --- PyTorch's CUDA rounding of the plain version's ops ---

// torch.clamp(v, lo, hi) and clamp_min on a float tensor: NaN stays NaN
__device__ __forceinline__ float clampf(float v, float lo, float hi) {
  return v != v ? v : fminf(fmaxf(v, lo), hi);
}
__device__ __forceinline__ float clamp_minf(float v, float lo) {
  return v != v ? v : fmaxf(v, lo);
}
// a float tensor cast to int32: truncation, NaN -> 0
__device__ __forceinline__ int to_i32(float v) { return __float2int_rz(v); }

// compute_tile_spans' tile of one footprint edge
__device__ __forceinline__ int tile_of(float v, float inv, int hi) {
  return to_i32(clampf(floorf(__fmul_rn(v, inv)), 0.0f, (float)hi));
}

// _bf16_bits: round to nearest even, the 16 bits
__device__ __forceinline__ unsigned bf16_bits(float x) {
  return (unsigned)__bfloat16_as_ushort(__float2bfloat16(x));
}

// _pack_color8: two-tier 8-bit colour
__device__ __forceinline__ unsigned color8(float c) {
  const int fine = to_i32(clampf(rintf(__fmul_rn(c, 127.0f)), 0.0f, 127.0f));
  const int coarse =
      to_i32(clampf(rintf(__fmul_rn(__fsub_rn(c, 1.0f), F32(127.0 / 3.0))),
                    0.0f, 127.0f)) |
      0x80;
  return (unsigned)(c <= 1.0f ? fine : coarse);
}

// --- scans ---

__device__ __forceinline__ unsigned warp_incl(unsigned v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned t = __shfl_up_sync(kFull, v, o);
    if (lane >= o) v += t;
  }
  return v;
}

__device__ __forceinline__ unsigned warp_sum(unsigned v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// The exclusive prefix of v over the block's threads in order; the
// block's total in *total. s_warp holds 33 words; every thread calls it.
__device__ unsigned block_excl(unsigned v, unsigned* s_warp,
                               unsigned* total) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  const unsigned incl = warp_incl(v);
  if (lane == 31) s_warp[w] = incl;
  __syncthreads();
  if (w == 0) {
    const unsigned x = lane < nw ? s_warp[lane] : 0u;
    const unsigned xi = warp_incl(x);
    if (lane < nw) s_warp[lane] = xi - x;
    if (lane == 31) s_warp[32] = xi;
  }
  __syncthreads();
  const unsigned r = s_warp[w] + incl - v;
  *total = s_warp[32];
  __syncthreads();
  return r;
}

__device__ __forceinline__ unsigned long long ld_volatile(
    const unsigned long long* p) {
  return *reinterpret_cast<const volatile unsigned long long*>(p);
}

// A block's exclusive prefix by decoupled look-back over a status word a
// block: flag (1 the block's own sum, 2 its inclusive prefix) in the high
// half, the int32 sum in the low half, so one 64-bit access carries both.
// Warp 0 of the block calls it with the block's sum; blocks take their
// ids in launch order (a ticket), so every predecessor runs or has run.
constexpr unsigned long long kAggregate = 1ull << 32, kPrefix = 2ull << 32;

__device__ unsigned look_back(unsigned long long* status, int bid,
                              unsigned aggregate) {
  const int lane = threadIdx.x & 31;
  volatile unsigned long long* st =
      reinterpret_cast<volatile unsigned long long*>(status);
  if (bid == 0) {
    if (lane == 0) st[0] = kPrefix | aggregate;
    return 0u;
  }
  if (lane == 0) st[bid] = kAggregate | aggregate;
  unsigned excl = 0;
  int idx = bid - 1;
  while (true) {
    const int j = idx - lane;  // lane 0 the nearest predecessor
    unsigned long long s = j >= 0 ? ld_volatile(status + j) : kPrefix;
    while (__any_sync(kFull, (s >> 32) == 0))
      if ((s >> 32) == 0) s = ld_volatile(status + j);
    const unsigned done = __ballot_sync(kFull, (s >> 32) == 2);
    if (done) {
      const int first = __ffs(done) - 1;
      excl += warp_sum(lane <= first ? (unsigned)s : 0u);
      break;
    }
    excl += warp_sum((unsigned)s);
    idx -= 32;
  }
  if (lane == 0) st[bid] = kPrefix | (unsigned)(excl + aggregate);
  return excl;
}

// --- bin_prep ---

struct Prep {
  const float *depth, *m2x, *m2y, *qa, *qb, *qc, *opacity, *cr, *cg, *cb,
      *rx, *ry;
  const unsigned char* alive;  // [n] bool
  const unsigned char* keep;   // [n] bool, or null
  int n, width, height, tile_w, tile_h, ntx, nty, k, max_pairs, max_units;
  int* grid;        // [(nty + 1) * (ntx + 1)] corner marks, zeroed
  unsigned* sums;   // [3] zeroed: pairs, units, blocks done
  float* key;       // [n]
  int4* rec;        // [n, 2]: the 8-word records
  int* tile_start;  // [T + 1]
  int* counts;      // [T]
  int* scalars;     // [3]: total, min(total, max_pairs), units_total
  bool* overflow;   // [1]
};

// The last block: both prefix sums of the corner grid g (shared memory,
// or the device grid itself), the counts, tile_start clamped at
// min(total, max_pairs), the scalars and the overflow flag.
__device__ void prep_finish(const Prep& p, int* g, unsigned* s_warp) {
  const int row = p.ntx + 1, T = p.ntx * p.nty;
  const int total = (int)__ldcg(p.sums), units = (int)__ldcg(p.sums + 1);
  for (int x = threadIdx.x; x < p.ntx; x += blockDim.x) {
    unsigned acc = 0;
    for (int y = 0; y < p.nty; ++y) {
      acc += (unsigned)g[y * row + x];
      g[y * row + x] = (int)acc;
    }
  }
  __syncthreads();
  for (int y = threadIdx.x; y < p.nty; y += blockDim.x) {
    unsigned acc = 0;
    for (int x = 0; x < p.ntx; ++x) {
      acc += (unsigned)g[y * row + x];
      p.counts[y * p.ntx + x] = (int)acc;
    }
  }
  __syncthreads();
  // tile_start: a contiguous chunk of the counts a thread
  const int per = (T + blockDim.x - 1) / blockDim.x;
  const int c0 = min((int)threadIdx.x * per, T), c1 = min(c0 + per, T);
  unsigned mine = 0;
  for (int c = c0; c < c1; ++c) mine += (unsigned)p.counts[c];
  unsigned all;
  unsigned acc = block_excl(mine, s_warp, &all);
  const int cap = min(total, p.max_pairs);
  for (int c = c0; c < c1; ++c) {
    acc += (unsigned)p.counts[c];
    p.tile_start[c + 1] = min((int)acc, cap);
  }
  if (threadIdx.x == 0) {
    p.tile_start[0] = min(0, cap);
    p.scalars[0] = total;
    p.scalars[1] = cap;
    p.scalars[2] = units;
    p.overflow[0] = total > p.max_pairs || units > p.max_units;
  }
}

template <bool kSharedGrid>
__global__ void __launch_bounds__(kPrepThreads) bin_prep_kernel(const Prep p) {
  extern __shared__ int s_grid[];
  __shared__ unsigned s_warp[33];
  __shared__ bool s_last;
  const int row = p.ntx + 1, cells = (p.nty + 1) * row;
  int* grid = kSharedGrid ? s_grid : p.grid;
  if (kSharedGrid) {
    for (int c = threadIdx.x; c < cells; c += blockDim.x) s_grid[c] = 0;
    __syncthreads();
  }
  // PyTorch divides a CUDA tensor by a host scalar as the product with
  // the scalar's reciprocal
  const float inv_w = __fdiv_rn(1.0f, (float)p.tile_w);
  const float inv_h = __fdiv_rn(1.0f, (float)p.tile_h);
  const float fw = (float)p.width, fh = (float)p.height;
  unsigned pairs = 0, units = 0;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < p.n;
       i += gridDim.x * blockDim.x) {
    // compute_tile_spans
    const float cx = __ldg(p.m2x + i), cy = __ldg(p.m2y + i);
    const float rx = __ldg(p.rx + i), ry = __ldg(p.ry + i);
    const float xlo = __fsub_rn(cx, rx), xhi = __fadd_rn(cx, rx);
    const float ylo = __fsub_rn(cy, ry), yhi = __fadd_rn(cy, ry);
    const int x0 = tile_of(xlo, inv_w, p.ntx - 1);
    const int x1 = tile_of(xhi, inv_w, p.ntx - 1);
    const int y0 = tile_of(ylo, inv_h, p.nty - 1);
    const int y1 = tile_of(yhi, inv_h, p.nty - 1);
    const bool alive = __ldg(p.alive + i) != 0;
    const bool on_screen = xhi >= 0.0f && xlo < fw && yhi >= 0.0f && ylo < fh;
    int touched = alive && on_screen && rx > 0.0f && ry > 0.0f
                      ? (x1 - x0 + 1) * (y1 - y0 + 1)
                      : 0;
    if (p.keep != nullptr && __ldg(p.keep + i) == 0) touched = 0;
    const bool live = touched > 0;
    const int rows = live ? y1 - y0 + 1 : 0;
    const int un = live ? y1 / p.k - y0 / p.k + 1 : 0;
    if (live) {  // tile_histogram's corner marks
      atomicAdd(grid + y0 * row + x0, 1);
      atomicAdd(grid + y0 * row + x1 + 1, -1);
      atomicAdd(grid + (y1 + 1) * row + x0, -1);
      atomicAdd(grid + (y1 + 1) * row + x1 + 1, 1);
    }
    pairs += (unsigned)touched;
    units += (unsigned)un;

    // the level-1 record: conic_cholesky, then the packs
    const float l11 = __fsqrt_rn(clamp_minf(__ldg(p.qa + i), F32(1e-12)));
    const float l21 = __fdiv_rn(__ldg(p.qb + i), clamp_minf(l11, F32(1e-12)));
    const float l22 = __fsqrt_rn(clamp_minf(
        __fsub_rn(__ldg(p.qc + i), __fmul_rn(l21, l21)), F32(1e-12)));
    const float depth = __ldg(p.depth + i);
    const float op = alive ? __ldg(p.opacity + i) : 0.0f;
    const unsigned oi =
        (unsigned)to_i32(clampf(rintf(__fmul_rn(op, 255.0f)), 0.0f, 255.0f));
    const unsigned rgba = (color8(__ldg(p.cr + i)) << 24) |
                          (color8(__ldg(p.cg + i)) << 16) |
                          (color8(__ldg(p.cb + i)) << 8) | oi;
    const unsigned xy0g =
        (unsigned)x0 | ((unsigned)y0 << 7) | ((unsigned)rows << 19);
    p.key[i] = live ? depth : INFINITY;
    p.rec[2 * (size_t)i] =
        make_int4((int)xy0g, live ? x1 - x0 + 1 : 1, 0, __float_as_int(cx));
    p.rec[2 * (size_t)i + 1] = make_int4(
        __float_as_int(cy), (int)((bf16_bits(l11) << 16) | bf16_bits(l21)),
        (int)((bf16_bits(l22) << 16) | bf16_bits(depth)), (int)rgba);
  }

  unsigned t;
  block_excl(pairs, s_warp, &t);
  const unsigned block_pairs = t;
  block_excl(units, s_warp, &t);
  if (threadIdx.x == 0) {
    atomicAdd(p.sums, block_pairs);
    atomicAdd(p.sums + 1, t);
  }
  if (kSharedGrid) {
    __syncthreads();
    for (int c = threadIdx.x; c < cells; c += blockDim.x) {
      const int v = s_grid[c];
      if (v != 0) atomicAdd(p.grid + c, v);
    }
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    s_last = atomicAdd(p.sums + 2, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  if (kSharedGrid) {
    for (int c = threadIdx.x; c < cells; c += blockDim.x)
      s_grid[c] = __ldcg(p.grid + c);
    __syncthreads();
  }
  prep_finish(p, grid, s_warp);
}

// --- bin_gather ---

// One thread a sorted position. After the unit scan, each splat adds its
// units that fall inside the unit buffer to its groups' totals (count and
// pairs, in shared memory, then once a block to the device); the last
// block to finish turns the totals into each group's first unit slot and
// first pair, which bin_units places the units from.
__global__ void __launch_bounds__(kGatherThreads)
bin_gather_kernel(const int64_t* __restrict__ order, int n,
                  const int4* __restrict__ rec, int k, int n_groups, int mu,
                  const int* __restrict__ scalars,
                  unsigned long long* status, unsigned* tickets,
                  unsigned* totals, unsigned* base, int* __restrict__ tab1) {
  extern __shared__ unsigned s_tot[];  // [2, nb]: counts, pairs
  __shared__ unsigned s_warp[33];
  __shared__ int s_bid;
  __shared__ unsigned s_prefix;
  __shared__ bool s_last;
  const int nb = n_groups + 1;
  for (int b = threadIdx.x; b < 2 * nb; b += blockDim.x) s_tot[b] = 0u;
  if (threadIdx.x == 0) s_bid = (int)atomicAdd(tickets, 1u);
  __syncthreads();
  const int bid = s_bid;
  const int j = bid * blockDim.x + threadIdx.x;
  int4 a = make_int4(0, 0, 0, 0), b = a;
  unsigned units = 0;
  if (j < n) {
    const int64_t s = __ldg(order + j);
    a = __ldg(rec + 2 * s);
    b = __ldg(rec + 2 * s + 1);
    const int y0 = (a.x >> 7) & 0xFFF, rows = (a.x >> 19) & 0xFFF;
    units = rows > 0 ? (unsigned)((y0 + rows - 1) / k - y0 / k + 1) : 0u;
  }
  unsigned total;
  const unsigned excl = block_excl(units, s_warp, &total);
  if (threadIdx.x < 32) {
    const unsigned pre = look_back(status, bid, total);
    if (threadIdx.x == 0) s_prefix = pre;
  }
  __syncthreads();
  if (j < n) {
    const unsigned ubase = s_prefix + excl;
    const size_t s = (size_t)n;
    int* t = tab1 + j;
    t[0] = a.x;
    t[s] = a.y;
    t[2 * s] = units > 0 ? (int)ubase : kDead;
    t[3 * s] = a.w;
    t[4 * s] = b.x;
    t[5 * s] = b.y;
    t[6 * s] = b.z;
    t[7 * s] = b.w;
    // the units bin_units will find live (slot < min(units_total, mu)),
    // with unit_at's group and pairs
    const int live = min(__ldg(scalars + 2), mu);
    const int y0 = (a.x >> 7) & 0xFFF, y1 = y0 + ((a.x >> 19) & 0xFFF) - 1;
    const int w = max(a.y & 0x7F, 1);
    for (int r = 0; r < (int)units && (int)(ubase + r) < live; ++r) {
      const int g = y0 / k + r, gk = g * k;
      atomicAdd(s_tot + g, 1u);
      atomicAdd(s_tot + nb + g,
                (unsigned)((min(y1, gk + k - 1) - max(y0, gk) + 1) * w));
    }
  }
  __syncthreads();
  for (int q = threadIdx.x; q < 2 * nb; q += blockDim.x)
    if (s_tot[q] != 0u) atomicAdd(totals + q, s_tot[q]);
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    s_last = atomicAdd(tickets + 1, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  // each group's first slot and first pair: exclusive sums over groups
  const int per = (nb + blockDim.x - 1) / blockDim.x;
  const int b0 = min((int)threadIdx.x * per, nb), b1 = min(b0 + per, nb);
  for (int half = 0; half < 2; ++half) {
    const unsigned* tot = totals + half * nb;
    unsigned mine = 0;
    for (int q = b0; q < b1; ++q) mine += __ldcg(tot + q);
    unsigned all;
    unsigned acc = block_excl(mine, s_warp, &all);
    for (int q = b0; q < b1; ++q) {
      base[half * nb + q] = acc;
      acc += __ldcg(tot + q);
    }
  }
}

// --- bin_units ---

// A tile of kUnitTile consecutive unit slots a block: each unit's group
// (the key) and pairs, a stable sort of the tile by key in shared memory,
// and per key a decoupled look-back over tiles (a thread a key) for the
// units and pairs of that key in the tiles before. A unit's place in the
// stable sort by group is then its group's first slot + the key's units
// in earlier tiles + its rank in the tile; its first pair likewise. The
// sort leaves the tile striped over the threads (a warp holds 32
// consecutive sorted units), so the rows are written a key's run of
// places at a time.
constexpr int kUnitThreads = 256;
constexpr int kUnitItems = 4;
constexpr int kUnitTile = kUnitThreads * kUnitItems;
constexpr int kUnitWarps = kUnitThreads / 32;
using UnitSort = cub::BlockRadixSort<unsigned, kUnitThreads, kUnitItems, int>;

struct Units {
  const int* e;         // [8, mu]: the level-1 expand of tab1
  int mu, k, n_groups, nb, key_bits;
  const int* scalars;   // [3], units_total at 2
  const unsigned* base; // [2, nb]: each group's first slot, first pair
  unsigned long long* status;  // [tiles, nb], zeroed: flag | units | pairs
  unsigned* ticket;     // zeroed
  int* tab2;            // [7, mu]
};

struct Unit {
  int key;        // group id, n_groups past the live units
  int pairs;      // rows x width, 0 past the live units
  unsigned geo;   // x0 | ys << 12 | w << 24
};

// The plain version's per-unit arithmetic, int32 wrap-around included
// (it also runs on the slots past the live units, whose columns the emit
// expand may copy).
__device__ __forceinline__ Unit unit_at(const Units& p, int u, int live) {
  const size_t mu = (size_t)p.mu;
  const int geo = __ldg(p.e + u), w = __ldg(p.e + mu + u);
  const int ubase = __ldg(p.e + 2 * mu + u);
  const bool valid = u < live;
  const int rank = max(u - ubase, 0);
  const int x0 = geo & 0x7F, y0 = (geo >> 7) & 0xFFF;
  const int rows = (geo >> 19) & 0xFFF;
  const int gid = (int)((unsigned)(y0 / p.k) + (unsigned)rank);
  const int gk = (int)((unsigned)gid * (unsigned)p.k);
  const int ys = max(y0, gk);
  const int ye = min(y0 + rows - 1, (int)((unsigned)gk + (unsigned)(p.k - 1)));
  const int rows_u = valid ? ye - ys + 1 : 0;
  Unit r;
  r.key = valid ? gid : p.n_groups;
  r.pairs = rows_u > 0 ? rows_u * max(w & 0x7F, 1) : 0;
  r.geo = (unsigned)x0 | ((unsigned)ys << 12) | ((unsigned)w << 24);
  return r;
}

// a tile's units (31 bits) and pairs (31 bits) of one key, and its flag:
// 1 this tile's own, 2 summed over it and the tiles before
constexpr unsigned long long kMask31 = (1ull << 31) - 1;
__device__ __forceinline__ unsigned long long pack_key(unsigned long long f,
                                                       unsigned c,
                                                       unsigned q) {
  return (f << 62) | ((c & kMask31) << 31) | (q & kMask31);
}

__global__ void __launch_bounds__(kUnitThreads) bin_units_kernel(
    const Units p) {
  __shared__ UnitSort::TempStorage sort_tmp;
  __shared__ unsigned s_col[kUnitItems * kUnitWarps + 1];
  __shared__ int s_tile;
  extern __shared__ unsigned s_key[];  // [4, nb]
  const int nb = p.nb;
  unsigned* s_cnt = s_key;
  unsigned* s_pairs = s_cnt + nb;
  unsigned* s_dest = s_pairs + nb;   // first place of a key, less its
  unsigned* s_pbase = s_dest + nb;   // first position in the tile
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int b = tid; b < nb; b += kUnitThreads) s_cnt[b] = s_pairs[b] = 0u;
  if (tid == 0) s_tile = (int)atomicAdd(p.ticket, 1u);
  __syncthreads();
  const int tile = s_tile, lo = tile * kUnitTile;
  const int tile_n = min(kUnitTile, p.mu - lo);
  const int live = min(__ldg(p.scalars + 2), p.mu);

  // the tile's keys, in slot order (blocked: thread t has 4 in a row)
  unsigned keys[kUnitItems];
  int vals[kUnitItems];
#pragma unroll
  for (int i = 0; i < kUnitItems; ++i) {
    const int li = tid * kUnitItems + i;
    vals[i] = li;
    keys[i] = (unsigned)nb;   // past the tile: sorts last, never written
    if (li < tile_n) {
      const Unit x = unit_at(p, lo + li, live);
      keys[i] = (unsigned)x.key;
      atomicAdd(s_cnt + x.key, 1u);
      atomicAdd(s_pairs + x.key, (unsigned)x.pairs);
    }
  }
  __syncthreads();
  // stable; striped out: item i of thread t is sorted position
  // i * kUnitThreads + t
  UnitSort(sort_tmp).SortBlockedToStriped(keys, vals, 0, p.key_bits);

  // per key: its first position in the tile and the pairs before it
  // there (sums over smaller keys), and by look-back its units and pairs
  // in the tiles before; a thread takes a contiguous chunk of keys
  const int per = (nb + kUnitThreads - 1) / kUnitThreads;
  const int b0 = min(tid * per, nb), b1 = min(b0 + per, nb);
  unsigned mc = 0, mq = 0;
  for (int b = b0; b < b1; ++b) {
    mc += s_cnt[b];
    mq += s_pairs[b];
  }
  unsigned all;
  unsigned first = block_excl(mc, s_col, &all);
  unsigned pfirst = block_excl(mq, s_col, &all);
  volatile unsigned long long* st = p.status + (size_t)tile * nb;
  for (int b = b0; b < b1; ++b)
    st[b] = pack_key(tile == 0 ? 2 : 1, s_cnt[b], s_pairs[b]);
  for (int b = b0; b < b1; ++b) {
    unsigned ec = 0, eq = 0;
    for (int t = tile - 1; t >= 0; --t) {
      const volatile unsigned long long* ps = p.status + (size_t)t * nb + b;
      unsigned long long v;
      do {
        v = *ps;
      } while ((v >> 62) == 0);
      ec += (unsigned)((v >> 31) & kMask31);
      eq += (unsigned)(v & kMask31);
      if ((v >> 62) == 2) break;
    }
    if (tile > 0) st[b] = pack_key(2, ec + s_cnt[b], eq + s_pairs[b]);
    s_dest[b] = p.base[b] + ec - first;
    s_pbase[b] = p.base[nb + b] + eq - pfirst;
    first += s_cnt[b];
    pfirst += s_pairs[b];
  }

  // each sorted unit's pairs, and the pairs before it in the tile: warp
  // scans a column of the striped items, then the columns' warp totals
  // in sorted order
  Unit xs[kUnitItems];
  unsigned before[kUnitItems];
#pragma unroll
  for (int i = 0; i < kUnitItems; ++i) {
    xs[i].pairs = 0;
    if (i * kUnitThreads + tid < tile_n) xs[i] = unit_at(p, lo + vals[i], live);
    const unsigned incl = warp_incl((unsigned)xs[i].pairs);
    before[i] = incl - (unsigned)xs[i].pairs;
    if (lane == 31) s_col[i * kUnitWarps + warp] = incl;
  }
  __syncthreads();
  if (warp == 0) {  // the (column, warp) totals' exclusive sums
    constexpr int kCols = kUnitItems * kUnitWarps;
    const unsigned x = lane < kCols ? s_col[lane] : 0u;
    const unsigned xi = warp_incl(x);
    if (lane < kCols) s_col[lane] = xi - x;
  }
  __syncthreads();
  const size_t mu = (size_t)p.mu;
#pragma unroll
  for (int i = 0; i < kUnitItems; ++i) {
    const int q = i * kUnitThreads + tid;
    if (q < tile_n) {
      const int u = lo + vals[i];
      const unsigned key = keys[i];
      int* t = p.tab2 + (s_dest[key] + (unsigned)q);
      t[0] = (int)xs[i].geo;
      t[mu] = xs[i].pairs > 0
                  ? (int)(s_pbase[key] + s_col[i * kUnitWarps + warp] +
                          before[i])
                  : kDead;
#pragma unroll
      for (int r = 3; r < 8; ++r) t[(r - 1) * mu] = __ldg(p.e + r * mu + u);
    }
  }
}

// The current device's SM count (asked on every call: a process may render
// on several cards).
int sm_count() {
  int dev = 0, count = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
  return max(count, 1);
}

}  // namespace

extern "C" {

// zero: the workspace's head (the corner grid, the sums, the tickets and
// the look-back status words), zero_bytes long; cleared here first.
int gsrt_bin_prep(const float* depth, const float* m2x, const float* m2y,
                  const float* qa, const float* qb, const float* qc,
                  const float* opacity, const float* cr, const float* cg,
                  const float* cb, const float* rx, const float* ry,
                  const unsigned char* alive, const unsigned char* keep,
                  int n, int width, int height, int tile_w, int tile_h,
                  int ntx, int nty, int k, int max_pairs, int max_units,
                  void* zero, long long zero_bytes, int* grid,
                  unsigned* sums, float* key, int4* rec, int* tile_start,
                  int* counts, int* scalars, bool* overflow, void* stream) {
  if (n <= 0 || ntx <= 0 || nty <= 0 || k <= 0 || tile_w <= 0 ||
      tile_h <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(zero, 0, (size_t)zero_bytes, s);
  if (err != cudaSuccess) return (int)err;
  const Prep p{depth,  m2x,   m2y,       qa,        qb,        qc,
               opacity, cr,   cg,        cb,        rx,        ry,
               alive,  keep,  n,         width,     height,    tile_w,
               tile_h, ntx,   nty,       k,         max_pairs, max_units,
               grid,   sums,  key,       rec,       tile_start, counts,
               scalars, overflow};
  const int smem = (nty + 1) * (ntx + 1) * (int)sizeof(int);
  // the corner grid in shared memory where it fits beside the kernel's own
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, bin_prep_kernel<true>);
  if (err != cudaSuccess) return (int)err;
  const bool shared = smem + (int)attr.sharedSizeBytes <= kSmemMax;
  // the opt-in above 48 KB is the current device's: set on every call
  if (shared && smem > kSmemDefault) {
    err = cudaFuncSetAttribute(bin_prep_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return (int)err;
  }
  // as many blocks as are resident at once: each adds its grid once
  int occ = 1;
  err = shared ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                     &occ, bin_prep_kernel<true>, kPrepThreads, smem)
               : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                     &occ, bin_prep_kernel<false>, kPrepThreads, 0);
  if (err != cudaSuccess) return (int)err;
  const int blocks = min((n + kPrepThreads - 1) / kPrepThreads,
                         max(occ, 1) * sm_count());
  if (shared)
    bin_prep_kernel<true><<<blocks, kPrepThreads, smem, s>>>(p);
  else
    bin_prep_kernel<false><<<blocks, kPrepThreads, 0, s>>>(p);
  return (int)cudaGetLastError();
}

int gsrt_bin_gather(const int64_t* order, int n, const int4* rec, int k,
                    int n_groups, int mu, const int* scalars,
                    unsigned long long* status, unsigned* tickets,
                    unsigned* totals, unsigned* base, int* tab1,
                    void* stream) {
  if (n <= 0 || k <= 0 || n_groups <= 0 || mu <= 0)
    return (int)cudaErrorInvalidValue;
  const int smem = 2 * (n_groups + 1) * (int)sizeof(unsigned);
  if (smem > kSmemDefault) return (int)cudaErrorInvalidValue;
  bin_gather_kernel<<<(n + kGatherThreads - 1) / kGatherThreads,
                      kGatherThreads, smem, (cudaStream_t)stream>>>(
      order, n, rec, k, n_groups, mu, scalars, status, tickets, totals, base,
      tab1);
  return (int)cudaGetLastError();
}

// One block a tile of kUnitTile slots: status is [tiles, n_groups + 1].
int gsrt_bin_units(const int* e, int mu, int k, int n_groups, int key_bits,
                   int tiles, const int* scalars, const unsigned* base,
                   unsigned long long* status, unsigned* ticket, int* tab2,
                   void* stream) {
  const int nb = n_groups + 1;
  if (mu <= 0 || k <= 0 || n_groups <= 0 || key_bits > 16 ||
      (1 << key_bits) <= nb || tiles != (mu + kUnitTile - 1) / kUnitTile)
    return (int)cudaErrorInvalidValue;
  const int smem = 4 * nb * (int)sizeof(unsigned);
  if (smem > kSmemMax) return (int)cudaErrorInvalidValue;
  if (smem > kSmemDefault) {    // the current device's opt-in, every call
    const cudaError_t err = cudaFuncSetAttribute(
        bin_units_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  const Units p{e, mu, k, n_groups, nb, key_bits, scalars, base, status,
                ticket, tab2};
  bin_units_kernel<<<tiles, kUnitThreads, smem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

const char* gsrt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
