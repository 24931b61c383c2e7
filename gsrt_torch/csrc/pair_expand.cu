// Run expansion of a depth-sorted splat (or unit) table into pair columns.
//
// Replaces the TPU kernel gsrt/ops/pair_expand.py:_expand_fused_kernel
// (:243) in both of its modes: plain (expand_pairs_fused) and emit
// (expand_pairs_binned, whose per-pair arithmetic is _emit_binned_rows,
// :122-184); and the TPU kernel gsrt/ops/pair_expand.py:_expand_kernel
// (:47, expand_pairs), which copies through a source row s(p) that its
// caller merged outside the kernel. Here both copies are the one plain
// kernel below, which finds s(p) itself: the TPU kernel kept the merge
// outside because a search inside a Mosaic kernel cost more than the
// merge done by sorts, and its fused sibling's SMEM rank table overflows
// past 2^24 pairs; neither holds on Hopper, where the block search below
// serves any max_pairs below the 2^30 sentinel with int32 columns.
//
// Contract. tab is [rows, n] int32, row-major (float rows travel as their
// bits). base [n] is each source's first output column: strictly
// increasing over the sources that emit, then a sentinel (1 << 30) for
// those that emit nothing. Output column p copies source
//     s(p) = clamp(#{j : base[j] <= p} - 1, 0, n - 1).
// Emit mode writes, in place of the copied rows, the five live rows of the
// compact pair payload: the tile-relative two-tier u16 mean, the two bf16
// Cholesky words, rgba8 (zeroed for dead or mean-saturated pairs) and the
// tile id (T past `total`).
//
// Design. The copy and emit kernels give a block 1024 consecutive output
// columns. s(p) does not fall as p grows, and every source in the block's
// window after its first starts a column of the block, so the window is
// at most 1024 sources long: warp 0 finds its first source by one 32-ary
// search over base (a ballot of 32 probes a round, about five rounds for
// two million sources, in place of a 21-step binary search a column), the
// block stages base over the window in shared memory, and each thread
// finds the source of the first of four consecutive columns by a binary
// search there and walks on to the other three (a column starts a new
// source or keeps the last one). This is the TPU kernel's merge of a base
// window per block (_merge_rank) without its barrel shifter: Hopper
// gathers directly. Where max_pairs is a multiple of 4 (every row then
// starts 16-byte aligned) a thread stores its four columns as one int4 a
// row; otherwise it takes the columns tid + 256 k (k < 4) through shared
// memory, so that a warp's stores of a row still cover 32 consecutive
// words. A thread issues the loads of 4 rows before their stores. Integer
// division takes the place of the TPU's f32-division fixups.
//
// Bound. Bytes: each output word is written once (rows x 4 B x mp) and each
// table column is read about once; there is no arithmetic to speak of.
// The wrapper (gsrt_torch/ops/pair_expand.py) checks shapes, types and
// devices; each entry point returns cudaGetLastError() of its launch.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kCols = 4;                         // output columns a thread
constexpr int kBlockCols = kThreads * kCols;     // output columns a block
constexpr int kMaxRows = 4;                      // rows loaded before stores
constexpr unsigned kFull = 0xFFFFFFFFu;

// two-tier mean constants (gsrt_torch/ops/tile_binning.py)
constexpr float kFineScale = 256.0f, kFineBias = 64.0f;
constexpr float kCoarseScale = 8.0f, kCoarseBias = 2048.0f;

// #{j : base[j] <= p} for a sorted base, by one warp: 32 probes a round.
__device__ __forceinline__ int count_le(const int* __restrict__ base, int n,
                                        int p) {
  const int lane = threadIdx.x & 31;
  int lo = 0, hi = n;  // the count lies in [lo, hi]
  while (hi - lo > 32) {
    const int step = (hi - lo + 31) >> 5;
    const int q = lo + lane * step;
    const int k =
        __popc(__ballot_sync(kFull, q < hi && __ldg(base + q) <= p));
    if (k == 0) return lo;
    lo += (k - 1) * step + 1;  // past the last probe <= p ...
    hi = min(lo - 1 + step, hi);  // ... up to the first one above
  }
  return lo + __popc(__ballot_sync(
                  kFull, lo + lane < hi && __ldg(base + lo + lane) <= p));
}

// s(p) of the kCols consecutive columns from p, where s_win holds base
// over the block's window from s_lo (INT_MAX past n).
__device__ __forceinline__ int4 sources(const int* s_win, int s_lo, int p) {
  int lo = 0, hi = kBlockCols + 1;  // first window entry above p
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (s_win[mid] <= p) lo = mid + 1; else hi = mid;
  }
  int i = lo > 0 ? lo - 1 : 0, s[kCols];
  s[0] = s_lo + i;
#pragma unroll
  for (int k = 1; k < kCols; ++k) {
    while (i < kBlockCols && s_win[i + 1] <= p + k) ++i;
    s[k] = s_lo + i;
  }
  return make_int4(s[0], s[1], s[2], s[3]);
}

// This thread's columns of the block: with vec (max_pairs a multiple of
// 4) the kCols consecutive ones from p0 + kCols * tid, stored as int4;
// else p0 + tid + kThreads * k, stored one by one but coalesced.
struct Cols {
  int first, stride, cnt;  // column k is first + stride * k, k < cnt
  int s[kCols];            // its source
};

// The block's window and this thread's columns with their sources. Every
// thread of the block calls it (it holds the block's barriers).
__device__ __forceinline__ Cols block_sources(const int* __restrict__ base,
                                              int n, int mp, bool vec,
                                              int* s_win, int4* s_src,
                                              int& s_lo_sh) {
  const int tid = threadIdx.x, p0 = blockIdx.x * kBlockCols;
  if (tid < 32) {
    const int c = count_le(base, n, p0);
    if (tid == 0) s_lo_sh = min(max(c - 1, 0), n - 1);
  }
  __syncthreads();
  const int s_lo = s_lo_sh;
  for (int i = tid; i <= kBlockCols; i += kThreads)
    s_win[i] = s_lo + i < n ? __ldg(base + s_lo + i) : INT_MAX;
  __syncthreads();
  const int q = p0 + kCols * tid;
  const int4 mine = q < mp ? sources(s_win, s_lo, q) : make_int4(0, 0, 0, 0);
  Cols c;
  if (vec) {
    c.first = q;
    c.stride = 1;
    c.cnt = min(max(mp - q, 0), kCols);
    c.s[0] = mine.x; c.s[1] = mine.y; c.s[2] = mine.z; c.s[3] = mine.w;
    return c;
  }
  s_src[tid] = mine;
  __syncthreads();
  const int* src = reinterpret_cast<const int*>(s_src);
  c.first = p0 + tid;
  c.stride = kThreads;
  c.cnt = 0;
#pragma unroll
  for (int k = 0; k < kCols; ++k) {
    const bool live = c.first + kThreads * k < mp;
    c.s[k] = live ? src[tid + kThreads * k] : 0;
    c.cnt += live;
  }
  return c;
}

// One row's words of this thread's columns (dst: the row's start).
__device__ __forceinline__ void store_cols(int* dst, const Cols& c,
                                           const int v[kCols], bool vec) {
  if (vec) {
    if (c.cnt == kCols)  // mp and the first column are multiples of 4
      *reinterpret_cast<int4*>(dst + c.first) =
          make_int4(v[0], v[1], v[2], v[3]);
    return;
  }
#pragma unroll
  for (int k = 0; k < kCols; ++k)
    if (k < c.cnt) dst[c.first + kThreads * k] = v[k];
}

__global__ void __launch_bounds__(kThreads)
expand_plain_kernel(const int* __restrict__ tab, int rows, int n,
                    const int* __restrict__ base, int mp,
                    int* __restrict__ out) {
  __shared__ int s_win[kBlockCols + 1];
  __shared__ int4 s_src[kThreads];
  __shared__ int s_lo;
  const bool vec = (mp & 3) == 0;
  const Cols c = block_sources(base, n, mp, vec, s_win, s_src, s_lo);
  for (int r0 = 0; r0 < rows; r0 += kMaxRows) {
    int v[kMaxRows][kCols];
#pragma unroll
    for (int r = 0; r < kMaxRows; ++r) {
      if (r0 + r < rows) {
        const int* row = tab + (size_t)(r0 + r) * n;
#pragma unroll
        for (int k = 0; k < kCols; ++k)
          v[r][k] = k < c.cnt ? __ldg(row + c.s[k]) : 0;
      }
    }
#pragma unroll
    for (int r = 0; r < kMaxRows; ++r)
      if (r0 + r < rows)
        store_cols(out + (size_t)(r0 + r) * mp, c, v[r], vec);
  }
}

// one tile-relative coordinate -> u16, two-tier: bit 15 = 0 fine
// (1/256 px over [-64, 64)), = 1 coarse (1/8 px over [-2048, 2048),
// saturating). Explicit _rn intrinsics: no contraction into FMAs, so the
// codes match the plain version bit for bit.
__device__ __forceinline__ uint32_t pack_mean_axis(float v) {
  float f = rintf(__fmul_rn(__fadd_rn(v, kFineBias), kFineScale));
  float c = rintf(__fmul_rn(__fadd_rn(v, kCoarseBias), kCoarseScale));
  f = fminf(fmaxf(f, 0.0f), 32767.0f);
  c = fminf(fmaxf(c, 0.0f), 32767.0f);
  bool fine = (v >= -kFineBias) && (v < kFineBias);
  return fine ? (uint32_t)f : ((uint32_t)c | 0x8000u);
}

// tab rows: 0 geometry (x0 | ys << 12 | w << 24), 1 base, 2 mean x bits,
// 3 mean y bits, 4 qab, 5 qcd, 6 rgba. out: [5, mp].
__global__ void __launch_bounds__(kThreads)
expand_emit_kernel(const int* __restrict__ tab, int n,
                   const int* __restrict__ base, int mp,
                   const int* __restrict__ total_ptr, int ntx, int T,
                   int tile_w, int tile_h, int* __restrict__ out) {
  __shared__ int s_win[kBlockCols + 1];
  __shared__ int4 s_src[kThreads];
  __shared__ int s_lo;
  const bool vec = (mp & 3) == 0;
  const Cols c = block_sources(base, n, mp, vec, s_win, s_src, s_lo);
  int w[7][kCols];
#pragma unroll
  for (int r = 0; r < 7; ++r)
#pragma unroll
    for (int k = 0; k < kCols; ++k)
      w[r][k] = k < c.cnt ? __ldg(tab + (size_t)r * n + c.s[k]) : 0;
  const int total = __ldg(total_ptr);
  int o[5][kCols];
#pragma unroll
  for (int k = 0; k < kCols; ++k) {
    const int p = c.first + c.stride * k;
    const int e0 = w[0][k];
    const int gx0 = e0 & 0xFFF;
    const int gy0 = (e0 >> 12) & 0xFFF;
    const int gw = max((e0 >> 24) & 0x7F, 1);
    const int rank = max(p - w[1][k], 0);
    const int q = rank / gw;
    const int tx = gx0 + (rank - q * gw);
    const int ty = gy0 + q;
    const float mx_rel = __fsub_rn(__int_as_float(w[2][k]),
                                   __fmul_rn((float)tx, (float)tile_w));
    const float my_rel = __fsub_rn(__int_as_float(w[3][k]),
                                   __fmul_rn((float)ty, (float)tile_h));
    const bool mean_sat = fabsf(mx_rel) >= kCoarseBias - 0.5f ||
                          fabsf(my_rel) >= kCoarseBias - 0.5f;
    const bool dead = p >= total;
    o[0][k] = (int)((pack_mean_axis(mx_rel) << 16) |
                    pack_mean_axis(my_rel));
    o[1][k] = w[4][k];
    o[2][k] = w[5][k];
    o[3][k] = (mean_sat || dead) ? 0 : w[6][k];
    o[4][k] = dead ? T : ty * ntx + tx;
  }
#pragma unroll
  for (int r = 0; r < 5; ++r) store_cols(out + (size_t)r * mp, c, o[r], vec);
}

inline int blocks_for(int mp, int cols) { return (mp + cols - 1) / cols; }

}  // namespace

extern "C" {

int gsrt_expand_plain(const int* tab, int rows, int n, const int* base,
                      int mp, int* out, void* stream) {
  if (mp > 0)
    expand_plain_kernel<<<blocks_for(mp, kBlockCols), kThreads, 0,
                          (cudaStream_t)stream>>>(tab, rows, n, base, mp,
                                                  out);
  return (int)cudaGetLastError();
}

int gsrt_expand_emit(const int* tab, int n, const int* base, int mp,
                     const int* total, int ntx, int T, int tile_w,
                     int tile_h, int* out, void* stream) {
  if (mp > 0)
    expand_emit_kernel<<<blocks_for(mp, kBlockCols), kThreads, 0,
                         (cudaStream_t)stream>>>(tab, n, base, mp, total,
                                                 ntx, T, tile_w, tile_h,
                                                 out);
  return (int)cudaGetLastError();
}

const char* gsrt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
