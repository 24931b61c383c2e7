// Run expansion of a depth-sorted splat (or unit) table into pair columns.
//
// Replaces the TPU kernel gsrt/ops/pair_expand.py:_expand_fused_kernel
// (:243) in both of its modes: plain (expand_pairs_fused) and emit
// (expand_pairs_binned, whose per-pair arithmetic is _emit_binned_rows,
// :122-184); and the TPU kernel gsrt/ops/pair_expand.py:_expand_kernel
// (:47, expand_pairs), which copies through a source row s(p) that its
// caller computed.
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
// Design. One thread per output column: it finds s(p) by binary search
// over base, then copies or emits. The TPU kernel streamed table windows
// through a barrel shifter because its vector unit has no gather; Hopper
// gathers directly, and the ~20 search steps of neighbouring threads read
// the same few cache lines, so the search costs L1/L2 hits, not DRAM
// traffic. A per-source write loop (one thread per source, writing its
// run) was the alternative; it needs no search but leaves warps idle on
// short runs and unbalanced on long ones, and its writes are not
// coalesced. Integer division takes the place of the TPU's f32-division
// fixups. The gather kernel (expand_pairs) is the same copy with s(p) read
// from a row the wrapper computed: the TPU kernel streamed 128-aligned
// table windows and shifted them into place, here it is one indexed load
// per row.
//
// Bound. Bytes: each output word is written once (rows x 4 B x mp) and each
// table column is read about once; there is no arithmetic to speak of.
// The wrapper (gsrt_torch/ops/pair_expand.py) checks shapes, types and
// devices; each entry point returns cudaGetLastError() of its launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// two-tier mean constants (gsrt_torch/ops/tile_binning.py)
constexpr float kFineScale = 256.0f, kFineBias = 64.0f;
constexpr float kCoarseScale = 8.0f, kCoarseBias = 2048.0f;

__device__ __forceinline__ int source_of(const int* __restrict__ base, int n,
                                         int p) {
  int lo = 0, hi = n;  // first j with base[j] > p
  while (lo < hi) {
    int mid = (lo + hi) >> 1;
    if (__ldg(base + mid) <= p) lo = mid + 1; else hi = mid;
  }
  int s = lo - 1;
  return s < 0 ? 0 : (s > n - 1 ? n - 1 : s);
}

__global__ void expand_plain_kernel(const int* __restrict__ tab, int rows,
                                    int n, const int* __restrict__ base,
                                    int mp, int* __restrict__ out) {
  int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= mp) return;
  int s = source_of(base, n, p);
  for (int r = 0; r < rows; ++r)
    out[(size_t)r * mp + p] = __ldg(tab + (size_t)r * n + s);
}

__global__ void expand_gather_kernel(const int* __restrict__ tab, int rows,
                                     int n, const int* __restrict__ src,
                                     int mp, int* __restrict__ out) {
  int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= mp) return;
  int s = __ldg(src + p);
  for (int r = 0; r < rows; ++r)
    out[(size_t)r * mp + p] = __ldg(tab + (size_t)r * n + s);
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
__global__ void expand_emit_kernel(const int* __restrict__ tab, int n,
                                   const int* __restrict__ base, int mp,
                                   const int* __restrict__ total_ptr,
                                   int ntx, int T, int tile_w, int tile_h,
                                   int* __restrict__ out) {
  int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= mp) return;
  int s = source_of(base, n, p);
  int total = __ldg(total_ptr);
  int e0 = __ldg(tab + s);
  int gx0 = e0 & 0xFFF;
  int gy0 = (e0 >> 12) & 0xFFF;
  int gw = max((e0 >> 24) & 0x7F, 1);
  int rank = max(p - __ldg(tab + (size_t)n + s), 0);
  int q = rank / gw;
  int tx = gx0 + (rank - q * gw);
  int ty = gy0 + q;
  float mx = __int_as_float(__ldg(tab + 2 * (size_t)n + s));
  float my = __int_as_float(__ldg(tab + 3 * (size_t)n + s));
  float mx_rel = __fsub_rn(mx, __fmul_rn((float)tx, (float)tile_w));
  float my_rel = __fsub_rn(my, __fmul_rn((float)ty, (float)tile_h));
  uint32_t meanp = (pack_mean_axis(mx_rel) << 16) | pack_mean_axis(my_rel);
  bool mean_sat = fabsf(mx_rel) >= kCoarseBias - 0.5f ||
                  fabsf(my_rel) >= kCoarseBias - 0.5f;
  bool dead = p >= total;
  out[p] = (int)meanp;
  out[(size_t)mp + p] = __ldg(tab + 4 * (size_t)n + s);
  out[2 * (size_t)mp + p] = __ldg(tab + 5 * (size_t)n + s);
  out[3 * (size_t)mp + p] =
      (mean_sat || dead) ? 0 : __ldg(tab + 6 * (size_t)n + s);
  out[4 * (size_t)mp + p] = dead ? T : ty * ntx + tx;
}

inline int blocks_for(int mp) { return (mp + kThreads - 1) / kThreads; }

}  // namespace

extern "C" {

int gsrt_expand_plain(const int* tab, int rows, int n, const int* base,
                      int mp, int* out, void* stream) {
  if (mp > 0)
    expand_plain_kernel<<<blocks_for(mp), kThreads, 0,
                          (cudaStream_t)stream>>>(tab, rows, n, base, mp,
                                                  out);
  return (int)cudaGetLastError();
}

int gsrt_expand_gather(const int* tab, int rows, int n, const int* src,
                       int mp, int* out, void* stream) {
  if (mp > 0)
    expand_gather_kernel<<<blocks_for(mp), kThreads, 0,
                           (cudaStream_t)stream>>>(tab, rows, n, src, mp,
                                                   out);
  return (int)cudaGetLastError();
}

int gsrt_expand_emit(const int* tab, int n, const int* base, int mp,
                     const int* total, int ntx, int T, int tile_w,
                     int tile_h, int* out, void* stream) {
  if (mp > 0)
    expand_emit_kernel<<<blocks_for(mp), kThreads, 0,
                         (cudaStream_t)stream>>>(tab, n, base, mp, total,
                                                 ntx, T, tile_w, tile_h,
                                                 out);
  return (int)cudaGetLastError();
}

const char* gsrt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
