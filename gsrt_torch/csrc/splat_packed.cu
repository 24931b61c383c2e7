// Front-to-back EWA blend of the packed pair streams.
//
// Replaces the TPU kernel gsrt/ops/splat_packed.py:_blend_packed_kernel
// (:68) in two kernels:
//   blend_group_kernel — group_stream=True: the group-contiguous compact
//     stream of the main path;
//   blend_tile_kernel — group_stream=False: the tile-sorted stream with
//     the compact or the f32 payload, the stream serving reads, with the
//     TPU kernel's chunk gate, its saturation map (track_consumed) and its
//     hit counts (track_hits).
// Both take the exact exp or the reference's exp LUT, and the skip-range
// or the 0 <= g <= g_cutoff accept rule (blend_common.cuh).
//
// Contract. The compact payload is [5, L] int32, row-major: 0 tile-relative
// two-tier u16 mean (x << 16 | y), 1 bf16 l11 | bf16 l21, 2 bf16 l22 |
// bf16 depth, 3 rgba8 (two-tier 8-bit colors, u8 opacity), 4 tile id. The
// f32 payload is [8, L] int32 holding float bits: 0 mean x, 1 mean y
// (image frame), 2-4 conic a, b, c, 5 pack15(r, g), 6 pack15(b, opacity).
// Out: color [H, W, 3] and trans [H, W] float32, hits [H, W] int32 where
// asked, written straight to the framebuffer; consumed [G * bs] int32.
//
// Group stream. Pairs are contiguous per group of bs tiles (tile_start is
// read at group bounds only) and depth-ordered per tile; tiles interleave
// within a group. One block per tile, one thread per pixel (tile_w *
// tile_h <= 1024). The block walks its group's pair range in batches of
// blockDim.x columns: each thread reads one column's tile id, the block
// compacts the columns of its own tile in payload order (warp ballots and
// a scan of the warp counts), decodes them once into shared memory, and
// every thread then blends them in order with the transmittance carried in
// f32 registers. Before each batch the block stops if no pixel has
// trans > term_eps (__syncthreads_or). The TPU kernel routed pairs to
// tiles with one-hot matrix products and ran the scan as a log-space
// matrix product because its matrix unit was its fast path; here the
// routing is a compare and the scan is the sequential loop each thread
// runs anyway. Its known cost: every block scans the tile ids of its whole
// group (120 tiles at 1080p with 32x16 tiles).
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
// read once, 16 (20 with hits) bytes of output per pixel. The wrapper
// (gsrt_torch/ops/splat_packed.py) checks shapes, types and devices; each
// entry point returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "blend_common.cuh"

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kWarps = kMaxThreads / 32;
constexpr int kBatch = 128;   // tile stream: pairs decoded per batch
constexpr float kRh = 0.7071067811865476f;  // folds the response's 1/2
constexpr float kInvQ = 4.0f / 32767.0f;    // pack15 step

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

// Decoded pairs in shared memory. Compact: (q0, q1, q2) = (l11, l21, l22)
// with the response's 1/2 folded in, mean tile-relative; f32: the conic
// (a, b, c), mean in the image frame.
struct Pairs {
  float* mx;
  float* my;
  float* q0;
  float* q1;
  float* q2;
  float* op;
  float* r;
  float* g;
  float* b;
};

__device__ __forceinline__ void decode_compact(const int* __restrict__ pay,
                                               long long L, long long p,
                                               const Pairs& s, int i) {
  const uint32_t w0 = (uint32_t)__ldg(pay + p);
  const uint32_t w1 = (uint32_t)__ldg(pay + L + p);
  const uint32_t w2 = (uint32_t)__ldg(pay + 2 * L + p);
  const uint32_t w3 = (uint32_t)__ldg(pay + 3 * L + p);
  s.mx[i] = mean_axis(w0 >> 16);
  s.my[i] = mean_axis(w0 & 0xFFFFu);
  s.q0[i] = __uint_as_float(w1 & 0xFFFF0000u) * kRh;
  s.q1[i] = __uint_as_float(w1 << 16) * kRh;
  s.q2[i] = __uint_as_float(w2 & 0xFFFF0000u) * kRh;
  s.r[i] = color8((w3 >> 24) & 0xFFu);
  s.g[i] = color8((w3 >> 16) & 0xFFu);
  s.b[i] = color8((w3 >> 8) & 0xFFu);
  s.op[i] = (float)(w3 & 0xFFu) * (1.0f / 255.0f);
}

__device__ __forceinline__ void decode_f32(const int* __restrict__ pay,
                                           long long L, long long p,
                                           const Pairs& s, int i) {
  s.mx[i] = __int_as_float(__ldg(pay + p));
  s.my[i] = __int_as_float(__ldg(pay + L + p));
  s.q0[i] = __int_as_float(__ldg(pay + 2 * L + p));
  s.q1[i] = __int_as_float(__ldg(pay + 3 * L + p));
  s.q2[i] = __int_as_float(__ldg(pay + 4 * L + p));
  const int rg = __ldg(pay + 5 * L + p);
  const int bo = __ldg(pay + 6 * L + p);
  s.r[i] = (float)((rg >> 15) & 0x7FFF) * kInvQ;
  s.g[i] = (float)(rg & 0x7FFF) * kInvQ;
  s.b[i] = (float)((bo >> 15) & 0x7FFF) * kInvQ;
  s.op[i] = (float)(bo & 0x7FFF) * kInvQ;
}

// The response is rounded as written, in the plain version's order, with
// no FMA contraction: an accept test on the edge of alpha_threshold, or a
// g on the edge of an exp-LUT segment (the LUT steps there), must come out
// as in the plain version, or hit counts and LUT colours drift from it.
template <bool kCompact>
__device__ __forceinline__ float response(const Pairs& s, int i, float px,
                                          float py) {
  const float dx = px - s.mx[i], dy = py - s.my[i];
  if (kCompact) {
    const float t1 =
        __fadd_rn(__fmul_rn(s.q0[i], dx), __fmul_rn(s.q1[i], dy));
    const float t2 = __fmul_rn(s.q2[i], dy);
    return __fadd_rn(__fmul_rn(t1, t1), __fmul_rn(t2, t2));
  }
  return gsrt::conic_response(s.q0[i], s.q1[i], s.q2[i], dx, dy);
}

struct Params {
  float g_cutoff;
  int skip_range_check;
  float alpha_threshold;
  float alpha_clamp;
  float term_eps;
  bool use_lut;
};

// Blend decoded pairs [0, n) in order into one pixel's state.
template <bool kCompact>
__device__ __forceinline__ void blend_pairs(const Pairs& s, int n, float px,
                                            float py, const Params& prm,
                                            float& T_, float& cr, float& cg,
                                            float& cb, int& hits) {
  for (int i = 0; i < n; ++i) {
    float alpha;
    if (gsrt::accept_alpha(response<kCompact>(s, i, px, py), s.op[i],
                           prm.g_cutoff, prm.skip_range_check,
                           prm.alpha_threshold, prm.alpha_clamp, prm.use_lut,
                           alpha)) {
      const float w = alpha * T_;
      cr += w * s.r[i];
      cg += w * s.g[i];
      cb += w * s.b[i];
      T_ *= 1.0f - alpha;
      ++hits;
    }
  }
}

__device__ __forceinline__ void store_pixel(int x, int y, int width,
                                            int height, float T_, float cr,
                                            float cg, float cb, int hits,
                                            float* __restrict__ color,
                                            float* __restrict__ trans,
                                            int* __restrict__ hit_map) {
  if (x < width && y < height) {
    const size_t pix = (size_t)y * width + x;
    trans[pix] = T_;
    color[3 * pix] = cr;
    color[3 * pix + 1] = cg;
    color[3 * pix + 2] = cb;
    if (hit_map) hit_map[pix] = hits;
  }
}

__global__ void __launch_bounds__(kMaxThreads)
blend_group_kernel(const int* __restrict__ payload, long long L,
                   const int* __restrict__ tile_start, int T, int ntx,
                   int bs, int width, int height, int tile_w, Params prm,
                   float* __restrict__ color, float* __restrict__ trans,
                   int* __restrict__ hit_map) {
  // decoded pairs of this tile in the current batch
  __shared__ float s_mx[kMaxThreads], s_my[kMaxThreads];
  __shared__ float s_l11[kMaxThreads], s_l21[kMaxThreads],
      s_l22[kMaxThreads];
  __shared__ float s_op[kMaxThreads], s_r[kMaxThreads], s_g[kMaxThreads],
      s_b[kMaxThreads];
  __shared__ int s_warp_off[kWarps + 1];
  const Pairs s{s_mx, s_my, s_l11, s_l21, s_l22, s_op, s_r, s_g, s_b};

  const int tile = blockIdx.x;
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = nthreads >> 5;
  const int tile_h = nthreads / tile_w;
  const int tx = tile % ntx, ty = tile / ntx;
  const float px = (float)(tid % tile_w), py = (float)(tid / tile_w);

  const int g0 = (tile / bs) * bs;
  const int start = tile_start[g0];
  const int end = tile_start[min(g0 + bs, T)];

  const int* tile_row = payload + 4 * L;
  float T_ = 1.0f, cr = 0.0f, cg = 0.0f, cb = 0.0f;
  int hits = 0;

  for (int b0 = start; b0 < end; b0 += nthreads) {
    if (!__syncthreads_or(T_ > prm.term_eps)) break;
    const int p = b0 + tid;
    const bool mine = p < end && __ldg(tile_row + p) == tile;
    const unsigned ballot = __ballot_sync(0xffffffffu, mine);
    if (lane == 0) s_warp_off[warp + 1] = __popc(ballot);
    __syncthreads();
    if (tid == 0) {
      s_warp_off[0] = 0;
      for (int w = 1; w <= nwarps; ++w) s_warp_off[w] += s_warp_off[w - 1];
    }
    __syncthreads();
    if (mine) {
      const int i = s_warp_off[warp] + __popc(ballot & ((1u << lane) - 1u));
      decode_compact(payload, L, p, s, i);
    }
    __syncthreads();
    blend_pairs<true>(s, s_warp_off[nwarps], px, py, prm, T_, cr, cg, cb,
                      hits);
  }
  store_pixel(tx * tile_w + tid % tile_w, ty * tile_h + tid / tile_w, width,
              height, T_, cr, cg, cb, hits, color, trans, hit_map);
}

template <bool kCompact>
__global__ void __launch_bounds__(kMaxThreads)
blend_tile_kernel(const int* __restrict__ payload, long long L,
                  const int* __restrict__ tile_start, int T, int ntx, int bs,
                  int cw, int width, int height, int tile_w, Params prm,
                  float* __restrict__ color, float* __restrict__ trans,
                  int* __restrict__ hit_map, int* __restrict__ consumed) {
  __shared__ float s_mx[kBatch], s_my[kBatch], s_q0[kBatch], s_q1[kBatch],
      s_q2[kBatch], s_op[kBatch], s_r[kBatch], s_g[kBatch], s_b[kBatch];
  const Pairs s{s_mx, s_my, s_q0, s_q1, s_q2, s_op, s_r, s_g, s_b};

  const int tile = blockIdx.x;   // grid: every tile of every group, pads too
  const int tid = threadIdx.x;
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
  const int lx = tid % tile_w, ly = tid / tile_w;
  const int x = (tile % ntx) * tile_w + lx, y = (tile / ntx) * tile_h + ly;
  // compact means are tile-relative, f32 means in the image frame
  const float px = (float)(kCompact ? lx : x), py = (float)(kCompact ? ly : y);

  const int lo = tile_start[tile], hi = tile_start[tile + 1];
  float T_ = 1.0f, cr = 0.0f, cg = 0.0f, cb = 0.0f;
  int hits = 0;
  int cons = total_chunks;

  if (hi > lo) {
    const int jf = (lo - astart) / cw, jl = (hi - 1 - astart) / cw;
    // the column after the segment holds the gate of t's last chunk open
    const bool force_last =
        (hi - astart) % cw != 0 && (hi < end_g || g0 + bs > T);
    bool saturated = false;
    for (int j = jf; j <= jl; ++j) {
      const bool live = __syncthreads_or(T_ > prm.term_eps) != 0;
      if (live || (j == jl && force_last)) {
        const int c_hi = min(hi, astart + (j + 1) * cw);
        for (int b0 = max(lo, astart + j * cw); b0 < c_hi; b0 += kBatch) {
          const int n = min(kBatch, c_hi - b0);
          __syncthreads();   // the last batch's readers are done
          for (int i = tid; i < n; i += blockDim.x) {
            if (kCompact)
              decode_compact(payload, L, b0 + i, s, i);
            else
              decode_f32(payload, L, b0 + i, s, i);
          }
          __syncthreads();
          blend_pairs<kCompact>(s, n, px, py, prm, T_, cr, cg, cb, hits);
        }
      }
      if (consumed && !saturated &&
          !__syncthreads_or(T_ >= prm.term_eps)) {
        saturated = true;
        cons = j + 1;
      }
    }
  }
  store_pixel(x, y, width, height, T_, cr, cg, cb, hits, color, trans,
              hit_map);
  if (consumed && tid == 0) consumed[tile] = cons;
}

}  // namespace

extern "C" {

int gsrt_blend_group(const int* payload, long long L, const int* tile_start,
                     int T, int ntx, int bs, int width, int height,
                     int tile_w, int tile_h, float g_cutoff,
                     int skip_range_check, float alpha_threshold,
                     float alpha_clamp, float term_eps, int use_lut,
                     float* color, float* trans, int* hits, void* stream) {
  const int threads = tile_w * tile_h;
  if (threads % 32 != 0 || threads > kMaxThreads)
    return (int)cudaErrorInvalidValue;
  const Params prm{g_cutoff, skip_range_check, alpha_threshold, alpha_clamp,
                   term_eps, use_lut != 0};
  if (T > 0)
    blend_group_kernel<<<T, threads, 0, (cudaStream_t)stream>>>(
        payload, L, tile_start, T, ntx, bs, width, height, tile_w, prm,
        color, trans, hits);
  return (int)cudaGetLastError();
}

int gsrt_blend_tile(const int* payload, long long L, int compact,
                    const int* tile_start, int T, int ntx, int bs, int chunk,
                    int width, int height, int tile_w, int tile_h,
                    float g_cutoff, int skip_range_check,
                    float alpha_threshold, float alpha_clamp, float term_eps,
                    int use_lut, float* color, float* trans, int* hits,
                    int* consumed, void* stream) {
  const int threads = tile_w * tile_h;
  if (threads % 32 != 0 || threads > kMaxThreads || bs <= 0 || chunk <= 0)
    return (int)cudaErrorInvalidValue;
  const Params prm{g_cutoff, skip_range_check, alpha_threshold, alpha_clamp,
                   term_eps, use_lut != 0};
  const int blocks = (T + bs - 1) / bs * bs;
  if (T > 0) {
    if (compact)
      blend_tile_kernel<true><<<blocks, threads, 0, (cudaStream_t)stream>>>(
          payload, L, tile_start, T, ntx, bs, chunk, width, height, tile_w,
          prm, color, trans, hits, consumed);
    else
      blend_tile_kernel<false><<<blocks, threads, 0, (cudaStream_t)stream>>>(
          payload, L, tile_start, T, ntx, bs, chunk, width, height, tile_w,
          prm, color, trans, hits, consumed);
  }
  return (int)cudaGetLastError();
}

const char* gsrt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
