// Front-to-back EWA blend of the group-contiguous compact pair stream.
//
// Replaces the TPU kernel gsrt/ops/splat_packed.py:_blend_packed_kernel
// (:68) in the mode the main path runs: group_stream=True, compact
// payload, skip_range_check (or the g <= g_cutoff test), exact exp (no
// LUT), term_eps early stop.
//
// Contract. payload is [5, L] int32, row-major: 0 tile-relative two-tier
// u16 mean (x << 16 | y), 1 bf16 l11 | bf16 l21, 2 bf16 l22 | bf16 depth,
// 3 rgba8 (two-tier 8-bit colors, u8 opacity), 4 tile id. Pairs are
// contiguous per group of bs tiles (tile_start is read at group bounds
// only) and depth-ordered per tile; tiles interleave within a group.
// Out: color [H, W, 3] and trans [H, W] float32, written straight to the
// framebuffer.
//
// Design. One block per tile, one thread per pixel (tile_w * tile_h <=
// 1024 threads). The block walks its group's pair range in batches of
// blockDim.x columns: each thread reads one column's tile id, the block
// compacts the columns of its own tile in payload order (warp ballots and
// a scan of the warp counts), decodes them once into shared memory, and
// every thread then blends them in order with the transmittance carried in
// f32 registers. Before each batch the block stops if no pixel has
// trans > term_eps (__syncthreads_or). The TPU kernel routed pairs to
// tiles with one-hot matrix products and ran the scan as a log-space
// matrix product because its matrix unit was its fast path; here the
// routing is a compare and the scan is the sequential loop each thread
// runs anyway.
//
// Known cost: every block scans the tile ids of its whole group (bs tiles,
// 120 at 1080p with 32x16 tiles), so the tile-id row is read bs times.
// A per-group prepass that builds per-tile pair lists is the first thing
// to redesign.
//
// Bound. Operations: per (pixel, pair of its tile) about 20 f32 operations
// and one exp; bytes: the 20-byte pairs, read once, and 16 bytes of output
// per pixel. The wrapper (gsrt_torch/ops/splat_packed.py) checks shapes,
// types and devices; the entry point returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kWarps = kMaxThreads / 32;

__device__ __forceinline__ float mean_axis(uint32_t w16) {
  float mag = (float)(w16 & 0x7FFFu);
  return (w16 & 0x8000u) ? mag * (1.0f / 8.0f) - 2048.0f
                         : mag * (1.0f / 256.0f) - 64.0f;
}

__device__ __forceinline__ float color8(uint32_t c8) {
  float mag = (float)(c8 & 0x7Fu);
  return (c8 & 0x80u) ? 1.0f + mag * (3.0f / 127.0f) : mag * (1.0f / 127.0f);
}

__global__ void __launch_bounds__(kMaxThreads)
blend_group_kernel(const int* __restrict__ payload, long long L,
                   const int* __restrict__ tile_start, int T, int ntx,
                   int bs, int width, int height, int tile_w,
                   float g_cutoff, int skip_range_check,
                   float alpha_threshold, float alpha_clamp, float term_eps,
                   float* __restrict__ color, float* __restrict__ trans) {
  // decoded pairs of this tile in the current batch
  __shared__ float s_mx[kMaxThreads], s_my[kMaxThreads];
  __shared__ float s_l11[kMaxThreads], s_l21[kMaxThreads],
      s_l22[kMaxThreads];
  __shared__ float s_op[kMaxThreads], s_r[kMaxThreads], s_g[kMaxThreads],
      s_b[kMaxThreads];
  __shared__ int s_warp_off[kWarps + 1];

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
  const float rh = 0.7071067811865476f;  // folds the response's 1/2
  float T_ = 1.0f, cr = 0.0f, cg = 0.0f, cb = 0.0f;

  for (int b0 = start; b0 < end; b0 += nthreads) {
    if (!__syncthreads_or(T_ > term_eps)) break;
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
      const uint32_t w0 = (uint32_t)__ldg(payload + p);
      const uint32_t w1 = (uint32_t)__ldg(payload + L + p);
      const uint32_t w2 = (uint32_t)__ldg(payload + 2 * L + p);
      const uint32_t w3 = (uint32_t)__ldg(payload + 3 * L + p);
      s_mx[i] = mean_axis(w0 >> 16);
      s_my[i] = mean_axis(w0 & 0xFFFFu);
      s_l11[i] = __uint_as_float(w1 & 0xFFFF0000u) * rh;
      s_l21[i] = __uint_as_float(w1 << 16) * rh;
      s_l22[i] = __uint_as_float(w2 & 0xFFFF0000u) * rh;
      s_r[i] = color8((w3 >> 24) & 0xFFu);
      s_g[i] = color8((w3 >> 16) & 0xFFu);
      s_b[i] = color8((w3 >> 8) & 0xFFu);
      s_op[i] = (float)(w3 & 0xFFu) * (1.0f / 255.0f);
    }
    __syncthreads();
    const int n = s_warp_off[nwarps];
    for (int i = 0; i < n; ++i) {
      const float dx = px - s_mx[i], dy = py - s_my[i];
      const float t1 = s_l11[i] * dx + s_l21[i] * dy;
      const float t2 = s_l22[i] * dy;
      const float gq = t1 * t1 + t2 * t2;
      const float alpha = fminf(s_op[i] * expf(-gq), alpha_clamp);
      if (alpha > alpha_threshold && (skip_range_check || gq <= g_cutoff)) {
        const float w = alpha * T_;
        cr += w * s_r[i];
        cg += w * s_g[i];
        cb += w * s_b[i];
        T_ *= 1.0f - alpha;
      }
    }
  }

  const int x = tx * tile_w + tid % tile_w;
  const int y = ty * tile_h + tid / tile_w;
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

int gsrt_blend_group(const int* payload, long long L, const int* tile_start,
                     int T, int ntx, int bs, int width, int height,
                     int tile_w, int tile_h, float g_cutoff,
                     int skip_range_check, float alpha_threshold,
                     float alpha_clamp, float term_eps, float* color,
                     float* trans, void* stream) {
  const int threads = tile_w * tile_h;
  if (threads % 32 != 0 || threads > kMaxThreads)
    return (int)cudaErrorInvalidValue;
  if (T > 0)
    blend_group_kernel<<<T, threads, 0, (cudaStream_t)stream>>>(
        payload, L, tile_start, T, ntx, bs, width, height, tile_w, g_cutoff,
        skip_range_check, alpha_threshold, alpha_clamp, term_eps, color,
        trans);
  return (int)cudaGetLastError();
}

const char* gsrt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
