// Screen-tile binned primary-ray triangle cast.
//
// Replaces the TPU kernel gsrt/ops/tri_binning.py:_tri_cast_kernel (:357,
// reached through cast_primary :514): per screen tile, the closest hit of
// each pixel's primary ray over the tile's near-depth-sorted triangle
// pairs, with the z-prepass early exit.
//
// Contract. v0r [3, L] f32: each pair's v0 minus the shared ray origin
// (the wrapper subtracts it in f32, as the JAX package does, so the
// Moller-Trumbore tvec is -v0r); payload [11, L] f32 rows 3-5 e1, 6-8 e2,
// 9 triangle id (int32 bits), 10 zmin (rows 0-2 are not read). Tile t owns
// columns [tile_start[t], tile_start[t + 1]) in ascending zmin. dirs
// [H * W, 3] f32 world-space directions in framebuffer order. Out: t
// [H, W] f32 (3.4e38 on a miss) and id [H, W] int32 (0x7FFFFFFF on a
// miss).
//
// Semantics (the TPU kernel's, exactly): a tile walks its segment in
// chunks of 128 pairs measured from the segment start; it skips a chunk
// unless some pixel of the tile (padding pixels past the image edge,
// whose direction is 0, included) has a best t above the chunk's smallest
// zmin; within a chunk a pixel takes the smallest t, ties to the smallest
// id, and keeps it only when strictly below its best, so an earlier chunk
// wins a tie. Moller-Trumbore rounds as written (no FMA contraction), so
// the kernel equals the plain version (gsrt_torch/ops/tri_binning.py
// cast_primary_plain) bit for bit.
//
// Design. One block per tile, one thread per pixel (tile_w * tile_h <=
// 1024). A chunk's pairs are staged in shared memory with their
// per-triangle qvec = tvec x e1 and e2 . qvec (the shared origin makes
// both properties of the triangle), about 8 KB; the skip test is one
// __syncthreads_or. The TPU
// kernel's group of 8 tiles per grid step, its one-hot column selects and
// its 128-aligned DMA windows follow from its block rules and are gone.
//
// Bound. Operations: 38 f32 operations per (pixel, pair) of a chunk that
// is cast and 14 per pair cast (CAST_FLOPS and CAST_PAIR_FLOPS in
// chip_smoke.py), against reading the payload and the directions once and
// writing 8 bytes a pixel.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 128;
constexpr int kMaxThreads = 1024;
constexpr float kInf = 3.4e38f;
constexpr int kSentinel = 0x7FFFFFFF;

__device__ __forceinline__ float mul(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ float add(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ float sub(float a, float b) {
  return __fsub_rn(a, b);
}

__global__ void __launch_bounds__(kMaxThreads)
tri_cast_kernel(const float* __restrict__ v0r,
                const float* __restrict__ payload, long long L,
                const int* __restrict__ tile_start, int ntx, int width,
                int height, int tile_w, const float* __restrict__ dirs,
                float t_min, float t_max, float* __restrict__ t_out,
                int* __restrict__ id_out) {
  // per pair: tvec (-v0r) xyz, e1 xyz, e2 xyz, qvec xyz, zmin, e2 . qvec;
  // and the id
  __shared__ float s_f[14][kChunk];
  __shared__ int s_id[kChunk];

  const int tile = blockIdx.x;
  const int tid = threadIdx.x;
  const int tile_h = blockDim.x / tile_w;
  const int x = (tile % ntx) * tile_w + tid % tile_w;
  const int y = (tile / ntx) * tile_h + tid / tile_w;
  const bool in_image = x < width && y < height;
  const size_t pix = (size_t)y * width + x;
  float dx = 0.0f, dy = 0.0f, dz = 0.0f;
  if (in_image) {
    dx = dirs[3 * pix];
    dy = dirs[3 * pix + 1];
    dz = dirs[3 * pix + 2];
  }

  const int start = tile_start[tile];
  const int end = tile_start[tile + 1];
  float best_t = kInf;
  int best_id = kSentinel;

  for (int c0 = start; c0 < end; c0 += kChunk) {
    const int n = min(kChunk, end - c0);
    __syncthreads();  // the last chunk's readers are done
    for (int j = tid; j < n; j += blockDim.x) {
      const long long p = c0 + j;
      const float tvx = -v0r[p], tvy = -v0r[L + p], tvz = -v0r[2 * L + p];
      const float e1x = payload[3 * L + p], e1y = payload[4 * L + p],
                  e1z = payload[5 * L + p];
      s_f[0][j] = tvx;
      s_f[1][j] = tvy;
      s_f[2][j] = tvz;
      s_f[3][j] = e1x;
      s_f[4][j] = e1y;
      s_f[5][j] = e1z;
      const float e2x = payload[6 * L + p], e2y = payload[7 * L + p],
                  e2z = payload[8 * L + p];
      const float qvx = sub(mul(tvy, e1z), mul(tvz, e1y));
      const float qvy = sub(mul(tvz, e1x), mul(tvx, e1z));
      const float qvz = sub(mul(tvx, e1y), mul(tvy, e1x));
      s_f[6][j] = e2x;
      s_f[7][j] = e2y;
      s_f[8][j] = e2z;
      s_f[9][j] = qvx;
      s_f[10][j] = qvy;
      s_f[11][j] = qvz;
      s_f[12][j] = payload[10 * L + p];
      s_f[13][j] = add(add(mul(e2x, qvx), mul(e2y, qvy)), mul(e2z, qvz));
      s_id[j] = __float_as_int(payload[9 * L + p]);
    }
    __syncthreads();
    float zlo = kInf;
    for (int i = 0; i < n; ++i) zlo = fminf(zlo, s_f[12][i]);
    if (!__syncthreads_or(best_t > zlo)) continue;

    float m = kInf;
    int im = kSentinel;
    for (int i = 0; i < n; ++i) {
      const float tvx = s_f[0][i], tvy = s_f[1][i], tvz = s_f[2][i];
      const float e1x = s_f[3][i], e1y = s_f[4][i], e1z = s_f[5][i];
      const float e2x = s_f[6][i], e2y = s_f[7][i], e2z = s_f[8][i];
      const float qvx = s_f[9][i], qvy = s_f[10][i], qvz = s_f[11][i];
      const float e2q = s_f[13][i];
      const int id = s_id[i];
      const float pvx = sub(mul(dy, e2z), mul(dz, e2y));
      const float pvy = sub(mul(dz, e2x), mul(dx, e2z));
      const float pvz = sub(mul(dx, e2y), mul(dy, e2x));
      const float det = add(add(mul(e1x, pvx), mul(e1y, pvy)), mul(e1z, pvz));
      const bool det_ok = fabsf(det) > 1e-12f;
      const float inv_det = det_ok ? __fdiv_rn(1.0f, det) : 0.0f;
      const float u = mul(add(add(mul(tvx, pvx), mul(tvy, pvy)),
                              mul(tvz, pvz)), inv_det);
      const float v = mul(add(add(mul(dx, qvx), mul(dy, qvy)),
                              mul(dz, qvz)), inv_det);
      const float t = mul(e2q, inv_det);
      const bool ok = det_ok && u >= 0.0f && v >= 0.0f &&
                      add(u, v) <= 1.0f && t > t_min && t < t_max &&
                      id != kSentinel;
      if (ok && (t < m || (t == m && id < im))) {
        m = t;
        im = id;
      }
    }
    if (m < best_t) {
      best_t = m;
      best_id = im;
    }
  }

  if (in_image) {
    t_out[pix] = best_t;
    id_out[pix] = best_id;
  }
}

}  // namespace

extern "C" {

int gsrt_tri_cast(const float* v0r, const float* payload, long long L,
                  const int* tile_start, int T, int ntx, int width,
                  int height, int tile_w, int tile_h, const float* dirs,
                  float t_min, float t_max, float* t_out, int* id_out,
                  void* stream) {
  const int threads = tile_w * tile_h;
  if (threads % 32 != 0 || threads <= 0 || threads > kMaxThreads)
    return (int)cudaErrorInvalidValue;
  if (T > 0)
    tri_cast_kernel<<<T, threads, 0, (cudaStream_t)stream>>>(
        v0r, payload, L, tile_start, ntx, width, height, tile_w, dirs,
        t_min, t_max, t_out, id_out);
  return (int)cudaGetLastError();
}

const char* gsrt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
