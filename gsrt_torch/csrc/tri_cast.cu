// Screen-tile binned primary-ray triangle cast.
//
// Replaces the TPU kernel gsrt/ops/tri_binning.py:_tri_cast_kernel (:357,
// reached through cast_primary :514): per screen tile, the closest hit of
// each pixel's primary ray over the tile's near-depth-sorted triangle
// pairs, with the z-prepass early exit.
//
// Contract. payload [11, L] f32 rows 0-2 v0, 3-5 e1, 6-8 e2, 9 triangle
// id (int32 bits), 10 zmin, never NaN; origin [3] f32, the shared ray
// origin, subtracted from v0 in f32 as the JAX package does (the
// Moller-Trumbore tvec is -(v0 - origin)), for the pairs a tile casts.
// Tile t owns columns [tile_start[t], tile_start[t + 1]). dirs [H * W, 3]
// f32 world-space directions in framebuffer order. Out: t [H, W] f32
// (3.4e38 on a miss) and id [H, W] int32 (0x7FFFFFFF on a miss).
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
// 1024, a multiple of 32).
//  * Chunks. "Some pixel's best t lies above the chunk's smallest zmin" is
//    "some zmin of the chunk lies below B", B the tile's largest best t,
//    which only changes when a chunk is cast. So after each cast the block
//    reads zmin alone, the next chunk first, then 512 columns at a time,
//    one __syncthreads_or each, until it finds the next chunk to cast or
//    the segment's end: skipped chunks are never staged. build_tri_binning
//    sorts each tile's pairs by ascending zmin, so the tile usually ends
//    one read after its first skipped chunk; the kernel does not rely on
//    that order (a binning that overflowed max_pairs breaks it, and so
//    does a triangle with a vertex at -inf depth, sorted first with zmin
//    3.4e38) and stays exact on any payload.
//  * Records. A chunk that is cast is staged as 16-float records (tvec,
//    e1, e2, qvec = tvec x e1, e2 . qvec, the id's bits): four 16-byte
//    shared loads a (warp, pair) step, broadcast to the warp.
//  * Warp cull. Each warp reduces its in-image lanes' directions to a box
//    once a tile. Per 32-pair batch lane j tests pair j: interval
//    arithmetic over the box through the per-lane formula, in its order,
//    encloses every rounded value a lane can compute (pvec, det, 1/det, u,
//    v, u + v, t), because rounding to nearest is monotone: each interval
//    end is the same _rn operation on the ends of its operands (a product
//    with a constant takes its ends by the constant's sign, a product with
//    1/det, whose sign is fixed, by the signs of the other factor). A pair
//    is culled for the warp when its id is the sentinel, when every det
//    has |det| <= 1e-12, or, det of one sign past the threshold, when u <
//    0, v < 0, u + v > 1, t <= t_min or t >= t_max hold over the whole
//    interval, or t's lower end lies above the warp's largest min(best t,
//    running minimum) at the batch's start (such a pair cannot change a
//    lane's result). NaN propagates through every step (selects, not
//    fminf), and every test is false on NaN, so a non-finite interval
//    culls nothing. The warp then walks the set bits of the ballot; the
//    min and tie rule does not depend on order, so no bit changes.
// The TPU kernel's group of 8 tiles per grid step, its one-hot column
// selects and its 128-aligned DMA windows follow from its block rules and
// are gone.
//
// Bound. Operations: 38 f32 operations per (pixel, pair) of a chunk that
// is cast and 14 per pair cast (CAST_FLOPS and CAST_PAIR_FLOPS in
// chip_smoke.py), against reading the payload and the directions once and
// writing 8 bytes a pixel. The plain version counts the (warp, pair)
// steps of the chunks cast and those the cull removes
// (stats["warp_steps"], stats["culled_steps"]).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 128;    // pairs a skip test covers (the TPU's)
constexpr int kBatch = 32;     // pairs a warp culls at once, one a lane
constexpr int kWindow = 512;   // zmin columns a scan reads at once
constexpr int kMaxThreads = 1024;
constexpr float kInf = 3.4e38f;
constexpr float kDetEps = 1e-12f;
constexpr int kSentinel = 0x7FFFFFFF;
constexpr unsigned kFull = 0xFFFFFFFFu;

__device__ __forceinline__ float mul(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ float add(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ float sub(float a, float b) {
  return __fsub_rn(a, b);
}

struct Rec {
  float tx, ty, tz, e1x, e1y, e1z, e2x, e2y, e2z, qx, qy, qz, e2q;
  int id;
};

// a staged pair: w0 tvec, e1.x; w1 e1.yz, e2.xy; w2 e2.z, qvec; w3 e2 .
// qvec, the id's bits, 0, 0
__device__ __forceinline__ Rec load_rec(const float4* r) {
  const float4 a = r[0], b = r[1], c = r[2], d = r[3];
  return Rec{a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w, c.x, c.y, c.z, c.w,
             d.x, __float_as_int(d.y)};
}

// ---- intervals, each end rounded to nearest (see the header) ----
struct Iv {
  float lo, hi;
};

__device__ __forceinline__ Iv scale(float c, Iv a) {  // c * a
  const float p = mul(c, a.lo), q = mul(c, a.hi);
  return c >= 0.0f ? Iv{p, q} : Iv{q, p};
}
__device__ __forceinline__ Iv iadd(Iv a, Iv b) {
  return Iv{add(a.lo, b.lo), add(a.hi, b.hi)};
}
__device__ __forceinline__ Iv isub(Iv a, Iv b) {
  return Iv{sub(a.lo, b.hi), sub(a.hi, b.lo)};
}
// a * b for b > 0 throughout (pos) or b < 0 throughout
__device__ __forceinline__ Iv imul_signed(Iv a, Iv b, bool pos) {
  if (pos)
    return Iv{a.lo >= 0.0f ? mul(a.lo, b.lo) : mul(a.lo, b.hi),
              a.hi >= 0.0f ? mul(a.hi, b.hi) : mul(a.hi, b.lo)};
  return Iv{a.hi >= 0.0f ? mul(a.hi, b.lo) : mul(a.hi, b.hi),
            a.lo >= 0.0f ? mul(a.lo, b.hi) : mul(a.lo, b.lo)};
}

// True when no lane whose direction lies in the box can accept the pair,
// or none can take it below `bound`.
__device__ __forceinline__ bool culled(const Rec& r, Iv dx, Iv dy, Iv dz,
                                       float t_min, float t_max,
                                       float bound) {
  const Iv pvx = isub(scale(r.e2z, dy), scale(r.e2y, dz));
  const Iv pvy = isub(scale(r.e2x, dz), scale(r.e2z, dx));
  const Iv pvz = isub(scale(r.e2y, dx), scale(r.e2x, dy));
  const Iv det = iadd(iadd(scale(r.e1x, pvx), scale(r.e1y, pvy)),
                      scale(r.e1z, pvz));
  if (det.lo >= -kDetEps && det.hi <= kDetEps) return true;
  const bool pos = det.lo > kDetEps;
  if (!pos && !(det.hi < -kDetEps)) return false;
  const Iv inv{__frcp_rn(det.hi), __frcp_rn(det.lo)};  // 1/x falls
  const Iv u = imul_signed(
      iadd(iadd(scale(r.tx, pvx), scale(r.ty, pvy)), scale(r.tz, pvz)),
      inv, pos);
  const Iv v = imul_signed(
      iadd(iadd(scale(r.qx, dx), scale(r.qy, dy)), scale(r.qz, dz)), inv,
      pos);
  const Iv t = scale(r.e2q, inv);
  return u.hi < 0.0f || v.hi < 0.0f || add(u.lo, v.lo) > 1.0f ||
         t.hi <= t_min || t.lo >= t_max || t.lo > bound;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}
__device__ __forceinline__ float warp_min(float v) {
  for (int o = 16; o; o >>= 1) v = fminf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// The first chunk start in [c0, end) whose columns hold a zmin below B,
// or end: the next chunk alone first, then kWindow columns at a time; a
// window that holds one is searched chunk by chunk.
__device__ __forceinline__ int next_chunk(const float* __restrict__ zmin,
                                          int c0, int end, float B) {
  bool narrow = true, found = false;
  while (c0 < end) {
    const int n = min(narrow ? kChunk : kWindow, end - c0);
    bool below = false;
    for (int j = threadIdx.x; j < n; j += blockDim.x)
      below |= __ldg(zmin + c0 + j) < B;
    if (__syncthreads_or(below)) {
      if (n <= kChunk) return c0;
      narrow = found = true;
      continue;
    }
    c0 += n;
    narrow = found;
  }
  return end;
}

__global__ void __launch_bounds__(kMaxThreads)
tri_cast_kernel(const float* __restrict__ payload, long long L,
                const float* __restrict__ origin,
                const int* __restrict__ tile_start, int ntx, int width,
                int height, int tile_w, const float* __restrict__ dirs,
                float t_min, float t_max, float* __restrict__ t_out,
                int* __restrict__ id_out) {
  __shared__ float4 s_rec[kChunk][4];
  __shared__ float s_wmax[kMaxThreads / 32];

  const int tile = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
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
  // the warp's box of in-image directions (a NaN component, which can
  // accept nothing, stays out of it)
  const Iv bx{warp_min(in_image && dx == dx ? dx : INFINITY),
              warp_max(in_image && dx == dx ? dx : -INFINITY)};
  const Iv by{warp_min(in_image && dy == dy ? dy : INFINITY),
              warp_max(in_image && dy == dy ? dy : -INFINITY)};
  const Iv bz{warp_min(in_image && dz == dz ? dz : INFINITY),
              warp_max(in_image && dz == dz ? dz : -INFINITY)};
  const bool warp_has_pixels = __any_sync(kFull, in_image);

  const float ox = __ldg(origin), oy = __ldg(origin + 1),
              oz = __ldg(origin + 2);
  const float* zmin = payload + 10 * L;
  const int start = tile_start[tile];
  const int end = tile_start[tile + 1];
  float best_t = kInf;
  int best_id = kSentinel;
  float B = kInf;  // the tile's largest best t

  for (int c0 = next_chunk(zmin, start, end, B); c0 < end;
       c0 = next_chunk(zmin, c0 + kChunk, end, B)) {
    const int n = min(kChunk, end - c0);
    // the last chunk's readers are past the barrier that published B
    for (int j = tid; j < n; j += blockDim.x) {
      const long long p = c0 + j;
      const float tvx = -sub(payload[p], ox),
                  tvy = -sub(payload[L + p], oy),
                  tvz = -sub(payload[2 * L + p], oz);
      const float e1x = payload[3 * L + p], e1y = payload[4 * L + p],
                  e1z = payload[5 * L + p];
      const float e2x = payload[6 * L + p], e2y = payload[7 * L + p],
                  e2z = payload[8 * L + p];
      const float qvx = sub(mul(tvy, e1z), mul(tvz, e1y));
      const float qvy = sub(mul(tvz, e1x), mul(tvx, e1z));
      const float qvz = sub(mul(tvx, e1y), mul(tvy, e1x));
      const float e2q = add(add(mul(e2x, qvx), mul(e2y, qvy)),
                            mul(e2z, qvz));
      s_rec[j][0] = make_float4(tvx, tvy, tvz, e1x);
      s_rec[j][1] = make_float4(e1y, e1z, e2x, e2y);
      s_rec[j][2] = make_float4(e2z, qvx, qvy, qvz);
      s_rec[j][3] = make_float4(e2q, payload[9 * L + p], 0.0f, 0.0f);
    }
    __syncthreads();

    float m = kInf;
    int im = kSentinel;
    for (int b = 0; b < n; b += kBatch) {
      const float bound =
          warp_max(in_image ? fminf(best_t, m) : -INFINITY);
      bool keep = false;
      if (warp_has_pixels && b + lane < n) {
        const Rec r = load_rec(s_rec[b + lane]);
        keep = r.id != kSentinel &&
               !culled(r, bx, by, bz, t_min, t_max, bound);
      }
      for (unsigned mask = __ballot_sync(kFull, keep); mask;
           mask &= mask - 1) {
        const Rec r = load_rec(s_rec[b + __ffs(mask) - 1]);
        const float pvx = sub(mul(dy, r.e2z), mul(dz, r.e2y));
        const float pvy = sub(mul(dz, r.e2x), mul(dx, r.e2z));
        const float pvz = sub(mul(dx, r.e2y), mul(dy, r.e2x));
        const float det = add(add(mul(r.e1x, pvx), mul(r.e1y, pvy)),
                              mul(r.e1z, pvz));
        const bool det_ok = fabsf(det) > kDetEps;
        const float rcp = __frcp_rn(det_ok ? det : 1.0f);  // no branch
        const float inv_det = det_ok ? rcp : 0.0f;
        const float u = mul(add(add(mul(r.tx, pvx), mul(r.ty, pvy)),
                                mul(r.tz, pvz)), inv_det);
        const float v = mul(add(add(mul(dx, r.qx), mul(dy, r.qy)),
                                mul(dz, r.qz)), inv_det);
        const float t = mul(r.e2q, inv_det);
        const bool ok = det_ok && u >= 0.0f && v >= 0.0f &&
                        add(u, v) <= 1.0f && t > t_min && t < t_max;
        if (ok && (t < m || (t == m && r.id < im))) {
          m = t;
          im = r.id;
        }
      }
    }
    if (m < best_t) {
      best_t = m;
      best_id = im;
    }
    const float wm = warp_max(best_t);
    if (lane == 0) s_wmax[warp] = wm;
    __syncthreads();
    B = s_wmax[0];
    for (int w = 1; w < nwarps; ++w) B = fmaxf(B, s_wmax[w]);
  }

  if (in_image) {
    t_out[pix] = best_t;
    id_out[pix] = best_id;
  }
}

}  // namespace

extern "C" {

int gsrt_tri_cast(const float* payload, long long L, const float* origin,
                  const int* tile_start, int T, int ntx, int width,
                  int height, int tile_w, int tile_h, const float* dirs,
                  float t_min, float t_max, float* t_out, int* id_out,
                  void* stream) {
  const int threads = tile_w * tile_h;
  if (threads % 32 != 0 || threads <= 0 || threads > kMaxThreads)
    return (int)cudaErrorInvalidValue;
  if (T > 0)
    tri_cast_kernel<<<T, threads, 0, (cudaStream_t)stream>>>(
        payload, L, origin, tile_start, ntx, width, height, tile_w, dirs,
        t_min, t_max, t_out, id_out);
  return (int)cudaGetLastError();
}

// The build: registers, static and dynamic shared memory, spilled bytes a
// thread, resident blocks of `threads` an SM.
int gsrt_tri_cast_info(int threads, int* info) {
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, tri_cast_kernel);
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, tri_cast_kernel, threads, 0);
  if (err != cudaSuccess) return (int)err;
  info[0] = a.numRegs;
  info[1] = (int)a.sharedSizeBytes;
  info[2] = 0;
  info[3] = (int)a.localSizeBytes;
  info[4] = blocks;
  return 0;
}

const char* gsrt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
