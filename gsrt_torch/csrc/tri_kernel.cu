// Cluster-BVH closest hit and any hit for triangle meshes.
//
// Replaces the TPU kernel gsrt/ops/tri_kernel.py:_tri_kernel (:266, reached
// through closest_hit_packed :444): per block of rb rays, walk the block's
// front-to-back list of super-clusters (8 clusters of 128 triangles each),
// cull each cluster by its AABB and run dense Moller-Trumbore on the rest.
//
// Contract. table [M, 9, 128] f32: per cluster the rows v0 xyz, e1 xyz,
// e2 xyz over its 128 triangle slots; box [M, 6] f32: each cluster's AABB
// (min xyz, max xyz); super-cluster s owns clusters 8s .. 8s + 7. Block b
// visits visit[block_start[b] .. block_start[b + 1]) in order, visit_near
// holding each visit's entry distance as the bits of a non-negative f32.
// rays [8, Rp] f32 rows ox oy oz dx dy dz tmin tmax, Rp = blocks * rb.
// Out: t [Rp] (+inf on a miss), slot [Rp] (cluster * 128 + triangle; 0 on
// a miss), actual [blocks] (visits executed).
//
// Semantics (the TPU kernel's, exactly):
// - visit j + 1 runs only if its entry distance is below the block's
//   largest best t taken BEFORE visit j is processed, clamped at 0 (any
//   hit: a ray with a hit counts as -inf); compared as int bits;
// - a cluster runs if some ray's slab window [max(t_in, tmin),
//   min(t_out, lim)] is non-empty, lim = min(tmax, best) (any hit: tmax,
//   or -inf once the ray has a hit);
// - within a cluster a ray takes the smallest t, ties to the smallest
//   slot, and keeps it only when strictly below its best; any hit changes
//   nothing else (a ray with a hit still takes nearer ones).
// Moller-Trumbore and the slab test round as written (no FMA
// contraction), min and max propagate NaN as torch.minimum does, so the
// kernel equals the plain version (gsrt_torch/ops/tri_kernel.py) bit for
// bit.
//
// Design. One block per ray block, one thread per ray. A visit stages its
// super-cluster (8 x 9 x 128 floats, 36 KB, plus the 8 boxes) in shared
// memory with a plain coalesced load; every thread then reads each
// triangle as a broadcast. The cluster cull is one __syncthreads_or, the
// go-on decision another. The TPU kernel's double-buffered DMA and its
// sublane/lane table layout follow from its memory rules; this is the
// simple version (ROADMAP Queue 2 lists the redesign).
//
// Bound. Operations: about 55 f32 operations per (ray, triangle) of a
// cluster that runs (MT_FLOPS in chip_smoke.py), against reading the
// table, the visit list and the rays once.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kK = 128;
constexpr int kSup = 8;
constexpr int kGeom = 9;
constexpr int kMaxThreads = 1024;

__device__ __forceinline__ float jmin(float a, float b) {
  return (isnan(a) || isnan(b)) ? NAN : fminf(a, b);
}
__device__ __forceinline__ float jmax(float a, float b) {
  return (isnan(a) || isnan(b)) ? NAN : fmaxf(a, b);
}
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
tri_traverse_kernel(const float* __restrict__ table,
                    const float* __restrict__ box,
                    const int* __restrict__ block_start,
                    const int* __restrict__ visit,
                    const int* __restrict__ visit_near, int mv,
                    const float* __restrict__ rays, int Rp, int any_hit,
                    float* __restrict__ t_out, int* __restrict__ slot_out,
                    int* __restrict__ actual) {
  __shared__ float s_geo[kSup * kGeom * kK];
  __shared__ float s_box[kSup * 6];

  const int b = blockIdx.x;
  const int r = b * blockDim.x + threadIdx.x;
  const float ox = rays[r], oy = rays[Rp + r], oz = rays[2 * Rp + r];
  const float dx = rays[3 * Rp + r], dy = rays[4 * Rp + r],
              dz = rays[5 * Rp + r];
  const float tmin = rays[6 * Rp + r], tmax = rays[7 * Rp + r];
  const float eps = 1e-20f;
  const float ivx = __fdiv_rn(1.0f, fabsf(dx) < eps ? eps : dx);
  const float ivy = __fdiv_rn(1.0f, fabsf(dy) < eps ? eps : dy);
  const float ivz = __fdiv_rn(1.0f, fabsf(dz) < eps ? eps : dz);

  const int v0i = block_start[b];
  const int nv = block_start[b + 1] - v0i;
  float bt = INFINITY;
  int bi = 0;
  int executed = 0;

  for (int j = 0; j < nv; ++j) {
    // go on to visit j + 1? decided before visit j updates the best
    const float eff = (any_hit && isfinite(bt)) ? -INFINITY : bt;
    const int best_bits = __float_as_int(fmaxf(eff, 0.0f));
    const int nxt = visit_near[min(v0i + j + 1, mv - 1)];
    const bool go_on = __syncthreads_or(best_bits > nxt) && j + 1 < nv;

    const int c = visit[v0i + j];
    const float* g = table + (size_t)c * kSup * kGeom * kK;
    for (int i = threadIdx.x; i < kSup * kGeom * kK; i += blockDim.x)
      s_geo[i] = __ldg(g + i);
    for (int i = threadIdx.x; i < kSup * 6; i += blockDim.x)
      s_box[i] = __ldg(box + (size_t)c * kSup * 6 + i);
    __syncthreads();
    ++executed;

    for (int cj = 0; cj < kSup; ++cj) {
      const float* bx = s_box + cj * 6;
      const float lim = any_hit ? (isfinite(bt) ? -INFINITY : tmax)
                                : jmin(tmax, bt);
      const float l0 = mul(sub(bx[0], ox), ivx), h0 = mul(sub(bx[3], ox), ivx);
      const float l1 = mul(sub(bx[1], oy), ivy), h1 = mul(sub(bx[4], oy), ivy);
      const float l2 = mul(sub(bx[2], oz), ivz), h2 = mul(sub(bx[5], oz), ivz);
      const float t_in = jmax(jmax(jmin(l0, h0), jmin(l1, h1)),
                              jmax(jmin(l2, h2), tmin));
      const float t_out = jmin(jmin(jmax(l0, h0), jmax(l1, h1)),
                               jmin(jmax(l2, h2), lim));
      if (!__syncthreads_or(t_in <= t_out)) continue;

      const float* gc = s_geo + cj * kGeom * kK;
      float tc = INFINITY;
      int ic = 0;
      for (int k = 0; k < kK; ++k) {
        const float v0x = gc[k], v0y = gc[kK + k], v0z = gc[2 * kK + k];
        const float e1x = gc[3 * kK + k], e1y = gc[4 * kK + k],
                    e1z = gc[5 * kK + k];
        const float e2x = gc[6 * kK + k], e2y = gc[7 * kK + k],
                    e2z = gc[8 * kK + k];
        const float pvx = sub(mul(dy, e2z), mul(dz, e2y));
        const float pvy = sub(mul(dz, e2x), mul(dx, e2z));
        const float pvz = sub(mul(dx, e2y), mul(dy, e2x));
        const float det = add(add(mul(e1x, pvx), mul(e1y, pvy)),
                              mul(e1z, pvz));
        const bool det_ok = fabsf(det) > 1e-12f;
        const float inv_det = det_ok ? __fdiv_rn(1.0f, det) : 0.0f;
        const float tvx = sub(ox, v0x), tvy = sub(oy, v0y),
                    tvz = sub(oz, v0z);
        const float u = mul(add(add(mul(tvx, pvx), mul(tvy, pvy)),
                                mul(tvz, pvz)), inv_det);
        const float qvx = sub(mul(tvy, e1z), mul(tvz, e1y));
        const float qvy = sub(mul(tvz, e1x), mul(tvx, e1z));
        const float qvz = sub(mul(tvx, e1y), mul(tvy, e1x));
        const float v = mul(add(add(mul(dx, qvx), mul(dy, qvy)),
                                mul(dz, qvz)), inv_det);
        const float t = mul(add(add(mul(e2x, qvx), mul(e2y, qvy)),
                                mul(e2z, qvz)), inv_det);
        const bool ok = det_ok && u >= 0.0f && v >= 0.0f &&
                        add(u, v) <= 1.0f && t > tmin && t < tmax;
        if (ok && t < tc) {
          tc = t;
          ic = k;
        }
      }
      if (tc < bt) {
        bt = tc;
        bi = (c * kSup + cj) * kK + ic;
      }
    }
    __syncthreads();  // the next visit overwrites the staged cluster
    if (!go_on) break;
  }

  t_out[r] = bt;
  slot_out[r] = bi;
  if (threadIdx.x == 0) actual[b] = executed;
}

}  // namespace

extern "C" {

int gsrt_tri_traverse(const float* table, const float* box, int m,
                      const int* block_start, const int* visit,
                      const int* visit_near, int mv, const float* rays,
                      int Rp, int rb, int any_hit, float* t_out,
                      int* slot_out, int* actual, void* stream) {
  if (rb % 32 != 0 || rb <= 0 || rb > kMaxThreads || Rp % rb != 0 ||
      m % kSup != 0 || mv <= 0)
    return (int)cudaErrorInvalidValue;
  const int blocks = Rp / rb;
  if (blocks > 0)
    tri_traverse_kernel<<<blocks, rb, 0, (cudaStream_t)stream>>>(
        table, box, block_start, visit, visit_near, mv, rays, Rp, any_hit,
        t_out, slot_out, actual);
  return (int)cudaGetLastError();
}

const char* gsrt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
