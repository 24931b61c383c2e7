// Per-ray BVH closest hit for triangle meshes.
//
// Replaces no TPU kernel. The TPU kernel gsrt/ops/tri_kernel.py:_tri_kernel
// (csrc/tri_kernel.cu here) walks one list of super-clusters for a block of
// rays and tests whole 128-triangle clusters densely: right for coherent
// bundles and a matrix unit. After a path's first bounce the rays scatter
// in every direction, and each 512-ray block visits most of the scene; so
// the path tracer's later waves (models/path_tracer.py, `pt.traverse`)
// take this kernel instead: every ray walks a binary tree on its own.
//
// Contract (gsrt_torch/ops/tri_bvh.py). nodes [NI, 16] f32 and root_box
// [6]: the node records of bvh_walk.cuh. Leaf l holds table slots 4l ..
// 4l + 3: the table is [M, 9, 128] f32 (per cluster the rows v0 xyz, e1
// xyz, e2 xyz over its 128 slots), so a leaf is one float4 of each of the
// 9 rows of cluster l / 32. Rays: orig, dirn [R, 3]; t_min, t_max per ray
// where the pointer is given, else the scalar. Out: t [R] (+inf on a
// miss), slot [R] (0 on a miss). counts, where given, receives (node
// records fetched, triangle tests, rays that entered the root box), added
// to what it holds.
//
// Semantics (the plain version's, exactly): the least (t, slot) over every
// slot the leaves hold of the Moller-Trumbore hits in (tmin, tmax), each
// rounded as tri_kernel.cu's (no FMA contraction, a correctly rounded
// 1/det), so on equal t the smaller slot wins. A box is entered where its
// slab window meets [tmin, min(tmax, best)] (bvh_walk.cuh). Leaf boxes
// are widened at the build by a share of the scene's extent (tri_bvh.py
// BOX_PAD), a margin set by measurement and not derived from
// Moller-Trumbore's rounding: as a ray turns parallel to a triangle, u, v
// and t lose their precision and a hit may be accepted outside any finite
// pad, so equality with the plain version is measured, not guaranteed
// (tri_bvh.py says where it was measured and where it failed). The walk
// is walk_bvh_plain's, step for step, which the counters follow.
//
// Design. One ray a thread; warps persist and take 32 rays at a time from
// a global counter (Aila & Laine 2009), so a warp whose rays end early
// takes new ones instead of idling to the end of a block. The walk is
// bvh_walk.cuh's (nodes until a leaf, then the leaf: their while-while
// loop). A leaf reads its 4 slots straight from the table, 9 float4
// loads. Rays that the coherence sort parked outside the scene leave at
// the root box test. Measured on the card and dropped (PERF.md): a node
// or a leaf a step (if-if: 18% slower); in that loop, lanes taking a new
// ray as soon as theirs ends or once 8 or 16 of a warp wait (dynamic
// fetch: 4-19% slower on the bounce-1 wave, 6-13% faster on bounce 8,
// slower than while-while on both); 64 or 256 threads a block (equal, 4%
// slower); registers capped for 8 blocks an SM (2% faster on if-if, with
// spills).
//
// Bound. Instruction issue and L2 latency: the tree (64 B a node, about
// 5.8 MB at 359,309 triangles) and the table (12.9 MB) sit in the 50 MB
// L2, and a ray's node fetches depend on each other. No roofline share is
// given (as for tri_kernel.cu: one structure's bound can be beaten by
// another's); PERF.md gives nodes and tests a ray beside the time.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "bvh_walk.cuh"

namespace {

using namespace gsrt::bvh;

constexpr int kThreads = 128;
constexpr int kRow4 = 128 / 4;              // float4s a geometry row
constexpr int kCluster4 = 9 * kRow4;        // float4s a cluster

// One Moller-Trumbore test, rounded as tri_kernel.cu's and the plain
// version's _mt; the ray keeps the least (t, slot).
__device__ __forceinline__ void mt_test(const Ray& r, float tmin,
                                        float tmax, float v0x, float v0y,
                                        float v0z, float e1x, float e1y,
                                        float e1z, float e2x, float e2y,
                                        float e2z, int slot, float& bt,
                                        int& bi) {
  const float pvx = sub(mul(r.dy, e2z), mul(r.dz, e2y));
  const float pvy = sub(mul(r.dz, e2x), mul(r.dx, e2z));
  const float pvz = sub(mul(r.dx, e2y), mul(r.dy, e2x));
  const float det = add(add(mul(e1x, pvx), mul(e1y, pvy)), mul(e1z, pvz));
  const float inv_det = __fdiv_rn(1.0f, det);
  const float tvx = sub(r.ox, v0x), tvy = sub(r.oy, v0y),
              tvz = sub(r.oz, v0z);
  const float u = mul(add(add(mul(tvx, pvx), mul(tvy, pvy)), mul(tvz, pvz)),
                      inv_det);
  const float qvx = sub(mul(tvy, e1z), mul(tvz, e1y));
  const float qvy = sub(mul(tvz, e1x), mul(tvx, e1z));
  const float qvz = sub(mul(tvx, e1y), mul(tvy, e1x));
  const float v = mul(add(add(mul(r.dx, qvx), mul(r.dy, qvy)),
                          mul(r.dz, qvz)), inv_det);
  const float t = mul(add(add(mul(e2x, qvx), mul(e2y, qvy)), mul(e2z, qvz)),
                      inv_det);
  const bool ok = fabsf(det) > 1e-12f && u >= 0.0f && v >= 0.0f &&
                  add(u, v) <= 1.0f && t > tmin && t < tmax;
  if (ok && (t < bt || (t == bt && slot < bi))) {
    bt = t;
    bi = slot;
  }
}

// Leaf l's four slots against the ray.
__device__ __forceinline__ void leaf_test(const float4* __restrict__ table,
                                          int l, const Ray& r, float tmin,
                                          float tmax, float& bt, int& bi) {
  const float4* g = table + (size_t)(l >> 5) * kCluster4 + (l & 31);
  const float4 v0x = __ldg(g), v0y = __ldg(g + kRow4),
               v0z = __ldg(g + 2 * kRow4);
  const float4 e1x = __ldg(g + 3 * kRow4), e1y = __ldg(g + 4 * kRow4),
               e1z = __ldg(g + 5 * kRow4);
  const float4 e2x = __ldg(g + 6 * kRow4), e2y = __ldg(g + 7 * kRow4),
               e2z = __ldg(g + 8 * kRow4);
  const int s = 4 * l;
  mt_test(r, tmin, tmax, v0x.x, v0y.x, v0z.x, e1x.x, e1y.x, e1z.x, e2x.x,
          e2y.x, e2z.x, s, bt, bi);
  mt_test(r, tmin, tmax, v0x.y, v0y.y, v0z.y, e1x.y, e1y.y, e1z.y, e2x.y,
          e2y.y, e2z.y, s + 1, bt, bi);
  mt_test(r, tmin, tmax, v0x.z, v0y.z, v0z.z, e1x.z, e1y.z, e1z.z, e2x.z,
          e2y.z, e2z.z, s + 2, bt, bi);
  mt_test(r, tmin, tmax, v0x.w, v0y.w, v0z.w, e1x.w, e1y.w, e1z.w, e2x.w,
          e2y.w, e2z.w, s + 3, bt, bi);
}

__global__ void __launch_bounds__(kThreads)
tri_bvh_kernel(const float4* __restrict__ nodes,
               const float* __restrict__ root_box,
               const float4* __restrict__ table,
               const float* __restrict__ orig, const float* __restrict__ dirn,
               const float* __restrict__ tmin_p, float tmin_s,
               const float* __restrict__ tmax_p, float tmax_s, int R,
               int* __restrict__ next_ray, float* __restrict__ t_out,
               int* __restrict__ slot_out,
               unsigned long long* __restrict__ counts) {
  const int lane = threadIdx.x % kWarp;
  float rb[6];
#pragma unroll
  for (int a = 0; a < 6; ++a) rb[a] = __ldg(root_box + a);
  unsigned n_nodes = 0, n_tests = 0, n_rays = 0;
  int2 stack[kStack];   // (node or leaf id, t_near bits)

  for (;;) {
    int base = 0;
    if (lane == 0) base = atomicAdd(next_ray, kWarp);
    base = __shfl_sync(kFull, base, 0);
    if (base >= R) break;
    const int i = base + lane;
    if (i >= R) continue;
    const Ray r{orig[3 * i], orig[3 * i + 1], orig[3 * i + 2],
                dirn[3 * i], dirn[3 * i + 1], dirn[3 * i + 2]};
    const float tmin = tmin_p ? tmin_p[i] : tmin_s;
    const float tmax = tmax_p ? tmax_p[i] : tmax_s;
    float bt = INFINITY;
    int bi = 0;
    n_rays += walk(
        nodes, rb, r, inv_dir(r), tmin, stack, n_nodes,
        [&] { return jmin(tmax, bt); },
        [&](int l) {
          leaf_test(table, l, r, tmin, tmax, bt, bi);
          n_tests += 4;
        });
    t_out[i] = bt;
    slot_out[i] = bi;
  }

  if (counts != nullptr) {
    n_nodes = __reduce_add_sync(kFull, n_nodes);
    n_tests = __reduce_add_sync(kFull, n_tests);
    n_rays = __reduce_add_sync(kFull, n_rays);
    if (lane == 0) {
      atomicAdd(counts, (unsigned long long)n_nodes);
      atomicAdd(counts + 1, (unsigned long long)n_tests);
      atomicAdd(counts + 2, (unsigned long long)n_rays);
    }
  }
}

}  // namespace

extern "C" {

int gsrt_tri_bvh(const float* nodes, const float* root_box,
                 const float* table, const float* orig, const float* dirn,
                 const float* tmin_p, float tmin_s, const float* tmax_p,
                 float tmax_s, int R, int* next_ray, float* t_out,
                 int* slot_out, long long* counts, void* stream) {
  if (R < 0 || reinterpret_cast<uintptr_t>(nodes) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(table) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  if (R == 0) return (int)cudaGetLastError();
  const cudaStream_t s = (cudaStream_t)stream;
  int blocks = 0;
  cudaError_t err =
      persistent_grid(tri_bvh_kernel, kThreads, R, next_ray, s, &blocks);
  if (err != cudaSuccess) return (int)err;
  tri_bvh_kernel<<<blocks, kThreads, 0, s>>>(
      reinterpret_cast<const float4*>(nodes), root_box,
      reinterpret_cast<const float4*>(table), orig, dirn, tmin_p, tmin_s,
      tmax_p, tmax_s, R, next_ray, t_out, slot_out,
      reinterpret_cast<unsigned long long*>(counts));
  return (int)cudaGetLastError();
}

// What the build gave the kernel (bvh_walk.cuh kernel_info).
int gsrt_tri_bvh_info(int* info) {
  return kernel_info(tri_bvh_kernel, kThreads, info);
}

const char* gsrt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
