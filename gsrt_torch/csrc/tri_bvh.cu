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
// Contract (gsrt_torch/ops/tri_bvh.py). nodes [NI, 16] f32, 64 B a node:
// float4 0 = child 0's lo x, hi x, lo y, hi y; float4 1 = the same of
// child 1; float4 2 = lo z, hi z of child 0, lo z, hi z of child 1;
// float4 3 = the children's int32 ids (c >= 0 an internal node, c < 0 the
// leaf ~c), two unused words. The root is node 0, its own box root_box
// [6] (lo xyz, hi xyz). Leaf l holds table slots 4l .. 4l + 3: the table
// is [M, 9, 128] f32 (per cluster the rows v0 xyz, e1 xyz, e2 xyz over its
// 128 slots), so a leaf is one float4 of each of the 9 rows of cluster
// l / 32. Rays: orig, dirn [R, 3]; t_min, t_max per ray where the pointer
// is given, else the scalar. Out: t [R] (+inf on a miss), slot [R] (0 on
// a miss). counts, where given, receives (node records fetched, triangle
// tests, rays that entered the root box), added to what it holds.
//
// Semantics (the plain version's, exactly): the least (t, slot) over every
// slot the leaves hold of the Moller-Trumbore hits in (tmin, tmax), each
// rounded as tri_kernel.cu's (no FMA contraction, a correctly rounded
// 1/det), so on equal t the smaller slot wins. A box is entered where its
// slab window [t_near, t_far * kFarScale] meets [tmin, min(tmax, best)]
// (kFarScale >= 1 + 2 gamma_3: Ize 2013; t_near compared with <=, so ties
// are visited). Leaf boxes are widened at the build by a share of the
// scene's extent (tri_bvh.py BOX_PAD), a margin set by measurement and not
// derived from Moller-Trumbore's rounding: as a ray turns parallel to a
// triangle, u, v and t lose their precision and a hit may be accepted
// outside any finite pad, so equality with the plain version is measured,
// not guaranteed (tri_bvh.py says where it was measured and where it
// failed). The walk is walk_bvh_plain's, step for step, which the counters
// follow.
//
// Design. One ray a thread; warps persist and take 32 rays at a time from
// a global counter (Aila & Laine 2009), so a warp whose rays end early
// takes new ones instead of idling to the end of a block. A ray walks
// nodes until it reaches a leaf, then tests the leaf (their while-while
// loop). A node fetch is four read-only float4 loads and tests both
// children; the nearer child is taken first and the other pushed with its
// t_near on a stack of kStack entries in local memory, and a popped entry
// whose t_near lies past the ray's window is dropped unfetched. A leaf
// reads its 4 slots straight from the table, 9 float4 loads. The build
// checks that the tree's depth fits the stack. Rays that the coherence
// sort parked outside the scene leave at the root box test. Measured on
// the card and dropped (PERF.md): a node or a leaf a
// step (if-if: 18% slower); in that loop, lanes taking a new ray as soon
// as theirs ends or once 8 or 16 of a warp wait (dynamic fetch: 4-19%
// slower on the bounce-1 wave, 6-13% faster on bounce 8, slower than
// while-while on both); 64 or 256 threads a block (equal, 4% slower);
// registers capped for 8 blocks an SM (2% faster on if-if, with spills).
//
// Bound. Instruction issue and L2 latency: the tree (64 B a node, about
// 5.8 MB at 359,309 triangles) and the table (12.9 MB) sit in the 50 MB
// L2, and a ray's node fetches depend on each other. No roofline share is
// given (as for tri_kernel.cu: one structure's bound can be beaten by
// another's); PERF.md gives nodes and tests a ray beside the time.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarp = 32;
constexpr int kStack = 64;                  // ops/tri_bvh.py STACK
constexpr int kRow4 = 128 / 4;              // float4s a geometry row
constexpr int kCluster4 = 9 * kRow4;        // float4s a cluster
constexpr int kEmpty = -2147483647 - 1;     // no more work for the ray
constexpr float kEps = 1e-20f;
constexpr float kFarScale = 1.000000476837158203125f;  // 1 + 2^-21
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float jmin(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}
__device__ __forceinline__ float jmax(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
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

struct Ray {
  float ox, oy, oz, dx, dy, dz, tmin, tmax;
};

// The box (lo x, hi x, lo y, hi y, lo z, hi z) against the ray's window
// [tmin, lim]: whether it is entered, and its t_near.
__device__ __forceinline__ bool slab(float lox, float hix, float loy,
                                     float hiy, float loz, float hiz,
                                     const Ray& r, const float3& iv,
                                     float lim, float& tn) {
  const float l0 = mul(sub(lox, r.ox), iv.x), h0 = mul(sub(hix, r.ox), iv.x);
  const float l1 = mul(sub(loy, r.oy), iv.y), h1 = mul(sub(hiy, r.oy), iv.y);
  const float l2 = mul(sub(loz, r.oz), iv.z), h2 = mul(sub(hiz, r.oz), iv.z);
  tn = jmax(jmax(jmin(l0, h0), jmin(l1, h1)), jmin(l2, h2));
  const float tf =
      mul(jmin(jmin(jmax(l0, h0), jmax(l1, h1)), jmax(l2, h2)), kFarScale);
  return tn <= tf && tf >= r.tmin && tn <= lim;
}

// One Moller-Trumbore test, rounded as tri_kernel.cu's and the plain
// version's _mt; the ray keeps the least (t, slot).
__device__ __forceinline__ void mt_test(const Ray& r, float v0x, float v0y,
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
                  add(u, v) <= 1.0f && t > r.tmin && t < r.tmax;
  if (ok && (t < bt || (t == bt && slot < bi))) {
    bt = t;
    bi = slot;
  }
}

// Leaf l's four slots against the ray.
__device__ __forceinline__ void leaf_test(const float4* __restrict__ table,
                                          int l, const Ray& r, float& bt,
                                          int& bi) {
  const float4* g = table + (size_t)(l >> 5) * kCluster4 + (l & 31);
  const float4 v0x = __ldg(g), v0y = __ldg(g + kRow4),
               v0z = __ldg(g + 2 * kRow4);
  const float4 e1x = __ldg(g + 3 * kRow4), e1y = __ldg(g + 4 * kRow4),
               e1z = __ldg(g + 5 * kRow4);
  const float4 e2x = __ldg(g + 6 * kRow4), e2y = __ldg(g + 7 * kRow4),
               e2z = __ldg(g + 8 * kRow4);
  const int s = 4 * l;
  mt_test(r, v0x.x, v0y.x, v0z.x, e1x.x, e1y.x, e1z.x, e2x.x, e2y.x, e2z.x,
          s, bt, bi);
  mt_test(r, v0x.y, v0y.y, v0z.y, e1x.y, e1y.y, e1z.y, e2x.y, e2y.y, e2z.y,
          s + 1, bt, bi);
  mt_test(r, v0x.z, v0y.z, v0z.z, e1x.z, e1y.z, e1z.z, e2x.z, e2y.z, e2z.z,
          s + 2, bt, bi);
  mt_test(r, v0x.w, v0y.w, v0z.w, e1x.w, e1y.w, e1z.w, e2x.w, e2y.w, e2z.w,
          s + 3, bt, bi);
}

// The top stack entry whose t_near lies inside the window [.., lim],
// those above it dropped; kEmpty once the stack is empty.
__device__ __forceinline__ int pop(const int2* stack, int& sp, float lim) {
  while (sp > 0) {
    const int2 e = stack[--sp];
    if (__int_as_float(e.y) <= lim) return e.x;
  }
  return kEmpty;
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
                dirn[3 * i], dirn[3 * i + 1], dirn[3 * i + 2],
                tmin_p ? tmin_p[i] : tmin_s, tmax_p ? tmax_p[i] : tmax_s};
    const float3 iv = make_float3(
        __fdiv_rn(1.0f, fabsf(r.dx) < kEps ? kEps : r.dx),
        __fdiv_rn(1.0f, fabsf(r.dy) < kEps ? kEps : r.dy),
        __fdiv_rn(1.0f, fabsf(r.dz) < kEps ? kEps : r.dz));
    float bt = INFINITY;
    int bi = 0;
    float tn;
    int cur = slab(rb[0], rb[3], rb[1], rb[4], rb[2], rb[5], r, iv, r.tmax,
                   tn) ? 0 : kEmpty;
    n_rays += cur == 0;
    int sp = 0;
    // nodes until the ray reaches a leaf or runs out (the warp's lanes
    // wait for each other there), then the leaf
    while (cur != kEmpty) {
      while (cur >= 0) {
        const float4* nd = nodes + 4 * (size_t)cur;
        const float4 a = __ldg(nd), b = __ldg(nd + 1), c = __ldg(nd + 2),
                     d = __ldg(nd + 3);
        ++n_nodes;
        const float lim = jmin(r.tmax, bt);
        float t0, t1;
        const bool h0 = slab(a.x, a.y, a.z, a.w, c.x, c.y, r, iv, lim, t0);
        const bool h1 = slab(b.x, b.y, b.z, b.w, c.z, c.w, r, iv, lim, t1);
        const int k0 = __float_as_int(d.x), k1 = __float_as_int(d.y);
        if (h0 && h1) {
          const bool swap = t1 < t0;
          stack[sp++] = swap ? make_int2(k0, __float_as_int(t0))
                             : make_int2(k1, __float_as_int(t1));
          cur = swap ? k1 : k0;
        } else if (h0 || h1) {
          cur = h0 ? k0 : k1;
        } else {
          cur = pop(stack, sp, lim);
        }
      }
      if (cur == kEmpty) break;
      leaf_test(table, ~cur, r, bt, bi);
      n_tests += 4;
      cur = pop(stack, sp, jmin(r.tmax, bt));
    }
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

// Resident blocks an SM, and the SMs of the current device.
cudaError_t grid_size(int* blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, tri_bvh_kernel, kThreads, 0);
  *blocks = sms * per_sm;
  return err;
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
  int blocks = 0;
  cudaError_t err = grid_size(&blocks);
  if (err != cudaSuccess) return (int)err;
  const int wanted = (R + kThreads - 1) / kThreads;
  if (blocks > wanted || blocks <= 0) blocks = wanted;
  const cudaStream_t s = (cudaStream_t)stream;
  err = cudaMemsetAsync(next_ray, 0, sizeof(int), s);
  if (err != cudaSuccess) return (int)err;
  tri_bvh_kernel<<<blocks, kThreads, 0, s>>>(
      reinterpret_cast<const float4*>(nodes), root_box,
      reinterpret_cast<const float4*>(table), orig, dirn, tmin_p, tmin_s,
      tmax_p, tmax_s, R, next_ray, t_out, slot_out,
      reinterpret_cast<unsigned long long*>(counts));
  return (int)cudaGetLastError();
}

// What the build gave the kernel: info = {registers a thread, static
// shared bytes, local (stack and spill) bytes a thread, resident blocks an
// SM, threads a block, blocks a launch fills the card with}.
int gsrt_tri_bvh_info(int* info) {
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, tri_bvh_kernel);
  int blocks = 0, per_sm = 0;
  if (err == cudaSuccess) err = grid_size(&blocks);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, tri_bvh_kernel, kThreads, 0);
  if (err != cudaSuccess) return (int)err;
  info[0] = a.numRegs;
  info[1] = (int)a.sharedSizeBytes;
  info[2] = (int)a.localSizeBytes;
  info[3] = per_sm;
  info[4] = kThreads;
  info[5] = blocks;
  return 0;
}

const char* gsrt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
