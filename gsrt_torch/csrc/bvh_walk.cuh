// The per-ray tree walk shared by the tree kernels: tri_bvh.cu (a ray's
// closest triangle) and splat_bvh.cu (a ray's k-buffer passes over
// splats). Each kernel brings its leaf test and the far end of its
// window; the node records, the box test, the stack and the order of the
// walk are this file's, so the two trees cannot drift apart.
//
// Node records (gsrt_torch/ops/bvh.py node_records): nodes [NI, 16] f32,
// 64 B a node: float4 0 = child 0's lo x, hi x, lo y, hi y; float4 1 =
// the same of child 1; float4 2 = lo z, hi z of child 0, lo z, hi z of
// child 1; float4 3 = the children's int32 ids (c >= 0 an internal node,
// c < 0 the leaf ~c), two unused words. The root is node 0, its own box
// root_box [6] (lo xyz, hi xyz).
//
// The walk (the plain walks' of ops/tri_bvh.py and ops/splat_bvh.py, step
// for step; ops/bvh.py `slab` is the box test). A box is entered where
// its slab window [t_near, t_far * kFarScale] meets the ray's window
// [lo, lim] (kFarScale >= 1 + 2 gamma_3: Ize 2013; t_near compared with
// <=, so ties are visited); min and max carry a NaN (min.NaN / max.NaN,
// as torch.minimum and torch.maximum do). The ray walks nodes until it
// reaches a leaf, then tests the leaf (Aila & Laine 2009's while-while
// loop). A node fetch is four read-only float4 loads and tests both
// children; the nearer child is taken first and the other pushed with
// its t_near on a stack of kStack entries in local memory, and a popped
// entry whose t_near lies past the window is dropped unfetched. `lim` is
// read anew at every node and pop, so a leaf that narrows the window
// prunes the rest of the walk. The builds check that a tree's depth fits
// the stack.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace gsrt {
namespace bvh {

constexpr int kWarp = 32;
constexpr int kStack = 64;                  // ops/*_bvh.py STACK
constexpr int kEmpty = -2147483647 - 1;     // ops/bvh.py EMPTY
constexpr float kEps = 1e-20f;              // ops/bvh.py EPS
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
  float ox, oy, oz, dx, dy, dz;
};

// The ray's inverse direction, each |d| under kEps taken as kEps.
__device__ __forceinline__ float3 inv_dir(const Ray& r) {
  return make_float3(__fdiv_rn(1.0f, fabsf(r.dx) < kEps ? kEps : r.dx),
                     __fdiv_rn(1.0f, fabsf(r.dy) < kEps ? kEps : r.dy),
                     __fdiv_rn(1.0f, fabsf(r.dz) < kEps ? kEps : r.dz));
}

// The box (lo x, hi x, lo y, hi y, lo z, hi z) against the window
// [lo, lim]: whether it is entered, and its t_near.
__device__ __forceinline__ bool slab(float lox, float hix, float loy,
                                     float hiy, float loz, float hiz,
                                     const Ray& r, const float3& iv,
                                     float lo, float lim, float& tn) {
  const float l0 = mul(sub(lox, r.ox), iv.x), h0 = mul(sub(hix, r.ox), iv.x);
  const float l1 = mul(sub(loy, r.oy), iv.y), h1 = mul(sub(hiy, r.oy), iv.y);
  const float l2 = mul(sub(loz, r.oz), iv.z), h2 = mul(sub(hiz, r.oz), iv.z);
  tn = jmax(jmax(jmin(l0, h0), jmin(l1, h1)), jmin(l2, h2));
  const float tf =
      mul(jmin(jmin(jmax(l0, h0), jmax(l1, h1)), jmax(l2, h2)), kFarScale);
  return tn <= tf && tf >= lo && tn <= lim;
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

// One walk of the tree from the root, front to back, over the window
// [lo, lim()]: leaf(l) for every leaf l it reaches, in walk order.
// n_nodes counts the node records fetched. Returns whether the root box
// was entered. stack holds kStack entries (node or leaf id, t_near bits).
template <class Lim, class Leaf>
__device__ __forceinline__ bool walk(const float4* __restrict__ nodes,
                                     const float (&rb)[6], const Ray& r,
                                     const float3& iv, float lo,
                                     int2* stack, unsigned& n_nodes,
                                     Lim lim, Leaf leaf) {
  float tn;
  int cur = slab(rb[0], rb[3], rb[1], rb[4], rb[2], rb[5], r, iv, lo, lim(),
                 tn) ? 0 : kEmpty;
  const bool entered = cur == 0;
  int sp = 0;
  // nodes until the ray reaches a leaf or runs out (the warp's lanes wait
  // for each other there), then the leaf
  while (cur != kEmpty) {
    while (cur >= 0) {
      const float4* nd = nodes + 4 * (size_t)cur;
      const float4 a = __ldg(nd), b = __ldg(nd + 1), c = __ldg(nd + 2),
                   d = __ldg(nd + 3);
      ++n_nodes;
      const float l = lim();
      float t0, t1;
      const bool h0 = slab(a.x, a.y, a.z, a.w, c.x, c.y, r, iv, lo, l, t0);
      const bool h1 = slab(b.x, b.y, b.z, b.w, c.z, c.w, r, iv, lo, l, t1);
      const int k0 = __float_as_int(d.x), k1 = __float_as_int(d.y);
      if (h0 && h1) {
        const bool swap = t1 < t0;
        stack[sp++] = swap ? make_int2(k0, __float_as_int(t0))
                           : make_int2(k1, __float_as_int(t1));
        cur = swap ? k1 : k0;
      } else if (h0 || h1) {
        cur = h0 ? k0 : k1;
      } else {
        cur = pop(stack, sp, l);
      }
    }
    if (cur == kEmpty) break;
    leaf(~cur);
    cur = pop(stack, sp, lim());
  }
  return entered;
}

// The blocks of a launch over R rays whose warps persist and take 32 rays
// at a time from the counter next_ray: the card filled with resident
// blocks of `threads`, no more than the rays need; the counter zeroed on
// the stream.
template <class Kernel>
inline cudaError_t persistent_grid(Kernel kernel, int threads, int R,
                                   int* next_ray, cudaStream_t s,
                                   int* blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        threads, 0);
  if (err != cudaSuccess) return err;
  const int wanted = (R + threads - 1) / threads;
  *blocks = sms * per_sm;
  if (*blocks > wanted || *blocks <= 0) *blocks = wanted;
  return cudaMemsetAsync(next_ray, 0, sizeof(int), s);
}

// What the build gave a kernel: info = {registers a thread, static shared
// bytes, local (stack and spill) bytes a thread, resident blocks an SM,
// threads a block, blocks a launch fills the card with}.
template <class Kernel>
inline int kernel_info(Kernel kernel, int threads, int* info) {
  cudaFuncAttributes a;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaFuncGetAttributes(&a, kernel);
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        threads, 0);
  if (err != cudaSuccess) return (int)err;
  info[0] = a.numRegs;
  info[1] = (int)a.sharedSizeBytes;
  info[2] = (int)a.localSizeBytes;
  info[3] = per_sm;
  info[4] = threads;
  info[5] = sms * per_sm;
  return 0;
}

}  // namespace bvh
}  // namespace gsrt
