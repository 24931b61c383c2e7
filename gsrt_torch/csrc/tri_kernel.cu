// Cluster-BVH closest hit and any hit for triangle meshes.
//
// Replaces the TPU kernel gsrt/ops/tri_kernel.py:_tri_kernel (:266, reached
// through closest_hit_packed :444): per block of rb rays, walk the block's
// front-to-back list of super-clusters (8 clusters of 128 triangles each),
// cull each cluster by its AABB and run dense Moller-Trumbore on the rest.
//
// Contract. table [M, 9, 128] f32: per cluster the rows v0 xyz, e1 xyz,
// e2 xyz over its 128 triangle slots; box [M, 6] f32: each cluster's AABB
// (min xyz, max xyz); super-cluster s owns clusters 8s .. 8s + 7, and
// sup_box [M / 8, 6] holds the AABBs of their members' boxes. Block b
// visits visit[block_start[b] .. block_start[b + 1]) in order, visit_near
// holding each visit's entry distance as the bits of a non-negative f32.
// rays [8, Rp] f32 rows ox oy oz dx dy dz tmin tmax, Rp = blocks * rb.
// Out: t [Rp] (+inf on a miss), slot [Rp] (cluster * 128 + triangle; 0 on
// a miss), actual [blocks] (visits executed).
//
// Semantics (the plain version's, gsrt_torch/ops/tri_kernel.py, exactly):
// - visit j + 1 runs only if its entry distance is below the block's
//   largest best t taken BEFORE visit j is processed, clamped at 0 (any
//   hit: a ray with a hit counts as -inf); compared as int bits. This is
//   the TPU kernel's rule, so `actual` follows it;
// - a cluster runs for a group of CULL_RAYS = 32 consecutive rays (one
//   warp) if some ray of the group has a non-empty slab window
//   [max(t_in, tmin), min(t_out, lim)], lim = min(tmax, best) (any hit:
//   tmax, or -inf once the ray has a hit), clusters taken in order with
//   the running best. The TPU kernel culls for the whole block; the two
//   differ only where rounding lets a ray hit a triangle of a cluster
//   whose box its own window misses;
// - within a cluster a ray takes the smallest t, ties to the smallest
//   slot, and keeps it only when strictly below its best; any hit changes
//   nothing else (a ray with a hit still takes nearer ones).
// Moller-Trumbore and the slab test round as written (no FMA
// contraction), min and max propagate NaN as torch.minimum does, and
// 1/det is correctly rounded (as the plain version's 1.0 / det), so the
// kernel equals the plain version bit for bit.
//
// Design. One block per ray block, one thread per ray, so a warp holds a
// cull group. A visit runs in three steps, as the plain version does:
// 1. each ray culls the 8 boxes with its best before the visit, unless
//    it misses the super-cluster's box: each slab operation is monotone
//    in the box's bounds, so a box inside a box that the window misses
//    is missed too, rounding included. (Padding clusters, whose inverted
//    boxes pass every window, exist only in the last super-cluster,
//    which is always culled box by box.) As the best only falls, the
//    (group, cluster) pairs that pass are a superset of those the exact
//    cull passes later. One block barrier (__syncthreads_or) publishes
//    them and takes the go-on decision, and one thread copies the
//    clusters that some group needs into shared memory with
//    cp.async.bulk (4,608 contiguous bytes each), completing on an
//    mbarrier;
// 2. the candidate pairs' triangles, 128 a pair, are split evenly over
//    all warps of the block: a warp tests its share against the 32 rays
//    of each pair's group (read from shared memory) and folds each ray's
//    first smallest hit into a 64-bit (t, slot) key with a shared
//    atomicMin, so a visit takes as long as its share of the block's
//    work, not as long as its busiest warp's clusters;
// 3. after a second barrier (skipped when no group has a candidate)
//    each warp commits its own rays, clusters in order: the exact cull
//    with the running best (__any_sync) and the key taken where strictly
//    nearer.
// The test loop takes four triangles a step: the [9][128] rows are read
// as float4 along the triangles, nine broadcast shared loads for four
// tests. Measured on the card and dropped (PERF.md): warps culling and
// testing their own clusters in lockstep between barriers (1.6x slower:
// warps idle while the busiest works), fixed 16-, 32- or 64-triangle
// chunks dealt in turn, copying the next super-cluster a visit ahead,
// rejecting before the division where all 32 rays provably fail,
// eight triangles a step, scalar shared loads and __frcp_rn for 1/det
// (all slower; __frcp_rn gives the same bits).
//
// Bound. Operations: 53 f32 operations per (ray, triangle) of a cluster
// that runs for the ray's warp (MT_FLOPS in chip_smoke.py), plus a slab
// test per (ray, cluster) of an executed visit; against reading the
// table, the visit list and the rays once. Moller-Trumbore without
// contraction is one instruction per operation (the 67 TFLOP/s peak
// counts an FMA as two), so the instruction floor is about twice the
// operations bound; chip_smoke.py reports both.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kK = 128;
constexpr int kSup = 8;
constexpr int kGeom = 9;
constexpr int kWarp = 32;
constexpr int kMaxThreads = 1024;
constexpr int kRayRows = 8;
constexpr int kClusterFloats = kGeom * kK;              // 1152
constexpr int kClusterBytes = kClusterFloats * 4;       // 4,608
constexpr int kStageFloats = kSup * kClusterFloats;     // one super-cluster
constexpr unsigned long long kNoHit = ~0ull;
constexpr unsigned kFull = 0xffffffffu;

// Dynamic shared memory: the staged super-cluster, the block's rays
// [8][rb] and the (t, slot) keys [rb / 32][8][32].
constexpr int smem_bytes(int rb) {
  return kStageFloats * 4 + kRayRows * 4 * rb + kSup * 8 * rb;
}

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

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n\t.reg .pred p;\n"
      "WAIT:\n\t"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n\t"
      "@!p bra WAIT;\n}"
      :: "r"(bar), "r"(parity) : "memory");
}

struct Ray {
  float ox, oy, oz, dx, dy, dz, tmin, tmax;
};

// Ray i of rows laid out [8][stride].
__device__ __forceinline__ Ray load_ray(const float* rows, int stride,
                                        int i) {
  return Ray{rows[i], rows[stride + i], rows[2 * stride + i],
             rows[3 * stride + i], rows[4 * stride + i],
             rows[5 * stride + i], rows[6 * stride + i],
             rows[7 * stride + i]};
}

// The ray's window limit given its best t.
__device__ __forceinline__ float window_limit(const Ray& r, float bt,
                                              bool any_hit) {
  return any_hit ? (isfinite(bt) ? -INFINITY : r.tmax) : jmin(r.tmax, bt);
}

// Does the ray's slab window [max(t_in, tmin), min(t_out, lim)] meet the
// box (min xyz, max xyz at bx)? iv: the ray's inverse directions.
__device__ __forceinline__ bool reaches(const float* __restrict__ bx,
                                        const Ray& r, const float3& iv,
                                        float lim) {
  const float l0 = mul(sub(__ldg(bx + 0), r.ox), iv.x),
              h0 = mul(sub(__ldg(bx + 3), r.ox), iv.x);
  const float l1 = mul(sub(__ldg(bx + 1), r.oy), iv.y),
              h1 = mul(sub(__ldg(bx + 4), r.oy), iv.y);
  const float l2 = mul(sub(__ldg(bx + 2), r.oz), iv.z),
              h2 = mul(sub(__ldg(bx + 5), r.oz), iv.z);
  const float t_in = jmax(jmax(jmin(l0, h0), jmin(l1, h1)),
                          jmax(jmin(l2, h2), r.tmin));
  const float t_out = jmin(jmin(jmax(l0, h0), jmax(l1, h1)),
                           jmin(jmax(l2, h2), lim));
  return t_in <= t_out;
}

// One Moller-Trumbore test, rounded as the plain version's _mt; keeps the
// first smallest t in (tc, ic).
__device__ __forceinline__ void mt_test(const Ray& r, float v0x, float v0y,
                                        float v0z, float e1x, float e1y,
                                        float e1z, float e2x, float e2y,
                                        float e2z, int k, float& tc,
                                        int& ic) {
  const float pvx = sub(mul(r.dy, e2z), mul(r.dz, e2y));
  const float pvy = sub(mul(r.dz, e2x), mul(r.dx, e2z));
  const float pvz = sub(mul(r.dx, e2y), mul(r.dy, e2x));
  const float det = add(add(mul(e1x, pvx), mul(e1y, pvy)), mul(e1z, pvz));
  // where |det| fails the test `ok` is false whatever inv_det holds, so
  // the plain version's select of 0 is not needed here
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
  if (ok && t < tc) {
    tc = t;
    ic = k;
  }
}

// The ray's first smallest hit t over triangles k0 .. k1 - 1 (multiples
// of 4) of one staged cluster ([9][128] rows at g), four triangles a step.
__device__ __forceinline__ void range_min(const float* g, const Ray& r,
                                          int k0, int k1, float& tc,
                                          int& ic) {
  const float4* g4 = reinterpret_cast<const float4*>(g);
  constexpr int kRow = kK / 4;
#pragma unroll 1
  for (int q = k0 / 4; q < k1 / 4; ++q) {
    const float4 v0x = g4[q], v0y = g4[kRow + q], v0z = g4[2 * kRow + q];
    const float4 e1x = g4[3 * kRow + q], e1y = g4[4 * kRow + q],
                 e1z = g4[5 * kRow + q];
    const float4 e2x = g4[6 * kRow + q], e2y = g4[7 * kRow + q],
                 e2z = g4[8 * kRow + q];
    const int k = 4 * q;
    mt_test(r, v0x.x, v0y.x, v0z.x, e1x.x, e1y.x, e1z.x, e2x.x, e2y.x,
            e2z.x, k, tc, ic);
    mt_test(r, v0x.y, v0y.y, v0z.y, e1x.y, e1y.y, e1z.y, e2x.y, e2y.y,
            e2z.y, k + 1, tc, ic);
    mt_test(r, v0x.z, v0y.z, v0z.z, e1x.z, e1y.z, e1z.z, e2x.z, e2y.z,
            e2z.z, k + 2, tc, ic);
    mt_test(r, v0x.w, v0y.w, v0z.w, e1x.w, e1y.w, e1z.w, e2x.w, e2y.w,
            e2z.w, k + 3, tc, ic);
  }
}

// A hit as a key whose unsigned order is (t, triangle): the f32 bits made
// monotone, both zeros on one key (they tie in the sequential scan) with
// the sign kept in bit 0.
__device__ __forceinline__ unsigned long long hit_key(float t, int k) {
  const unsigned u = __float_as_uint(t);
  const unsigned o = t == 0.0f ? 0x80000000u
                               : (u & 0x80000000u) ? ~u : u | 0x80000000u;
  return (unsigned long long)o << 32 | (unsigned)k << 1 | u >> 31;
}

__device__ __forceinline__ void key_hit(unsigned long long key, float& t,
                                        int& k) {
  const unsigned o = (unsigned)(key >> 32), lo = (unsigned)key;
  const unsigned u = o == 0x80000000u ? (lo & 1u) << 31
                     : (o & 0x80000000u) ? o & 0x7fffffffu : ~o;
  t = __uint_as_float(u);
  k = (int)(lo >> 1);
}

// Thread 0: copy the clusters of mask m of super-cluster sc into dst,
// completing on the mbarrier (an arrival without bytes when m is empty,
// so the phase still completes).
__device__ __forceinline__ void stage(const float* __restrict__ table,
                                      int sc, unsigned m, float* dst,
                                      uint32_t bar) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
      :: "r"(bar), "r"(__popc(m) * kClusterBytes) : "memory");
  const float* src = table + (size_t)sc * kStageFloats;
  for (; m; m &= m - 1) {
    const int cj = __ffs(m) - 1;
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
        " [%0], [%1], %2, [%3];"
        :: "r"(smem_addr(dst + cj * kClusterFloats)),
           "l"(src + cj * kClusterFloats), "r"(kClusterBytes), "r"(bar)
        : "memory");
  }
}

__global__ void __launch_bounds__(kMaxThreads)
tri_traverse_kernel(const float* __restrict__ table,
                    const float* __restrict__ box,
                    const float* __restrict__ sup_box,
                    const int* __restrict__ block_start,
                    const int* __restrict__ visit,
                    const int* __restrict__ visit_near, int mv,
                    const float* __restrict__ rays, int Rp, int last,
                    int any_hit, float* __restrict__ t_out,
                    int* __restrict__ slot_out, int* __restrict__ actual) {
  extern __shared__ __align__(128) float s_geo[];  // [8][9][128], then ...
  __shared__ __align__(8) uint64_t s_bar;
  __shared__ unsigned s_gmask[2][kMaxThreads / kWarp];  // by visit parity

  const int rb = blockDim.x, nw = rb / kWarp;
  const int w = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  float* s_ray = s_geo + kStageFloats;                          // [8][rb]
  unsigned long long* s_key = reinterpret_cast<unsigned long long*>(
      s_ray + kRayRows * rb);                            // [nw][8][32]
  const int b = blockIdx.x;
  const int r_i = b * rb + threadIdx.x;
  const bool lead = threadIdx.x == 0;
  const Ray r = load_ray(rays, Rp, r_i);
  const float eps = 1e-20f;
  const float3 iv = make_float3(
      __fdiv_rn(1.0f, fabsf(r.dx) < eps ? eps : r.dx),
      __fdiv_rn(1.0f, fabsf(r.dy) < eps ? eps : r.dy),
      __fdiv_rn(1.0f, fabsf(r.dz) < eps ? eps : r.dz));
  float* my = s_ray + threadIdx.x;
  my[0] = r.ox, my[rb] = r.oy, my[2 * rb] = r.oz, my[3 * rb] = r.dx;
  my[4 * rb] = r.dy, my[5 * rb] = r.dz, my[6 * rb] = r.tmin;
  my[7 * rb] = r.tmax;
  for (int i = threadIdx.x; i < nw * kSup * kWarp; i += rb) s_key[i] = kNoHit;

  const int v0i = block_start[b];
  const int nv = block_start[b + 1] - v0i;
  float bt = INFINITY;
  int bi = 0;
  int executed = 0;

  if (lead) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;"
                 :: "r"(smem_addr(&s_bar)) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  for (int j = 0; j < nv; ++j) {
    const int c = visit[v0i + j];
    const float* bx = box + (size_t)c * kSup * 6;
    // 1. the candidates: the clusters each group reaches with its best
    // before this visit (a superset of what the exact cull passes)
    const float lim = window_limit(r, bt, any_hit);
    unsigned m = 0;
    if (c == last || reaches(sup_box + (size_t)c * 6, r, iv, lim)) {
#pragma unroll
      for (int cj = 0; cj < kSup; ++cj)
        m |= reaches(bx + cj * 6, r, iv, lim) ? 1u << cj : 0u;
    }
    const unsigned wm = __reduce_or_sync(kFull, m);
    if (lane == 0) s_gmask[j & 1][w] = wm;
    // go on to visit j + 1? decided before visit j updates the best
    const float eff = (any_hit && isfinite(bt)) ? -INFINITY : bt;
    const int best_bits = __float_as_int(fmaxf(eff, 0.0f));
    const int nxt = visit_near[min(v0i + j + 1, mv - 1)];
    const bool go_on = __syncthreads_or(best_bits > nxt) && j + 1 < nv;

    // the block's work items, (group, cluster) pairs group-major: lane
    // l < nw holds group l's mask and the count of items up to and
    // including it. The staged clusters were last read before the
    // previous visit's second barrier (a visit without items has none,
    // so a warp may reach the next visit's masks early: they alternate).
    const unsigned gm = lane < nw ? s_gmask[j & 1][lane] : 0u;
    int upto = __popc(gm);
    for (int o = 1; o < kWarp; o <<= 1) {
      const int v = __shfl_up_sync(kFull, upto, o);
      if (lane >= o) upto += v;
    }
    const int items = __shfl_sync(kFull, upto, kWarp - 1);
    const unsigned needed = __reduce_or_sync(kFull, gm);
    if (lead) stage(table, c, needed, s_geo, smem_addr(&s_bar));
    if (!items) {         // no group reaches a cluster: nothing to commit
      ++executed;
      if (!go_on) break;
      continue;
    }
    bar_wait(smem_addr(&s_bar), j & 1);

    // 2. the items' triangles in a row (triangle f is triangle f % 128
    // of item f / 128), split evenly over the warps, four at a time
    const int quota = (items * kK + 4 * nw - 1) / (4 * nw) * 4;
    const int f_end = min((w + 1) * quota, items * kK);
    for (int f = w * quota; f < f_end;) {
      const int i = f / kK, k0 = f % kK, k1 = min(kK, k0 + f_end - f);
      const int g = __popc(__ballot_sync(kFull, lane < nw && upto <= i));
      const unsigned gmask = __shfl_sync(kFull, gm, g);
      unsigned bits = gmask;
      for (int n = i - (__shfl_sync(kFull, upto, g) - __popc(gmask)); n > 0;
           --n)
        bits &= bits - 1;
      const int cj = __ffs(bits) - 1;
      const Ray rr = load_ray(s_ray, rb, g * kWarp + lane);
      float tc = INFINITY;
      int ic = 0;
      range_min(s_geo + cj * kClusterFloats, rr, k0, k1, tc, ic);
      if (tc < INFINITY)
        atomicMin(&s_key[(g * kSup + cj) * kWarp + lane], hit_key(tc, ic));
      f += k1 - k0;
    }
    __syncthreads();

    // 3. commit this warp's rays, clusters in order, with the running
    // best; every key of the group is read and reset
    for (unsigned mm = wm; mm; mm &= mm - 1) {
      const int cj = __ffs(mm) - 1;
      unsigned long long* kp = &s_key[(w * kSup + cj) * kWarp + lane];
      const unsigned long long key = *kp;
      *kp = kNoHit;
      if (!__any_sync(kFull, reaches(bx + cj * 6, r, iv,
                                     window_limit(r, bt, any_hit))))
        continue;
      if (key != kNoHit) {
        float tc;
        int ic;
        key_hit(key, tc, ic);
        if (tc < bt) {
          bt = tc;
          bi = (c * kSup + cj) * kK + ic;
        }
      }
    }
    ++executed;
    if (!go_on) break;
  }

  t_out[r_i] = bt;
  slot_out[r_i] = bi;
  if (lead) actual[b] = executed;
}

}  // namespace

extern "C" {

int gsrt_tri_traverse(const float* table, const float* box,
                      const float* sup_box, int m,
                      const int* block_start, const int* visit,
                      const int* visit_near, int mv, const float* rays,
                      int Rp, int rb, int cull_rays, int any_hit,
                      float* t_out, int* slot_out, int* actual,
                      void* stream) {
  if (rb % kWarp != 0 || rb <= 0 || rb > kMaxThreads || Rp % rb != 0 ||
      m % kSup != 0 || mv <= 0 || cull_rays != kWarp ||
      reinterpret_cast<uintptr_t>(table) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  // above the 48 KB a block gets without asking from rb = 128 on
  const cudaError_t err = cudaFuncSetAttribute(
      tri_traverse_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes(kMaxThreads));
  if (err != cudaSuccess) return (int)err;
  const int blocks = Rp / rb;
  if (blocks > 0)
    tri_traverse_kernel<<<blocks, rb, smem_bytes(rb),
                          (cudaStream_t)stream>>>(
        table, box, sup_box, block_start, visit, visit_near, mv, rays, Rp,
        m / kSup - 1, any_hit, t_out, slot_out, actual);
  return (int)cudaGetLastError();
}

// What the build gave the kernel: info = {registers a thread, static
// shared bytes, dynamic shared bytes at rb, local (spill) bytes a thread,
// resident blocks an SM at rb threads}.
int gsrt_tri_traverse_info(int rb, int* info) {
  cudaError_t err = cudaFuncSetAttribute(
      tri_traverse_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes(kMaxThreads));
  cudaFuncAttributes a;
  if (err == cudaSuccess)
    err = cudaFuncGetAttributes(&a, tri_traverse_kernel);
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, tri_traverse_kernel, rb, smem_bytes(rb));
  if (err != cudaSuccess) return (int)err;
  info[0] = a.numRegs;
  info[1] = (int)a.sharedSizeBytes;
  info[2] = smem_bytes(rb);
  info[3] = (int)a.localSizeBytes;
  info[4] = blocks;
  return 0;
}

const char* gsrt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
