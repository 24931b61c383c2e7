// Per-ray BVH k-buffer tracing of a Gaussian cloud: the reference's
// multi-pass k-buffer (GaussTracing.rgen, RayTracing.ProceduralGauss.rint)
// through the port's ray-space response.
//
// Replaces no TPU kernel: the JAX package traces splats with free rays in
// plain jnp (brute force or planned cluster visits), which the port's
// models/gaussian_rt.py `trace_gaussian_rays` and ops/splat_clusters.py
// keep. At a captured scene's size (millions of splats, a frame of rays)
// those sweeps take hours a frame, so each ray walks a tree of its own.
//
// Contract (gsrt_torch/ops/splat_bvh.py). nodes [NI, 16] f32 and
// root_box [6]: the node records of bvh_walk.cuh (ops/bvh.py
// `node_records`). slots [L, 12, 4] f32: leaf l's rows over its 4 slots,
// mean x, y, z, the upper-triangular inverse covariance (6 rows), opacity,
// the splat index (int32 bits), an unused row; padding slots have opacity
// 0. colors [N, 3] by splat index. Rays: orig, dirn [R, 3]; t_min the
// scalar; t_max per ray where the pointer is given, else the scalar. Out:
// trans [R], color [R, 3], hits [R] and passes [R] (int32: passes that
// found something). counts, where given, receives (node records fetched,
// response evaluations, walks from the root, hits blended, passes
// replayed from a walk's buffer after the walk's own), added to what it
// holds. A ray whose window is empty (t_max <= max(0, t_min), or NaN)
// makes no walk: the path tracer gives its retired rays such windows.
//
// Semantics (the plain version's, trace_gaussian_rays'): per pass the
// kK nearest splats with g <= g_cutoff, alpha = min(opacity * exp(-g),
// 0.99) > alpha_threshold and t* in (max(front, t_min), t_max), by
// (t*, splat index), composited front to back; the front moves to the
// last of them; a ray is done on a pass that finds nothing or once hits
// >= max_hits. The response is rounded as ops/gaussian.py
// `ray_gaussian_response` rounds it on the card (every product and sum
// rounded on its own, no FMA contraction, IEEE division, expf, clamps
// that carry a NaN as torch.clamp does), so the kernel accepts the hits
// the plain version accepts; the composite follows ops/kbuffer.py
// `finish_pass` but sums a pass's colours in slot order. The walk is walk_splat_bvh_plain's, step for step, which the
// counters follow.
//
// Design. One ray a thread, passes in-thread. Warps persist and take 32
// rays at a time from a global counter. One walk of bvh_walk.cuh from the
// root, front to back (a leaf: 11 float4 loads for 4 slots), fills a
// buffer of the kW nearest hits past lo = max(front, t_min), entering a
// box only while its slab window meets [lo, lim], lim = t_max while the
// buffer has room, else its kW-th t* (compared with <=: ties are
// visited). The passes are then replayed from the buffer, each exactly
// the pass a walk of its own would make: the next kK entries past the
// front, composited in order; the front moves to the last of them and
// the entries tied with it are skipped (a walk from it would reject them,
// t > lo). Replay stops when fewer than kK entries are left: of a full
// buffer they are dropped and the ray walks again from its front (a hit
// past the kW-th may belong to the pass); of a buffer that held every
// hit in the window they are the ray's last pass, so no empty walk ends
// the ray. The reference's rgen launches a traceRayEXT a pass; the
// outputs are the same pass for pass.
//
// The buffer lives in shared memory, a slice a thread: entry j of thread
// x at [j][x], so each lane of a warp reads its own bank whichever
// entries it touches; 12 B an entry, 24 KB a block of 64, 9 blocks an SM
// at 96 registers. The last entry's (t*, index) stays in registers: the
// window's end, and the test a hit must pass to enter (most fail it once
// the buffer is full). A hit enters by insertion from the back; the walk
// meets hits roughly front to back, so few move. Measured on m360-rt's
// frames (PERF.md §6): kW = 32 in blocks of 64 is the fastest of kW =
// 16, 24, 28, 32, 40, 64 in blocks of 32 to 128 and of register buffers
// of 16 and 32 (a register buffer spills or halves residency; a kW that
// is no multiple of kK drops the entries past its last whole pass).
//
// Bound. Latency of dependent node and leaf fetches (the tree is 64 B a
// node and the leaves 192 B, about 190 MB at 2.96M splats: past the 50
// MB L2) and the response's arithmetic on every slot of each leaf a walk
// enters. benchmark/rt_roofline.py counts the least time (each blended
// hit evaluated and blended once, the splats and rays read once).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "bvh_walk.cuh"

namespace {

using namespace gsrt::bvh;

constexpr int kThreads = 64;
constexpr int kK = 8;                       // a pass: ops/splat_bvh.py K
constexpr int kW = 32;                      // a walk's buffer: KW
constexpr int kRows = 12;                   // float4 rows a leaf record
constexpr int kNoId = 2147483647;           // an empty buffer entry

// The block's walk buffers: thread x's entry j at [j][x].
__shared__ float buf_t[kW][kThreads], buf_a[kW][kThreads];
__shared__ int buf_id[kW][kThreads];

// A ray's walk buffer: m entries ascending by (t*, index) in column x of
// buf_*; the last entry's (t*, index) in registers, (inf, kNoId) while
// the buffer has room.
struct Buffer {
  int x, m;
  float last_t;
  int last_id;
  __device__ float& t(int j) { return buf_t[j][x]; }
  __device__ float& a(int j) { return buf_a[j][x]; }
  __device__ int& id(int j) { return buf_id[j][x]; }
};

__device__ __forceinline__ void clear(Buffer& b) {
  b.m = 0;
  b.last_t = INFINITY;
  b.last_id = kNoId;
}

// The hit put in its place, if it comes before the last entry; of a full
// buffer the last entry falls off.
__device__ __forceinline__ void insert(Buffer& b, float t, float a, int id) {
  if (!(t < b.last_t || (t == b.last_t && id < b.last_id))) return;
  int j = b.m < kW ? b.m : kW - 1;
  for (; j > 0; --j) {
    const float pt = b.t(j - 1);
    const int pi = b.id(j - 1);
    if (!(t < pt || (t == pt && id < pi))) break;
    b.t(j) = pt;
    b.a(j) = b.a(j - 1);
    b.id(j) = pi;
  }
  b.t(j) = t;
  b.a(j) = a;
  b.id(j) = id;
  if (b.m < kW) ++b.m;
  if (b.m == kW) {
    b.last_t = b.t(kW - 1);
    b.last_id = b.id(kW - 1);
  }
}

struct Params {
  float tmin, g_cutoff, alpha_threshold;
};

// One slot against the ray: ray_gaussian_response's t* and g in its
// rounding, then the accept rule.
__device__ __forceinline__ void test_slot(const Ray& r, float mx, float my,
                                          float mz, float i0, float i1,
                                          float i2, float i3, float i4,
                                          float i5, float op, int id,
                                          float lo, float tmax,
                                          const Params& p, Buffer& b) {
  const float ux = sub(r.ox, mx), uy = sub(r.oy, my), uz = sub(r.oz, mz);
  const float sdx = add(add(mul(i0, r.dx), mul(i1, r.dy)), mul(i2, r.dz));
  const float sdy = add(add(mul(i1, r.dx), mul(i3, r.dy)), mul(i4, r.dz));
  const float sdz = add(add(mul(i2, r.dx), mul(i4, r.dy)), mul(i5, r.dz));
  const float d_sd = add(add(mul(r.dx, sdx), mul(r.dy, sdy)), mul(r.dz, sdz));
  const float m_sd = add(add(mul(ux, sdx), mul(uy, sdy)), mul(uz, sdz));
  const float smx = add(add(mul(i0, ux), mul(i1, uy)), mul(i2, uz));
  const float smy = add(add(mul(i1, ux), mul(i3, uy)), mul(i4, uz));
  const float smz = add(add(mul(i2, ux), mul(i4, uy)), mul(i5, uz));
  const float m_sm = add(add(mul(ux, smx), mul(uy, smy)), mul(uz, smz));
  const float dss = jmax(d_sd, 1e-12f);
  const float t = __fdiv_rn(-m_sd, dss);
  const float q = sub(m_sm, __fdiv_rn(mul(m_sd, m_sd), dss));
  const float g = mul(0.5f, jmax(q, 0.0f));
  const float alpha = jmin(mul(op, expf(-g)), 0.99f);
  if (g <= p.g_cutoff && alpha > p.alpha_threshold && t > lo && t < tmax)
    insert(b, t, alpha, id);
}

// Leaf l's four slots against the ray, in slot order.
__device__ __forceinline__ void leaf_test(const float4* __restrict__ slots,
                                          int l, const Ray& r, float lo,
                                          float tmax, const Params& p,
                                          Buffer& b) {
  const float4* s = slots + (size_t)l * kRows;
  const float4 mx = __ldg(s), my = __ldg(s + 1), mz = __ldg(s + 2);
  const float4 c0 = __ldg(s + 3), c1 = __ldg(s + 4), c2 = __ldg(s + 5);
  const float4 c3 = __ldg(s + 6), c4 = __ldg(s + 7), c5 = __ldg(s + 8);
  const float4 op = __ldg(s + 9), id = __ldg(s + 10);
  test_slot(r, mx.x, my.x, mz.x, c0.x, c1.x, c2.x, c3.x, c4.x, c5.x, op.x,
            __float_as_int(id.x), lo, tmax, p, b);
  test_slot(r, mx.y, my.y, mz.y, c0.y, c1.y, c2.y, c3.y, c4.y, c5.y, op.y,
            __float_as_int(id.y), lo, tmax, p, b);
  test_slot(r, mx.z, my.z, mz.z, c0.z, c1.z, c2.z, c3.z, c4.z, c5.z, op.z,
            __float_as_int(id.z), lo, tmax, p, b);
  test_slot(r, mx.w, my.w, mz.w, c0.w, c1.w, c2.w, c3.w, c4.w, c5.w, op.w,
            __float_as_int(id.w), lo, tmax, p, b);
}

__global__ void __launch_bounds__(kThreads)
splat_bvh_kernel(const float4* __restrict__ nodes,
                 const float* __restrict__ root_box,
                 const float4* __restrict__ slots,
                 const float* __restrict__ colors,
                 const float* __restrict__ orig,
                 const float* __restrict__ dirn, Params p,
                 const float* __restrict__ tmax_p, float tmax_s, int R,
                 int max_hits, int* __restrict__ next_ray,
                 float* __restrict__ trans_out, float* __restrict__ color_out,
                 int* __restrict__ hits_out, int* __restrict__ passes_out,
                 unsigned long long* __restrict__ counts) {
  const int lane = threadIdx.x % kWarp;
  float rb[6];
#pragma unroll
  for (int a = 0; a < 6; ++a) rb[a] = __ldg(root_box + a);
  unsigned n_nodes = 0, n_tests = 0, n_walks = 0, n_hits = 0, n_replays = 0;
  int2 stack[kStack];   // (node or leaf id, t_near bits)
  Buffer b{(int)threadIdx.x, 0, INFINITY, kNoId};

  for (;;) {
    int base = 0;
    if (lane == 0) base = atomicAdd(next_ray, kWarp);
    base = __shfl_sync(kFull, base, 0);
    if (base >= R) break;
    const int i = base + lane;
    if (i >= R) continue;
    const Ray r{orig[3 * i], orig[3 * i + 1], orig[3 * i + 2],
                dirn[3 * i], dirn[3 * i + 1], dirn[3 * i + 2]};
    const float tmax = tmax_p ? tmax_p[i] : tmax_s;
    const float3 iv = inv_dir(r);
    float front = 0.0f, trans = 1.0f, cr = 0.0f, cg = 0.0f, cb = 0.0f;
    int hits = 0, passes = 0;
    // an empty window (a retired or parked ray of a path): no walk
    bool done = !(jmax(front, p.tmin) < tmax);
    while (!done) {   // a walk
      const float lo = jmax(front, p.tmin);
      clear(b);
      ++n_walks;
      walk(nodes, rb, r, iv, lo, stack, n_nodes,
           [&] { return jmin(tmax, b.last_t); },
           [&](int l) {
             leaf_test(slots, l, r, lo, tmax, p, b);
             n_tests += 4;
           });
      // its passes: finish_pass's composite of the next kK entries, the
      // front advanced, the entries tied with it skipped
      int j = 0;
      for (bool own = true;; own = false) {
        const int left = b.m - j;
        if (left < kK && b.m == kW) break;       // walk again
        if (left == 0) {
          done = true;
          break;
        }
        const int n = left < kK ? left : kK;
        float keep = 1.0f, sr = 0.0f, sg = 0.0f, sbl = 0.0f;
        for (const int end = j + n; j < end; ++j) {
          const float a = b.a(j);
          const float w = mul(mul(a, keep), trans);
          const float* col = colors + 3 * (size_t)b.id(j);
          sr = add(sr, mul(w, __ldg(col)));
          sg = add(sg, mul(w, __ldg(col + 1)));
          sbl = add(sbl, mul(w, __ldg(col + 2)));
          keep = mul(keep, sub(1.0f, a));
          front = b.t(j);
        }
        cr = add(cr, sr);
        cg = add(cg, sg);
        cb = add(cb, sbl);
        trans = mul(trans, keep);
        hits += n;
        n_hits += n;
        ++passes;
        if (!own) ++n_replays;
        if (hits >= max_hits) {
          done = true;
          break;
        }
        while (j < b.m && b.t(j) == front) ++j;
      }
    }
    trans_out[i] = trans;
    color_out[3 * i] = cr;
    color_out[3 * i + 1] = cg;
    color_out[3 * i + 2] = cb;
    hits_out[i] = hits;
    passes_out[i] = passes;
  }

  if (counts != nullptr) {
    n_nodes = __reduce_add_sync(kFull, n_nodes);
    n_tests = __reduce_add_sync(kFull, n_tests);
    n_walks = __reduce_add_sync(kFull, n_walks);
    n_hits = __reduce_add_sync(kFull, n_hits);
    n_replays = __reduce_add_sync(kFull, n_replays);
    if (lane == 0) {
      atomicAdd(counts, (unsigned long long)n_nodes);
      atomicAdd(counts + 1, (unsigned long long)n_tests);
      atomicAdd(counts + 2, (unsigned long long)n_walks);
      atomicAdd(counts + 3, (unsigned long long)n_hits);
      atomicAdd(counts + 4, (unsigned long long)n_replays);
    }
  }
}

}  // namespace

extern "C" {

int gsrt_splat_bvh(const float* nodes, const float* root_box,
                   const float* slots, const float* colors,
                   const float* orig, const float* dirn, float tmin,
                   const float* tmax_p, float tmax_s, int R, int max_hits,
                   float g_cutoff, float alpha_threshold, int* next_ray,
                   float* trans, float* color, int* hits, int* passes,
                   long long* counts, void* stream) {
  if (R < 0 || reinterpret_cast<uintptr_t>(nodes) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(slots) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  if (R == 0) return (int)cudaGetLastError();
  const cudaStream_t s = (cudaStream_t)stream;
  int blocks = 0;
  cudaError_t err =
      persistent_grid(splat_bvh_kernel, kThreads, R, next_ray, s, &blocks);
  if (err != cudaSuccess) return (int)err;
  const Params p{tmin, g_cutoff, alpha_threshold};
  splat_bvh_kernel<<<blocks, kThreads, 0, s>>>(
      reinterpret_cast<const float4*>(nodes), root_box,
      reinterpret_cast<const float4*>(slots), colors, orig, dirn, p, tmax_p,
      tmax_s, R, max_hits, next_ray, trans, color, hits, passes,
      reinterpret_cast<unsigned long long*>(counts));
  return (int)cudaGetLastError();
}

// What the build gave the kernel (bvh_walk.cuh kernel_info).
int gsrt_splat_bvh_info(int* info) {
  return kernel_info(splat_bvh_kernel, kThreads, info);
}

const char* gsrt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
