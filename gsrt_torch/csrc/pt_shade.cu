// The path tracer's shading of one bounce wave in one launch: per ray the
// miss colour, the hit point, the four scatter models and the light
// selected by the hit's material, the emitted light, the throughput, and
// the ray's next origin, direction and liveness.
//
// Replaces no TPU kernel. The JAX package shades a wave with plain jnp
// code (gsrt/models/path_tracer.py: _sky, _scatter and the wave loop) that
// XLA fuses; the port's plain version of it (gsrt_torch/models/
// path_tracer.py: _shade_plain, which calls _sky and _scatter) is the same
// composition run op by op, about 150 launches a wave over [R] and [R, 3]
// columns. This kernel is that composition fused; the plain version stays
// the CPU's path and this kernel's reference. The random draws are not
// made here: the wrapper draws the unit vectors and the uniforms from the
// path tracer's generator, as _scatter does, and passes them in.
//
// Arithmetic. Bit-equal to the plain version on the card: every operation
// follows the operation order of _shade_plain, _scatter, _reflect,
// _refract, _schlick and _unit_rays, rounded on its own (__fmul_rn,
// __fadd_rn, __fsub_rn, __fdiv_rn, __fsqrt_rn: nothing contracts to an
// FMA), with PyTorch's CUDA rounding where it differs from the op's face:
// `1.0 / x` is reciprocal(x) * 1.0, `x ** 2` is x * x, `x ** 5` is powf(x,
// 5), clamp_min keeps NaN, a Python float constant is rounded to float32,
// and every dot product is summed left to right. Every value the plain
// version computes for every ray (the refraction on total internal
// reflection, 1 / ior, each model's direction) is computed here too and
// selected as torch.where selects it. The sky's norm is
// torch.linalg.norm's over a row of 3: its reduction squares x and z on
// one thread and y on another, then adds y's square last.
//
// Bound. Bytes: a ray reads t, mat and the uniform (4 B each), hit and
// active (1 B each), and its normal, origin, direction, throughput,
// accumulated colour and unit draw (12 B each), then writes its origin,
// direction, throughput and colour (12 B each) and active (1 B): 135 B a
// ray (147 with a texture colour), 280 MB for bathroom-pt's 2,073,600-ray
// wave, 0.084 ms at 3.35 TB/s. Its ~200 flops and one powf are far below
// the card's 20 flops a byte. One thread a ray, blocks of 128, every
// column read and written a float at a time: a warp's three loads of one
// [R, 3] column cover 384 contiguous bytes, the second and third from L1,
// and every byte of a sector it fetches is used. On an H100 SXM at 700 W a
// 1080p wave takes 0.096 ms, 87% of the byte bound; staging each block's
// slice of the [R, 3] columns through shared memory with 16-byte copies,
// as csrc/project.cu stages its SH rows, took 0.138 (PERF.md). The
// material table (a few dozen rows) is read through the read-only cache.
// The outputs are written in place.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

// Materials' model constants (gsrt_torch.core.types.Materials)
constexpr int kLambertian = 0, kMetallic = 1, kDielectric = 2,
              kIsotropic = 3, kDiffuseLight = 4;

// Python float constants as the plain version rounds them
#define F32(x) static_cast<float>(x)

struct Params {
  const float* t;             // [R]
  const float* n;             // [R, 3]
  const int* mat;             // [R]
  const unsigned char* hit;   // [R]
  float* orig;                // [R, 3], updated in place
  float* dirn;                // [R, 3], updated in place
  unsigned char* active;      // [R], updated in place
  float* ray_color;           // [R, 3], updated in place
  float* out_color;           // [R, 3], updated in place
  const float* unit;          // [R, 3] the unit draw
  const float* uni;           // [R] the uniform draw
  const float* tex;           // [R, 3] or null
  const int* model;           // [M]
  const float* diffuse;       // [M, 3]
  const float* fuzz;          // [M]
  const float* ior;           // [M]
  int n_rays, n_mats, has_sky;
};

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ float mul(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ float add(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ float sub(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ float div(float a, float b) {
  return __fdiv_rn(a, b);
}
// torch.clamp_min on the card: NaN stays NaN
__device__ __forceinline__ float clamp_min(float v, float lo) {
  return v != v ? v : fmaxf(v, lo);
}
// primitives._dot: summed left to right
__device__ __forceinline__ float dot(V3 a, V3 b) {
  return add(add(mul(a.x, b.x), mul(a.y, b.y)), mul(a.z, b.z));
}
__device__ __forceinline__ V3 sel(bool c, V3 a, V3 b) {
  return c ? a : b;
}

__device__ __forceinline__ V3 row(const float* a, size_t r) {
  return V3{a[3 * r], a[3 * r + 1], a[3 * r + 2]};
}
__device__ __forceinline__ void put(float* a, size_t r, V3 v) {
  a[3 * r] = v.x;
  a[3 * r + 1] = v.y;
  a[3 * r + 2] = v.z;
}

// One ray's shading, the plain version's ops in its order. o, d, rc and oc
// are updated; returns the new active flag.
__device__ __forceinline__ bool shade_ray(const Params& p, int i, V3& o,
                                          V3& d, V3& rc, V3& oc, V3 nrm,
                                          V3 u, V3 tex, bool has_tex) {
  const bool act = p.active[i] != 0;
  const bool hit = __ldg(p.hit + i) != 0;
  const float t = __ldg(p.t + i);
  const float uni = __ldg(p.uni + i);

  // the miss shader: out += where(active & ~hit, ray_color * _sky(dirn))
  V3 sky{0.0f, 0.0f, 0.0f};
  if (p.has_sky) {
    const float nn = __fsqrt_rn(add(add(mul(d.x, d.x), mul(d.z, d.z)),
                                    mul(d.y, d.y)));
    const float ts =
        mul(0.5f, add(div(d.y, clamp_min(nn, F32(1e-9))), 1.0f));
    const float one_m = mul(sub(1.0f, ts), 1.0f);
    sky = V3{add(one_m, mul(ts, 0.5f)), add(one_m, mul(ts, F32(0.7))),
             add(one_m, mul(ts, 1.0f))};
  }
  const bool miss = act && !hit;
  oc.x = add(oc.x, miss ? mul(rc.x, sky.x) : 0.0f);
  oc.y = add(oc.y, miss ? mul(rc.y, sky.y) : 0.0f);
  oc.z = add(oc.z, miss ? mul(rc.z, sky.z) : 0.0f);

  const V3 hp{add(o.x, mul(t, d.x)), add(o.y, mul(t, d.y)),
              add(o.z, mul(t, d.z))};

  // _scatter: the material's row (a negative index counts from the end,
  // as tensor indexing does; the plain version fails on an index outside
  // [-M, M), which reads the nearest row here)
  int m = p.mat[i];
  m = m < 0 ? m + p.n_mats : m;
  m = min(max(m, 0), p.n_mats - 1);
  const int model = __ldg(p.model + m);
  const V3 dif{__ldg(p.diffuse + 3 * m), __ldg(p.diffuse + 3 * m + 1),
               __ldg(p.diffuse + 3 * m + 2)};
  const V3 dift = has_tex ? V3{mul(dif.x, tex.x), mul(dif.y, tex.y),
                               mul(dif.z, tex.z)}
                          : dif;
  const float fuzz = __ldg(p.fuzz + m);
  const float ior = __ldg(p.ior + m);

  // _unit_rays
  const float len = clamp_min(__fsqrt_rn(dot(d, d)), F32(1e-9));
  const V3 dd{div(d.x, len), div(d.y, len), div(d.z, len)};

  const V3 lam_dir{add(nrm.x, u.x), add(nrm.y, u.y), add(nrm.z, u.z)};
  const float dn = dot(dd, nrm);
  const bool lam_scattered = dn < 0.0f;
  // _reflect
  const float two_dn = mul(2.0f, dn);
  const V3 refl{sub(dd.x, mul(two_dn, nrm.x)), sub(dd.y, mul(two_dn, nrm.y)),
                sub(dd.z, mul(two_dn, nrm.z))};
  const V3 met_dir{add(refl.x, mul(fuzz, u.x)), add(refl.y, mul(fuzz, u.y)),
                   add(refl.z, mul(fuzz, u.z))};
  const bool met_scattered = dot(refl, nrm) > 0.0f;
  const bool front = dn > 0.0f;
  const V3 outward = sel(front, V3{-nrm.x, -nrm.y, -nrm.z}, nrm);
  const float eta = front ? ior : mul(div(1.0f, ior), 1.0f);
  const float cosine = front ? mul(ior, dn) : -dn;
  // _refract(d, outward, eta)
  const float cos_i = -dot(dd, outward);
  const float k =
      sub(1.0f, mul(mul(eta, eta), sub(1.0f, mul(cos_i, cos_i))));
  const float coef = sub(mul(eta, cos_i), __fsqrt_rn(clamp_min(k, 0.0f)));
  V3 refr{add(mul(eta, dd.x), mul(coef, outward.x)),
          add(mul(eta, dd.y), mul(coef, outward.y)),
          add(mul(eta, dd.z), mul(coef, outward.z))};
  if (!(k >= 0.0f)) refr = V3{0.0f, 0.0f, 0.0f};
  const bool tir = dot(refr, refr) == 0.0f;
  // _schlick
  const float r0h = div(sub(1.0f, ior), add(ior, 1.0f));
  const float r0 = mul(r0h, r0h);
  const float schlick =
      add(r0, mul(sub(1.0f, r0), powf(sub(1.0f, cosine), 5.0f)));
  const float reflect_prob = tir ? 1.0f : schlick;
  const V3 die_dir = sel(uni < reflect_prob, refl, refr);

  const bool is_lam = model == kLambertian, is_met = model == kMetallic;
  const bool is_die = model == kDielectric, is_iso = model == kIsotropic;
  const bool is_light = model == kDiffuseLight;
  const V3 new_dir =
      sel(is_lam, lam_dir, sel(is_met, met_dir, sel(is_die, die_dir, u)));
  const V3 atten = sel(is_die, has_tex ? tex : V3{1.0f, 1.0f, 1.0f}, dift);
  const bool scattered =
      (is_lam ? lam_scattered : is_met ? met_scattered : (is_die || is_iso))
      && !is_light;

  // the light, the throughput, the next segment
  const bool light = act && hit && is_light;
  oc.x = add(oc.x, light ? mul(rc.x, dif.x) : 0.0f);
  oc.y = add(oc.y, light ? mul(rc.y, dif.y) : 0.0f);
  oc.z = add(oc.z, light ? mul(rc.z, dif.z) : 0.0f);
  if (act && hit) rc = V3{mul(rc.x, atten.x), mul(rc.y, atten.y),
                          mul(rc.z, atten.z)};
  if (hit) {
    o = hp;
    d = new_dir;
  }
  return act && hit && scattered;
}

__global__ void __launch_bounds__(kThreads) pt_shade_kernel(const Params p) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= p.n_rays) return;
  const bool has_tex = p.tex != nullptr;
  V3 o = row(p.orig, i), d = row(p.dirn, i), rc = row(p.ray_color, i),
     oc = row(p.out_color, i);
  const V3 nrm{__ldg(p.n + 3 * (size_t)i), __ldg(p.n + 3 * (size_t)i + 1),
               __ldg(p.n + 3 * (size_t)i + 2)};
  const V3 u{__ldg(p.unit + 3 * (size_t)i), __ldg(p.unit + 3 * (size_t)i + 1),
             __ldg(p.unit + 3 * (size_t)i + 2)};
  const V3 tex = has_tex ? V3{__ldg(p.tex + 3 * (size_t)i),
                              __ldg(p.tex + 3 * (size_t)i + 1),
                              __ldg(p.tex + 3 * (size_t)i + 2)}
                         : V3{0.0f, 0.0f, 0.0f};
  const bool act = shade_ray(p, i, o, d, rc, oc, nrm, u, tex, has_tex);
  put(p.orig, i, o);
  put(p.dirn, i, d);
  put(p.ray_color, i, rc);
  put(p.out_color, i, oc);
  p.active[i] = act ? 1 : 0;
}

}  // namespace

extern "C" {

// One launch over a wave of n_rays rays; orig, dirn, active, ray_color and
// out_color are read and written in place. tex may be null. model, diffuse,
// fuzz and ior are the material table's n_mats rows (n_mats >= 1).
int gsrt_pt_shade(const float* t, const float* n, const int* mat,
                  const unsigned char* hit, float* orig, float* dirn,
                  unsigned char* active, float* ray_color, float* out_color,
                  const float* unit, const float* uni, const float* tex,
                  const int* model, const float* diffuse, const float* fuzz,
                  const float* ior, int n_rays, int n_mats, int has_sky,
                  void* stream) {
  if (n_rays < 0 || n_mats < 1) return (int)cudaErrorInvalidValue;
  const Params p{t,    n,    mat,     hit,  orig, dirn,   active,
                 ray_color, out_color, unit, uni,  tex,  model,
                 diffuse,   fuzz,      ior,  n_rays, n_mats, has_sky};
  if (n_rays > 0)
    pt_shade_kernel<<<(n_rays + kThreads - 1) / kThreads, kThreads, 0,
                      (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

// The kernel's build: registers, static shared memory, local (spilled)
// bytes a thread, resident blocks of 128 an SM.
int gsrt_pt_shade_info(int* info) {
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, pt_shade_kernel);
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, pt_shade_kernel, kThreads, 0);
  if (err != cudaSuccess) return (int)err;
  info[0] = a.numRegs;
  info[1] = (int)a.sharedSizeBytes;
  info[2] = (int)a.localSizeBytes;
  info[3] = blocks;
  return 0;
}

const char* gsrt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
