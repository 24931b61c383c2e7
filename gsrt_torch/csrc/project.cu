// The tiled forward's projection layer in one launch: per splat the EWA
// projection, the conic, the SH colour, the footprint extents and the
// alive mask, written as the eleven float columns and the mask that the
// binning takes.
//
// Replaces no TPU kernel. The JAX package's projection is plain jnp code
// that XLA fuses into a few loops; the port's plain PyTorch version of it
// (gsrt_torch/ops/project.py: project_splats_plain) is the same
// composition run op by op, about two hundred launches on strided columns.
// This kernel is that composition fused, and the plain version stays the
// CPU's path and this kernel's reference.
//
// Arithmetic. Bit-equal to the plain version on the card: every operation
// follows the operation order of ops/gaussian.py (_project_columns,
// _conic, screen_extents_abc), ops/sh.py (_sh_terms), ops/project.py
// (unit_dirs, alive_mask), rounded on its own (__fmul_rn, __fadd_rn,
// __fsub_rn, __fdiv_rn, __fsqrt_rn: nothing contracts to an FMA), with
// PyTorch's CUDA rounding where it differs from the op's face: `1.0 / x`
// is reciprocal(x) * 1.0, a tensor divided by a host scalar is a product
// with the scalar's reciprocal (taken on the host in double and rounded to
// float32, passed in as inv_alpha_threshold), clamp_min and minimum keep
// NaN, and a Python float constant is rounded to float32 before use.
//
// Bound. Bytes: a splat reads its mean (12 B), Σ (24 B), opacity (4 B) and
// SH rows (12 B a coefficient, 192 B at degree 3) and writes 11 floats and
// a byte, 277 B at degree 3; its ~270 flops (~1 a byte) are far below
// the card's 20 a byte. One thread a splat, blocks of 128. At
// degree 3 with 16 coefficient rows the SH are 83% of the bytes, at a
// 192 B stride a thread: read thread by thread, a warp's load touches 32
// sectors for 16 useful bytes each. So the block first stages its
// contiguous 24 KB SH slice into shared memory with 16-byte cp.async
// copies (consecutive threads, consecutive chunks), computes the
// projection from its mean and Σ while they land, then reads its own row
// back. The 12 chunks of a row are stored at chunk index
// c ^ ((row >> 1) & 3), which spreads a warp's reads of one word over
// eight banks (a plain 48-word stride puts them on two). Other
// coefficient counts read their rows straight from global memory.
// Outputs are [11, n] float rows and [n] bytes: every store is coalesced.
// The camera (view matrix, fx, fy, cx, cy, position) is read through
// device pointers, so the host reads nothing. On an H100 SXM at 700 W,
// 2.96M splats at degree 3 take 0.27 ms, 89% of the byte bound; rows
// read as float4 through L1 0.29, unswizzled 0.30, a float at a time
// from global memory 0.39 (tools/project_ab.py).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kRowFloats = 48;          // 16 coefficients x 3 channels
constexpr int kRowChunks = kRowFloats / 4;

// load paths for the SH rows
constexpr int kGlobal = 0;   // scalar loads from global memory, any K
constexpr int kStaged = 1;   // K == 16: cp.async slice in shared memory

// Python float constants as the plain version rounds them
#define F32(x) static_cast<float>(x)
constexpr float kC0 = F32(0.28209479177387814);
constexpr float kC1 = F32(0.4886025119029199);
constexpr float kC20 = F32(1.0925484305920792);
constexpr float kC21 = F32(-1.0925484305920792);
constexpr float kC22 = F32(0.31539156525252005);
constexpr float kC23 = F32(-1.0925484305920792);
constexpr float kC24 = F32(0.5462742152960396);
constexpr float kC30 = F32(-0.5900435899266435);
constexpr float kC31 = F32(2.890611442640554);
constexpr float kC32 = F32(-0.4570457994644658);
constexpr float kC33 = F32(0.3731763325901154);
constexpr float kC34 = F32(-0.4570457994644658);
constexpr float kC35 = F32(1.445305721320277);
constexpr float kC36 = F32(-0.5900435899266435);

struct Params {
  const float* means;      // [n, 3]
  const float* cov;        // [n, 6] upper-triangular Σ
  const float* opacity;    // [n]
  const float* sh;         // [n, k, 3]
  const float* view;       // [4, 4] world -> camera
  const float* fx;
  const float* fy;
  const float* cx;
  const float* cy;
  const float* pos;        // [3] camera position
  int n, k;
  float dilation, g_cutoff, alpha_threshold, inv_alpha_threshold;
  float t_min, t_hi;
  float* out;              // [11, n]
  unsigned char* alive;    // [n]
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
// torch.clamp_min on the card: NaN stays NaN
__device__ __forceinline__ float clamp_min(float v, float lo) {
  return v != v ? v : fmaxf(v, lo);
}
// `1.0 / x`: reciprocal(x), then the product with 1.0 (exact)
__device__ __forceinline__ float recip(float x) { return __fdiv_rn(1.0f, x); }

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

// Σ basis · coefficient for one channel, in _sh_terms' order; coef(i) is
// the i-th coefficient of the channel. b holds the basis factors.
template <int DEG, typename Coef>
__device__ __forceinline__ float sh_channel(const float* b, Coef coef) {
  float r = mul(kC0, coef(0));
  if (DEG >= 1) {
    r = sub(r, mul(b[1], coef(1)));
    r = add(r, mul(b[2], coef(2)));
    r = sub(r, mul(b[3], coef(3)));
  }
#pragma unroll
  for (int i = 4; i < (DEG + 1) * (DEG + 1); ++i) r = add(r, mul(b[i], coef(i)));
  return clamp_min(add(r, 0.5f), 0.0f);
}

template <int DEG, bool STANDARD, int LOAD>
__global__ void __launch_bounds__(kThreads) project_kernel(const Params p) {
  __shared__ __align__(16) float sh_s[LOAD == kStaged ? kThreads * kRowFloats
                                                      : 4];
  const int i0 = blockIdx.x * kThreads;
  const int i = i0 + threadIdx.x;
  const int n = p.n;
  if (LOAD == kStaged) {
    const int chunks = min(kThreads, n - i0) * kRowChunks;
    const float4* src =
        reinterpret_cast<const float4*>(p.sh) + (size_t)i0 * kRowChunks;
    for (int q = threadIdx.x; q < chunks; q += kThreads) {
      const int r = q / kRowChunks, c = q - r * kRowChunks;
      cp_async16(sh_s + 4 * (r * kRowChunks + (c ^ ((r >> 1) & 3))),
                 src + q);
    }
    asm volatile("cp.async.commit_group;\n" ::);
  }

  float mx = 0.f, my = 0.f, mz = 0.f;
  if (i < n) {
    const float* v = p.view;
    const float r00 = __ldg(v + 0), r01 = __ldg(v + 1), r02 = __ldg(v + 2);
    const float r10 = __ldg(v + 4), r11 = __ldg(v + 5), r12 = __ldg(v + 6);
    const float r20 = __ldg(v + 8), r21 = __ldg(v + 9), r22 = __ldg(v + 10);
    const float tx = __ldg(v + 3), ty = __ldg(v + 7), tz = __ldg(v + 11);
    const float fx = __ldg(p.fx), fy = __ldg(p.fy);
    const float cx = __ldg(p.cx), cy = __ldg(p.cy);
    mx = __ldg(p.means + 3 * (size_t)i);
    my = __ldg(p.means + 3 * (size_t)i + 1);
    mz = __ldg(p.means + 3 * (size_t)i + 2);
    const float* cv = p.cov + 6 * (size_t)i;
    const float c0 = __ldg(cv), c1 = __ldg(cv + 1), c2 = __ldg(cv + 2);
    const float c3 = __ldg(cv + 3), c4 = __ldg(cv + 4), c5 = __ldg(cv + 5);
    const float op = __ldg(p.opacity + i);

    // _project_columns
    const float px = add(add(add(mul(r00, mx), mul(r01, my)), mul(r02, mz)), tx);
    const float py = add(add(add(mul(r10, mx), mul(r11, my)), mul(r12, mz)), ty);
    const float pz = add(add(add(mul(r20, mx), mul(r21, my)), mul(r22, mz)), tz);
    const float depth = pz;
    bool in_front = depth > F32(1e-4);
    const float z = in_front ? depth : 1.0f;
    const float inv_z = recip(z);
    const float m2x = add(mul(mul(fx, px), inv_z), cx);
    const float m2y = add(mul(mul(fy, py), inv_z), cy);
    const float j00 = mul(fx, inv_z);
    const float j02 = mul(mul(mul(-fx, px), inv_z), inv_z);
    const float j11 = mul(fy, inv_z);
    const float j12 = mul(mul(mul(-fy, py), inv_z), inv_z);
    const float t00 = add(mul(j00, r00), mul(j02, r20));
    const float t01 = add(mul(j00, r01), mul(j02, r21));
    const float t02 = add(mul(j00, r02), mul(j02, r22));
    const float t10 = add(mul(j11, r10), mul(j12, r20));
    const float t11 = add(mul(j11, r11), mul(j12, r21));
    const float t12 = add(mul(j11, r12), mul(j12, r22));
    const float u0 = add(add(mul(c0, t00), mul(c1, t01)), mul(c2, t02));
    const float u1 = add(add(mul(c1, t00), mul(c3, t01)), mul(c4, t02));
    const float u2 = add(add(mul(c2, t00), mul(c4, t01)), mul(c5, t02));
    const float v0 = add(add(mul(c0, t10), mul(c1, t11)), mul(c2, t12));
    const float v1 = add(add(mul(c1, t10), mul(c3, t11)), mul(c4, t12));
    const float v2 = add(add(mul(c2, t10), mul(c4, t11)), mul(c5, t12));
    const float a = add(add(add(mul(t00, u0), mul(t01, u1)), mul(t02, u2)),
                        p.dilation);
    const float b = add(add(mul(t10, u0), mul(t11, u1)), mul(t12, u2));
    const float c = add(add(add(mul(t10, v0), mul(t11, v1)), mul(t12, v2)),
                        p.dilation);
    const float det = sub(mul(a, c), mul(b, b));

    // _conic
    float qa = a, qb = b, qc = c;
    if (STANDARD) {
      const bool ok = det > F32(1e-12);
      const float inv_det = ok ? recip(clamp_min(det, F32(1e-12))) : 0.0f;
      qa = mul(c, inv_det);
      qb = mul(-b, inv_det);
      qc = mul(a, inv_det);
      in_front = in_front && ok;
    }

    // screen_extents_abc, with the opacity's alpha cutoff
    const float qdet = clamp_min(sub(mul(qa, qc), mul(qb, qb)), F32(1e-18));
    const float g_alpha =
        clamp_min(logf(clamp_min(mul(op, p.inv_alpha_threshold), F32(1e-6))),
                  0.0f);
    const float gc = p.g_cutoff;
    const float g = gc != gc ? gc : (g_alpha != g_alpha ? g_alpha
                                                         : fminf(gc, g_alpha));
    const float g2 = mul(2.0f, g);
    const float rx =
        __fsqrt_rn(clamp_min(__fdiv_rn(mul(g2, qc), qdet), 0.0f));
    const float ry =
        __fsqrt_rn(clamp_min(__fdiv_rn(mul(g2, qa), qdet), 0.0f));

    // alive_mask
    const bool alive = in_front && op > p.alpha_threshold &&
                       depth > p.t_min && depth < p.t_hi;

    float* o = p.out + i;
    const size_t s = (size_t)n;
    o[0] = depth;
    o[s] = m2x;
    o[2 * s] = m2y;
    o[3 * s] = qa;
    o[4 * s] = qb;
    o[5 * s] = qc;
    o[9 * s] = rx;
    o[10 * s] = ry;
    p.alive[i] = alive ? 1 : 0;
  }

  if (LOAD == kStaged) {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();
  }
  if (i >= n) return;

  // unit_dirs: the view direction from the camera to the mean
  const float dx = sub(mx, __ldg(p.pos));
  const float dy = sub(my, __ldg(p.pos + 1));
  const float dz = sub(mz, __ldg(p.pos + 2));
  const float inv_n = recip(clamp_min(
      __fsqrt_rn(add(add(mul(dx, dx), mul(dy, dy)), mul(dz, dz))),
      F32(1e-9)));
  const float x = mul(dx, inv_n), y = mul(dy, inv_n), z = mul(dz, inv_n);

  // _sh_terms' basis factors (the channel-free part of each term)
  float b[16];
  if (DEG >= 1) {
    b[1] = mul(kC1, y);
    b[2] = mul(kC1, z);
    b[3] = mul(kC1, x);
  }
  if (DEG >= 2) {
    const float xx = mul(x, x), yy = mul(y, y), zz = mul(z, z);
    b[4] = mul(kC20, mul(x, y));
    b[5] = mul(kC21, mul(y, z));
    b[6] = mul(kC22, sub(sub(mul(2.0f, zz), xx), yy));
    b[7] = mul(kC23, mul(x, z));
    b[8] = mul(kC24, sub(xx, yy));
    if (DEG >= 3) {
      const float zz4 = sub(sub(mul(4.0f, zz), xx), yy);
      b[9] = mul(mul(kC30, y), sub(mul(3.0f, xx), yy));
      b[10] = mul(mul(kC31, mul(x, y)), z);
      b[11] = mul(mul(kC32, y), zz4);
      b[12] = mul(mul(kC33, z),
                  sub(sub(mul(2.0f, zz), mul(3.0f, xx)), mul(3.0f, yy)));
      b[13] = mul(mul(kC34, x), zz4);
      b[14] = mul(mul(kC35, z), sub(xx, yy));
      b[15] = mul(mul(kC36, x), sub(xx, mul(3.0f, yy)));
    }
  }

  float rgb[3];
  if (LOAD == kStaged) {
    // the row's float f = 3 coefficient + channel lies in chunk f / 4
    const int r = threadIdx.x, swz = (r >> 1) & 3;
    const float* row = sh_s + r * kRowFloats;
#pragma unroll
    for (int ch = 0; ch < 3; ++ch)
      rgb[ch] = sh_channel<DEG>(b, [&](int ci) {
        const int f = 3 * ci + ch;
        return row[4 * ((f >> 2) ^ swz) + (f & 3)];
      });
  } else {
    const float* row = p.sh + (size_t)i * p.k * 3;
#pragma unroll
    for (int ch = 0; ch < 3; ++ch)
      rgb[ch] = sh_channel<DEG>(b, [&](int ci) {
        return __ldg(row + 3 * ci + ch);
      });
  }
  float* o = p.out + i;
  const size_t s = (size_t)n;
  o[6 * s] = rgb[0];
  o[7 * s] = rgb[1];
  o[8 * s] = rgb[2];
}

using Kernel = void (*)(const Params);

// [degree][standard][load]
#define GSRT_PROJECT_ROW(D)                                              \
  {{project_kernel<D, false, kGlobal>, project_kernel<D, false, kStaged>}, \
   {project_kernel<D, true, kGlobal>, project_kernel<D, true, kStaged>}}
const Kernel kKernels[4][2][2] = {GSRT_PROJECT_ROW(0), GSRT_PROJECT_ROW(1),
                                  GSRT_PROJECT_ROW(2), GSRT_PROJECT_ROW(3)};
#undef GSRT_PROJECT_ROW

// the staged path serves degree 3 over 16 coefficient rows
inline int load_path(int degree, int k) {
  return degree == 3 && k == 16 ? kStaged : kGlobal;
}

}  // namespace

extern "C" {

// One launch over n splats. degree <= 3 and (degree + 1)^2 <= k; the
// staged path wants sh 16-byte aligned (the wrapper checks). Scalars are
// the plain version's, rounded to float32; inv_alpha_threshold is
// float32(1 / alpha_threshold), t_hi min(t_max, init_depth).
int gsrt_project(const float* means, const float* cov, const float* opacity,
                 const float* sh, int n, int k, int degree, int standard,
                 const float* view, const float* fx, const float* fy,
                 const float* cx, const float* cy, const float* pos,
                 float dilation, float g_cutoff, float alpha_threshold,
                 float inv_alpha_threshold, float t_min, float t_hi,
                 float* out, unsigned char* alive, void* stream) {
  if (degree < 0 || degree > 3 || (degree + 1) * (degree + 1) > k || n < 0)
    return (int)cudaErrorInvalidValue;
  const Params p{means,    cov,      opacity,         sh,
                 view,     fx,       fy,              cx,
                 cy,       pos,      n,               k,
                 dilation, g_cutoff, alpha_threshold, inv_alpha_threshold,
                 t_min,    t_hi,     out,             alive};
  if (n > 0)
    kKernels[degree][standard ? 1 : 0][load_path(degree, k)]
        <<<(n + kThreads - 1) / kThreads, kThreads, 0,
           (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

// The build of the instance a launch with (degree, standard, k) runs:
// registers, static and dynamic shared memory, local (spilled) bytes a
// thread, resident blocks of 128 an SM.
int gsrt_project_info(int degree, int standard, int k, int* info) {
  if (degree < 0 || degree > 3) return (int)cudaErrorInvalidValue;
  const Kernel fn = kKernels[degree][standard ? 1 : 0][load_path(degree, k)];
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, fn);
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn,
                                                        kThreads, 0);
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
