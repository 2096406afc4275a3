// K4: shade every ray over its k shell hits and composite them outer->inner.
//
// Replaces volsurfs_tpu/renderers/mesh_renderer.py's _sample_bands_mesh,
// _shade_mesh and _composite (:271-375) as _render_rays runs them after
// trace_all (:375-388): XLA shaped for the TPU, which gathers one
// block-packed uint8 row per (pixel, mesh, band) (make_band_table, a
// workaround for the TPU's gather width), reduces each footprint with a
// one-hot matmul, evaluates the SH and composites with [N, k] tensors. Here
// one thread takes one ray through all of it, and nothing but the ray's rgb
// and background transmittance is written:
//   1. the float16 SH basis of the ray's direction (ops/sh.py's op order);
//   2. for each shell, outer to inner (mesh k-1 down to 0), if the ray hits
//      it: the face's uv as (1-u-v) a + u b + v c of its vertex UVs, then
//      for each band the clamped 2x2 texel footprint of the band's uint8
//      texture [H, W, 4*C], each texel byte weighted and summed, scaled
//      (lo + scale*s) and multiplied into the SH sum of its colour channel;
//      a float32 sigmoid of the four sums; alpha 1 where the mesh ignores
//      alpha. A shell the ray misses shades to 0, as in JAX;
//   3. the float16 compositing: T *= 1 - alpha, and the float32 sum of
//      rgb * T_before * alpha over shells; then + T * background.
//
// Bound: bytes, at the render's shapes. A hit reads its face's 24 B of UVs
// and four texels of every band, 4*C bytes each (4, 12, 20, 28 B for bands
// 0-3); neighbouring rays share most texels, so the distinct bytes are far
// fewer than the gathered ones and are read through L1 and L2. The
// operations are ~11 a texel byte (weights, sums, scale, SH product).
// A simple kernel: one byte load a texel channel, one thread a ray.
//
// Rounding follows the plain version (ops/shade.py), which follows the JAX
// code run op by op: every float16 operation is done in float32 and rounded
// to float16 (r16 below), which equals the float16 operation for the
// products and sums that occur here; the texel sum and the SH sum are
// float32 sums rounded once. The library is built with -fmad=false and the
// arithmetic that must round as separate operations is written with
// __fmul_rn / __fadd_rn, so no product is contracted into an fma.

#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

// ops/sh.py's constants rounded to float16 (exact as float)
constexpr float kC0 = 0x1.20cp-2f;
constexpr float kC1 = 0x1.f44p-2f;
constexpr float kC2_0 = 0x1.17cp+0f, kC2_1 = -0x1.17cp+0f, kC2_2 = 0x1.43p-2f,
                kC2_3 = -0x1.17cp+0f, kC2_4 = 0x1.17cp-1f;
constexpr float kC3_0 = -0x1.2ep-1f, kC3_1 = 0x1.72p+1f, kC3_2 = -0x1.d4p-2f,
                kC3_3 = 0x1.7e4p-2f, kC3_4 = -0x1.d4p-2f, kC3_5 = 0x1.72p+0f,
                kC3_6 = -0x1.2ep-1f;

// a float rounded to float16 and back
__device__ __forceinline__ float r16(float x) { return __half2float(__float2half_rn(x)); }
// one float16 product / sum / difference of float16 values
__device__ __forceinline__ float hmul(float a, float b) { return r16(__fmul_rn(a, b)); }
__device__ __forceinline__ float hadd(float a, float b) { return r16(__fadd_rn(a, b)); }
__device__ __forceinline__ float hsub(float a, float b) { return r16(__fsub_rn(a, b)); }

// SH basis in float16, term by term in ops/sh.py's order: (degree + 1)^2
// terms into b
__device__ __forceinline__ void sh_basis(float x, float y, float z, int degree, float *b) {
  b[0] = kC0;
  if (degree > 0) {
    b[1] = hmul(-kC1, y);
    b[2] = hmul(kC1, z);
    b[3] = hmul(-kC1, x);
  }
  if (degree > 1) {
    const float xx = hmul(x, x), yy = hmul(y, y), zz = hmul(z, z);
    const float xy = hmul(x, y), yz = hmul(y, z), xz = hmul(x, z);
    b[4] = hmul(kC2_0, xy);
    b[5] = hmul(kC2_1, yz);
    b[6] = hmul(kC2_2, hsub(hsub(hmul(2.0f, zz), xx), yy));
    b[7] = hmul(kC2_3, xz);
    b[8] = hmul(kC2_4, hsub(xx, yy));
    if (degree > 2) {
      b[9] = hmul(hmul(kC3_0, y), hsub(hmul(3.0f, xx), yy));
      b[10] = hmul(hmul(kC3_1, xy), z);
      b[11] = hmul(hmul(kC3_2, y), hsub(hsub(hmul(4.0f, zz), xx), yy));
      b[12] = hmul(hmul(kC3_3, z), hsub(hsub(hmul(2.0f, zz), hmul(3.0f, xx)), hmul(3.0f, yy)));
      b[13] = hmul(hmul(kC3_4, x), hsub(hsub(hmul(4.0f, zz), xx), yy));
      b[14] = hmul(hmul(kC3_5, z), hsub(xx, yy));
      b[15] = hmul(hmul(kC3_6, x), hsub(xx, hmul(3.0f, yy)));
    }
  }
}

// bilinear corners along one axis of a texture of `size` texels: first
// index, second index, float16 weight of the second (ops/shade.py _corners)
__device__ __forceinline__ void corners(float x, int size, int &i0, int &i1, float &f) {
  const float x0 = floorf(x);
  f = r16(x0 < 0.0f ? 0.0f : __fsub_rn(x, x0));
  i0 = (int)fminf(fmaxf(x0, 0.0f), (float)(size - 1));
  i1 = min(i0 + 1, size - 1);
}

// One ray; DEG is the scene's SH degree, so that the band, channel and
// coefficient loops unroll and the basis and the sums stay in registers.
template <int DEG>
__device__ __forceinline__ void shade_ray(
    long long i, const uint8_t *__restrict__ is_hit, const long long *__restrict__ tri_id,
    const float2 *__restrict__ bary, const float *__restrict__ face_uv,
    const long long *__restrict__ face_offset, const float *__restrict__ rays_d,
    const uint8_t *__restrict__ texels, const long long *__restrict__ table,
    const float *__restrict__ scales, const uint8_t *__restrict__ ignore_alpha,
    const float *__restrict__ bg, int k, long long nr_rays, float *__restrict__ rgb_out,
    float *__restrict__ bg_t_out) {
  constexpr int nb = DEG + 1;
  float basis[16];
  sh_basis(r16(rays_d[3 * i]), r16(rays_d[3 * i + 1]), r16(rays_d[3 * i + 2]), DEG, basis);

  float T = 1.0f;                     // transmittance in front of the shell
  float sum[3] = {0.0f, 0.0f, 0.0f};  // float32 sum over shells
  for (int m = k - 1; m >= 0; --m) {  // outer -> inner
    const long long h = (long long)m * nr_rays + i;
    float rgb[3] = {0.0f, 0.0f, 0.0f};
    float alpha = 0.0f;
    if (is_hit[h]) {
      const float2 uvb = bary[h];
      // a face id below 0 reads face 0, as the plain version's clamp does
      const long long face = tri_id[h] < 0 ? 0 : tri_id[h];
      const float *uv6 = face_uv + 6 * (face_offset[m] + face);
      const float w0 = __fsub_rn(__fsub_rn(1.0f, uvb.x), uvb.y);
      const float U = __fadd_rn(__fadd_rn(__fmul_rn(w0, uv6[0]), __fmul_rn(uvb.x, uv6[2])),
                                __fmul_rn(uvb.y, uv6[4]));
      const float V = __fadd_rn(__fadd_rn(__fmul_rn(w0, uv6[1]), __fmul_rn(uvb.x, uv6[3])),
                                __fmul_rn(uvb.y, uv6[5]));
      float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};  // SH sums of r, g, b, alpha
#pragma unroll
      for (int b = 0; b < nb; ++b) {
        const long long e = (long long)m * nb + b;
        const long long off = table[4 * e];
        const int H = (int)table[4 * e + 1], W = (int)table[4 * e + 2];
        const int nc = 2 * b + 1;  // coefficients of this band (a constant once unrolled)
        const int C = 4 * nc;      // bytes a texel
        const float lo = scales[2 * e], scale = scales[2 * e + 1];
        int x0, x1, y0, y1;
        float fx, fy;
        corners(__fsub_rn(__fmul_rn(U, (float)W), 0.5f), W, x0, x1, fx);
        corners(__fsub_rn(__fmul_rn(__fsub_rn(1.0f, V), (float)H), 0.5f), H, y0, y1, fy);
        const float wx0 = hsub(1.0f, fx), wy0 = hsub(1.0f, fy);
        const float w00 = hmul(wy0, wx0), w01 = hmul(wy0, fx);
        const float w10 = hmul(fy, wx0), w11 = hmul(fy, fx);
        const uint8_t *t00 = texels + off + ((long long)y0 * W + x0) * C;
        const uint8_t *t01 = texels + off + ((long long)y0 * W + x1) * C;
        const uint8_t *t10 = texels + off + ((long long)y1 * W + x0) * C;
        const uint8_t *t11 = texels + off + ((long long)y1 * W + x1) * C;
#pragma unroll
        for (int ch = 0; ch < 4; ++ch) {
#pragma unroll
          for (int j = 0; j < nc; ++j) {
            const int c = ch * nc + j;
            // footprint order (y0, x0), (y0, x1), (y1, x0), (y1, x1)
            float s = r16(__fmul_rn((float)__ldg(t00 + c), w00));
            s = __fadd_rn(s, r16(__fmul_rn((float)__ldg(t01 + c), w01)));
            s = __fadd_rn(s, r16(__fmul_rn((float)__ldg(t10 + c), w10)));
            s = __fadd_rn(s, r16(__fmul_rn((float)__ldg(t11 + c), w11)));
            const float coef = hadd(lo, hmul(scale, r16(s)));
            acc[ch] = __fadd_rn(acc[ch], __fmul_rn(coef, basis[b * b + j]));
          }
        }
      }
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) rgb[ch] = r16(1.0f / (1.0f + expf(-r16(acc[ch]))));
      alpha = ignore_alpha[m] ? 1.0f : r16(1.0f / (1.0f + expf(-r16(acc[3]))));
    }
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) sum[ch] = __fadd_rn(sum[ch], hmul(hmul(rgb[ch], T), alpha));
    T = hmul(T, hsub(1.0f, alpha));
  }
#pragma unroll
  for (int ch = 0; ch < 3; ++ch)
    rgb_out[3 * i + ch] = __fadd_rn(r16(sum[ch]), __fmul_rn(T, bg[ch]));
  bg_t_out[i] = T;
}

}  // namespace

// One kernel a SH degree, with C names, so that ptxas -v reports each under
// its own name.
#define SHADE_KERNEL(DEG)                                                                     \
  extern "C" __global__ void __launch_bounds__(kThreads) shade_composite_deg##DEG##_kernel( \
      const uint8_t *__restrict__ is_hit, const long long *__restrict__ tri_id,               \
      const float2 *__restrict__ bary, const float *__restrict__ face_uv,                     \
      const long long *__restrict__ face_offset, const float *__restrict__ rays_d,            \
      const uint8_t *__restrict__ texels, const long long *__restrict__ table,                \
      const float *__restrict__ scales, const uint8_t *__restrict__ ignore_alpha,             \
      const float *__restrict__ bg, int k, long long nr_rays, float *__restrict__ rgb_out,    \
      float *__restrict__ bg_t_out) {                                                         \
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;                    \
    if (i < nr_rays)                                                                          \
      shade_ray<DEG>(i, is_hit, tri_id, bary, face_uv, face_offset, rays_d, texels, table,    \
                     scales, ignore_alpha, bg, k, nr_rays, rgb_out, bg_t_out);                \
  }
SHADE_KERNEL(0)
SHADE_KERNEL(1)
SHADE_KERNEL(2)
SHADE_KERNEL(3)

extern "C" int vs_shade_composite(const void *is_hit, const void *tri_id, const void *bary,
                                  const void *face_uv, const void *face_offset,
                                  const void *rays_d, const void *texels, const void *table,
                                  const void *scales, const void *ignore_alpha, const void *bg,
                                  int k, int sh_degree, long long nr_rays, void *rgb_out,
                                  void *bg_t_out, void *stream) {
  if (sh_degree < 0 || sh_degree > 3) return (int)cudaErrorInvalidValue;
  if (nr_rays > 0) {
    const unsigned int blocks = (unsigned int)((nr_rays + kThreads - 1) / kThreads);
    auto kernel = sh_degree == 0   ? shade_composite_deg0_kernel
                  : sh_degree == 1 ? shade_composite_deg1_kernel
                  : sh_degree == 2 ? shade_composite_deg2_kernel
                                   : shade_composite_deg3_kernel;
    kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const uint8_t *)is_hit, (const long long *)tri_id, (const float2 *)bary,
        (const float *)face_uv, (const long long *)face_offset, (const float *)rays_d,
        (const uint8_t *)texels, (const long long *)table, (const float *)scales,
        (const uint8_t *)ignore_alpha, (const float *)bg, k, nr_rays, (float *)rgb_out,
        (float *)bg_t_out);
  }
  return (int)cudaGetLastError();
}
