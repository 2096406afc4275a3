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
//   2. every shell's face id as K2 wrote it, then for every shell that is
//      hit its u, v and face UVs, and (1-u-v) a + u b + v c of them: the
//      loads of each of the two steps are independent, so they are in
//      flight together;
//   3. for each shell, outer to inner (mesh k-1 down to 0), if the ray hits
//      it: for each band the clamped 2x2 texel footprint of the band's uint8
//      texture [H, W, 4*C], each texel byte weighted and summed, scaled
//      (lo + scale*s) and multiplied into the SH sum of its colour channel;
//      a float32 sigmoid of the four sums; alpha 1 where the mesh ignores
//      alpha. A shell the ray misses adds nothing, as in JAX;
//   4. the float16 compositing: T *= 1 - alpha, and the float32 sum of
//      rgb * T_before * alpha over shells; then + T * background.
//
// Bound: bytes, at the render's shapes. A hit reads its face's 24 B of UVs
// and four texels of every band, 4*C bytes each (4, 12, 20, 28 B for bands
// 0-3); neighbouring rays share most texels, so the distinct bytes are far
// fewer than the gathered ones and are read through L1 and L2.
// What kept the first version (one byte load and ~30 float32 instructions
// a texel byte, a third of them conversions) far from that bound was
// instruction issue, and on a cold frame the chain of dependent loads of
// each shell. This version:
//   - reads a texel as C aligned 32-bit words (a band's offset and 4*C are
//     multiples of 4), not 4*C byte loads;
//   - takes two texel bytes into float16 without a conversion: each byte
//     goes under the float16 exponent of 1024 (__byte_perm gives 1024 +
//     byte), and one half2 fma of that and the weight less 1024 times the
//     weight gives the two rounded byte-times-weight products;
//   - does every float16 product, sum and difference as a native half2 (or
//     half) operation in its _rn form, two channels an instruction;
//   - loads every shell's hit and face UVs before any texel;
//   - on a frame (width > 0) gives a block of 128 threads a 16x8 pixel
//     tile, so that a warp's 32 rays (16x2 pixels) read one compact patch
//     of texels; outputs stay row-major.
//
// Rounding is that of the plain version (ops/shade.py), which follows the
// JAX code run op by op: a float16 operation of float16 operands rounds
// once (the _rn intrinsics never contract into an fma; the first version
// did each in float32 and rounded to float16, which is the same, since
// float32 has at least 2*11+2 bits); the footprint's four float16 products
// are summed in float32 and rounded once; the SH contraction sums float32
// products of float16 values, which are exact, so each product and sum is
// one fma; the sigmoid is float32; the sum over shells is float32. The
// library is built with -fmad=false, so that nvcc contracts nothing else.

#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kThreads = 128;
constexpr int kTileW = 16, kTileH = 8;  // a block's pixels on a frame
constexpr int kMaxShells = 9;           // base_9.cfg; every shell's hit stays in registers

// one (mesh, band) texture, a row of ops/shade.py's kernel_table: offset of
// its texels in 32-bit words, H, W, and lo and scale as float16 bits in
// both halves of a half2
struct Band {
  int off, H, W;
  unsigned int lo, scale;
};

__device__ __forceinline__ Band load_band(const int4 *__restrict__ table, int e) {
  const int4 a = __ldg(table + 2 * e), b = __ldg(table + 2 * e + 1);
  return {a.x, a.y, a.z, (unsigned int)a.w, (unsigned int)b.x};
}

__device__ __forceinline__ __half2 bits_h2(unsigned int x) {
  __half2 h;
  memcpy(&h, &x, sizeof h);
  return h;
}
__device__ __forceinline__ __half bits_h(unsigned short x) { return __ushort_as_half(x); }

// float16 bits of ops/sh.py's constants and small integers
constexpr unsigned short kOne = 0x3c00, kTwo = 0x4000, kThree = 0x4200, kFour = 0x4400;
constexpr unsigned short kC0 = 0x3483, kC1 = 0x37d1, kMinusC1 = 0xb7d1;
constexpr unsigned short kC2_0 = 0x3c5f, kC2_1 = 0xbc5f, kC2_2 = 0x350c, kC2_3 = 0xbc5f,
                         kC2_4 = 0x385f;
constexpr unsigned short kC3_0 = 0xb8b8, kC3_1 = 0x41c8, kC3_2 = 0xb750, kC3_3 = 0x35f9,
                         kC3_4 = 0xb750, kC3_5 = 0x3dc8, kC3_6 = 0xb8b8;
constexpr unsigned int kMinus1024x2 = 0xe400e400u;  // half2 (-1024, -1024)
constexpr unsigned int kOnex2 = 0x3c003c00u;        // half2 (1, 1)

__device__ __forceinline__ __half hmul(__half a, __half b) { return __hmul_rn(a, b); }
__device__ __forceinline__ __half hsub(__half a, __half b) { return __hsub_rn(a, b); }

// bytes 0, 1 (lo) or 2, 3 (hi) of a texel word b as the half2 1024 + b:
// the float16 with exponent bits 0x64 has the byte as its low mantissa bits
__device__ __forceinline__ __half2 biased_lo(unsigned int w) {
  return bits_h2(__byte_perm(w, 0x6464u, 0x5140));
}
__device__ __forceinline__ __half2 biased_hi(unsigned int w) {
  return bits_h2(__byte_perm(w, 0x6464u, 0x5342));
}

// b * w rounded once to float16, for the bytes b of biased = 1024 + b and a
// weight w in [0, 1]: one fma of biased * w and minus_1024w = -1024 w (an
// exact float16 product), whose exact value is b * w, so it rounds as
// __hmul2_rn(b, w) does
__device__ __forceinline__ __half2 byte_products(__half2 biased, __half2 w, __half2 minus_1024w) {
  return __hfma2(biased, w, minus_1024w);
}

// SH basis in float16, term by term in ops/sh.py's order, (DEG + 1)^2
// terms into b as floats (exact), for the float32 contraction
template <int DEG>
__device__ __forceinline__ void sh_basis(const float *__restrict__ d, float *b) {
  const __half x = __float2half_rn(d[0]), y = __float2half_rn(d[1]), z = __float2half_rn(d[2]);
  b[0] = __half2float(bits_h(kC0));
  if constexpr (DEG > 0) {
    b[1] = __half2float(hmul(bits_h(kMinusC1), y));
    b[2] = __half2float(hmul(bits_h(kC1), z));
    b[3] = __half2float(hmul(bits_h(kMinusC1), x));
  }
  if constexpr (DEG > 1) {
    const __half xx = hmul(x, x), yy = hmul(y, y), zz = hmul(z, z);
    const __half xy = hmul(x, y), yz = hmul(y, z), xz = hmul(x, z);
    const __half two_zz = hmul(bits_h(kTwo), zz), xx_yy = hsub(xx, yy);
    b[4] = __half2float(hmul(bits_h(kC2_0), xy));
    b[5] = __half2float(hmul(bits_h(kC2_1), yz));
    b[6] = __half2float(hmul(bits_h(kC2_2), hsub(hsub(two_zz, xx), yy)));
    b[7] = __half2float(hmul(bits_h(kC2_3), xz));
    b[8] = __half2float(hmul(bits_h(kC2_4), xx_yy));
    if constexpr (DEG > 2) {
      const __half three_xx = hmul(bits_h(kThree), xx), three_yy = hmul(bits_h(kThree), yy);
      const __half four_zz_xx_yy = hsub(hsub(hmul(bits_h(kFour), zz), xx), yy);
      b[9] = __half2float(hmul(hmul(bits_h(kC3_0), y), hsub(three_xx, yy)));
      b[10] = __half2float(hmul(hmul(bits_h(kC3_1), xy), z));
      b[11] = __half2float(hmul(hmul(bits_h(kC3_2), y), four_zz_xx_yy));
      b[12] = __half2float(hmul(hmul(bits_h(kC3_3), z), hsub(hsub(two_zz, three_xx), three_yy)));
      b[13] = __half2float(hmul(hmul(bits_h(kC3_4), x), four_zz_xx_yy));
      b[14] = __half2float(hmul(hmul(bits_h(kC3_5), z), xx_yy));
      b[15] = __half2float(hmul(hmul(bits_h(kC3_6), x), hsub(xx, three_yy)));
    }
  }
}

// bilinear corners along one axis of a texture of `size` texels: first
// index, second index, and the float32 value whose float16 rounding is the
// weight of the second (ops/shade.py _corners)
__device__ __forceinline__ void corners(float x, int size, int &i0, int &i1, float &f) {
  const float x0 = floorf(x);
  f = x0 < 0.0f ? 0.0f : __fsub_rn(x, x0);
  i0 = (int)fminf(fmaxf(x0, 0.0f), (float)(size - 1));
  i1 = min(i0 + 1, size - 1);
}

// Band of NC coefficients (C = 4*NC bytes a texel) at texture coordinates
// (U, V): each byte's footprint sum, lo + scale*s, times its basis term into
// the float32 sum of its channel (byte ch*NC + j is channel ch,
// coefficient j; the bytes of a channel come in coefficient order)
template <int NC>
__device__ __forceinline__ void shade_band(const unsigned int *__restrict__ words,
                                           const Band &band, float U, float V,
                                           const float *basis, float acc[4]) {
  int x0, x1, y0, y1;
  float fx, fy;
  corners(__fsub_rn(__fmul_rn(U, (float)band.W), 0.5f), band.W, x0, x1, fx);
  corners(__fsub_rn(__fmul_rn(__fsub_rn(1.0f, V), (float)band.H), 0.5f), band.H, y0, y1, fy);
  const __half2 f = __floats2half2_rn(fx, fy);               // (fx, fy)
  const __half2 w0 = __hsub2_rn(bits_h2(kOnex2), f);         // (1 - fx, 1 - fy)
  const __half2 xs = __lows2half2(w0, f);                    // (1 - fx, fx)
  const __half2 top = __hmul2_rn(__high2half2(w0), xs);      // (w00, w01)
  const __half2 bottom = __hmul2_rn(__high2half2(f), xs);    // (w10, w11)
  const __half2 top_m = __hmul2_rn(top, bits_h2(kMinus1024x2));        // -1024 (w00, w01)
  const __half2 bottom_m = __hmul2_rn(bottom, bits_h2(kMinus1024x2));  // -1024 (w10, w11)
  const __half2 w00 = __low2half2(top), w01 = __high2half2(top);
  const __half2 w10 = __low2half2(bottom), w11 = __high2half2(bottom);
  const __half2 m00 = __low2half2(top_m), m01 = __high2half2(top_m);
  const __half2 m10 = __low2half2(bottom_m), m11 = __high2half2(bottom_m);
  const unsigned int *t00 = words + (y0 * band.W + x0) * NC;
  const unsigned int *t01 = words + (y0 * band.W + x1) * NC;
  const unsigned int *t10 = words + (y1 * band.W + x0) * NC;
  const unsigned int *t11 = words + (y1 * band.W + x1) * NC;
  unsigned int q00[NC], q01[NC], q10[NC], q11[NC];
#pragma unroll
  for (int j = 0; j < NC; ++j) {
    q00[j] = __ldg(t00 + j);
    q01[j] = __ldg(t01 + j);
    q10[j] = __ldg(t10 + j);
    q11[j] = __ldg(t11 + j);
  }
  const __half2 lo = bits_h2(band.lo), scale = bits_h2(band.scale);
#pragma unroll
  for (int j = 0; j < NC; ++j) {
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      // footprint order (y0, x0), (y0, x1), (y1, x0), (y1, x1)
      const float2 p00 = __half22float2(
          byte_products(hi ? biased_hi(q00[j]) : biased_lo(q00[j]), w00, m00));
      const float2 p01 = __half22float2(
          byte_products(hi ? biased_hi(q01[j]) : biased_lo(q01[j]), w01, m01));
      const float2 p10 = __half22float2(
          byte_products(hi ? biased_hi(q10[j]) : biased_lo(q10[j]), w10, m10));
      const float2 p11 = __half22float2(
          byte_products(hi ? biased_hi(q11[j]) : biased_lo(q11[j]), w11, m11));
      const float sx = __fadd_rn(__fadd_rn(__fadd_rn(p00.x, p01.x), p10.x), p11.x);
      const float sy = __fadd_rn(__fadd_rn(__fadd_rn(p00.y, p01.y), p10.y), p11.y);
      const float2 coef = __half22float2(
          __hadd2_rn(lo, __hmul2_rn(scale, __floats2half2_rn(sx, sy))));
      const int c = 4 * j + 2 * hi;  // the byte of coef.x
      acc[c / NC] = __fmaf_rn(coef.x, basis[c % NC], acc[c / NC]);
      acc[(c + 1) / NC] = __fmaf_rn(coef.y, basis[(c + 1) % NC], acc[(c + 1) / NC]);
    }
  }
}

__device__ __forceinline__ __half sigmoid16(float x) {
  const float s = __half2float(__float2half_rn(x));
  return __float2half_rn(1.0f / (1.0f + expf(-s)));
}

// One ray; DEG is the scene's SH degree, so that the band, channel and
// coefficient loops unroll and the basis and the sums stay in registers.
template <int DEG>
__device__ __forceinline__ void shade_ray(
    long long i, const int *__restrict__ tri, const float *__restrict__ bu,
    const float *__restrict__ bv, const float2 *__restrict__ face_uv,
    const long long *__restrict__ face_offset, const float *__restrict__ rays_d,
    const unsigned int *__restrict__ texels, const int4 *__restrict__ bands,
    const uint8_t *__restrict__ ignore_alpha, const float *__restrict__ bg, int k,
    long long nr_rays, float *__restrict__ rgb_out, float *__restrict__ bg_t_out) {
  constexpr int nb = DEG + 1;
  // every shell's face id, then the barycentrics and face UVs of each hit
  // (a miss reads neither): all loads of one step in flight together
  int face[kMaxShells];
  float U[kMaxShells], V[kMaxShells];
#pragma unroll
  for (int m = 0; m < kMaxShells; ++m)
    face[m] = m < k ? __ldg(tri + (long long)m * nr_rays + i) : -1;
#pragma unroll
  for (int m = 0; m < kMaxShells; ++m) {
    U[m] = V[m] = 0.0f;
    if (face[m] >= 0) {
      const long long h = (long long)m * nr_rays + i;
      const float u = __ldg(bu + h), v = __ldg(bv + h);
      const float2 *uv = face_uv + 3 * (__ldg(face_offset + m) + face[m]);
      const float2 a = __ldg(uv), b = __ldg(uv + 1), c = __ldg(uv + 2);
      const float w0 = __fsub_rn(__fsub_rn(1.0f, u), v);
      U[m] = __fadd_rn(__fadd_rn(__fmul_rn(w0, a.x), __fmul_rn(u, b.x)), __fmul_rn(v, c.x));
      V[m] = __fadd_rn(__fadd_rn(__fmul_rn(w0, a.y), __fmul_rn(u, b.y)), __fmul_rn(v, c.y));
    }
  }
  float basis[16];
  sh_basis<DEG>(rays_d + 3 * i, basis);

  const __half one = bits_h(kOne);
  __half T = one;                     // transmittance in front of the shell
  float sum[3] = {0.0f, 0.0f, 0.0f};  // float32 sum over shells
  for (int m = k - 1; m >= 0; --m) {  // outer -> inner
    int f = -1;
    float u = 0.0f, v = 0.0f;
#pragma unroll
    for (int j = 0; j < kMaxShells; ++j) {
      if (j == m) {
        f = face[j];
        u = U[j];
        v = V[j];
      }
    }
    if (f < 0) continue;  // a miss: rgb and alpha 0 leave T and the sum as they are
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};  // SH sums of r, g, b, alpha
#pragma unroll
    for (int b = 0; b < nb; ++b) {
      const Band band = load_band(bands, m * nb + b);
      const unsigned int *words = texels + band.off;
      if (b == 0) shade_band<1>(words, band, u, v, basis, acc);
      if (b == 1) shade_band<3>(words, band, u, v, basis + 1, acc);
      if (b == 2) shade_band<5>(words, band, u, v, basis + 4, acc);
      if (b == 3) shade_band<7>(words, band, u, v, basis + 9, acc);
    }
    const __half alpha = __ldg(ignore_alpha + m) ? one : sigmoid16(acc[3]);
#pragma unroll
    for (int ch = 0; ch < 3; ++ch)
      sum[ch] = __fadd_rn(sum[ch], __half2float(hmul(hmul(sigmoid16(acc[ch]), T), alpha)));
    T = hmul(T, hsub(one, alpha));
  }
  const float t = __half2float(T);
#pragma unroll
  for (int ch = 0; ch < 3; ++ch)
    rgb_out[3 * i + ch] = __fadd_rn(__half2float(__float2half_rn(sum[ch])), __fmul_rn(t, bg[ch]));
  bg_t_out[i] = t;
}

// float16 operations against float32 ones rounded to float16, for the card
// test of the rounding argument above: for element i of a and b (float16
// bits), rows 0-2 of out hold the half2 _rn product, sum and difference,
// rows 3-5 the half ones, rows 6-8 the float32 ones rounded to float16;
// rows 9-12 the products of b with bytes 0-3 of the word a * 0x01010101
// (a taken as an integer) as K4 forms them from a texel word.
__global__ void half_ops_check_kernel(const unsigned short *__restrict__ a,
                                      const unsigned short *__restrict__ b, long long n,
                                      unsigned short *__restrict__ out) {
  const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;  // a pair
  if (2 * p >= n) return;
  const long long i = 2 * p;
  const __half2 x = __halves2half2(bits_h(a[i]), bits_h(a[i + 1]));
  const __half2 y = __halves2half2(bits_h(b[i]), bits_h(b[i + 1]));
  const __half2 r[3] = {__hmul2_rn(x, y), __hadd2_rn(x, y), __hsub2_rn(x, y)};
  for (int e = 0; e < 2; ++e) {
    const __half xs = bits_h(a[i + e]), ys = bits_h(b[i + e]);
    const float xf = __half2float(xs), yf = __half2float(ys);
    const __half s[9] = {
        e ? __high2half(r[0]) : __low2half(r[0]), e ? __high2half(r[1]) : __low2half(r[1]),
        e ? __high2half(r[2]) : __low2half(r[2]), __hmul_rn(xs, ys), __hadd_rn(xs, ys),
        __hsub_rn(xs, ys), __float2half_rn(__fmul_rn(xf, yf)), __float2half_rn(__fadd_rn(xf, yf)),
        __float2half_rn(__fsub_rn(xf, yf))};
    for (int row = 0; row < 9; ++row) out[row * n + i + e] = __half_as_ushort(s[row]);
    const unsigned int word = (unsigned int)fminf(fmaxf(xf, 0.0f), 255.0f) * 0x01010101u;
    const __half2 w = __half2half2(ys), m = __hmul2_rn(w, bits_h2(kMinus1024x2));
    const __half2 lo = byte_products(biased_lo(word), w, m);
    const __half2 hi = byte_products(biased_hi(word), w, m);
    out[9 * n + i + e] = __half_as_ushort(__low2half(lo));
    out[10 * n + i + e] = __half_as_ushort(__high2half(lo));
    out[11 * n + i + e] = __half_as_ushort(__low2half(hi));
    out[12 * n + i + e] = __half_as_ushort(__high2half(hi));
  }
}

}  // namespace

// One kernel a SH degree, with C names, so that ptxas -v reports each under
// its own name. width > 0: the rays are a row-major frame of that width,
// and a block shades a kTileW x kTileH tile of it; width 0: ray i is
// thread i.
#define SHADE_KERNEL(DEG)                                                                      \
  extern "C" __global__ void __launch_bounds__(kThreads) shade_composite_deg##DEG##_kernel(  \
      const int *__restrict__ tri, const float *__restrict__ bu, const float *__restrict__ bv, \
      const float2 *__restrict__ face_uv, const long long *__restrict__ face_offset,          \
      const float *__restrict__ rays_d, const unsigned int *__restrict__ texels,              \
      const int4 *__restrict__ bands, const uint8_t *__restrict__ ignore_alpha,               \
      const float *__restrict__ bg, int k, long long nr_rays, int width,                       \
      float *__restrict__ rgb_out, float *__restrict__ bg_t_out) {                             \
    long long i;                                                                               \
    if (width > 0) {                                                                           \
      const int tiles_x = (width + kTileW - 1) / kTileW;                                       \
      const int x = (int)(blockIdx.x % tiles_x) * kTileW + (int)(threadIdx.x % kTileW);        \
      const long long y = (long long)(blockIdx.x / tiles_x) * kTileH + threadIdx.x / kTileW;   \
      if (x >= width || y >= nr_rays / width) return;                                          \
      i = y * width + x;                                                                       \
    } else {                                                                                   \
      i = (long long)blockIdx.x * kThreads + threadIdx.x;                                      \
      if (i >= nr_rays) return;                                                                \
    }                                                                                          \
    shade_ray<DEG>(i, tri, bu, bv, face_uv, face_offset, rays_d, texels, bands, ignore_alpha,  \
                   bg, k, nr_rays, rgb_out, bg_t_out);                                         \
  }
SHADE_KERNEL(0)
SHADE_KERNEL(1)
SHADE_KERNEL(2)
SHADE_KERNEL(3)

// bands: ops/shade.py's kernel_table, [k * (sh_degree + 1), 8] int32 on the
// device
extern "C" int vs_shade_composite(const void *tri, const void *u, const void *v,
                                  const void *face_uv, const void *face_offset,
                                  const void *rays_d, const void *texels, const void *bands,
                                  const void *ignore_alpha, const void *bg, int k, int sh_degree,
                                  long long nr_rays, int width, void *rgb_out, void *bg_t_out,
                                  void *stream) {
  if (sh_degree < 0 || sh_degree > 3 || k < 0 || k > kMaxShells || width < 0 ||
      (width > 0 && nr_rays % width != 0))
    return (int)cudaErrorInvalidValue;
  if (nr_rays > 0) {
    const long long blocks =
        width > 0 ? (long long)((width + kTileW - 1) / kTileW) *
                        ((nr_rays / width + kTileH - 1) / kTileH)
                  : (nr_rays + kThreads - 1) / kThreads;
    auto kernel = sh_degree == 0   ? shade_composite_deg0_kernel
                  : sh_degree == 1 ? shade_composite_deg1_kernel
                  : sh_degree == 2 ? shade_composite_deg2_kernel
                                   : shade_composite_deg3_kernel;
    kernel<<<(unsigned int)blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const int *)tri, (const float *)u, (const float *)v, (const float2 *)face_uv,
        (const long long *)face_offset, (const float *)rays_d, (const unsigned int *)texels,
        (const int4 *)bands, (const uint8_t *)ignore_alpha, (const float *)bg, k, nr_rays,
        width, (float *)rgb_out, (float *)bg_t_out);
  }
  return (int)cudaGetLastError();
}

// a, b: n float16 values (n even), out: [13, n] uint16 (see
// half_ops_check_kernel)
extern "C" int vs_half_ops_check(const void *a, const void *b, long long n, void *out,
                                 void *stream) {
  if (n % 2 != 0) return (int)cudaErrorInvalidValue;
  if (n > 0)
    half_ops_check_kernel<<<(unsigned int)((n / 2 + kThreads - 1) / kThreads), kThreads, 0,
                            (cudaStream_t)stream>>>((const unsigned short *)a,
                                                    (const unsigned short *)b, n,
                                                    (unsigned short *)out);
  return (int)cudaGetLastError();
}
