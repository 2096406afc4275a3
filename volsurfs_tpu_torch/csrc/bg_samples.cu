// K10: the background's samples of a ray, contracted into the unit ball.
//
// Replaces no TPU kernel: the JAX package computes these samples with XLA
// ops (volsurfs_tpu/ops/samplers.py:247-327, compute_samples_bg,
// contract_points and contract_samples, through ops/samples.py::update_dt
// with is_background=True), which the port's plain version
// (ops/samplers.py::bg_samples_reference) runs as some 25 small torch ops a
// call. This kernel does the same in one launch.
//
// For each ray and each of its N samples i:
//   s_i = 1 - ds * i                         (ds = 1 / (N - 1), float32)
//   t_i = clamp(1 / (s_i + 1e-6) - 1 + t_start, t_start, t_far)
//   middle samples with jitter u: t_i = t_{i-1} + (t_i - t_{i-1}) * u_i,
//     t_{i-1} the un-jittered depth before
//   max_dt = max_i (t_i - t_{i-1}), t_{-1} = t_start (the jittered depths)
//   p_i = o + t_i d; n = |2 p_i|; c_i = n > 1 ? (2 - 1/n) p_i / n : p_i
//   cz_i = |c_i - o|; dt_i = clamp(cz_{i+1} - cz_i, 0, max_dt), 1e10 last
// and writes c_i [R, N, 3], cz, dt and t [R, N], max_dt [R, 1]. The
// directions are the rays' own, which the caller expands (no write).
//
// Bound: bytes. A sample takes a few dozen operations (one division, two
// square roots), reads 4 bytes of jitter where jittered and writes 24;
// at 512 x 64 samples that is 0.9 MB, 0.27 us at 3.35 TB/s, so the
// launch itself dominates.
//
// Design: a warp a ray, its lanes over the samples (lane + 32 k). A lane
// recomputes the depths of the samples before and after its own rather
// than exchanging them: they are a handful of operations, and the row's
// max_dt, which every dt needs, is one warp reduction between two passes.
//
// Rounding: built with -fmad=false, every product and sum rounds on its
// own, in the plain version's order (torch ops, one each), divisions and
// square roots IEEE. XLA:CPU, run op by op as the parity tests run JAX,
// contracts nothing but jnp.linalg.norm's reduction, which it rounds as
// sqrt(fma(z, z, fma(y, y, x * x))): the kernel makes those two fmas
// (__fmaf_rn) and the plain version the same (utils/math.py::norm3), so the
// two agree bit for bit, and with JAX.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;  // rays a block
constexpr int kThreads = 32 * kWarps;

// torch.maximum / torch.minimum: NaN propagates
__device__ __forceinline__ float max_nan(float a, float b) {
  return (a != a || a > b) ? a : b;
}
__device__ __forceinline__ float min_nan(float a, float b) {
  return (a != a || a < b) ? a : b;
}

struct Ray {
  float o[3], d[3], t_start, t_far, ds;
  const float *u;  // the row's jitter, or null
  int n;
};

// the un-jittered depth of sample i
__device__ __forceinline__ float base_depth(const Ray &r, int i) {
  float s = 1.0f - r.ds * (float)i;
  float t = 1.0f / (s + 1e-6f) - 1.0f + r.t_start;
  return min_nan(max_nan(t, r.t_start), r.t_far);
}

// the depth of sample i (t_start for i = -1), jittered where asked
__device__ __forceinline__ float depth(const Ray &r, int i) {
  if (i < 0) return r.t_start;
  float t = base_depth(r, i);
  if (r.u != nullptr && i > 0 && i < r.n - 1) {
    float t_prev = base_depth(r, i - 1);
    t = t_prev + (t - t_prev) * r.u[i];
  }
  return t;
}

// XLA:CPU's float32 norm of 3: sqrt(fma(z, z, fma(y, y, x * x)))
__device__ __forceinline__ float norm3(float x, float y, float z) {
  return sqrtf(__fmaf_rn(z, z, __fmaf_rn(y, y, x * x)));
}

// the contracted point of depth t into c, and its distance from the origin
__device__ __forceinline__ float contract(const Ray &r, float t, float c[3]) {
  float p[3];
  for (int k = 0; k < 3; ++k) p[k] = r.o[k] + t * r.d[k];
  float n = norm3(p[0] * 2.0f, p[1] * 2.0f, p[2] * 2.0f);
  float safe = max_nan(n, 1e-12f);
  float factor = 2.0f - 1.0f / safe;
  for (int k = 0; k < 3; ++k) c[k] = n > 1.0f ? factor * p[k] / safe : p[k];
  return norm3(c[0] - r.o[0], c[1] - r.o[1], c[2] - r.o[2]);
}

}  // namespace

extern "C" __global__ void __launch_bounds__(kThreads)
bg_samples_kernel(const float *__restrict__ rays_o, const float *__restrict__ rays_d,
                  const float *__restrict__ t_start, const float *__restrict__ jitter,
                  float ds, float t_far, float *__restrict__ cpos,
                  float *__restrict__ cz,
                  float *__restrict__ dt, float *__restrict__ z,
                  float *__restrict__ max_dt, int n, long long nr_rays) {
  long long ray = (long long)blockIdx.x * kWarps + threadIdx.x / 32;
  int lane = threadIdx.x % 32;
  if (ray >= nr_rays) return;
  Ray r;
  for (int k = 0; k < 3; ++k) {
    r.o[k] = rays_o[ray * 3 + k];
    r.d[k] = rays_d[ray * 3 + k];
  }
  r.t_start = t_start[ray];
  r.t_far = t_far;
  r.ds = ds;
  r.u = jitter == nullptr ? nullptr : jitter + ray * n;
  r.n = n;

  // pass 1: the row's largest gap of the uncontracted depths
  float gap = -INFINITY;
  for (int i = lane; i < n; i += 32) gap = max_nan(gap, depth(r, i) - depth(r, i - 1));
  for (int off = 16; off > 0; off /= 2)
    gap = max_nan(gap, __shfl_xor_sync(0xffffffffu, gap, off));
  if (lane == 0) max_dt[ray] = gap;

  // pass 2: the contracted samples and their gaps
  long long row = ray * n;
  for (int i = lane; i < n; i += 32) {
    float t = depth(r, i);
    float c[3];
    float dist = contract(r, t, c);
    float gap_c = 1e10f;
    if (i < n - 1) {
      float c_next[3];
      float next = contract(r, depth(r, i + 1), c_next);
      gap_c = min_nan(max_nan(next - dist, 0.0f), gap);
    }
    for (int k = 0; k < 3; ++k) cpos[(row + i) * 3 + k] = c[k];
    cz[row + i] = dist;
    dt[row + i] = gap_c;
    z[row + i] = t;
  }
}

extern "C" int vs_bg_samples(const void *rays_o, const void *rays_d, const void *t_start,
                             const void *jitter, float ds, float t_far, void *cpos,
                             void *cz, void *dt, void *z, void *max_dt, int n,
                             long long nr_rays, void *stream) {
  if (nr_rays <= 0) return (int)cudaSuccess;
  unsigned int blocks = (unsigned int)((nr_rays + kWarps - 1) / kWarps);
  bg_samples_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const float *)rays_o, (const float *)rays_d, (const float *)t_start,
      (const float *)jitter, ds, t_far, (float *)cpos, (float *)cz,
      (float *)dt, (float *)z, (float *)max_dt, n, nr_rays);
  return (int)cudaGetLastError();
}
