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
// Bound: bytes. A sample reads 4 bytes of jitter where jittered and
// writes 24; its ~49 operations (one division for the depth, four for
// the contraction, two square roots) come to a sixth of that time at the
// card's issue rate. At 512 x 64 samples the bytes take 0.28 us, so the
// launch and one sample's chain of dependent operations set the time.
//
// Design: a thread a sample. A row's samples lie on consecutive lanes of
// ceil(N / 32) warps of one block; a block holds one row, or two rows of
// up to 32 samples, so that 512 rays put work on every SM. Each thread
// computes its own un-jittered depth, jittered depth and contracted point
// once, and takes its neighbours' values from __shfl_up_sync /
// __shfl_down_sync, or across a warp boundary inside a row from shared
// memory (two __syncthreads in all). The row's largest gap is a warp
// reduction followed by one over the row's warps in shared memory. The
// block's contracted points, one contiguous range of its rows' N * 12
// bytes, are staged in shared memory and written with 16-byte stores; cz,
// dt and z are written coalesced by lane. A row holds at most kMaxSamples
// samples (one block); the wrapper raises above it.
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

constexpr int kMaxSamples = 1024;  // a row's samples: the threads of one block
constexpr int kMaxWarps = kMaxSamples / 32;
constexpr int kSmallBlock = 64;    // threads of a block of short rows
constexpr unsigned kFull = 0xffffffffu;

// torch.maximum / torch.minimum: NaN propagates
__device__ __forceinline__ float max_nan(float a, float b) {
  return (a != a || a > b) ? a : b;
}
__device__ __forceinline__ float min_nan(float a, float b) {
  return (a != a || a < b) ? a : b;
}

// XLA:CPU's float32 norm of 3: sqrt(fma(z, z, fma(y, y, x * x)))
__device__ __forceinline__ float norm3(float x, float y, float z) {
  return sqrtf(__fmaf_rn(z, z, __fmaf_rn(y, y, x * x)));
}

// the un-jittered depth of sample i
__device__ __forceinline__ float base_depth(float ds, int i, float t_start, float t_far) {
  float s = 1.0f - ds * (float)i;
  float t = 1.0f / (s + 1e-6f) - 1.0f + t_start;
  return min_nan(max_nan(t, t_start), t_far);
}

// the jittered depth between the un-jittered t_prev and t
__device__ __forceinline__ float jittered(float t_prev, float t, float u) {
  return t_prev + (t - t_prev) * u;
}

// rows a block and threads a row of N samples
__host__ __device__ __forceinline__ int row_threads(int n) { return 32 * ((n + 31) / 32); }
__host__ __device__ __forceinline__ int rows_a_block(int n) {
  return row_threads(n) >= kSmallBlock ? 1 : kSmallBlock / row_threads(n);
}

}  // namespace

extern "C" __global__ void __launch_bounds__(kMaxSamples)
bg_samples_kernel(const float *__restrict__ rays_o, const float *__restrict__ rays_d,
                  const float *__restrict__ t_start, const float *__restrict__ jitter,
                  float ds, float t_far, float *__restrict__ cpos,
                  float *__restrict__ cz,
                  float *__restrict__ dt, float *__restrict__ z,
                  float *__restrict__ max_dt, int n, long long nr_rays) {
  // the block's contracted points, from a 16-byte boundary of cpos
  extern __shared__ float4 stage4[];
  float *stage = reinterpret_cast<float *>(stage4);
  // a warp's last un-jittered and jittered depths, first contracted
  // distance and largest gap
  __shared__ float sh_base[kMaxWarps], sh_t[kMaxWarps], sh_cz[kMaxWarps], sh_gap[kMaxWarps];

  const int width = row_threads(n), rows = rows_a_block(n);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int local_row = tid / width, i = tid % width;
  const int row_warp = i / 32, row_warps = width / 32;
  const long long ray0 = (long long)blockIdx.x * rows;
  const long long ray = ray0 + local_row;
  const bool valid = ray < nr_rays && i < n;
  // threads past the row's end or the last ray run along (every lane takes
  // part in the shuffles and barriers) on ray 0's inputs, and store nothing
  const long long src = valid ? ray : 0;

  float o[3], d[3];
  for (int k = 0; k < 3; ++k) {
    o[k] = __ldg(rays_o + src * 3 + k);
    d[k] = __ldg(rays_d + src * 3 + k);
  }
  const float t0 = __ldg(t_start + src);
  const bool jit = jitter != nullptr && i > 0 && i < n - 1;
  const float u = jit && valid ? __ldg(jitter + src * n + i) : 0.0f;

  // the depths: own un-jittered, the one before from the lane before
  const float base = base_depth(ds, i, t0, t_far);
  float base_prev = __shfl_up_sync(kFull, base, 1);
  float t = base;
  if (lane != 0 && jit) t = jittered(base_prev, base, u);
  if (lane == 31) {  // complete within the warp: publish for the next warp
    sh_base[warp] = base;
    sh_t[warp] = t;
  }
  __syncthreads();
  if (lane == 0 && row_warp > 0 && jit) t = jittered(sh_base[warp - 1], base, u);
  float t_prev = __shfl_up_sync(kFull, t, 1);
  if (lane == 0) t_prev = row_warp > 0 ? sh_t[warp - 1] : t0;
  float gap = i < n ? t - t_prev : -INFINITY;
  for (int off = 16; off > 0; off /= 2) gap = max_nan(gap, __shfl_xor_sync(kFull, gap, off));

  // the contracted point and its distance from the origin
  float p[3], c[3];
  for (int k = 0; k < 3; ++k) p[k] = o[k] + t * d[k];
  const float norm = norm3(p[0] * 2.0f, p[1] * 2.0f, p[2] * 2.0f);
  const float safe = max_nan(norm, 1e-12f);
  const float factor = 2.0f - 1.0f / safe;
  for (int k = 0; k < 3; ++k) c[k] = norm > 1.0f ? factor * p[k] / safe : p[k];
  const float dist = norm3(c[0] - o[0], c[1] - o[1], c[2] - o[2]);
  if (lane == 0) {
    sh_cz[warp] = dist;
    sh_gap[warp] = gap;
  }
  const long long start = ray0 * n * 3;  // the block's first float of cpos
  const int shift = (int)(start & 3);
  if (valid)
    for (int k = 0; k < 3; ++k) stage[shift + (local_row * n + i) * 3 + k] = c[k];
  __syncthreads();

  // the row's largest gap, and the next sample's distance
  const int first_warp = warp - row_warp;
  float row_gap = sh_gap[first_warp];
  for (int w = 1; w < row_warps; ++w) row_gap = max_nan(row_gap, sh_gap[first_warp + w]);
  float next = __shfl_down_sync(kFull, dist, 1);
  if (lane == 31 && row_warp + 1 < row_warps) next = sh_cz[warp + 1];
  if (valid) {
    const long long at = ray * n + i;
    cz[at] = dist;
    dt[at] = i < n - 1 ? min_nan(max_nan(next - dist, 0.0f), row_gap) : 1e10f;
    z[at] = t;
    if (i == 0) max_dt[ray] = row_gap;
  }

  // the staged points: a scalar head and tail around 16-byte stores
  const long long rows_here = nr_rays - ray0 < rows ? nr_rays - ray0 : rows;
  const int end = shift + (int)rows_here * n * 3;
  const int vec_begin = min((shift + 3) & ~3, end), vec_end = max(end & ~3, vec_begin);
  float *dst = cpos + (start - shift);  // on a 16-byte boundary
  for (int k = shift + tid; k < vec_begin; k += blockDim.x) dst[k] = stage[k];
  for (int k = vec_end + tid; k < end; k += blockDim.x) dst[k] = stage[k];
  float4 *dst4 = reinterpret_cast<float4 *>(dst);
  for (int q = vec_begin / 4 + tid; q < vec_end / 4; q += blockDim.x) dst4[q] = stage4[q];
}

extern "C" int vs_bg_samples(const void *rays_o, const void *rays_d, const void *t_start,
                             const void *jitter, float ds, float t_far, void *cpos,
                             void *cz, void *dt, void *z, void *max_dt, int n,
                             long long nr_rays, void *stream) {
  if (nr_rays <= 0) return (int)cudaSuccess;
  if (n < 2 || n > kMaxSamples) return (int)cudaErrorInvalidValue;
  const int rows = rows_a_block(n);
  const unsigned int blocks = (unsigned int)((nr_rays + rows - 1) / rows);
  // the rows' points and up to 3 floats ahead of them to a 16-byte boundary
  const size_t smem = (size_t)((rows * n * 3 + 3 + 3) / 4) * sizeof(float4);
  bg_samples_kernel<<<blocks, rows * row_threads(n), smem, (cudaStream_t)stream>>>(
      (const float *)rays_o, (const float *)rays_d, (const float *)t_start,
      (const float *)jitter, ds, t_far, (float *)cpos, (float *)cz,
      (float *)dt, (float *)z, (float *)max_dt, n, nr_rays);
  return (int)cudaGetLastError();
}
