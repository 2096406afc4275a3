// K7: samples inside the occupied space of an occupancy grid, four warps a
// ray where the rays are few and a warp a ray where they are many.
//
// Replaces the TPU path volsurfs_tpu/ops/samplers.py
// (rays_t_near_t_far_in_occupancy and compute_samples_fg_in_occupied_regions,
// :105-245), which probed every ray at 512 midpoints as one [R, 512]
// gather, reduced them with argmax, marched 512 more as a second gather,
// summed the occupied arc with associative_scan and placed the samples
// with a batched searchsorted: dense [R, 512] tensors, several passes
// through device memory.
//
// Here a group of W warps walks one ray (a block of four warps holds 4 / W
// rays). Thread t of the group takes steps t, t + 32 W, ... of a pass
// (probe, then march), so that each warp holds runs of 32 neighbouring
// steps. A thread first computes the voxels of 512 / (32 W) of its steps
// and issues their byte loads together, then the warps ballot on them: a
// pass of 512 steps is one round trip to the grid, not 16 in a row as a
// warp took before. The probe's first and last occupied step are reduced
// over the group; the march's occupied steps are counted in each run of 32
// by popc, the runs' counts summed by one warp's scan, and the inclusive
// count of step k is its run's prefix plus its place in the run (2 B a
// step of shared memory). The <= S targets are then placed a thread each
// by a binary search of those counts. A ray whose interval is empty (a
// step of length 0) reads no voxel.
//
// Each point computes its midpoint, its voxel (three quotients p / extent,
// floors, conversions, clamps), its grid index and one byte load, for one
// byte read from the 16.7 MB grid (256^3, refreshed once per occupancy
// update; it stays in L2): the instructions bound the kernel, not the
// bytes. A correctly rounded division (div.rn.f32) is a dozen instructions
// and a branch to a slow path in SASS. Where an extent is a power of two
// (the port's grids span 2 * radius, 2.0 on its scenes) the quotient
// p / extent is exactly p times its reciprocal, so those grids' kernels
// multiply. The kernels (times on an H100 80GB HBM3 at 700 W, kernel_bench
// k7, PERF.md):
// - power-of-two extents, fewer than kWarpRays rays: W = 4. The train
//   step's 512 rays fill 512 blocks on the 132 SMs, where a warp a ray
//   fills 128: 0.0056 ms against 0.0081;
// - power-of-two extents, from kWarpRays rays on: W = 1, four neighbouring
//   rays a block sharing their voxels in the SM's L1: at 2,048, 4,096 and
//   16,384 rays 0.0118, 0.0189 and 0.0633 ms against W = 4's 0.0127,
//   0.0221 and 0.0785;
// - any other extent: one kernel that divides, W = 4 (at 512 rays 0.0060
//   ms against W = 1's 0.0115; at 16,384 rays 0.0967 against 0.0900).
//
// Rounding, as the plain version in ops/samplers.py: built with
// -fmad=false, every step midpoint, point, voxel coordinate, arc
// (count * step length, one product of an exact count) and target rounds
// as the torch ops do, so z and the mask equal the plain version's bit for
// bit.

#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>

namespace {

constexpr int kWarps = 4;                  // warps a block
constexpr int kThreads = 32 * kWarps;
constexpr int kSteps = 512;                // steps a round of a pass covers
constexpr int kMaxRuns = 2048 / 32;        // runs of 32 steps of the longest march
constexpr long long kWarpRays = 2048;      // from this many rays on, a warp a ray
constexpr unsigned kFull = 0xffffffffu;
constexpr float kInvalidZ = 1e10f;

struct Grid {
  const uint8_t *occ;  // occupancy & roi, row-major [res, res, res]
  float ex, ey, ez;
  float rx, ry, rz;  // 1 / extent, exact where kExact
  int res;
};

// p / extent: the product with the reciprocal where both are powers of two
// (then it is the same number), else the division
template <bool kExact>
__device__ __forceinline__ int voxel(float p, float extent, float recip, int res,
                                     bool &in_bounds) {
  const float normalized = (kExact ? p * recip : p / extent) + 0.5f;
  const int c = (int)floorf(normalized * (float)res);
  in_bounds = in_bounds && c >= 0 && c < res;
  return min(max(c, 0), res - 1);
}

// The grid cell of the midpoint of step k (of length seg > 0 from t0), or -1
// where the point lies outside the grid
template <bool kExact>
__device__ __forceinline__ long long step_cell(const Grid &g, const float o[3],
                                               const float d[3], float t0, float seg, int k) {
  const float t = t0 + ((float)k + 0.5f) * seg;
  bool in_bounds = true;
  const int cx = voxel<kExact>(o[0] + t * d[0], g.ex, g.rx, g.res, in_bounds);
  const int cy = voxel<kExact>(o[1] + t * d[1], g.ey, g.ry, g.res, in_bounds);
  const int cz = voxel<kExact>(o[2] + t * d[2], g.ez, g.rz, g.res, in_bounds);
  return in_bounds ? ((long long)cx * g.res + cy) * g.res + cz : -1;
}

// One pass of nr steps of length seg from t0 by a group of W warps (tid
// the thread's place in it): for each run of 32 steps the ballot of its
// occupied steps goes to visit(run, ballot), in the warp that holds it (all
// lanes alike). A thread's kSteps / (32 W) loads of a round are in flight
// together before the first ballot.
template <int W, bool kExact, typename Visit>
__device__ __forceinline__ void pass(const Grid &g, const float o[3], const float d[3],
                                     float t0, float seg, int nr, int tid, Visit visit) {
  constexpr int kPer = kSteps / (32 * W);
  const bool any = seg > 0.0f;
  for (int base = 0; base < nr; base += kSteps) {
    uint8_t occ[kPer];
#pragma unroll
    for (int c = 0; c < kPer; ++c) {
      const int k = base + 32 * W * c + tid;
      const long long cell = any && k < nr ? step_cell<kExact>(g, o, d, t0, seg, k) : -1;
      occ[c] = cell >= 0 ? g.occ[cell] : 0;
    }
#pragma unroll
    for (int c = 0; c < kPer; ++c) {
      const int k = base + 32 * W * c + tid;
      if (k - (tid & 31) < nr) visit(k >> 5, __ballot_sync(kFull, occ[c] != 0));
    }
  }
}

// the group's barrier: a warp's own, or the block's (a ray a block)
template <int W>
__device__ __forceinline__ void group_sync() {
  if (W == 1) {
    __syncwarp();
  } else {
    __syncthreads();
  }
}

// One ray by a group of W warps: tid, lane and warp the thread's place in
// the group; in_run [nr_march], run_count [kMaxRuns] and first_occ,
// last_occ [W] the group's shared memory
template <int W, bool kExact>
__device__ __forceinline__ void occupancy_samples_ray(
    long long r, const float *__restrict__ rays_o, const float *__restrict__ rays_d,
    const float *__restrict__ t_near, const float *__restrict__ t_far,
    const float *__restrict__ jitter, const Grid &g, float *__restrict__ z_out,
    uint8_t *__restrict__ mask_out, float *__restrict__ t0_out, float *__restrict__ t1_out,
    float *__restrict__ max_dt_out, int nr_march, int nr_probe, int S, float min_dist,
    int min_nr, int tid, unsigned short *in_run, int *run_count, int *first_occ,
    int *last_occ) {
  // in_run: the occupied steps up to k in k's run of 32; run_count: each
  // run's, then the runs' exclusive prefix; first_occ, last_occ: each warp's
  // first and last occupied probe
  const int lane = tid & 31, warp = tid >> 5;
  const float o[3] = {rays_o[3 * r], rays_o[3 * r + 1], rays_o[3 * r + 2]};
  const float d[3] = {rays_d[3 * r], rays_d[3 * r + 1], rays_d[3 * r + 2]};
  float t0 = t_near[r], t1 = t_far[r];

  // clip to the first and last occupied probe
  if (nr_probe > 0) {
    const float seg0 = (t1 - t0) / (float)nr_probe;
    int first = nr_probe, last = -1;
    pass<W, kExact>(g, o, d, t0, seg0, nr_probe, tid, [&](int run, unsigned b) {
      if (b != 0u) {
        first = min(first, 32 * run + __ffs(b) - 1);
        last = max(last, 32 * run + 31 - __clz(b));
      }
    });
    if (W > 1) {
      if (lane == 0) {
        first_occ[warp] = first;
        last_occ[warp] = last;
      }
      group_sync<W>();
#pragma unroll
      for (int w = 0; w < W; ++w) {
        first = min(first, first_occ[w]);
        last = max(last, last_occ[w]);
      }
    }
    if (last >= 0) {
      t1 = t0 + ((float)last + 1.0f) * seg0;
      t0 = t0 + (float)first * seg0;
    } else {
      t1 = t0;
    }
  }

  // march: each run's occupied steps, then the runs' prefix
  const float seg = (t1 - t0) / (float)nr_march;
  const unsigned lane_le = lane == 31 ? kFull : (2u << lane) - 1u;
  pass<W, kExact>(g, o, d, t0, seg, nr_march, tid, [&](int run, unsigned b) {
    in_run[32 * run + lane] = (unsigned short)__popc(b & lane_le);
    if (lane == 0) run_count[run] = __popc(b);
  });
  group_sync<W>();
  const int runs = nr_march >> 5;
  if (warp == 0) {
    // the runs' exclusive prefix: runs 0-31 a lane each, then runs 32-63
    const int a = lane < runs ? run_count[lane] : 0;
    const int b = lane + 32 < runs ? run_count[lane + 32] : 0;
    int pa = a, pb = b;
#pragma unroll
    for (int s = 1; s < 32; s <<= 1) {
      const int ya = __shfl_up_sync(kFull, pa, s);
      const int yb = __shfl_up_sync(kFull, pb, s);
      if (lane >= s) {
        pa += ya;
        pb += yb;
      }
    }
    const int a_total = __shfl_sync(kFull, pa, 31);
    __syncwarp();
    if (lane < runs) run_count[lane] = pa - a;
    if (lane + 32 < runs) run_count[lane + 32] = a_total + pb - b;
  }
  group_sync<W>();
  // the inclusive count of occupied steps up to step k
  auto count = [&](int k) { return run_count[k >> 5] + in_run[k]; };
  const int running = count(nr_march - 1);

  // the samples' count and spacing (_plan_sample_counts)
  const float total_arc = (float)running * seg;
  int nr_big = (int)(total_arc / min_dist);
  nr_big = min(max(nr_big, 0), S);
  int nr = total_arc <= 0.0f ? 0 : (total_arc > min_dist ? nr_big : 1);
  const float const_dist = nr > 0 ? total_arc / (float)max(nr, 1) : 0.0f;
  if (nr < min_nr) nr = 0;

  // each target (jitter + i) * const_dist at the first step whose arc at its
  // end exceeds it (searchsorted, side right)
  const float jit = jitter[r];
  for (int i = tid; i < S; i += 32 * W) {
    const float s = (jit + (float)i) * const_dist;
    int lo = 0, hi = nr_march;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if ((float)count(mid) * seg <= s) {
        lo = mid + 1;
      } else {
        hi = mid;
      }
    }
    const int k = min(lo, nr_march - 1);
    const int step_occ = count(k) - (k > 0 ? count(k - 1) : 0);
    const float arc_before = (float)count(k) * seg - (float)step_occ * seg;
    float z = (t0 + (float)k * seg) + (s - arc_before);
    z = fminf(fmaxf(z, t0), t1);
    const bool m = i < nr && nr > 0 && s < total_arc;
    z_out[r * S + i] = m ? z : kInvalidZ;
    mask_out[r * S + i] = m ? 1 : 0;
  }
  if (tid == 0) {
    t0_out[r] = t0;
    t1_out[r] = t1;
    max_dt_out[r] = const_dist;
  }
}

}  // namespace

// W warps a ray; kExact: every extent a power of two (the quotients
// multiply). A block holds 4 / W rays, and a warp a ray may leave alone
// (the barriers are the warp's own).
#define OCCUPANCY_SAMPLES_KERNEL(name, W, exact)                                                 \
  extern "C" __global__ void __launch_bounds__(kThreads) name(                                 \
      const float *__restrict__ rays_o, const float *__restrict__ rays_d,                      \
      const float *__restrict__ t_near, const float *__restrict__ t_far,                       \
      const float *__restrict__ jitter, const uint8_t *__restrict__ occ,                       \
      float *__restrict__ z_out, uint8_t *__restrict__ mask_out, float *__restrict__ t0_out,   \
      float *__restrict__ t1_out, float *__restrict__ max_dt_out, float ex, float ey,          \
      float ez, int res, int nr_march, int nr_probe, int S, float min_dist, int min_nr,        \
      long long R) {                                                                           \
    extern __shared__ unsigned short in_run[];                                                 \
    __shared__ int run_count[kWarps / W][kMaxRuns], first_occ[kWarps], last_occ[kWarps];       \
    const int group = threadIdx.x / (32 * W);                                                  \
    const long long r = (long long)blockIdx.x * (kWarps / W) + group;                          \
    if (r >= R) return;                                                                        \
    const Grid g{occ, ex, ey, ez, 1.0f / ex, 1.0f / ey, 1.0f / ez, res};                       \
    occupancy_samples_ray<W, exact>(                                                           \
        r, rays_o, rays_d, t_near, t_far, jitter, g, z_out, mask_out, t0_out, t1_out,          \
        max_dt_out, nr_march, nr_probe, S, min_dist, min_nr, threadIdx.x % (32 * W),           \
        in_run + group * nr_march, run_count[group], first_occ + group * W,                    \
        last_occ + group * W);                                                                 \
  }

OCCUPANCY_SAMPLES_KERNEL(occupancy_samples_kernel, 4, false)
OCCUPANCY_SAMPLES_KERNEL(occupancy_samples_pow2_kernel, 4, true)
OCCUPANCY_SAMPLES_KERNEL(occupancy_samples_warp_pow2_kernel, 1, true)

// whether 1 / x is exact: x a power of two whose reciprocal is a normal
// float too
static bool exact_reciprocal(float x) {
  int e = 0;
  return x > 0.0f && std::frexp(x, &e) == 0.5f && e - 1 >= -126 && e - 1 <= 126;
}

extern "C" int vs_occupancy_samples(const void *rays_o, const void *rays_d, const void *t_near,
                                    const void *t_far, const void *jitter, const void *occ,
                                    void *z, void *mask, void *t0, void *t1, void *max_dt,
                                    float ex, float ey, float ez, int res, int nr_march,
                                    int nr_probe, int S, float min_dist, int min_nr,
                                    long long R, void *stream) {
  if (R > 0) {
    const bool exact = exact_reciprocal(ex) && exact_reciprocal(ey) && exact_reciprocal(ez);
    const bool warp_a_ray = exact && R >= kWarpRays;
    const int rays_a_block = warp_a_ray ? kWarps : 1;
    const auto kernel = !exact ? occupancy_samples_kernel
                        : warp_a_ray ? occupancy_samples_warp_pow2_kernel
                                     : occupancy_samples_pow2_kernel;
    const size_t smem = (size_t)rays_a_block * nr_march * sizeof(unsigned short);
    const unsigned blocks = (unsigned)((R + rays_a_block - 1) / rays_a_block);
    kernel<<<blocks, kThreads, smem, (cudaStream_t)stream>>>(
        (const float *)rays_o, (const float *)rays_d, (const float *)t_near,
        (const float *)t_far, (const float *)jitter, (const uint8_t *)occ, (float *)z,
        (uint8_t *)mask, (float *)t0, (float *)t1, (float *)max_dt, ex, ey, ez, res, nr_march,
        nr_probe, S, min_dist, min_nr, R);
  }
  return (int)cudaGetLastError();
}
