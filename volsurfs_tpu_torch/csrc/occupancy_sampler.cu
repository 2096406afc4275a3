// K7: samples inside the occupied space of an occupancy grid, one warp a
// ray.
//
// Replaces the TPU path volsurfs_tpu/ops/samplers.py
// (rays_t_near_t_far_in_occupancy and compute_samples_fg_in_occupied_regions,
// :105-245), which probed every ray at 512 midpoints as one [R, 512]
// gather, reduced them with argmax, marched 512 more as a second gather,
// summed the occupied arc with associative_scan and placed the samples
// with a batched searchsorted: dense [R, 512] tensors, several passes
// through device memory. Here a warp walks one ray: each lane takes every
// 32nd probe, __ballot_sync finds the first and last occupied one, the
// march's occupied steps are counted with ballots and popc into a prefix
// count in shared memory (2 B a step), and each lane places every 32nd of
// the <= S targets by a binary search of that count. The train step's 512
// rays fill 64 blocks of 8 warps; one thread a ray would fill 2.
//
// Bound: the grid reads. Each of the 2 x 512 points of a ray reads one byte
// of occupancy & roi (the grid is 16.7 MB at 256^3, refreshed once per
// occupancy update, and stays in L2); the rays (40 B in) and the samples
// (5 B a slot out) are small. The arithmetic is a few dozen flops a point.
//
// Rounding, as the plain version in ops/samplers.py: built with
// -fmad=false, every step midpoint, point, voxel coordinate, arc
// (count * step length, one product of an exact count) and target rounds
// as the torch ops do, so z and the mask equal the plain version's bit for
// bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kInvalidZ = 1e10f;

struct Grid {
  const uint8_t *occ;  // occupancy & roi, row-major [res, res, res]
  float ex, ey, ez;
  int res;
};

__device__ __forceinline__ int voxel(float p, float extent, int res, bool &in_bounds) {
  const float normalized = p / extent + 0.5f;
  const int c = (int)floorf(normalized * (float)res);
  in_bounds = in_bounds && c >= 0 && c < res;
  return min(max(c, 0), res - 1);
}

__device__ __forceinline__ bool occupied(const Grid &g, float px, float py, float pz) {
  bool in_bounds = true;
  const int cx = voxel(px, g.ex, g.res, in_bounds);
  const int cy = voxel(py, g.ey, g.res, in_bounds);
  const int cz = voxel(pz, g.ez, g.res, in_bounds);
  return in_bounds && g.occ[((long long)cx * g.res + cy) * g.res + cz] != 0;
}

// Is the midpoint of step k (of length seg from t0) occupied?
__device__ __forceinline__ bool step_occupied(const Grid &g, const float o[3],
                                              const float d[3], float t0, float seg, int k) {
  const float t = t0 + ((float)k + 0.5f) * seg;
  return seg > 0.0f && occupied(g, o[0] + t * d[0], o[1] + t * d[1], o[2] + t * d[2]);
}

}  // namespace

extern "C" __global__ void __launch_bounds__(kWarps * 32)
occupancy_samples_kernel(const float *__restrict__ rays_o, const float *__restrict__ rays_d,
                         const float *__restrict__ t_near, const float *__restrict__ t_far,
                         const float *__restrict__ jitter, const uint8_t *__restrict__ occ,
                         float *__restrict__ z_out, uint8_t *__restrict__ mask_out,
                         float *__restrict__ t0_out, float *__restrict__ t1_out,
                         float *__restrict__ max_dt_out, float ex, float ey, float ez, int res,
                         int nr_march, int nr_probe, int S, float min_dist, int min_nr,
                         long long R) {
  extern __shared__ unsigned short counts_smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long r = (long long)blockIdx.x * kWarps + warp;
  if (r >= R) return;  // the whole warp leaves together
  unsigned short *count = counts_smem + warp * nr_march;
  const Grid g{occ, ex, ey, ez, res};
  const float o[3] = {rays_o[3 * r], rays_o[3 * r + 1], rays_o[3 * r + 2]};
  const float d[3] = {rays_d[3 * r], rays_d[3 * r + 1], rays_d[3 * r + 2]};
  float t0 = t_near[r], t1 = t_far[r];

  // clip to the first and last occupied probe
  if (nr_probe > 0) {
    const float seg0 = (t1 - t0) / (float)nr_probe;
    int first = -1, last = -1;
    for (int base = 0; base < nr_probe; base += 32) {
      const unsigned b = __ballot_sync(kFull, step_occupied(g, o, d, t0, seg0, base + lane));
      if (b != 0u) {
        if (first < 0) first = base + __ffs(b) - 1;
        last = base + 31 - __clz(b);
      }
    }
    if (first >= 0) {
      t1 = t0 + ((float)last + 1.0f) * seg0;
      t0 = t0 + (float)first * seg0;
    } else {
      t1 = t0;
    }
  }

  // march: the inclusive count of occupied steps, step by step
  const float seg = (t1 - t0) / (float)nr_march;
  const unsigned lane_le = lane == 31 ? kFull : (2u << lane) - 1u;
  int running = 0;
  for (int base = 0; base < nr_march; base += 32) {
    const unsigned b = __ballot_sync(kFull, step_occupied(g, o, d, t0, seg, base + lane));
    count[base + lane] = (unsigned short)(running + __popc(b & lane_le));
    running += __popc(b);
  }
  __syncwarp();

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
  for (int i = lane; i < S; i += 32) {
    const float s = (jit + (float)i) * const_dist;
    int lo = 0, hi = nr_march;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if ((float)count[mid] * seg <= s) {
        lo = mid + 1;
      } else {
        hi = mid;
      }
    }
    const int k = min(lo, nr_march - 1);
    const int step_occ = count[k] - (k > 0 ? count[k - 1] : 0);
    const float arc_before = (float)count[k] * seg - (float)step_occ * seg;
    float z = (t0 + (float)k * seg) + (s - arc_before);
    z = fminf(fmaxf(z, t0), t1);
    const bool m = i < nr && nr > 0 && s < total_arc;
    z_out[r * S + i] = m ? z : kInvalidZ;
    mask_out[r * S + i] = m ? 1 : 0;
  }
  if (lane == 0) {
    t0_out[r] = t0;
    t1_out[r] = t1;
    max_dt_out[r] = const_dist;
  }
}

extern "C" int vs_occupancy_samples(const void *rays_o, const void *rays_d, const void *t_near,
                                    const void *t_far, const void *jitter, const void *occ,
                                    void *z, void *mask, void *t0, void *t1, void *max_dt,
                                    float ex, float ey, float ez, int res, int nr_march,
                                    int nr_probe, int S, float min_dist, int min_nr,
                                    long long R, void *stream) {
  if (R > 0) {
    const unsigned blocks = (unsigned)((R + kWarps - 1) / kWarps);
    const size_t smem = (size_t)kWarps * nr_march * sizeof(unsigned short);
    occupancy_samples_kernel<<<blocks, kWarps * 32, smem, (cudaStream_t)stream>>>(
        (const float *)rays_o, (const float *)rays_d, (const float *)t_near,
        (const float *)t_far, (const float *)jitter, (const uint8_t *)occ, (float *)z,
        (uint8_t *)mask, (float *)t0, (float *)t1, (float *)max_dt, ex, ey, ez, res, nr_march,
        nr_probe, S, min_dist, min_nr, R);
  }
  return (int)cudaGetLastError();
}
