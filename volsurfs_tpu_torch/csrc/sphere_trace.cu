// K9: one march step of the sphere tracer, over the rays still marching.
//
// Replaces no TPU kernel: the JAX package marches with XLA ops, the body
// of the lax.while_loop in volsurfs_tpu/ops/sphere_tracing.py:161-263,
// which the port's plain version (ops/sphere_tracing.py::
// sphere_trace_step_reference) runs as ~90 small torch ops a step. A step
// lies between two evaluations of the SDF (the permutohedral lookup K6 and
// the MLP), which give sdf1, the SDF at each active ray's probe point.
//
// Active-ray compaction: JAX steps every ray every step, because XLA needs
// static shapes. Here a step runs over a list of the rays still marching
// (int32 ray indices, M of them), a thread a listed ray, with sdf1 in the
// list's order. For each listed ray the step reads its state (t, the
// bracket t_lo, s_lo, t_hi, s_hi, and the flags refining, hit, converged)
// and its sdf1, and writes the next state in place:
//   - a marching ray whose probe turned negative has bracketed the surface
//     (crossed); one whose first probe is negative starts inside (a hit);
//   - a threshold hit |sdf1| < thresh counts, with a grid, only in an
//     occupied voxel (refining rays excepted);
//   - refining rays replace the bracket end of the probe's sign, and the
//     next probe is the false-position point, frac clipped to [0.05, 0.95];
//   - marching rays step by sdf1, at least min_step where
//     positive, and in an empty voxel at least to its exit, or to the exit
//     of its 4^3 block where the coarse grid marks that empty too;
//   - a ray converges on a hit, a collapsed bracket (< 1e-5) or a marching
//     step that leaves the bounding sphere or box.
// A ray still marching after the step appends itself to the next list,
// with one atomicAdd a warp on the list's count (__ballot_sync, __popc),
// and writes its next probe point o + t d into a compact [M', 3] buffer
// at its slot: the caller evaluates the SDF there, at M' points, not at
// all N. The list's order comes from the atomics and changes from run to
// run; a ray's state does not depend on its slot.
//
// Converged rays are never stepped again. Their t, hit, refining and
// converged equal those of JAX's lockstep march, whose steps of a
// converged ray change none of the four. Their bracket fields (t_lo,
// s_lo, t_hi, s_hi) keep the values they had at convergence, where the
// lockstep march goes on overwriting them; they are not results (JAX's
// sphere_trace discards them, volsurfs_tpu/ops/sphere_tracing.py:265).
//
// Bound: bytes. A listed ray reads its index, sdf1 and its ray (32 bytes),
// 23 bytes of state and at most two grid bytes, and writes 23 of state;
// one still marching writes 16 more (its index and probe point). Its ~150
// operations come to a fraction of that time at the card's issue rate.
// At the trained field's 22,523 active rays of a 256^2 frame that is
// ~2 MB, 0.6 us at 3.35 TB/s: the launch and one ray's chain of dependent
// operations (two grid reads, three divisions) set the time.
//
// Rounding: built with -fmad=false, every operation rounds on its own in
// the plain version's order, but for the bounding sphere's distance, which
// both round as XLA:CPU's jnp.linalg.norm, sqrt(fma(z, z, fma(y, y, x * x)))
// (__fmaf_rn here, utils/math.py::norm3 there); divisions and square roots
// IEEE, float-to-int
// conversions saturating as torch's on the card, and maxima and minima
// propagate NaN as torch.maximum and torch.minimum do; so the kernel
// equals its plain version bit for bit. JAX, run op by op, contracts
// nothing either. The probe point o + t d is the product and the sum of
// torch's ``rays_o + t[:, None] * rays_d``.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

// what a step reads besides the rays, the SDF and the state; a kernel
// argument, so outside the unnamed namespace
struct Space {
  const uint8_t *occupied;  // [res^3] occupancy & roi, or null without a grid
  const uint8_t *coarse;    // [(res / C)^3] its C^3 pooling
  float ext[3];
  int res, C;
  float eps_skip;
  int kind;  // 0 sphere, 1 box
  float center[3], half[3];  // half[0]: the sphere's radius
};

namespace {

constexpr int kThreads = 128;  // listed rays a block: 22,523 fill 176 blocks

__device__ __forceinline__ float max_nan(float a, float b) {
  return (a != a || a > b) ? a : b;
}
__device__ __forceinline__ float min_nan(float a, float b) {
  return (a != a || a < b) ? a : b;
}

// the grid cell of p along axis k at grid_res cells: floor((p / ext + 0.5) * n)
__device__ __forceinline__ float cell_coord(const Space &s, float p, int k, int n) {
  return floorf((p / s.ext[k] + 0.5f) * (float)n);
}

__device__ __forceinline__ bool occupied_at(const Space &s, const float p[3]) {
  int c[3];
  bool in_bounds = true;
  for (int k = 0; k < 3; ++k) {
    int ci = (int)cell_coord(s, p[k], k, s.res);  // saturating, as torch's .to(int32)
    in_bounds = in_bounds && ci >= 0 && ci < s.res;
    c[k] = min(max(ci, 0), s.res - 1);
  }
  long long idx = ((long long)c[0] * s.res + c[1]) * s.res + c[2];
  return in_bounds && s.occupied[idx] != 0;
}

// the distance along d to the exit of p's cell of a grid of n^3 cells
__device__ __forceinline__ float exit_dist(const Space &s, const float p[3], const float d[3],
                                           int n) {
  float best = INFINITY;
  for (int k = 0; k < 3; ++k) {
    float nf = (float)n;
    float cell = s.ext[k] / nf;
    float lower = (cell_coord(s, p[k], k, n) / nf - 0.5f) * s.ext[k];
    float te = d[k] > 0.0f ? (lower + cell - p[k]) / d[k]
                           : (d[k] < 0.0f ? (lower - p[k]) / d[k] : INFINITY);
    best = k == 0 ? te : min_nan(best, te);
  }
  return best;
}

__device__ __forceinline__ float empty_space_skip(const Space &s, const float p[3],
                                                  const float d[3]) {
  float fine = exit_dist(s, p, d, s.res);
  if (s.C == 1) return fine + s.eps_skip;
  int res_c = s.res / s.C;
  int c[3];
  for (int k = 0; k < 3; ++k) c[k] = min(max((int)cell_coord(s, p[k], k, res_c), 0), res_c - 1);
  bool block_occ = s.coarse[((long long)c[0] * res_c + c[1]) * res_c + c[2]] != 0;
  float skip = block_occ ? fine : exit_dist(s, p, d, res_c);
  return skip + s.eps_skip;
}

__device__ __forceinline__ bool contains(const Space &s, const float p[3]) {
  if (s.kind == 0) {
    float x = p[0] - s.center[0], y = p[1] - s.center[1], z = p[2] - s.center[2];
    return sqrtf(__fmaf_rn(z, z, __fmaf_rn(y, y, x * x))) <= s.half[0];
  }
  bool in = true;
  for (int k = 0; k < 3; ++k) in = in && fabsf(p[k] - s.center[k]) <= s.half[k];
  return in;
}

}  // namespace

extern "C" __global__ void __launch_bounds__(kThreads)
sphere_trace_step_kernel(const float *__restrict__ rays_o, const float *__restrict__ rays_d,
                         const int *__restrict__ active, const float *__restrict__ sdf1,
                         float *__restrict__ T, float *__restrict__ T_lo,
                         float *__restrict__ S_lo, float *__restrict__ T_hi,
                         float *__restrict__ S_hi, bool *__restrict__ Refining,
                         bool *__restrict__ Hit, bool *__restrict__ Converged,
                         int *__restrict__ next_active, float *__restrict__ next_points,
                         int *__restrict__ count, Space s, float thresh, float min_step,
                         long long n_active) {
  const long long j = (long long)blockIdx.x * kThreads + threadIdx.x;
  const int lane = threadIdx.x % 32;
  bool keep = false;  // still marching after the step
  long long r = 0;
  float p_next[3];
  if (j < n_active) {
    r = active[j];
    float o[3], d[3], pos[3];
    float t = T[r], t_lo = T_lo[r], s_lo = S_lo[r], t_hi = T_hi[r], s_hi = S_hi[r];
    bool refining = Refining[r], hit = Hit[r], converged = Converged[r];
    float sdf = sdf1[j];
    for (int k = 0; k < 3; ++k) {
      o[k] = rays_o[r * 3 + k];
      d[k] = rays_d[r * 3 + k];
      pos[k] = o[k] + t * d[k];
    }
    const bool grid = s.occupied != nullptr;

    bool crossed = sdf < 0.0f && s_lo > 0.0f && s_lo < 1e9f && !refining && !converged;
    bool start_inside = sdf < 0.0f && s_lo > 1e9f && !refining && !converged;
    bool thresh_hit = (fabsf(sdf) < thresh || start_inside) && !converged;
    bool in_occ = false;
    if (grid) {
      in_occ = occupied_at(s, pos);
      thresh_hit = thresh_hit && (in_occ || refining);
    }

    bool neg = sdf < 0.0f;
    float b_t_lo = (refining && !neg) ? t : t_lo;
    float b_s_lo = (refining && !neg) ? sdf : s_lo;
    float b_t_hi = (refining && neg) ? t : t_hi;
    float b_s_hi = (refining && neg) ? sdf : s_hi;
    if (crossed) {
      b_t_hi = t;
      b_s_hi = sdf;
    }
    bool now_refining = refining || crossed;

    float denom = max_nan(b_s_lo - b_s_hi, 1e-12f);
    float frac = min_nan(max_nan(b_s_lo / denom, 0.05f), 0.95f);
    float t_secant = b_t_lo + frac * (b_t_hi - b_t_lo);
    bool bracket_done = (b_t_hi - b_t_lo) < 1e-5f;

    float step = sdf;
    if (min_step > 0.0f && step > 0.0f) step = max_nan(step, min_step);
    if (grid && !in_occ) step = max_nan(step, empty_space_skip(s, pos, d));
    float t_march = t + step;

    bool newly_hit = (thresh_hit || (now_refining && bracket_done)) && !converged;
    float next_t_lo = now_refining ? b_t_lo : t;
    float next_s_lo = now_refining ? b_s_lo : sdf;
    float t_next = now_refining ? t_secant : t_march;
    for (int k = 0; k < 3; ++k) p_next[k] = o[k] + t_next * d[k];
    bool newly_conv = newly_hit || (!contains(s, p_next) && !now_refining);

    T[r] = (converged || newly_conv) ? t : t_next;
    T_lo[r] = next_t_lo;
    S_lo[r] = next_s_lo;
    T_hi[r] = b_t_hi;
    S_hi[r] = b_s_hi;
    converged = converged || newly_conv;
    Hit[r] = hit || newly_hit;
    Converged[r] = converged;
    Refining[r] = now_refining && !converged;
    keep = !converged;  // then t is t_next and p_next its probe point
  }

  // append the rays still marching: one atomic a warp, slots in lane order
  const unsigned ballot = __ballot_sync(0xffffffffu, keep);
  if (ballot == 0u) return;
  const int leader = __ffs(ballot) - 1;
  int first = 0;
  if (lane == leader) first = atomicAdd(count, __popc(ballot));
  first = __shfl_sync(0xffffffffu, first, leader);
  const long long slot = first + __popc(ballot & ((1u << lane) - 1u));
  // the count starts at 0, so a slot lies below n_active; the test keeps a
  // count that did not start at 0 from writing past the buffers
  if (keep && slot < n_active) {
    next_active[slot] = (int)r;
    for (int k = 0; k < 3; ++k) next_points[slot * 3 + k] = p_next[k];
  }
}

extern "C" int vs_sphere_trace_step(
    const void *rays_o, const void *rays_d, const void *active, const void *sdf1, void *t,
    void *t_lo, void *s_lo, void *t_hi, void *s_hi, void *refining, void *hit,
    void *converged, void *next_active, void *next_points, void *count,
    const void *occupied, const void *coarse, float ex, float ey, float ez, int res,
    int coarse_factor, float eps_skip, int kind, float cx, float cy, float cz, float hx,
    float hy, float hz, float thresh, float min_step, long long n_active, void *stream) {
  if (n_active <= 0) return (int)cudaSuccess;
  Space s;
  s.occupied = (const uint8_t *)occupied;
  s.coarse = (const uint8_t *)coarse;
  s.ext[0] = ex;
  s.ext[1] = ey;
  s.ext[2] = ez;
  s.res = res;
  s.C = coarse_factor;
  s.eps_skip = eps_skip;
  s.kind = kind;
  s.center[0] = cx;
  s.center[1] = cy;
  s.center[2] = cz;
  s.half[0] = hx;
  s.half[1] = hy;
  s.half[2] = hz;
  unsigned int blocks = (unsigned int)((n_active + kThreads - 1) / kThreads);
  sphere_trace_step_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const float *)rays_o, (const float *)rays_d, (const int *)active, (const float *)sdf1,
      (float *)t, (float *)t_lo, (float *)s_lo, (float *)t_hi, (float *)s_hi,
      (bool *)refining, (bool *)hit, (bool *)converged, (int *)next_active,
      (float *)next_points, (int *)count, s, thresh, min_step, n_active);
  return (int)cudaGetLastError();
}
