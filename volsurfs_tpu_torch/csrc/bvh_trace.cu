// K2: closest-hit trace of every (mesh, ray) pair over k stacked BVHs.
//
// Replaces volsurfs_tpu/ops/bvh.py::trace_all (:490-543) with
// _traversal_step, _ray_box and _moller_trumbore (:265-335), which the JAX
// package runs as one lockstep while_loop of row gathers over all k*R
// cursors. Here each (mesh, ray) pair is one thread with its own stackless
// cursor over the packed node rows (_pack_nodes layout, ops/bvh.py:52-96):
//   [0] leaf tag, [1] skip pointer (int bits), [2:5] box lo, [5:8] box hi,
//   [8 : 8+9L] L leaf triangles as (v0, e1, e2), [8+9L : 8+10L] face ids.
// An inner node whose box the ray hits descends to node+1, else jumps to
// its skip pointer. A leaf tests its triangles (its own box is not tested,
// as in JAX) and jumps to its skip pointer.
//
// Bound: operations. Each inner node visited is one slab box test (~24
// flops) and each real triangle of a visited leaf one Moller-Trumbore
// test (~50 flops); the node table (about 10 MB for five shells of ~16k
// faces) is read from memory once and then shared by the rays through L2,
// so its bytes are the smaller term. Threads of a warp diverge where their
// rays take different paths; this first version leaves that as it is.
//
// The hit rule is that of the JAX code, bit for bit where the arithmetic
// allows: |det| > 1e-9, t > 1e-6 (t_min is ignored, as in JAX), face id
// >= 0, t < t_best within a leaf and across nodes, the first minimum of a
// leaf wins, the box test is t_far >= t_near && t_far > 0 && t_near <
// t_best, and 1/d is taken of d clamped to 1e-12 where |d| < 1e-12.
// Rounding: the triangle test of small triangles is ill-conditioned (u and
// v are differences of products over a det of ~1e-4), so the order of
// rounding shows in the 5th digit. The kernel spells out its fmas in the
// pattern in which XLA:CPU contracts the JAX expression (a*b - c*d as
// fma(a, b, -(c*d)); a dot product as fma(a2, b2, fma(a1, b1, a0*b0))),
// and the library is compiled with -fmad=false so that nvcc contracts
// nothing else. The plain version computes the same fmas in float64.
//
// Guard: a cursor moves strictly forward, so it takes at most
// node_end - node_begin steps. A cursor still running after one step more
// (a skip pointer that does not move forward) stops and is added to
// *overflow, a count that the wrapper keeps over its traces and checks.

#include <cuda_runtime.h>
#include <math.h>

namespace {

__global__ void bvh_trace_kernel(const float *__restrict__ packed, int width,
                                 int leaf_size,
                                 const int *__restrict__ node_begin,
                                 const int *__restrict__ node_end, int k,
                                 const float *__restrict__ rays_o,
                                 const float *__restrict__ rays_d, int nr_rays,
                                 float *__restrict__ t_out,
                                 int *__restrict__ tri_out,
                                 float *__restrict__ u_out,
                                 float *__restrict__ v_out,
                                 int *__restrict__ overflow) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)k * nr_rays) return;
  int m = (int)(i / nr_rays);
  int r = (int)(i - (long long)m * nr_rays);

  float o[3], d[3], inv_d[3];
  for (int a = 0; a < 3; ++a) {
    o[a] = rays_o[3 * r + a];
    d[a] = rays_d[3 * r + a];
    float dc = fabsf(d[a]) < 1e-12f ? 1e-12f : d[a];
    inv_d[a] = 1.0f / dc;
  }

  int node = node_begin[m];
  const int end = node_end[m];
  const int cap = end - node + 1;
  float t_best = INFINITY;
  int tri_best = -1;
  float u_best = 0.0f, v_best = 0.0f;

  int steps = 0;
  while (node < end) {
    if (steps >= cap) {
      atomicAdd(overflow, 1);
      break;
    }
    ++steps;
    const float *row = packed + (long long)node * width;
    const bool is_leaf = row[0] > 0.5f;
    const int skip = __float_as_int(row[1]);
    if (is_leaf) {
      float t_leaf = INFINITY;
      int tid_win = -1;
      float u_win = 0.0f, v_win = 0.0f;
      for (int j = 0; j < leaf_size; ++j) {
        const float *tri = row + 8 + 9 * j;
        const int tid = __float_as_int(row[8 + 9 * leaf_size + j]);
        const float v0x = tri[0], v0y = tri[1], v0z = tri[2];
        const float e1x = tri[3], e1y = tri[4], e1z = tri[5];
        const float e2x = tri[6], e2y = tri[7], e2z = tri[8];
        // pvec = cross(d, e2); each difference of products and each dot
        // product contracts into fmas as XLA:CPU contracts the JAX code
        const float px = fmaf(d[1], e2z, -(d[2] * e2y));
        const float py = fmaf(d[2], e2x, -(d[0] * e2z));
        const float pz = fmaf(d[0], e2y, -(d[1] * e2x));
        const float det = fmaf(e1z, pz, fmaf(e1y, py, e1x * px));
        const bool det_ok = fabsf(det) > 1e-9f;
        const float inv_det = det_ok ? 1.0f / det : 0.0f;
        const float tx = o[0] - v0x, ty = o[1] - v0y, tz = o[2] - v0z;
        const float u = fmaf(tz, pz, fmaf(ty, py, tx * px)) * inv_det;
        // qvec = cross(tvec, e1)
        const float qx = fmaf(ty, e1z, -(tz * e1y));
        const float qy = fmaf(tz, e1x, -(tx * e1z));
        const float qz = fmaf(tx, e1y, -(ty * e1x));
        const float v = fmaf(d[2], qz, fmaf(d[1], qy, d[0] * qx)) * inv_det;
        const float t = fmaf(e2z, qz, fmaf(e2y, qy, e2x * qx)) * inv_det;
        const bool hit = det_ok && u >= 0.0f && v >= 0.0f &&
                         u + v <= 1.0f && t > 1e-6f && tid >= 0 &&
                         t < t_best;
        if (hit && t < t_leaf) {
          t_leaf = t;
          tid_win = tid;
          u_win = u;
          v_win = v;
        }
      }
      if (t_leaf < t_best) {
        t_best = t_leaf;
        tri_best = tid_win;
        u_best = u_win;
        v_best = v_win;
      }
      node = skip;
    } else {
      float t_near = -INFINITY, t_far = INFINITY;
      for (int a = 0; a < 3; ++a) {
        const float t0 = (row[2 + a] - o[a]) * inv_d[a];
        const float t1 = (row[5 + a] - o[a]) * inv_d[a];
        t_near = fmaxf(t_near, fminf(t0, t1));
        t_far = fminf(t_far, fmaxf(t0, t1));
      }
      const bool box_hit = t_far >= t_near && t_far > 0.0f && t_near < t_best;
      node = box_hit ? node + 1 : skip;
    }
  }

  t_out[i] = t_best;
  tri_out[i] = tri_best;
  u_out[i] = u_best;
  v_out[i] = v_best;
}

}  // namespace

extern "C" int vs_bvh_trace(const void *packed, int width, int leaf_size,
                            const void *node_begin, const void *node_end,
                            int k, const void *rays_o, const void *rays_d,
                            int nr_rays, void *t_out, void *tri_out,
                            void *u_out, void *v_out, void *overflow,
                            void *stream) {
  long long n = (long long)k * nr_rays;
  if (n > 0) {
    const int threads = 128;
    long long blocks = (n + threads - 1) / threads;
    bvh_trace_kernel<<<(unsigned int)blocks, threads, 0,
                       (cudaStream_t)stream>>>(
        (const float *)packed, width, leaf_size, (const int *)node_begin,
        (const int *)node_end, k, (const float *)rays_o, (const float *)rays_d,
        nr_rays, (float *)t_out, (int *)tri_out, (float *)u_out,
        (float *)v_out, (int *)overflow);
  }
  return (int)cudaGetLastError();
}
