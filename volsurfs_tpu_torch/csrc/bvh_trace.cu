// K2: closest-hit trace of every (mesh, ray) pair over k stacked BVHs.
//
// Replaces volsurfs_tpu/ops/bvh.py::trace_all (:490-543) with
// _traversal_step, _ray_box and _moller_trumbore (:265-335), which the JAX
// package runs as one lockstep while_loop of row gathers over all k*R
// cursors. Here each (mesh, ray) pair is one thread with its own stackless
// cursor over the node table. An inner node whose box the ray hits descends
// to node+1, else jumps to its skip pointer. A leaf tests its triangles (its
// own box is not tested, as in JAX) and jumps to its skip pointer.
//
// Layout (ops/bvh.py::_compact_layout), read through the read-only path in
// 16-byte loads:
//   nodes [N, 8]: inner [lo.xyz, skip | hi.xyz, 0], leaf [first, count, 0,
//                 skip | 0, 0, 0, 1]: 32 B a node, two loads;
//   tris [T, 12]: [v0.xyz, id | e1.xyz, 0 | e2.xyz, 0], the real triangles
//                 of each leaf in slot order: 48 B a triangle, three loads.
//
// Bound: operations. Each inner node visited is one slab box test (~24
// flops) and each real triangle of a visited leaf one Moller-Trumbore test
// (~50 flops); the nodes and triangles that the rays visit (at most the
// 5.5 MB of tables for five shells of ~16k faces) are read from memory once
// and then shared by the rays through the 50 MB L2.
// What kept the first version far from that bound was instruction issue
// and latency: 48-float rows read one float at a time, four triangle tests
// a leaf with the -1 pads among them, and the lanes of a warp running the
// leaf branch and the inner branch interleaved in one loop. This version
// reads 16-byte vectors, tests only real triangles, and loops while-while
// (Aila and Laine, HPG 2009): an inner loop runs box tests until the lane
// reaches a leaf or leaves its mesh's rows, then the lanes that hold a leaf
// test it together. A leaf's triangle loads are all issued before its
// first test, so a leaf waits on memory once, not once a triangle.
// What bounds it now is the latency of each lane's chain of dependent node
// loads, about one L2 round trip a visit (chip_smoke.py reports the node
// visits of all cursors and of the longest): more resident warps,
// persistent warps, a larger L1 and L1 eviction hints did not make it
// faster on the card (PERF.md, section 6).
// Each lane still visits its nodes, and tests its triangles, in the order
// of the plain version, so the first minimum that wins at an exact tie is
// the same; nothing is speculative or reordered.
//
// The hit rule is that of the JAX code, bit for bit where the arithmetic
// allows: |det| > 1e-9, t > 1e-6 (t_min is ignored, as in JAX), t < t_best
// within a leaf and across nodes, the first minimum of a leaf wins, the box
// test is t_far >= t_near && t_far > 0 && t_near < t_best, and 1/d is taken
// of d clamped to 1e-12 where |d| < 1e-12.
// Rounding: the triangle test of small triangles is ill-conditioned (u and
// v are differences of products over a det of ~1e-4), so the order of
// rounding shows in the 5th digit. The kernel spells out its fmas in the
// pattern in which XLA:CPU contracts the JAX expression (a*b - c*d as
// fma(a, b, -(c*d)); a dot product as fma(a2, b2, fma(a1, b1, a0*b0))),
// and the library is compiled with -fmad=false so that nvcc contracts
// nothing else. The plain version computes the same fmas in float64.
//
// Guard: a cursor moves strictly forward, so it takes at most
// node_end - node_begin steps (node visits, in either loop). A cursor still
// running after one step more (a skip pointer that does not move forward)
// stops and is added to *overflow, a count that the wrapper keeps over its
// traces and checks.
//
// Block size: up to 128 threads, fewer where the trace is small, so that a
// train step's 5 x 512 cursors spread over 80 SMs rather than 20 (sms is
// the stream's device's SM count, which the wrapper passes in).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kMaxThreads = 128;
constexpr int kLeafMax = 4;  // triangles a leaf (ops/bvh.py LEAF_TRIS)

}  // namespace

// C names, so that ptxas -v reports each kernel under its own name
extern "C" __global__ void __launch_bounds__(kMaxThreads)
bvh_trace_kernel(const float4 *__restrict__ nodes,
                 const float4 *__restrict__ tris,
                 const int *__restrict__ node_begin,
                 const int *__restrict__ node_end, int k,
                 const float *__restrict__ rays_o,
                 const float *__restrict__ rays_d, int nr_rays,
                 float *__restrict__ t_out, int *__restrict__ tri_out,
                 float *__restrict__ u_out, float *__restrict__ v_out,
                 int *__restrict__ overflow) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)k * nr_rays) return;
  int m = (int)(i / nr_rays);
  int r = (int)(i - (long long)m * nr_rays);

  const float ox = rays_o[3 * r], oy = rays_o[3 * r + 1], oz = rays_o[3 * r + 2];
  const float dx = rays_d[3 * r], dy = rays_d[3 * r + 1], dz = rays_d[3 * r + 2];
  const float ix = 1.0f / (fabsf(dx) < 1e-12f ? 1e-12f : dx);
  const float iy = 1.0f / (fabsf(dy) < 1e-12f ? 1e-12f : dy);
  const float iz = 1.0f / (fabsf(dz) < 1e-12f ? 1e-12f : dz);

  int node = node_begin[m];
  const int end = node_end[m];
  const int cap = end - node + 1;
  int steps = 0;
  float t_best = INFINITY;
  int tri_best = -1;
  float u_best = 0.0f, v_best = 0.0f;

  while (node < end) {
    // inner loop: box tests until this lane holds a leaf or has left its rows
    int first = 0, count = -1, skip = end;
    while (node < end) {
      if (steps >= cap) {
        atomicAdd(overflow, 1);
        node = end;
        break;
      }
      ++steps;
      const float4 a = __ldg(nodes + 2 * node);
      const float4 b = __ldg(nodes + 2 * node + 1);
      skip = __float_as_int(a.w);
      if (b.w > 0.5f) {
        first = __float_as_int(a.x);
        count = __float_as_int(a.y);
        break;
      }
      const float tx0 = (a.x - ox) * ix, tx1 = (b.x - ox) * ix;
      const float ty0 = (a.y - oy) * iy, ty1 = (b.y - oy) * iy;
      const float tz0 = (a.z - oz) * iz, tz1 = (b.z - oz) * iz;
      const float t_near =
          fmaxf(fmaxf(fmaxf(-INFINITY, fminf(tx0, tx1)), fminf(ty0, ty1)),
                fminf(tz0, tz1));
      const float t_far =
          fminf(fminf(fminf(INFINITY, fmaxf(tx0, tx1)), fmaxf(ty0, ty1)),
                fmaxf(tz0, tz1));
      const bool box_hit = t_far >= t_near && t_far > 0.0f && t_near < t_best;
      node = box_hit ? node + 1 : skip;
    }
    if (count < 0) break;

    // leaf: its real triangles in slot order; a strict t < t_best keeps the
    // first minimum, as the plain version's min over the leaf does
    float4 P[kLeafMax], Q[kLeafMax], S[kLeafMax];
#pragma unroll
    for (int j = 0; j < kLeafMax; ++j) {
      if (j < count) {
        P[j] = __ldg(tris + 3 * (first + j));
        Q[j] = __ldg(tris + 3 * (first + j) + 1);
        S[j] = __ldg(tris + 3 * (first + j) + 2);
      }
    }
#pragma unroll
    for (int j = 0; j < kLeafMax; ++j) {
      if (j >= count) break;
      const float4 p = P[j], q = Q[j], s = S[j];
      // pvec = cross(d, e2); each difference of products and each dot
      // product contracts into fmas as XLA:CPU contracts the JAX code
      const float px = fmaf(dy, s.z, -(dz * s.y));
      const float py = fmaf(dz, s.x, -(dx * s.z));
      const float pz = fmaf(dx, s.y, -(dy * s.x));
      const float det = fmaf(q.z, pz, fmaf(q.y, py, q.x * px));
      const bool det_ok = fabsf(det) > 1e-9f;
      const float inv_det = det_ok ? 1.0f / det : 0.0f;
      const float tx = ox - p.x, ty = oy - p.y, tz = oz - p.z;
      const float u = fmaf(tz, pz, fmaf(ty, py, tx * px)) * inv_det;
      // qvec = cross(tvec, e1)
      const float qx = fmaf(ty, q.z, -(tz * q.y));
      const float qy = fmaf(tz, q.x, -(tx * q.z));
      const float qz = fmaf(tx, q.y, -(ty * q.x));
      const float v = fmaf(dz, qz, fmaf(dy, qy, dx * qx)) * inv_det;
      const float t = fmaf(s.z, qz, fmaf(s.y, qy, s.x * qx)) * inv_det;
      if (det_ok && u >= 0.0f && v >= 0.0f && u + v <= 1.0f && t > 1e-6f &&
          t < t_best) {
        t_best = t;
        tri_best = __float_as_int(p.w);
        u_best = u;
        v_best = v;
      }
    }
    node = skip;
  }

  t_out[i] = t_best;
  tri_out[i] = tri_best;
  u_out[i] = u_best;
  v_out[i] = v_best;
}

extern "C" int vs_bvh_trace(const void *nodes, const void *tris,
                            const void *node_begin, const void *node_end,
                            int k, const void *rays_o, const void *rays_d,
                            int nr_rays, void *t_out, void *tri_out,
                            void *u_out, void *v_out, void *overflow,
                            int sms, void *stream) {
  long long n = (long long)k * nr_rays;
  if (n > 0) {
    int threads = kMaxThreads;
    while (threads > 32 && (n + threads - 1) / threads < sms) threads /= 2;
    long long blocks = (n + threads - 1) / threads;
    bvh_trace_kernel<<<(unsigned int)blocks, threads, 0,
                       (cudaStream_t)stream>>>(
        (const float4 *)nodes, (const float4 *)tris, (const int *)node_begin,
        (const int *)node_end, k, (const float *)rays_o, (const float *)rays_d,
        nr_rays, (float *)t_out, (int *)tri_out, (float *)u_out,
        (float *)v_out, (int *)overflow);
  }
  return (int)cudaGetLastError();
}
