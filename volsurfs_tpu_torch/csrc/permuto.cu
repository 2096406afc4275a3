// K6: permutohedral-lattice hash lookup of 3-D points, with the features'
// spatial Jacobian, and its backward: the table's gradient, accumulated in
// place, and the points' gradient.
//
// Replaces the TPU path volsurfs_tpu/models/encodings.py
// (PermutoEncoder.__call__ :1039-1232 and _hash_lookup_cm /
// _hash_lookup_grad_cm with their backward passes :878-986), which kept
// every tensor 2-D and N-major, [N, 4L] with corner c / level l at column
// c*L + l, so that XLA:TPU would not pad a size-3 or size-4 minor axis to
// 128 lanes, ran the elevation as one [N, 3] x [3, 4L] matmul and scattered
// the [N, 4L] updates into the table.
//
// Forward. One thread a (point, level), t = n * L + l, keeping its 4
// residuals, 4 ranks and 4 corners in registers; feats [N, L] float2 and
// dfeats [3, N, L] float2 are then stored contiguously by a warp. Nothing is
// saved for the backward. Bound: bytes. 12 B a point in, the distinct
// 8-byte rows read, 8 B of feats a (point, level) out, with grads 24 B of
// dfeats more. (A level-uniform layout, a warp one level for 32 points with
// the outputs staged through shared memory, was 13-33% slower on the H100.)
//
// Backward. A block takes a tile of 32 points, each warp one level at a
// time for the tile's points (lane = point), so that the level's elevation
// weights, Jacobian entries, size and offset are warp-uniform loads and the
// warp's lanes can merge their updates of one row. One launch after a
// memset of the dense [R, 2] gradient: each (point, level, corner) forms
// its update bary * dout + sum_k dbary_k * gd_k in registers and adds it to
// the table's row, so no update tensor goes through device memory. The
// rows and weights are recomputed from the points (12 B a point) by the
// forward's own arithmetic. The tile's cotangents are read into shared
// memory, coalesced. The warp's lanes on the same row (a ray's
// neighbouring samples share corners) sum their updates first
// (__match_any_sync), and one lane adds the sum with one float2 atomicAdd;
// a sum that is zero is skipped (the samples a ray does not use, z = 1e10,
// all hash to the same few rows of every level, and their cotangents are
// zero). Bound: bytes: the inputs, the gradient's memset and the distinct
// rows' read-modify-writes.
//
// Rounding, as the plain versions in ops/permuto.py (torch ops in the JAX
// op order): the elevation is fma(p2, W2, fma(p1, W1, p0 * W0)), XLA:CPU's
// float32 dot of length 3, and the library is built with -fmad=false, so
// no other product and sum is contracted. The simplex choice (floors and
// comparisons of the elevated residuals) is therefore the plain version's
// bit for bit, and so are the rows, the weights, the corner sums and the
// recomputed rows and weights of the backward. The table gradient sums a
// row's updates in another order than the plain version (atomics), so it
// agrees to float32 summation error.
//
// dbary is constant inside a simplex: it comes from the ranks and the
// level's [4, 3] entries of d residual / d p. Each weight (and each row of
// its Jacobian) is the difference of two residuals (two table entries)
// picked by rank: the value of JAX's masked sums over the 4 residuals,
// which add these two and zeros. The points' gradient sums, over levels
// and corners, (g . dout) * d bary / d unit, with d residual_j / d unit_k =
// W[k, jL + l] / 4, in the order of the plain version: slot s (s < 32)
// sums its levels s, s + 32, ... and their corners in turn, and the 32
// slots are added by xor shuffles.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;  // points a tile, one a lane
constexpr int kD = 3;      // lattice dimension; a simplex has kD + 1 corners
constexpr int kSlots = 32; // the points' gradient's partial sums a point

// the spatial hash's primes
__device__ __forceinline__ unsigned prime(int k) {
  return k == 0 ? 1u : (k == 1 ? 2654435761u : 805459861u);
}

// The residual j of each rank r (the last such j, 0 if none: the ranks
// are a permutation but where float32 loses the residuals, at the invalid
// samples' depth), as the plain version's _by_rank.
__device__ __forceinline__ void by_rank(const int rank[4], int inv[4]) {
#pragma unroll
  for (int r = 0; r <= kD; ++r) {
    inv[r] = 0;
#pragma unroll
    for (int j = 0; j <= kD; ++j) inv[r] = rank[j] == r ? j : inv[r];
  }
}

// v[i] by selects, so that v stays in registers
__device__ __forceinline__ float pick4(const float v[4], int i) {
  return i == 0 ? v[0] : (i == 1 ? v[1] : (i == 2 ? v[2] : v[3]));
}

// Corner c's weight takes the value of the rank-(kD - c) residual less that
// of the rank-((kD + 1 - c) mod 4) one: JAX's masked slot sums, which add
// exactly these two terms and zeros.
__device__ __forceinline__ int pos_rank(int c) { return kD - c; }
__device__ __forceinline__ int neg_rank(int c) { return (kD + 1 - c) % (kD + 1); }

// A level's columns of W, w[k][j] = W[k, j*L + l], and its rows.
struct Level {
  float w[3][4];
  unsigned size;
  int offset;
};

__device__ __forceinline__ Level load_level(const float *__restrict__ W,
                                            const int *__restrict__ sizes,
                                            const int *__restrict__ offsets, int L, int l) {
  Level v;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
#pragma unroll
    for (int j = 0; j <= kD; ++j) v.w[k][j] = W[(k * (kD + 1) + j) * L + l];
  }
  v.size = (unsigned)sizes[l];
  v.offset = offsets[l];
  return v;
}

// d residual_j / d p_k of level l: dd[k][j] = ddiff[j, k, l]
__device__ __forceinline__ void load_ddiff(const float *__restrict__ ddiff, int L, int l,
                                           float dd[3][4]) {
#pragma unroll
  for (int k = 0; k < 3; ++k) {
#pragma unroll
    for (int j = 0; j <= kD; ++j) dd[k][j] = ddiff[(j * 3 + k) * L + l];
  }
}

// The enclosing simplex of a point at a level: its corners' absolute rows
// and barycentric weights, and the residuals' ranks.
struct Simplex {
  int row[4];
  float bary[4];
  int rank[4];
};

__device__ __forceinline__ void locate(float p0, float p1, float p2, const Level &v,
                                       Simplex &s) {
  float e[4];
#pragma unroll
  for (int j = 0; j <= kD; ++j) {
    e[j] = __fmaf_rn(p2, v.w[2][j], __fmaf_rn(p1, v.w[1][j], p0 * v.w[0][j]));
  }
  // back onto the sum = 0 hyperplane
  const float mean = (e[0] + e[1] + e[2] + e[3]) * 0.25f;
#pragma unroll
  for (int j = 0; j <= kD; ++j) e[j] = e[j] - mean;

  // closest remainder-0 lattice point, per residual
  float rem0[4];
#pragma unroll
  for (int j = 0; j <= kD; ++j) {
    const float down = floorf(e[j] / 4.0f) * 4.0f;
    const float up = down + 4.0f;
    rem0[j] = (e[j] - down < up - e[j]) ? down : up;
  }
  const float sum_rem = (rem0[0] + rem0[1] + rem0[2] + rem0[3]) * 0.25f;

  // rank the residuals (largest -> 0, ties by index), then wrap
  float diff[4];
  int *rank = s.rank;
#pragma unroll
  for (int j = 0; j <= kD; ++j) {
    diff[j] = e[j] - rem0[j];
    rank[j] = 0;
  }
#pragma unroll
  for (int i = 0; i <= kD; ++i) {
#pragma unroll
    for (int j = i + 1; j <= kD; ++j) {
      const int lt = diff[i] < diff[j] ? 1 : 0;
      rank[i] += lt;
      rank[j] += 1 - lt;
    }
  }
  const int sr = (int)sum_rem;
#pragma unroll
  for (int j = 0; j <= kD; ++j) {
    int r = rank[j] + sr;
    if (r < 0) {
      rem0[j] = rem0[j] + 4.0f;
      r += 4;
    }
    if (r > kD) {
      rem0[j] = rem0[j] - 4.0f;
      r -= 4;
    }
    rank[j] = r;
  }

  // barycentric weights: differences of two residuals picked by rank,
  // corner 0 adding 1
#pragma unroll
  for (int j = 0; j <= kD; ++j) diff[j] = (e[j] - rem0[j]) * 0.25f;
  int inv[4];
  by_rank(rank, inv);
#pragma unroll
  for (int c = 1; c <= kD; ++c) {
    s.bary[c] = pick4(diff, inv[pos_rank(c)]) - pick4(diff, inv[neg_rank(c)]);
  }
  s.bary[0] = pick4(diff, inv[kD]) + (1.0f + (0.0f - pick4(diff, inv[0])));

  // the corners' hashed rows (the level's size is a power of two in the
  // encoder; the mask then equals the modulo)
  const bool pow2 = (v.size & (v.size - 1u)) == 0u;
#pragma unroll
  for (int c = 0; c <= kD; ++c) {
    unsigned h = 0u;
#pragma unroll
    for (int k = 0; k < kD; ++k) {
      const float add = rank[k] >= kD + 1 - c ? 4.0f : 0.0f;
      const unsigned key = (unsigned)(int)(rem0[k] + add);
      const unsigned term = key * prime(k);
      h = k == 0 ? term : (h ^ term);
    }
    s.row[c] = (int)(pow2 ? (h & (v.size - 1u)) : (h % v.size)) + v.offset;
  }
}

// The sum of x over the lanes of a group (peers: the lanes holding the same
// row, this one included), at the group's lowest lane: each lane adds its
// next higher peer's partial sum, in a tree (log2 of the group's size
// rounds). Every lane of the warp takes part.
__device__ __forceinline__ float2 sum_peers(unsigned peers, float2 x, int lane) {
  unsigned above = peers & (0xfffffffeu << lane);  // this group's lanes above this one
  int rank = __popc(peers & ((1u << lane) - 1u));  // this lane's place in its group
  while (__any_sync(0xffffffffu, above != 0u)) {
    const int next = __ffs(above);  // 1 + the next higher lane, or 0
    const float tx = __shfl_sync(0xffffffffu, x.x, (next - 1) & 31);
    const float ty = __shfl_sync(0xffffffffu, x.y, (next - 1) & 31);
    if (next != 0) {
      x.x = x.x + tx;
      x.y = x.y + ty;
    }
    // a lane at an odd place gave its sum to the one below: it leaves
    above &= ~__ballot_sync(0xffffffffu, rank & 1);
    rank >>= 1;
  }
  return x;
}

// Bytes of the backward's shared memory: with the points' gradient its
// partial sums [3][kTile][kSlots + 1], then the tile's cotangents s_go
// [kTile][L | 1] float2, and with grads s_gd [3][kTile][L | 1] float2.
__host__ __device__ __forceinline__ size_t backward_smem(int L, bool grads, bool points) {
  return (points ? 3 * kTile * (kSlots + 1) * sizeof(float) : 0)
         + (size_t)kTile * (L | 1) * sizeof(float2) * (grads ? 4 : 1);
}

// Lets a kernel take smem bytes of dynamic shared memory: above the default
// 48 KB it raises the kernel's limit, once for each larger size (allowed is
// the kernel's own record of the most set so far).
cudaError_t allow_smem(const void *kernel, size_t smem, size_t &allowed) {
  if (smem <= 48 * 1024 || smem <= allowed) return cudaSuccess;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess) allowed = smem;
  return err;
}

}  // namespace

// One thread a (point, level): t = n * L + l, so that a warp's feats and
// dfeats stores are contiguous.
template <bool kGrads>
__device__ __forceinline__ void forward_point_level(
    const float *__restrict__ pts, const float *__restrict__ W, const int *__restrict__ sizes,
    const int *__restrict__ offsets, const float2 *__restrict__ table,
    const float *__restrict__ ddiff, float2 *__restrict__ feats, float2 *__restrict__ dfeats,
    long long n_points, int L) {
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (t >= n_points * L) return;
  const long long n = t / L;
  const int l = (int)(t - n * L);
  const Level v = load_level(W, sizes, offsets, L, l);
  Simplex s;
  locate(pts[3 * n], pts[3 * n + 1], pts[3 * n + 2], v, s);
  float2 g[4];
#pragma unroll
  for (int c = 0; c <= kD; ++c) g[c] = table[s.row[c]];
  float2 f;
  f.x = s.bary[0] * g[0].x;
  f.y = s.bary[0] * g[0].y;
#pragma unroll
  for (int c = 1; c <= kD; ++c) {
    f.x = f.x + s.bary[c] * g[c].x;
    f.y = f.y + s.bary[c] * g[c].y;
  }
  feats[t] = f;
  if (!kGrads) return;

  int inv[4];
  by_rank(s.rank, inv);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    float2 df;
#pragma unroll
    for (int c = 0; c <= kD; ++c) {
      const float db = ddiff[(inv[pos_rank(c)] * 3 + k) * L + l]
                       - ddiff[(inv[neg_rank(c)] * 3 + k) * L + l];
      if (c == 0) {
        df.x = db * g[0].x;
        df.y = db * g[0].y;
      } else {
        df.x = df.x + db * g[c].x;
        df.y = df.y + db * g[c].y;
      }
    }
    dfeats[k * n_points * L + t] = df;
  }
}

// A block a tile of 32 points; warp w takes the slots s = w, w + 8, ... <
// min(L, 32), each the levels s, s + 32, ... for the tile's points (lane =
// point). kGrads: gd (and ddiff) is the cotangent of dfeats; kPoints: d_unit
// receives the points' gradient (table is read). d_table == nullptr: the
// table needs no gradient (else it is zero on entry).
template <bool kGrads, bool kPoints>
__device__ __forceinline__ void backward_tile(
    const float *__restrict__ pts, const float *__restrict__ W, const int *__restrict__ sizes,
    const int *__restrict__ offsets, const float *__restrict__ ddiff,
    const float2 *__restrict__ table, const float2 *__restrict__ dout,
    const float2 *__restrict__ gd, float2 *__restrict__ d_table, float *__restrict__ d_unit,
    long long n_points, int L) {
  extern __shared__ __align__(16) float smem_f[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int lp = L | 1;
  float *part = smem_f;
  float2 *s_go = (float2 *)(part + (kPoints ? 3 * kTile * (kSlots + 1) : 0));
  float2 *s_gd = s_go + kTile * lp;
  const int slots = L < kSlots ? L : kSlots;
  const long long n0 = (long long)blockIdx.x * kTile;
  const int np = (int)(n_points - n0 < kTile ? n_points - n0 : kTile);
  const long long n = n0 + lane;
  const bool valid = lane < np;

  // the slots past min(L, 32) stay zero for the shuffles
  if (kPoints) {
    for (int i = threadIdx.x; i < 3 * kTile * (kSlots + 1); i += kThreads) part[i] = 0.0f;
  }
  // the tile's cotangents are contiguous: read them coalesced
  for (int i = threadIdx.x; i < np * L; i += kThreads) {
    const int p = i / L, l = i - p * L;
    s_go[p * lp + l] = dout[n0 * L + i];
    if (kGrads) {
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        s_gd[(k * kTile + p) * lp + l] = gd[(long long)k * n_points * L + n0 * L + i];
      }
    }
  }
  __syncthreads();
  float p0 = 0.0f, p1 = 0.0f, p2 = 0.0f;
  if (valid) {
    p0 = pts[3 * n];
    p1 = pts[3 * n + 1];
    p2 = pts[3 * n + 2];
  }
  for (int s = warp; s < slots; s += kWarps) {
    float du[3] = {0.0f, 0.0f, 0.0f};
    // every lane runs every level (the atomics' aggregation takes the whole
    // warp); a lane past the tile's points locates the origin and adds zero
    for (int l = s; l < L; l += kSlots) {
      const Level v = load_level(W, sizes, offsets, L, l);
      Simplex sx;
      locate(p0, p1, p2, v, sx);
      int inv[4];
      by_rank(sx.rank, inv);
      const float2 go = valid ? s_go[lane * lp + l] : make_float2(0.0f, 0.0f);
      if (d_table != nullptr) {
        float dd[3][4];
        float2 gk[3];
        if (kGrads) {
          load_ddiff(ddiff, L, l, dd);
#pragma unroll
          for (int k = 0; k < 3; ++k) {
            gk[k] = valid ? s_gd[(k * kTile + lane) * lp + l] : make_float2(0.0f, 0.0f);
          }
        }
#pragma unroll
        for (int c = 0; c <= kD; ++c) {
          float2 u;
          u.x = sx.bary[c] * go.x;
          u.y = sx.bary[c] * go.y;
          if (kGrads) {
#pragma unroll
            for (int k = 0; k < 3; ++k) {
              const float db = pick4(dd[k], inv[pos_rank(c)]) - pick4(dd[k], inv[neg_rank(c)]);
              u.x = u.x + db * gk[k].x;
              u.y = u.y + db * gk[k].y;
            }
          }
          // lanes on the same row (a ray's neighbouring samples share
          // corners) add their updates first, and one atomic goes out; a
          // zero sum (masked samples') adds nothing: the gradient starts at
          // +0, and +0 + (+-0) is +0
          const int row = sx.row[c];
          const unsigned peers = __match_any_sync(0xffffffffu, row);
          u = sum_peers(peers, u, lane);
          if (lane == __ffs(peers) - 1 && (u.x != 0.0f || u.y != 0.0f)) {
            atomicAdd(d_table + row, u);
          }
        }
      }
      if (kPoints && valid) {
#pragma unroll
        for (int c = 0; c <= kD; ++c) {
          const int jp = inv[pos_rank(c)], jn = inv[neg_rank(c)];
          const float2 g = table[sx.row[c]];
          const float dg = g.x * go.x + g.y * go.y;
#pragma unroll
          for (int k = 0; k < 3; ++k) {
            const float dbu = (pick4(v.w[k], jp) - pick4(v.w[k], jn)) * 0.25f;
            du[k] = du[k] + dg * dbu;
          }
        }
      }
    }
    if (kPoints) {
#pragma unroll
      for (int k = 0; k < 3; ++k) part[(k * kTile + lane) * (kSlots + 1) + s] = du[k];
    }
  }
  if (kPoints) {
    __syncthreads();
    // point p's 32 slots across a warp, added by xor shuffles
    for (int p = warp; p < np; p += kWarps) {
      float v[3];
#pragma unroll
      for (int k = 0; k < 3; ++k) v[k] = part[(k * kTile + p) * (kSlots + 1) + lane];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
        for (int k = 0; k < 3; ++k) v[k] = v[k] + __shfl_xor_sync(0xffffffffu, v[k], off);
      }
      if (lane == 0) {
#pragma unroll
        for (int k = 0; k < 3; ++k) d_unit[3 * (n0 + p) + k] = v[k];
      }
    }
  }
}

// C-named entry points, one a variant, so that ptxas -v reports each under
// its own name: permuto_forward[_grads]_kernel and
// permuto_backward[_grads][_points]_kernel
#define VS_FORWARD_ARGS                                                                    \
  const float *__restrict__ pts, const float *__restrict__ W, const int *__restrict__ sizes, \
      const int *__restrict__ offsets, const float2 *__restrict__ table,                   \
      const float *__restrict__ ddiff, float2 *__restrict__ feats, float2 *__restrict__ dfeats, \
      long long n_points, int L
#define VS_FORWARD_KERNEL(name, grads)                                                   \
  extern "C" __global__ void __launch_bounds__(kThreads) name(VS_FORWARD_ARGS) {         \
    forward_point_level<grads>(pts, W, sizes, offsets, table, ddiff, feats, dfeats,      \
                               n_points, L);                                             \
  }
VS_FORWARD_KERNEL(permuto_forward_kernel, false)
VS_FORWARD_KERNEL(permuto_forward_grads_kernel, true)

#define VS_BACKWARD_ARGS                                                                     \
  const float *__restrict__ pts, const float *__restrict__ W, const int *__restrict__ sizes,   \
      const int *__restrict__ offsets, const float *__restrict__ ddiff,                      \
      const float2 *__restrict__ table, const float2 *__restrict__ dout,                     \
      const float2 *__restrict__ gd, float2 *__restrict__ d_table, float *__restrict__ d_unit, \
      long long n_points, int L
#define VS_BACKWARD_KERNEL(name, grads, points)                                              \
  extern "C" __global__ void __launch_bounds__(kThreads) name(VS_BACKWARD_ARGS) {           \
    backward_tile<grads, points>(pts, W, sizes, offsets, ddiff, table, dout, gd, d_table,    \
                                 d_unit, n_points, L);                                       \
  }
VS_BACKWARD_KERNEL(permuto_backward_kernel, false, false)
VS_BACKWARD_KERNEL(permuto_backward_grads_kernel, true, false)
VS_BACKWARD_KERNEL(permuto_backward_points_kernel, false, true)
VS_BACKWARD_KERNEL(permuto_backward_grads_points_kernel, true, true)

extern "C" int vs_permuto_forward(const void *pts, const void *W, const void *sizes,
                                  const void *offsets, const void *table, const void *ddiff,
                                  void *feats, void *dfeats, long long n_points, int L,
                                  void *stream) {
  const long long n_threads = n_points * L;
  if (n_threads <= 0) return (int)cudaGetLastError();
  void (*kernel)(VS_FORWARD_ARGS) =
      dfeats != nullptr ? permuto_forward_grads_kernel : permuto_forward_kernel;
  const unsigned blocks = (unsigned)((n_threads + kThreads - 1) / kThreads);
  kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const float *)pts, (const float *)W, (const int *)sizes, (const int *)offsets,
      (const float2 *)table, (const float *)ddiff, (float2 *)feats, (float2 *)dfeats, n_points,
      L);
  return (int)cudaGetLastError();
}

// d_table: total_rows float2 (any contents), zeroed here first. gd and
// d_unit pick the variant.
extern "C" int vs_permuto_backward(const void *pts, const void *W, const void *sizes,
                                   const void *offsets, const void *ddiff, const void *table,
                                   const void *dout, const void *gd, void *d_table,
                                   void *d_unit, long long n_points, int L,
                                   long long total_rows, void *stream) {
  static size_t allowed[4];
  cudaStream_t s = (cudaStream_t)stream;
  if (d_table != nullptr) {
    const cudaError_t err = cudaMemsetAsync(d_table, 0, (size_t)total_rows * sizeof(float2), s);
    if (err != cudaSuccess) return (int)err;
  }
  if (n_points <= 0 || (d_table == nullptr && d_unit == nullptr)) return (int)cudaGetLastError();
  const bool grads = gd != nullptr && d_table != nullptr, points = d_unit != nullptr;
  void (*kernel)(VS_BACKWARD_ARGS) =
      grads ? (points ? permuto_backward_grads_points_kernel : permuto_backward_grads_kernel)
            : (points ? permuto_backward_points_kernel : permuto_backward_kernel);
  const size_t smem = backward_smem(L, grads, points);
  const cudaError_t err = allow_smem((const void *)kernel, smem, allowed[2 * grads + points]);
  if (err != cudaSuccess) return (int)err;
  const long long tiles = (n_points + kTile - 1) / kTile;
  kernel<<<(unsigned)tiles, kThreads, smem, s>>>(
      (const float *)pts, (const float *)W, (const int *)sizes, (const int *)offsets,
      (const float *)ddiff, (const float2 *)table, (const float2 *)dout, (const float2 *)gd,
      (float2 *)d_table, (float *)d_unit, n_points, L);
  return (int)cudaGetLastError();
}
