// K6: permutohedral-lattice hash lookup of 3-D points, with the features'
// spatial Jacobian, and its backward: the per-corner table-gradient updates
// and the points' gradient.
//
// Replaces the TPU path volsurfs_tpu/models/encodings.py
// (PermutoEncoder.__call__ :1039-1232 and _hash_lookup_cm /
// _hash_lookup_grad_cm with their backward passes :878-986), which kept
// every tensor 2-D and N-major, [N, 4L] with corner c / level l at column
// c*L + l, so that XLA:TPU would not pad a size-3 or size-4 minor axis to
// 128 lanes, and ran the elevation as one [N, 3] x [3, 4L] matmul. On Hopper
// each (point, level) is one thread that keeps its 4 residuals, 4 ranks and
// 4 corners in registers.
//
// Bound: bytes. The forward reads 12 B a point and the 4 corners' 8-byte
// rows, and writes 8 B of feats a (point, level); with grads 24 B of dfeats
// more; and where a backward can follow (save) 16 B of rows, 16 B of
// weights and 1 B of rank code more. At 49,152 points x 24 levels with
// grads and save that is ~77 MB of writes, ~0.023 ms at 3.35 TB/s, plus the
// distinct rows the points touch; without save (the occupancy refresh,
// importance sampling) the writes are 8 B a (point, level). The arithmetic
// (~150 flops a thread) is far below the card's rate. The row reads are
// random within a level; the coarse levels' tables stay in L2.
//
// Rounding, as the plain version in ops/permuto.py (torch ops in the JAX
// op order): the elevation is fma(p2, W2, fma(p1, W1, p0 * W0)), XLA:CPU's
// float32 dot of length 3, and the library is built with -fmad=false, so
// no other product and sum is contracted. The simplex choice (floors and
// comparisons of the elevated residuals) is therefore the plain version's
// bit for bit, and so are the rows, the weights and the corner sums.
//
// The backward takes one warp a point, lane l a level (l, l + 32, ...), and
// writes the update bary * dout + sum_k dbary_k * gJ_k of each corner as one
// float2 in the order of the rows; kernel K1 (csrc/scatter_add.cu)
// accumulates them into the table. dbary is constant inside a simplex: it
// is recomputed from the forward's 1-byte rank code and the [4, 3, L] table
// of d residual / d p. Each weight (and each row of its Jacobian) is the
// difference of two residuals (two table entries) picked by rank: the value
// of JAX's masked sums over the 4 residuals, which add these two and zeros.
// Where the points need a gradient (the curvature term's moved points), the
// warp also sums, over levels and corners, (g . dout) * d bary / d unit,
// with d residual_j / d unit_k = W[k, jL + l] / 4, each lane in order and
// then across the warp by xor shuffles, which the plain version repeats.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kD = 3;  // lattice dimension; a simplex has kD + 1 corners

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

}  // namespace

// One thread a (point, level): t = n * L + l. idx_out, bary_out and
// code_out are all null (no backward follows) or all set.
extern "C" __global__ void __launch_bounds__(kThreads)
permuto_forward_kernel(const float *__restrict__ pts, const float *__restrict__ W,
                       const int *__restrict__ sizes, const int *__restrict__ offsets,
                       const float2 *__restrict__ table, const float *__restrict__ ddiff,
                       float2 *__restrict__ feats, float2 *__restrict__ dfeats,
                       int *__restrict__ idx_out, float *__restrict__ bary_out,
                       uint8_t *__restrict__ code_out, long long n_points, int L) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n_points * L) return;
  const long long n = t / L;
  const int l = (int)(t - n * L);
  const int ncols = (kD + 1) * L;
  const float p0 = pts[3 * n], p1 = pts[3 * n + 1], p2 = pts[3 * n + 2];

  float e[4];
#pragma unroll
  for (int j = 0; j <= kD; ++j) {
    const int col = j * L + l;
    e[j] = __fmaf_rn(p2, W[2 * ncols + col], __fmaf_rn(p1, W[ncols + col], p0 * W[col]));
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
  int rank[4] = {0, 0, 0, 0};
#pragma unroll
  for (int j = 0; j <= kD; ++j) diff[j] = e[j] - rem0[j];
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
  float bary[4];
#pragma unroll
  for (int c = 1; c <= kD; ++c) {
    bary[c] = pick4(diff, inv[pos_rank(c)]) - pick4(diff, inv[neg_rank(c)]);
  }
  bary[0] = pick4(diff, inv[kD]) + (1.0f + (0.0f - pick4(diff, inv[0])));

  // the corners' hashed rows and their features
  const unsigned size = (unsigned)sizes[l];
  const int offset = offsets[l];
  float2 g[4];
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
    const int row = (int)(h % size) + offset;
    if (idx_out != nullptr) {
      const long long col = n * ncols + c * L + l;
      idx_out[col] = row;
      bary_out[col] = bary[c];
    }
    g[c] = table[row];
  }
  float2 f;
  f.x = bary[0] * g[0].x;
  f.y = bary[0] * g[0].y;
#pragma unroll
  for (int c = 1; c <= kD; ++c) {
    f.x = f.x + bary[c] * g[c].x;
    f.y = f.y + bary[c] * g[c].y;
  }
  feats[t] = f;
  if (code_out != nullptr) {
    code_out[t] = (uint8_t)(rank[0] | (rank[1] << 2) | (rank[2] << 4) | (rank[3] << 6));
  }
  if (dfeats == nullptr) return;

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

// One warp a point n, lane l a level (l, l + 32, ... where L > 32). upd ==
// nullptr: the table needs no gradient; gd == nullptr: the lookup without
// grads; d_unit == nullptr: the points need no gradient (else idx, table
// and W are read).
extern "C" __global__ void __launch_bounds__(kThreads)
permuto_backward_kernel(const int *__restrict__ idx, const float *__restrict__ bary,
                        const uint8_t *__restrict__ code, const float *__restrict__ ddiff,
                        const float *__restrict__ W, const float2 *__restrict__ table,
                        const float2 *__restrict__ dout, const float2 *__restrict__ gd,
                        float2 *__restrict__ upd, float *__restrict__ d_unit,
                        long long n_points, int L) {
  const long long n = ((long long)blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x & 31;
  if (n >= n_points) return;  // the whole warp: the shuffles below see every lane
  const int ncols = (kD + 1) * L;
  float du[3] = {0.0f, 0.0f, 0.0f};
  for (int l = lane; l < L; l += 32) {
    const long long nl = n * L + l;
    const float2 go = dout[nl];
    int inv[4] = {0, 0, 0, 0};
    if (gd != nullptr || d_unit != nullptr) {
      const int packed = code[nl];
      const int rank[4] = {packed & 3, (packed >> 2) & 3, (packed >> 4) & 3, (packed >> 6) & 3};
      by_rank(rank, inv);
    }
#pragma unroll
    for (int c = 0; c <= kD; ++c) {
      const long long col = n * ncols + c * L + l;
      const int jp = inv[pos_rank(c)], jn = inv[neg_rank(c)];
      if (upd != nullptr) {
        const float b = bary[col];
        float2 u;
        u.x = b * go.x;
        u.y = b * go.y;
        if (gd != nullptr) {
#pragma unroll
          for (int k = 0; k < 3; ++k) {
            const float db = ddiff[(jp * 3 + k) * L + l] - ddiff[(jn * 3 + k) * L + l];
            const float2 gk = gd[k * n_points * L + nl];
            u.x = u.x + db * gk.x;
            u.y = u.y + db * gk.y;
          }
        }
        upd[col] = u;
      }
      if (d_unit != nullptr) {
        const float2 g = table[idx[col]];
        const float dg = g.x * go.x + g.y * go.y;
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          const float dbu = (W[k * ncols + jp * L + l] - W[k * ncols + jn * L + l]) * 0.25f;
          du[k] = du[k] + dg * dbu;
        }
      }
    }
  }
  if (d_unit == nullptr) return;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int k = 0; k < 3; ++k) du[k] = du[k] + __shfl_xor_sync(0xffffffffu, du[k], off);
  }
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < 3; ++k) d_unit[3 * n + k] = du[k];
  }
}

extern "C" int vs_permuto_forward(const void *pts, const void *W, const void *sizes,
                                  const void *offsets, const void *table, const void *ddiff,
                                  void *feats, void *dfeats, void *idx, void *bary, void *code,
                                  long long n_points, int L, void *stream) {
  const long long n_threads = n_points * L;
  if (n_threads > 0) {
    const unsigned blocks = (unsigned)((n_threads + kThreads - 1) / kThreads);
    permuto_forward_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const float *)pts, (const float *)W, (const int *)sizes, (const int *)offsets,
        (const float2 *)table, (const float *)ddiff, (float2 *)feats, (float2 *)dfeats,
        (int *)idx, (float *)bary, (uint8_t *)code, n_points, L);
  }
  return (int)cudaGetLastError();
}

extern "C" int vs_permuto_backward(const void *idx, const void *bary, const void *code,
                                   const void *ddiff, const void *W, const void *table,
                                   const void *dout, const void *gd, void *upd, void *d_unit,
                                   long long n_points, int L, void *stream) {
  const long long n_threads = n_points * 32;
  if (n_threads > 0) {
    const unsigned blocks = (unsigned)((n_threads + kThreads - 1) / kThreads);
    permuto_backward_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const int *)idx, (const float *)bary, (const uint8_t *)code, (const float *)ddiff,
        (const float *)W, (const float2 *)table, (const float2 *)dout, (const float2 *)gd,
        (float2 *)upd, (float *)d_unit, n_points, L);
  }
  return (int)cudaGetLastError();
}
