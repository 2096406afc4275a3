// K8: the volume-rendering kernels of the NeuS samplers and renders (surf,
// offsets_surfs).
//
// Replaces, on the TPU path, volsurfs_tpu/ops/samples.py::combine
// (:148-220) and the scans of volsurfs_tpu/ops/volume_rendering.py
// (cumprod_one_minus_alpha_to_transmittance :36, compute_cdf :103,
// importance_sample :137, sdf2alpha :218, neus_weights :307). XLA ran them
// there as dense [R, S] passes: two argsorts and a lax.scan keep-chain for
// combine, associative_scan trees for the products and sums, a batched
// searchsorted for the inverse CDF. On the card the port ran the same as
// torch ops: combine's keep-chain alone was one Python step a slot (~800
// launches of a surf data step), a round of importance sampling ~45.
//
// Three kernels, each one launch:
//
// - combine_samples_kernel (K8a), a thread a ray: the stable merge of a
//   ray's two sample sets, the keep-chain (a sample closer than min_dist to
//   the last one kept is dropped), the compaction (kept samples first, then
//   the dropped ones in merge order, then a's and b's invalid slots) with
//   the carried values [C], and update_dt. The merge is an insertion of the
//   concatenated row into a column of shared memory: on sorted rows, as
//   the samplers give, that is a two-pointer merge, and on any row it
//   orders as a stable argsort does, so the result equals the plain
//   version's bit for bit.
// - neus_transmittance_{forward,backward}_kernel (K8b), a warp a row: the
//   exclusive product of (1 - alpha) + 1e-6 over the valid samples, the
//   weights alpha T and the background transmittance (T at sample count -
//   1); the backward runs the reverse recurrence R_j = G_{j+1} + o_{j+1}
//   R_{j+1}, dL/dalpha_j = T_j (g_w_j - R_j), as a suffix scan of the affine
//   maps R -> G + o R, with no division (alpha reaches 1, o then 1e-6, and
//   the products underflow).
// - neus_importance_kernel (K8c), a warp a ray: the row (z, dt, mask and
//   its S x K SDFs) staged in shared memory; for each of K surfaces the
//   sdf2alpha alphas, the transmittance scan, the weights' sum, their
//   normalised exclusive sum (compute_cdf, with its snap to 1 and 2 in
//   invalid slots), summed in shared memory and averaged over K; then the
//   n inverse-CDF depths of importance_sample, a lane a target
//   (torch.searchsorted's binary search, map_range's clamp and
//   interpolation).
//
// The warp-a-row layout: a lane holds its row's samples lane, lane + 32,
// lane + 64, ... in kChunks chunks of 32 at once (a tile of kTile
// samples; longer rows loop over tiles). Each load or store of a chunk is
// one contiguous 128-byte stretch of the row, whatever S and the row's
// alignment, and K8c's shared-memory reads of a surface's SDFs (stride K
// words) are free of bank conflicts at odd K. The products and sums run as
// warp scans (__shfl_up_sync / __shfl_down_sync, the kChunks chunks side by
// side so that their shuffles overlap), carried from chunk to chunk and
// tile to tile; the valid samples are counted with __ballot_sync and
// __popc.
//
// Bound: the bytes. Each reads its rows once (5-9 B a sample and surface)
// and writes its outputs once, with a few dozen flops a sample: at the
// paths' 512-2,048 rays x <= 96 slots (x 5 surfaces) a few MB. A thread a
// row would load at a stride of a row between threads (32 sectors a warp
// load) on grids of a few blocks; a warp a row loads whole lines and puts
// thousands of warps on the card, so what remains is a launch's few
// microseconds and a row's dependent chain (the loads, five shuffle rounds
// a scan; in K8c three scans a surface, the surfaces one after another).
//
// Rounding: built with -fmad=false, every product, sum, comparison and
// division rounds as the plain version's float32 torch op does. combine
// moves values and compares them only, so it equals its plain version bit
// for bit. The scans take their products and sums as trees (as JAX's
// associative_scan does); the plain version's cumprod and cumsum
// accumulate otherwise (in double on the CPU, as a parallel scan on the
// card) and its sums in another order, and expf is not torch's sigmoid, so
// K8b and K8c agree with it within a few float32 roundings a sample (the
// tolerances are stated in kernel_bench.k8_check).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kInvalidZ = 1e10f;
constexpr unsigned short kKept = 0x8000;  // the keep-chain's mark on a slot's source
constexpr size_t kSmemLimit = 48 * 1024;  // static launch limit of dynamic shared memory
constexpr unsigned kAll = 0xffffffffu;
constexpr int kChunks = 4;             // chunks of 32 samples a lane holds at once
constexpr int kTile = 32 * kChunks;    // samples a warp holds at once
constexpr int kWarpsPerBlock = 4;      // rows (K8b) or rays (K8c) a block

__device__ __forceinline__ float clamp_dt(float x, float max_dt) {
  return fminf(fmaxf(x, 0.0f), max_dt);
}

__device__ __forceinline__ float sigmoid(float x) { return 1.0f / (1.0f + expf(-x)); }

// threads a block such that bytes_per_slot x S slots a thread fit the
// static shared-memory limit (a column of shared memory a thread)
int threads_for(int S, size_t bytes_per_slot) {
  int nt = 32;
  while (nt > 1 && (size_t)nt * S * bytes_per_slot > kSmemLimit) nt >>= 1;
  return nt;
}

// Lets a kernel take smem bytes of dynamic shared memory: above the default
// 48 KB it raises the kernel's limit, once for each larger size (allowed is
// the kernel's own record of the most set so far).
cudaError_t allow_smem(const void *kernel, size_t smem, size_t &allowed) {
  if (smem <= kSmemLimit || smem <= allowed) return cudaSuccess;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess) allowed = smem;
  return err;
}

// the chunks of the tile at base that hold samples of the row (the rest,
// past S, are skipped: the same for every lane)
__device__ __forceinline__ int chunks_in(int S, int base) {
  const int c = (S - base + 31) >> 5;
  return c < kChunks ? c : kChunks;
}

// Inclusive scans over the warp of the first nch chunks, each on its own:
// x[c] becomes the product (sum) of chunk c's elements of lanes 0..lane
__device__ __forceinline__ void warp_scan_products(float (&x)[kChunks], int nch, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      if (c >= nch) break;
      const float y = __shfl_up_sync(kAll, x[c], d);
      if (lane >= d) x[c] = y * x[c];
    }
  }
}

__device__ __forceinline__ void warp_scan_sums(float (&x)[kChunks], int nch, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      if (c >= nch) break;
      const float y = __shfl_up_sync(kAll, x[c], d);
      if (lane >= d) x[c] = y + x[c];
    }
  }
}

// From the chunks' inclusive scans to the tile's exclusive one: x[c]
// becomes carry times (plus) the scan of lanes 0..lane-1, and carry moves
// past each chunk in turn
__device__ __forceinline__ void exclusive_products(float (&x)[kChunks], int nch, float &carry,
                                                   int lane) {
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    if (c >= nch) break;
    const float before = __shfl_up_sync(kAll, x[c], 1);
    const float total = __shfl_sync(kAll, x[c], 31);
    x[c] = lane == 0 ? carry : carry * before;
    carry = carry * total;
  }
}

__device__ __forceinline__ void exclusive_sums(float (&x)[kChunks], int nch, float &carry,
                                               int lane) {
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    if (c >= nch) break;
    const float before = __shfl_up_sync(kAll, x[c], 1);
    const float total = __shfl_sync(kAll, x[c], 31);
    x[c] = lane == 0 ? carry : carry + before;
    carry = carry + total;
  }
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) x += __shfl_xor_sync(kAll, x, d);
  return x;
}

// m[c]: whether sample base + 32 c + lane of the row is valid (false past
// S); returns the valid samples of the tile
__device__ __forceinline__ int load_mask_tile(const uint8_t *mask, int base, int S, int lane,
                                              bool (&m)[kChunks]) {
  int count = 0;
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const int j = base + 32 * c + lane;
    m[c] = j < S && mask[j] != 0;
    count += __popc(__ballot_sync(kAll, m[c]));
  }
  return count;
}

// the valid samples of a row (K8b counts a row of one tile as it loads it,
// sparing a second trip to device memory)
__device__ __forceinline__ int row_count(const uint8_t *mask, int S, int lane) {
  int count = 0;
  bool m[kChunks];
  for (int base = 0; base < S; base += kTile) count += load_mask_tile(mask, base, S, lane, m);
  return count;
}

// sdf2alpha of the pair (s, sn) dt apart
__device__ __forceinline__ float neus_alpha(float s, float sn, float d, float beta) {
  const float mid = 0.5f * (s + sn);
  const float cos_val = fminf(fmaxf((sn - s) / (d + 1e-6f), -1e3f), 0.0f);
  const float prev_cdf = sigmoid((mid - cos_val * d * 0.5f) * beta);
  const float next_cdf = sigmoid((mid + cos_val * d * 0.5f) * beta);
  return (prev_cdf - next_cdf + 1e-6f) / (prev_cdf + 1e-6f);
}

// K8c's shared memory a warp, in floats: the CDFs' sum and a surface's
// weights [Sp each]; staged, also z and dt [Sp each], the S x K SDFs and
// the mask bytes. Every array, and every warp's share, starts on 16 bytes.
__host__ __device__ __forceinline__ int importance_warp_floats(int S, int K, bool staged) {
  const int Sp = (S + 3) & ~3;
  return 2 * Sp + (staged ? 2 * Sp + ((S * K + 3) & ~3) + ((Sp / 4 + 3) & ~3) : 0);
}

}  // namespace

extern "C" __global__ void combine_samples_kernel(
    const float *__restrict__ za, const uint8_t *__restrict__ ma, const float *__restrict__ zb,
    const uint8_t *__restrict__ mb, const float *__restrict__ va, const float *__restrict__ vb,
    const float *__restrict__ t_far, const float *__restrict__ max_dt_a,
    const float *__restrict__ max_dt_b, float min_dist, float *__restrict__ z_out,
    uint8_t *__restrict__ mask_out, float *__restrict__ dt_out, float *__restrict__ v_out,
    float *__restrict__ max_dt_out, int Sa, int Sb, int C, long long R) {
  extern __shared__ float combine_smem[];
  const int S = Sa + Sb;
  const int nt = blockDim.x, tid = threadIdx.x;
  const long long r = (long long)blockIdx.x * nt + tid;
  if (r >= R) return;  // no barrier below
  // slot p of this thread's row: key[p * nt + tid] (its depth) and
  // src[p * nt + tid] (its index in the concatenated row [a | b])
  float *key = combine_smem;
  unsigned short *src = reinterpret_cast<unsigned short *>(combine_smem + (size_t)S * nt);
  auto valid = [&](int i) {
    return i < Sa ? ma[r * Sa + i] != 0 : mb[r * Sb + (i - Sa)] != 0;
  };

  // 1. the stable merge: insert a's slots, then b's, each after every slot
  // of equal depth (invalid slots at kInvalidZ)
  for (int i = 0; i < S; ++i) {
    const float zi = valid(i) ? (i < Sa ? za[r * Sa + i] : zb[r * Sb + (i - Sa)]) : kInvalidZ;
    int p = i;
    while (p > 0 && key[(p - 1) * nt + tid] > zi) {
      key[p * nt + tid] = key[(p - 1) * nt + tid];
      src[p * nt + tid] = src[(p - 1) * nt + tid];
      --p;
    }
    key[p * nt + tid] = zi;
    src[p * nt + tid] = (unsigned short)i;
  }

  // 2. the keep-chain
  float last = -1e10f;
  int kept = 0;
  for (int p = 0; p < S; ++p) {
    const int i = src[p * nt + tid];
    const float zp = key[p * nt + tid];
    if (valid(i) && zp - last >= min_dist) {
      last = zp;
      src[p * nt + tid] = (unsigned short)(i | kKept);
      ++kept;
    }
  }

  // 3. the compaction: the kept slots, then the others, each in merge
  // order; dt of each kept slot from the next (the last from t_far)
  const float mdt = fmaxf(max_dt_a[r], max_dt_b[r]);
  const long long row = r * S;
  int q = 0;
  float prev = 0.0f;
  for (int pass = 0; pass < 2; ++pass) {
    for (int p = 0; p < S; ++p) {
      const unsigned short e = src[p * nt + tid];
      const bool keep = (e & kKept) != 0;
      if (keep != (pass == 0)) continue;
      const int i = e & ~kKept;
      const float zq = keep ? key[p * nt + tid] : kInvalidZ;
      z_out[row + q] = zq;
      mask_out[row + q] = keep ? 1 : 0;
      if (keep) {
        if (q > 0) dt_out[row + q - 1] = clamp_dt(zq - prev, mdt);
        prev = zq;
      } else {
        dt_out[row + q] = 0.0f;
      }
      const float *v = i < Sa ? va + (r * Sa + i) * C : vb + (r * Sb + (i - Sa)) * C;
      for (int c = 0; c < C; ++c) v_out[(row + q) * C + c] = v[c];
      ++q;
    }
  }
  if (kept > 0) dt_out[row + kept - 1] = clamp_dt(t_far[r] - prev, mdt);
  max_dt_out[r] = mdt;
}


extern "C" __global__ void __launch_bounds__(32 * kWarpsPerBlock) neus_transmittance_forward_kernel(
    const float *__restrict__ alpha, const uint8_t *__restrict__ mask, float *__restrict__ w,
    float *__restrict__ T_out, float *__restrict__ bg, int S, long long N) {
  const int lane = threadIdx.x & 31;
  const long long r = (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (r >= N) return;  // the whole warp; no block barrier below
  const long long row = r * S;
  int count = S > kTile ? row_count(mask + row, S, lane) : 0;
  float carry = 1.0f;  // T at the tile's first sample
  for (int base = 0; base < S; base += kTile) {
    float a[kChunks], x[kChunks];
    bool m[kChunks];
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const int j = base + 32 * c + lane;
      a[c] = j < S ? alpha[row + j] : 0.0f;
    }
    const int in_tile = load_mask_tile(mask + row, base, S, lane, m);
    if (S <= kTile) count = in_tile;
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      a[c] = m[c] ? a[c] : 0.0f;
      x[c] = m[c] ? (1.0f - a[c]) + 1e-6f : 1.0f;
    }
    const int nch = chunks_in(S, base);
    warp_scan_products(x, nch, lane);
    exclusive_products(x, nch, carry, lane);  // x: T
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const int j = base + 32 * c + lane;
      if (j < S) {
        T_out[row + j] = x[c];
        w[row + j] = a[c] * x[c];
      }
      // the transmittance at sample count - 1 (the count's, as the plain
      // version indexes it)
      if (j == count - 1) bg[r] = x[c];
    }
  }
  if (count == 0 && lane == 0) bg[r] = 1.0f;  // a row without samples
}

extern "C" __global__ void __launch_bounds__(32 * kWarpsPerBlock) neus_transmittance_backward_kernel(
    const float *__restrict__ alpha, const uint8_t *__restrict__ mask,
    const float *__restrict__ T, const float *__restrict__ g_w, const float *__restrict__ g_T,
    const float *__restrict__ g_bg, float *__restrict__ g_alpha, int S, long long N) {
  const int lane = threadIdx.x & 31;
  const long long r = (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (r >= N) return;  // the whole warp; no block barrier below
  const long long row = r * S;
  int count = S > kTile ? row_count(mask + row, S, lane) : 0;
  const float gbg = g_bg[r];
  // R_j: the gradient of everything after sample j with respect to
  // T_{j+1}, times T_{j+1} / (T_j o_j), so that dL/do_j = T_j R_j. carry is
  // R at the tile's last sample (0 at the row's last and past it).
  float carry = 0.0f;
  for (int base = (S - 1) / kTile * kTile; base >= 0; base -= kTile) {
    float a[kChunks], t[kChunks], gw[kChunks], o[kChunks], G[kChunks];
    bool m[kChunks];
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const int j = base + 32 * c + lane;
      const bool in = j < S;
      a[c] = in ? alpha[row + j] : 0.0f;
      t[c] = in ? T[row + j] : 0.0f;
      gw[c] = in ? g_w[row + j] : 0.0f;
      G[c] = in ? g_T[row + j] : 0.0f;
    }
    const int in_tile = load_mask_tile(mask + row, base, S, lane, m);
    if (S <= kTile) count = in_tile;
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      // w_j = a_j T_j and o_j = (1 - a_j) + 1e-6; G_j, the gradient with
      // respect to T_j; (o_j, G_j) the map R_j -> R_{j-1} = G_j + o_j R_j
      // (the identity past S)
      a[c] = m[c] ? a[c] : 0.0f;
      o[c] = m[c] ? (1.0f - a[c]) + 1e-6f : 1.0f;
      G[c] = G[c] + gw[c] * a[c];
      if (base + 32 * c + lane == count - 1) G[c] += gbg;
    }
    // each chunk's inclusive suffix composition: lane's map followed (on
    // the way back) by those of the lanes above it, (o1, G1) after (o2, G2)
    // = (o1 o2, G1 + o1 G2)
    const int nch = chunks_in(S, base);
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        if (c >= nch) break;
        const float o2 = __shfl_down_sync(kAll, o[c], d);
        const float G2 = __shfl_down_sync(kAll, G[c], d);
        if (lane + d < 32) {
          G[c] = G[c] + o[c] * G2;
          o[c] = o[c] * o2;
        }
      }
    }
#pragma unroll
    for (int c = kChunks - 1; c >= 0; --c) {
      if (c >= nch) continue;  // past S: the identity
      const float o_after = __shfl_down_sync(kAll, o[c], 1);
      const float G_after = __shfl_down_sync(kAll, G[c], 1);
      const float Rj = lane == 31 ? carry : G_after + o_after * carry;
      const int j = base + 32 * c + lane;
      if (j < S) g_alpha[row + j] = m[c] ? gw[c] * t[c] - t[c] * Rj : 0.0f;
      carry = __shfl_sync(kAll, G[c], 0) + __shfl_sync(kAll, o[c], 0) * carry;
    }
  }
}

// K8c's staging of a ray: z, dt and the mask (S each) and the S x K SDFs
// as nv elements of V (float, or float4 where the row's SDFs are aligned),
// all of a tile's loads in flight before its stores
template <typename V>
__device__ __forceinline__ void stage_ray(const float *__restrict__ z,
                                          const float *__restrict__ dt,
                                          const uint8_t *__restrict__ mask,
                                          const V *__restrict__ sdf, float *sz, float *sdt,
                                          uint8_t *smask, V *ssdf, int S, int nv, int lane) {
  for (int base = 0; base < (S > nv ? S : nv); base += kTile) {
    float zv[kChunks], dv[kChunks];
    uint8_t mv[kChunks];
    V sv[kChunks];
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const int i = base + 32 * c + lane;
      if (i < S) {
        zv[c] = z[i];
        dv[c] = dt[i];
        mv[c] = mask[i];
      }
      if (i < nv) sv[c] = sdf[i];
    }
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const int i = base + 32 * c + lane;
      if (i < S) {
        sz[i] = zv[c];
        sdt[i] = dv[c];
        smask[i] = mv[c];
      }
      if (i < nv) ssdf[i] = sv[c];
    }
  }
}

// staged: whether the ray's row is copied into shared memory (it is unless
// its S x K SDFs exceed what a block may take; then they are read in place)
extern "C" __global__ void __launch_bounds__(32 * kWarpsPerBlock) neus_importance_kernel(
    const float *__restrict__ z, const float *__restrict__ dt, const uint8_t *__restrict__ mask,
    const float *__restrict__ sdfs, const float *__restrict__ jitter, float beta,
    float *__restrict__ z_imp, uint8_t *__restrict__ mask_imp, int S, int K, int n,
    long long R, int staged) {
  extern __shared__ __align__(16) float importance_smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long r = (long long)blockIdx.x * (blockDim.x >> 5) + warp;
  if (r >= R) return;  // the whole warp; no block barrier below
  const int Sp = (S + 3) & ~3;
  float *cdf = importance_smem + (size_t)warp * importance_warp_floats(S, K, staged);
  float *wk = cdf + Sp;  // a surface's weights, then its CDF
  const long long row = r * S;
  const float *zr = z + row, *dtr = dt + row, *sdf = sdfs + row * K;
  const uint8_t *mr = mask + row;
  if (staged) {
    float *sz = wk + Sp, *sdt = sz + Sp, *ssdf = sdt + Sp;
    uint8_t *smask = reinterpret_cast<uint8_t *>(ssdf + ((S * K + 3) & ~3));
    if ((S * K) % 4 == 0 && reinterpret_cast<uintptr_t>(sdf) % 16 == 0) {
      stage_ray(zr, dtr, mr, reinterpret_cast<const float4 *>(sdf), sz, sdt, smask,
                reinterpret_cast<float4 *>(ssdf), S, S * K / 4, lane);
    } else {
      stage_ray(zr, dtr, mr, sdf, sz, sdt, smask, ssdf, S, S * K, lane);
    }
    __syncwarp();
    zr = sz;
    dtr = sdt;
    sdf = ssdf;
    mr = smask;
  }
  const int count = row_count(mr, S, lane);

  for (int k = 0; k < K; ++k) {
    // 1. sdf2alpha, the transmittance scan, the weights (into wk) and their sum
    float carry = 1.0f, w_sum = 0.0f;
    for (int base = 0; base < S; base += kTile) {
      const int nch = chunks_in(S, base);
      float a[kChunks], x[kChunks];
      bool m[kChunks];
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        if (c >= nch) break;
        const int j = base + 32 * c + lane;
        const int jj = j < S ? j : S - 1, jn = j + 1 < S ? j + 1 : S - 1;
        m[c] = j < S && mr[j] != 0;
        const bool pair = m[c] && j + 1 < S && mr[j + 1] != 0;
        const float al = neus_alpha(sdf[jj * K + k], sdf[jn * K + k], dtr[jj], beta);
        a[c] = pair ? al : 0.0f;
        x[c] = m[c] ? (1.0f - a[c]) + 1e-6f : 1.0f;
      }
      warp_scan_products(x, nch, lane);
      exclusive_products(x, nch, carry, lane);  // x: T
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        if (c >= nch) break;
        const int j = base + 32 * c + lane;
        const float wj = a[c] * x[c];
        if (j < S) wk[j] = wj;
        if (m[c]) w_sum += wj;
      }
    }
    const float denom = fmaxf(warp_sum(w_sum), 1e-6f);
    // 2. compute_cdf of the normalised weights: their exclusive sum, 2 in
    // the invalid slots (each lane reads back only what it wrote)
    float acc = 0.0f;
    for (int base = 0; base < S; base += kTile) {
      const int nch = chunks_in(S, base);
      float x[kChunks];
      bool m[kChunks];
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        if (c >= nch) break;
        const int j = base + 32 * c + lane;
        m[c] = j < S && mr[j] != 0;
        x[c] = m[c] ? wk[j] / denom : 0.0f;
      }
      warp_scan_sums(x, nch, lane);
      exclusive_sums(x, nch, acc, lane);
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        if (c >= nch) break;
        const int j = base + 32 * c + lane;
        if (j < S) wk[j] = m[c] ? x[c] : 2.0f;
      }
    }
    // the last valid sample snapped to 1 when the total is within 1e-3 of 1
    __syncwarp();
    if (lane == 0 && fabsf(acc - 1.0f) < 1e-3f && count > 0 && mr[count - 1] != 0) {
      wk[count - 1] = 1.0f;
    }
    __syncwarp();
    // 3. into the CDFs' sum (lane j % 32 writes wk[j] in every pass)
    for (int j = lane; j < S; j += 32) cdf[j] = k == 0 ? wk[j] : cdf[j] + wk[j];
  }
  if (K > 1) {
    for (int j = lane; j < S; j += 32) cdf[j] = cdf[j] / (float)K;
  }
  __syncwarp();

  // importance_sample, a lane a target: targets (i + 1) / (n + 1), moved by
  // the jitter, each between the two samples whose CDF values bracket it
  const float spacing = (float)(1.0 / (double)(n + 1));
  const float u_max = (float)(1.0 - 1e-6);
  const int last = count - 1 > 0 ? count - 1 : 0;
  for (int i = lane; i < n; i += 32) {
    float u = spacing * (1.0f + (float)i);
    if (jitter != nullptr) u = u + jitter[r * n + i] * spacing;
    u = fminf(fmaxf(u, 1e-6f), u_max);
    int lo = 0, hi = S;  // searchsorted, side right
    while (lo < hi) {
      const int mid = lo + ((hi - lo) >> 1);
      if (!(cdf[mid] > u)) {
        lo = mid + 1;
      } else {
        hi = mid;
      }
    }
    const int imax = max(min(lo, last), 1);
    const int imin = imax - 1;
    const float c0 = cdf[imin], c1 = cdf[imax];
    const float z0 = zr[imin], z1 = zr[imax];
    // map_range: u clamped to [c0, c1], a degenerate range gives z1
    const float x = fminf(fmaxf(u, fminf(c0, c1)), fmaxf(c0, c1));
    const float den = c1 - c0;
    const float t = den != 0.0f ? (x - c0) / den : 1.0f;
    const bool m = count >= 2;
    z_imp[r * n + i] = m ? z0 + (z1 - z0) * t : kInvalidZ;
    mask_imp[r * n + i] = m ? 1 : 0;
  }
}

extern "C" int vs_combine_samples(const void *za, const void *ma, const void *zb, const void *mb,
                                  const void *va, const void *vb, const void *t_far,
                                  const void *max_dt_a, const void *max_dt_b, float min_dist,
                                  void *z, void *mask, void *dt, void *v, void *max_dt, int Sa,
                                  int Sb, int C, long long R, void *stream) {
  if (R > 0) {
    const int S = Sa + Sb;
    const int nt = threads_for(S, sizeof(float) + sizeof(unsigned short));
    const size_t smem = (size_t)nt * S * (sizeof(float) + sizeof(unsigned short));
    const unsigned blocks = (unsigned)((R + nt - 1) / nt);
    combine_samples_kernel<<<blocks, nt, smem, (cudaStream_t)stream>>>(
        (const float *)za, (const uint8_t *)ma, (const float *)zb, (const uint8_t *)mb,
        (const float *)va, (const float *)vb, (const float *)t_far, (const float *)max_dt_a,
        (const float *)max_dt_b, min_dist, (float *)z, (uint8_t *)mask, (float *)dt,
        (float *)v, (float *)max_dt, Sa, Sb, C, R);
  }
  return (int)cudaGetLastError();
}

extern "C" int vs_neus_transmittance_forward(const void *alpha, const void *mask, void *w,
                                             void *T, void *bg, int S, long long N,
                                             void *stream) {
  if (N > 0) {
    const unsigned blocks = (unsigned)((N + kWarpsPerBlock - 1) / kWarpsPerBlock);
    neus_transmittance_forward_kernel<<<blocks, 32 * kWarpsPerBlock, 0, (cudaStream_t)stream>>>(
        (const float *)alpha, (const uint8_t *)mask, (float *)w, (float *)T, (float *)bg, S, N);
  }
  return (int)cudaGetLastError();
}

extern "C" int vs_neus_transmittance_backward(const void *alpha, const void *mask,
                                              const void *T, const void *g_w, const void *g_T,
                                              const void *g_bg, void *g_alpha, int S,
                                              long long N, void *stream) {
  if (N > 0) {
    const unsigned blocks = (unsigned)((N + kWarpsPerBlock - 1) / kWarpsPerBlock);
    neus_transmittance_backward_kernel<<<blocks, 32 * kWarpsPerBlock, 0, (cudaStream_t)stream>>>(
        (const float *)alpha, (const uint8_t *)mask, (const float *)T, (const float *)g_w,
        (const float *)g_T, (const float *)g_bg, (float *)g_alpha, S, N);
  }
  return (int)cudaGetLastError();
}

// A warp a ray, kWarpsPerBlock rays a block while their shared memory fits
// the static 48 KB, fewer for long rows; one ray's staged row past 48 KB
// raises the kernel's limit, and past the card's most (227 KB on the
// H100: S = 4,096 with K > 9) its SDFs stay in device memory.
extern "C" int vs_neus_importance(const void *z, const void *dt, const void *mask,
                                  const void *sdfs, const void *jitter, float beta, void *z_imp,
                                  void *mask_imp, int S, int K, int n, long long R,
                                  void *stream) {
  static int optin = 0;
  static size_t allowed = 0;
  if (R > 0) {
    if (optin == 0) {
      int dev = 0;
      cudaError_t err = cudaGetDevice(&dev);
      if (err == cudaSuccess) {
        err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
      }
      if (err != cudaSuccess) return (int)err;
    }
    const int staged =
        (size_t)importance_warp_floats(S, K, true) * sizeof(float) <= (size_t)optin;
    const size_t per_warp = (size_t)importance_warp_floats(S, K, staged) * sizeof(float);
    int warps = kWarpsPerBlock;
    while (warps > 1 && warps * per_warp > kSmemLimit) warps >>= 1;
    const size_t smem = warps * per_warp;
    const cudaError_t err = allow_smem((const void *)neus_importance_kernel, smem, allowed);
    if (err != cudaSuccess) return (int)err;
    const unsigned blocks = (unsigned)((R + warps - 1) / warps);
    neus_importance_kernel<<<blocks, 32 * warps, smem, (cudaStream_t)stream>>>(
        (const float *)z, (const float *)dt, (const uint8_t *)mask, (const float *)sdfs,
        (const float *)jitter, beta, (float *)z_imp, (uint8_t *)mask_imp, S, K, n, R, staged);
  }
  return (int)cudaGetLastError();
}
