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
// Three kernels, each a thread a ray (a row), each one launch:
//
// - combine_samples_kernel (K8a): the stable merge of a ray's two sample
//   sets, the keep-chain (a sample closer than min_dist to the last one
//   kept is dropped), the compaction (kept samples first, then the dropped
//   ones in merge order, then a's and b's invalid slots) with the carried
//   values [C], and update_dt. The merge is an insertion of the
//   concatenated row into a column of shared memory: on sorted rows, as
//   the samplers give, that is a two-pointer merge, and on any row it
//   orders as a stable argsort does, so the result equals the plain
//   version's bit for bit.
// - neus_transmittance_{forward,backward}_kernel (K8b): the exclusive
//   product of (1 - alpha) + 1e-6 over the valid samples, the weights
//   alpha T and the background transmittance; the backward runs the
//   reverse recurrence R_j = g_{j+1} + o_{j+1} R_{j+1}, dL/do_j = T_j R_j,
//   with no division (alpha reaches 1, o then 1e-6, and the products
//   underflow).
// - neus_importance_kernel (K8c): for each of K surfaces the sdf2alpha
//   alphas, the transmittance scan, the weights normalised by their sum
//   and their CDF (with compute_cdf's snap to 1 and 2 in invalid slots),
//   summed in shared memory and averaged over K; then the n inverse-CDF
//   depths of importance_sample (torch.searchsorted's binary search,
//   map_range's clamp and interpolation).
//
// Bound: the bytes. Each reads its rows once (5-9 B a sample and surface)
// and writes its outputs once, with a few dozen flops a sample; at the
// paths' 512 rays x <= 96 slots (x 5 surfaces) that is well under a MB, so
// each takes the few microseconds of one launch and one dependent chain a
// ray. A thread walks its row in order, so its loads are strided by the
// row (not coalesced); at these sizes the rows stay in L2.
//
// Rounding: built with -fmad=false, every product, sum, comparison and
// division rounds as the plain version's float32 torch op does. combine
// moves values and compares them only, so it equals its plain version bit
// for bit. The scans run in order in float32; the plain version's cumprod
// and cumsum accumulate otherwise (in double on the CPU, as a parallel scan
// on the card) and its sums in another order, and expf is not torch's
// sigmoid, so K8b and K8c agree with it within a few float32 roundings a
// sample (the tolerances are stated in tests/test_torch_cuda.py and
// chip_smoke.py).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kInvalidZ = 1e10f;
constexpr unsigned short kKept = 0x8000;  // the keep-chain's mark on a slot's source
constexpr size_t kSmemLimit = 48 * 1024;  // static launch limit of dynamic shared memory

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

extern "C" __global__ void neus_transmittance_forward_kernel(
    const float *__restrict__ alpha, const uint8_t *__restrict__ mask, float *__restrict__ w,
    float *__restrict__ T_out, float *__restrict__ bg, int S, long long N) {
  const long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= N) return;
  const long long row = r * S;
  float T = 1.0f;
  int count = 0;
  for (int j = 0; j < S; ++j) {
    const bool m = mask[row + j] != 0;
    const float a = m ? alpha[row + j] : 0.0f;
    T_out[row + j] = T;
    w[row + j] = a * T;
    count += m;
    T = T * (m ? (1.0f - a) + 1e-6f : 1.0f);
  }
  // the transmittance at the last valid sample (the count's, as the plain
  // version indexes it), 1 for a row without samples
  bg[r] = count > 0 ? T_out[row + count - 1] : 1.0f;
}

extern "C" __global__ void neus_transmittance_backward_kernel(
    const float *__restrict__ alpha, const uint8_t *__restrict__ mask,
    const float *__restrict__ T, const float *__restrict__ g_w, const float *__restrict__ g_T,
    const float *__restrict__ g_bg, float *__restrict__ g_alpha, int S, long long N) {
  const long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= N) return;
  const long long row = r * S;
  int count = 0;
  for (int j = 0; j < S; ++j) count += mask[row + j] != 0;
  // Rj: the gradient of everything after sample j with respect to T_{j+1},
  // times T_{j+1} / (T_j o_j): dL/do_j = T_j Rj
  float Rj = 0.0f;
  for (int j = S - 1; j >= 0; --j) {
    const bool m = mask[row + j] != 0;
    const float a = m ? alpha[row + j] : 0.0f;
    const float Tj = T[row + j];
    const float gw = g_w[row + j];
    // w_j = a_j T_j and o_j = (1 - a_j) + 1e-6
    g_alpha[row + j] = m ? gw * Tj - Tj * Rj : 0.0f;
    float G = g_T[row + j] + gw * a;  // the gradient with respect to T_j
    if (j == count - 1) G += g_bg[r];
    Rj = G + (m ? (1.0f - a) + 1e-6f : 1.0f) * Rj;
  }
}

extern "C" __global__ void neus_importance_kernel(
    const float *__restrict__ z, const float *__restrict__ dt, const uint8_t *__restrict__ mask,
    const float *__restrict__ sdfs, const float *__restrict__ jitter, float beta,
    float *__restrict__ z_imp, uint8_t *__restrict__ mask_imp, int S, int K, int n,
    long long R) {
  extern __shared__ float importance_smem[];
  const int nt = blockDim.x, tid = threadIdx.x;
  const long long r = (long long)blockIdx.x * nt + tid;
  if (r >= R) return;  // no barrier below
  float *w = importance_smem;                      // [S][nt]: a surface's weights, then its CDF
  float *cdf = importance_smem + (size_t)S * nt;  // [S][nt]: the CDFs' sum
  const long long row = r * S;
  int count = 0;
  for (int j = 0; j < S; ++j) count += mask[row + j] != 0;

  for (int k = 0; k < K; ++k) {
    // sdf2alpha, then the NeuS weights and their sum
    float T = 1.0f, w_sum = 0.0f;
    for (int j = 0; j < S; ++j) {
      const bool m = mask[row + j] != 0;
      const bool pair = m && j + 1 < S && mask[row + j + 1] != 0;
      const float s = sdfs[(row + j) * K + k];
      const float sn = sdfs[(row + (j + 1 < S ? j + 1 : S - 1)) * K + k];
      const float d = dt[row + j];
      const float mid = 0.5f * (s + sn);
      const float cos_val = fminf(fmaxf((sn - s) / (d + 1e-6f), -1e3f), 0.0f);
      const float prev_cdf = sigmoid((mid - cos_val * d * 0.5f) * beta);
      const float next_cdf = sigmoid((mid + cos_val * d * 0.5f) * beta);
      const float a = pair ? (prev_cdf - next_cdf + 1e-6f) / (prev_cdf + 1e-6f) : 0.0f;
      const float wj = a * T;
      w[j * nt + tid] = wj;
      if (m) w_sum += wj;
      T = T * (m ? (1.0f - a) + 1e-6f : 1.0f);
    }
    // compute_cdf of the normalised weights: the exclusive sum, 2 in the
    // invalid slots, the last valid one snapped to 1 when the total is
    // within 1e-3 of 1
    const float denom = fmaxf(w_sum, 1e-6f);
    float acc = 0.0f;
    for (int j = 0; j < S; ++j) {
      const bool m = mask[row + j] != 0;
      const float wn = m ? w[j * nt + tid] / denom : 0.0f;
      w[j * nt + tid] = m ? acc : 2.0f;
      acc += wn;
    }
    if (fabsf(acc - 1.0f) < 1e-3f && count > 0 && mask[row + count - 1] != 0) {
      w[(count - 1) * nt + tid] = 1.0f;
    }
    for (int j = 0; j < S; ++j) {
      cdf[j * nt + tid] = k == 0 ? w[j * nt + tid] : cdf[j * nt + tid] + w[j * nt + tid];
    }
  }
  if (K > 1) {
    for (int j = 0; j < S; ++j) cdf[j * nt + tid] = cdf[j * nt + tid] / (float)K;
  }

  // importance_sample: targets (i + 1) / (n + 1), moved by the jitter,
  // each between the two samples whose CDF values bracket it
  const float spacing = (float)(1.0 / (double)(n + 1));
  const float u_max = (float)(1.0 - 1e-6);
  const int last = count - 1 > 0 ? count - 1 : 0;
  for (int i = 0; i < n; ++i) {
    float u = spacing * (1.0f + (float)i);
    if (jitter != nullptr) u = u + jitter[r * n + i] * spacing;
    u = fminf(fmaxf(u, 1e-6f), u_max);
    int lo = 0, hi = S;  // searchsorted, side right
    while (lo < hi) {
      const int mid = lo + ((hi - lo) >> 1);
      if (!(cdf[mid * nt + tid] > u)) {
        lo = mid + 1;
      } else {
        hi = mid;
      }
    }
    const int imax = max(min(lo, last), 1);
    const int imin = imax - 1;
    const float c0 = cdf[imin * nt + tid], c1 = cdf[imax * nt + tid];
    const float z0 = z[row + imin], z1 = z[row + imax];
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
    const unsigned blocks = (unsigned)((N + 127) / 128);
    neus_transmittance_forward_kernel<<<blocks, 128, 0, (cudaStream_t)stream>>>(
        (const float *)alpha, (const uint8_t *)mask, (float *)w, (float *)T, (float *)bg, S, N);
  }
  return (int)cudaGetLastError();
}

extern "C" int vs_neus_transmittance_backward(const void *alpha, const void *mask,
                                              const void *T, const void *g_w, const void *g_T,
                                              const void *g_bg, void *g_alpha, int S,
                                              long long N, void *stream) {
  if (N > 0) {
    const unsigned blocks = (unsigned)((N + 127) / 128);
    neus_transmittance_backward_kernel<<<blocks, 128, 0, (cudaStream_t)stream>>>(
        (const float *)alpha, (const uint8_t *)mask, (const float *)T, (const float *)g_w,
        (const float *)g_T, (const float *)g_bg, (float *)g_alpha, S, N);
  }
  return (int)cudaGetLastError();
}

extern "C" int vs_neus_importance(const void *z, const void *dt, const void *mask,
                                  const void *sdfs, const void *jitter, float beta, void *z_imp,
                                  void *mask_imp, int S, int K, int n, long long R,
                                  void *stream) {
  if (R > 0) {
    const int nt = threads_for(S, 2 * sizeof(float));
    const size_t smem = (size_t)nt * S * 2 * sizeof(float);
    const unsigned blocks = (unsigned)((R + nt - 1) / nt);
    neus_importance_kernel<<<blocks, nt, smem, (cudaStream_t)stream>>>(
        (const float *)z, (const float *)dt, (const uint8_t *)mask, (const float *)sdfs,
        (const float *)jitter, beta, (float *)z_imp, (uint8_t *)mask_imp, S, K, n, R);
  }
  return (int)cudaGetLastError();
}
