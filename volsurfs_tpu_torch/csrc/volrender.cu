// K8: the volume-rendering kernels of the NeuS samplers and renders (surf,
// offsets_surfs) and of the nerf method's.
//
// Replaces, on the TPU path, volsurfs_tpu/ops/samples.py::combine
// (:148-220) and the scans of volsurfs_tpu/ops/volume_rendering.py
// (cumprod_one_minus_alpha_to_transmittance :36, compute_cdf :103,
// importance_sample :137, sdf2alpha :218, nerf_weights :288, neus_weights
// :307) and the importance round of volsurfs_tpu/methods/nerf.py (:143-151,
// the chain nerf_weights, sum_over_rays, compute_cdf, importance_sample). XLA ran them
// there as dense [R, S] passes: two argsorts and a lax.scan keep-chain for
// combine, associative_scan trees for the products and sums, a batched
// searchsorted for the inverse CDF. On the card the port ran the same as
// torch ops: combine's keep-chain alone was one Python step a slot (~800
// launches of a surf data step), a round of importance sampling ~45.
//
// Four kernels, each one launch:
//
// - combine_samples_kernel (K8a), a warp a ray: the stable merge of a ray's
//   two sample sets, the keep-chain (a sample closer than min_dist to the
//   last one kept is dropped), the compaction (kept samples first, then the
//   dropped ones in merge order, then a's and b's invalid slots) with the
//   carried values [C], and update_dt. The merge places each slot of the
//   concatenated row [a | b] (invalid ones at kInvalidZ) at its rank, the
//   number of slots strictly smaller plus the equal ones before it, which is
//   the stable argsort's place: on rows sorted after masking, as every
//   caller gives (K7's rows, K8c's depths, combine's own outputs), a_i goes
//   to i + #(b < a_i) and b_j to j + #(a <= b_j) by binary searches of the
//   row staged in shared memory; a row that a ballot finds unsorted is
//   ranked by counting, all pairs. The keep-chain takes each slot's
//   successor, the first valid slot at least min_dist further (the four
//   next slots tested side by side, a binary search where none holds: the
//   test is monotone on the sorted row); a row whose every successor is the
//   next valid slot keeps them all, any other marks its chain from the head
//   by pointer doubling (log2 of its length rounds, however the row drops
//   its samples; one lane walking the chain's jumps measured the same). The
//   compaction places the slots by ballot prefixes, and the outputs and the
//   row's S x C carried values (staged in shared memory by cp.async while
//   the rest runs) leave as coalesced runs, a lane a float. One kernel a
//   tile width of 1-4 chunks of 32 slots: a warp's dependent steps are this
//   kernel's time, so each step issues its chunks' shared-memory loads
//   together before it uses them.
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
// - nerf_importance_kernel (K8d): K8c's ray with one field, the density
//   [R, S], whose alphas are nerf_weights' clip(1 - exp(-sigma dt), 0, 1)
//   of each valid sample (K8c takes sdf2alpha of consecutive samples): the
//   same template (importance_ray<true>), staging, scans and search.
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
// a scan; in K8c three scans a surface, the surfaces one after another; in
// K8a the searches, ~7 rounds each, and the chain's marking).
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

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kInvalidZ = 1e10f;
// K8a's marks beside a slot's source index (S <= 4,096 takes 12 bits)
constexpr unsigned short kKept = 0x8000;   // on the keep-chain
constexpr unsigned short kValid = 0x4000;  // valid in its input set
constexpr unsigned short kSource = 0x3fff;
constexpr size_t kSmemLimit = 48 * 1024;  // static launch limit of dynamic shared memory
constexpr unsigned kAll = 0xffffffffu;
constexpr int kChunks = 4;             // chunks of 32 samples a lane holds at once
constexpr int kTile = 32 * kChunks;    // samples a warp holds at once
constexpr int kWarpsPerBlock = 4;      // rows (K8b) or rays (K8c) a block

__device__ __forceinline__ float clamp_dt(float x, float max_dt) {
  return fminf(fmaxf(x, 0.0f), max_dt);
}

__device__ __forceinline__ float sigmoid(float x) { return 1.0f / (1.0f + expf(-x)); }

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

// K8a's shared memory a warp, in bytes: the order keys of the row [a | b],
// then the merged row's depths; the merged depths; the merged slots'
// sources; two arrays of slot indices (the next valid slot, the keep-chain's
// successors, the jumps of its marking, then the output's sources); the
// keep-chain's marks; and the staged_values carried values of [a | b].
// Every array, and every warp's share, starts on 16 bytes.
__host__ __device__ __forceinline__ size_t combine_warp_bytes(int S, int staged_values) {
  const size_t S4 = (size_t)((S + 3) & ~3), S8 = (size_t)((S + 8) & ~7);
  return 4 * S4 + 4 * S4 + 2 * ((S4 + 7) & ~(size_t)7) + 2 * S8 + 2 * S8 +
         ((S8 + 15) & ~(size_t)15) + 4 * (size_t)((staged_values + 3) & ~3);
}

// K8a stages a row's carried values (S x C floats) in shared memory up to
// this many; a longer row's are read from device memory in the last step
constexpr int kStagedValues = 4096;

// the float's place in torch's (and JAX's) sort as an unsigned key: -0 as
// +0, every NaN after everything else
__device__ __forceinline__ unsigned order_key(float x) {
  if (x != x) return 0xffffffffu;
  const unsigned u = __float_as_uint(x == 0.0f ? 0.0f : x);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ int highest_pow2(int n) { return n > 0 ? 1 << (31 - __clz(n)) : 0; }

// One ray of combine, a warp: the merge by ranks, the keep-chain by
// successors, the compaction by ballots, then the outputs (see the header).
// A lane holds slots lane + 32 c of a tile of NC chunks (NC = 4 and a loop
// over tiles past 128 slots, else just the chunks the row has). A warp's
// dependent steps are this kernel's time, so every step reads shared
// memory at clamped indices, outside any branch, and only its stores are
// predicated: the chunks' loads then overlap instead of waiting in turn.
template <int NC>
__device__ __forceinline__ void combine_ray(
    const float *__restrict__ za, const uint8_t *__restrict__ ma, const float *__restrict__ zb,
    const uint8_t *__restrict__ mb, const float *__restrict__ va, const float *__restrict__ vb,
    float tf, float mdt, float min_dist, float *__restrict__ z_out,
    uint8_t *__restrict__ mask_out, float *__restrict__ dt_out, float *__restrict__ v_out,
    int Sa, int Sb, int C, bool staged, unsigned char *smem, int lane) {
  constexpr int T = 32 * NC;  // slots a tile
  const int S = Sa + Sb;
  if (S == 0) return;
  const bool one_tile = S <= T;
  const int S4 = (S + 3) & ~3, S8 = (S + 8) & ~7;
  unsigned *uk = reinterpret_cast<unsigned *>(smem);  // order keys of [a | b]; then oz
  float *oz = reinterpret_cast<float *>(smem);        // the output's depths
  float *mz = reinterpret_cast<float *>(smem) + S4;   // the merged row's depths
  unsigned short *msrc = reinterpret_cast<unsigned short *>(mz + S4);  // source | kValid
  unsigned short *nxt = msrc + ((S4 + 7) & ~7);  // keep-chain successors (S: none), [S + 1]
  unsigned short *jmp = nxt + S8;  // the next valid slot; the doubling's jumps; then osrc
  unsigned short *osrc = jmp;      // source | kKept of each output slot
  uint8_t *kept = reinterpret_cast<uint8_t *>(jmp + S8);  // the keep-chain's marks
  float *sv = reinterpret_cast<float *>(kept + ((S8 + 15) & ~15));  // staged values

  // 1. the keys of the concatenated row (invalid slots at kInvalidZ) and
  // their order keys; a one-tile row's stay in registers. Whether a and b
  // are each sorted (then a slot's rank is two sums, else a count), from
  // each slot's and its left neighbour's key by shuffles.
  float key[NC];
  bool valid[NC];
  unsigned u[NC];
  auto load = [&](int base) {
    float z[NC];
    uint8_t m[NC];
#pragma unroll
    for (int c = 0; c < NC; ++c) {  // the chunks' loads in flight together
      const int i = min(base + 32 * c + lane, S - 1);
      z[c] = *(i < Sa ? za + i : zb + (i - Sa));
      m[c] = *(i < Sa ? ma + i : mb + (i - Sa));
    }
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int i = base + 32 * c + lane;
      valid[c] = (i < S) & (m[c] != 0);
      key[c] = valid[c] ? z[c] : kInvalidZ;
      u[c] = i < S ? order_key(key[c]) : 0u;
    }
  };
  int nans = 0;
  bool disorder = false;
  unsigned left = 0;  // the key left of the tile
  for (int base = 0; base < S; base += T) {
    load(base);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int i = base + 32 * c + lane;
      const unsigned up = __shfl_up_sync(kAll, u[c], 1);
      const unsigned last = c == 0 ? left : __shfl_sync(kAll, u[c == 0 ? 0 : c - 1], 31);
      const unsigned prev = lane == 0 ? last : up;
      disorder = disorder || (i < S && i != 0 && i != Sa && prev > u[c]);
      nans += __popc(__ballot_sync(kAll, i < S && key[c] != key[c]));
      if (i < S) uk[i] = u[c];
    }
    left = __shfl_sync(kAll, u[NC - 1], 31);
  }
  const bool unsorted = __any_sync(kAll, disorder);
  // the carried values' copy into shared memory, in flight until the last
  // step needs them: 16 bytes a copy where both rows allow it, else 4
  if (staged) {
    const bool wide = (Sa * C) % 4 == 0 && (Sb * C) % 4 == 0 &&
                      reinterpret_cast<uintptr_t>(va) % 16 == 0 &&
                      reinterpret_cast<uintptr_t>(vb) % 16 == 0;
    if (wide) {
      for (int e = 4 * lane; e < S * C; e += 128) {
        __pipeline_memcpy_async(sv + e, e < Sa * C ? va + e : vb + (e - Sa * C), 16);
      }
    } else {
      for (int e = lane; e < S * C; e += 32) {
        __pipeline_memcpy_async(sv + e, e < Sa * C ? va + e : vb + (e - Sa * C), sizeof(float));
      }
    }
    __pipeline_commit();
  }
  __syncwarp();

  // 2. the merge: slot i of [a | b] to its rank, the slots strictly smaller
  // plus the equal ones before it (the stable argsort's place). On sorted
  // rows a_i goes to i + #(b < a_i) and b_j to j + #(a <= b_j), by binary
  // searches of the staged keys, the chunks' searches side by side.
  const int top_ab = highest_pow2(Sa > Sb ? Sa : Sb);
  for (int base = 0; base < S; base += T) {
    if (!one_tile) load(base);
    int rank[NC];
#pragma unroll
    for (int c = 0; c < NC; ++c) rank[c] = 0;
    if (!unsorted) {
      const unsigned *arr[NC];
      int n[NC];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int i = base + 32 * c + lane;
        arr[c] = i < Sa ? uk + Sa : uk;  // a's slots search b's keys, b's search a's
        n[c] = i < Sa ? Sb : (i < S ? Sa : 0);
      }
      // a probe past the end reads the last key: if it is below, so are
      // all, and the count, clamped to n at the end, is n
      for (int step = top_ab; step > 0; step >>= 1) {
        unsigned v[NC];
#pragma unroll
        for (int c = 0; c < NC; ++c) v[c] = arr[c][max(min(rank[c] + step, n[c]) - 1, 0)];
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const int i = base + 32 * c + lane;
          // a's slots count b's keys below theirs, b's count a's at or below
          const bool below = (v[c] < u[c]) | ((i >= Sa) & (v[c] == u[c]));
          rank[c] = below ? rank[c] + step : rank[c];
        }
      }
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int i = base + 32 * c + lane;
        rank[c] = min(rank[c], n[c]) + (i < Sa ? i : i - Sa);
      }
    } else {
      for (int k = 0; k < S; ++k) {
        const unsigned v = uk[k];
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const int i = base + 32 * c + lane;
          rank[c] += (v < u[c] || (v == u[c] && k < i)) ? 1 : 0;
        }
      }
    }
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int i = base + 32 * c + lane;
      if (i < S) {
        mz[rank[c]] = key[c];
        msrc[rank[c]] = (unsigned short)(i | (valid[c] ? kValid : 0));
      }
    }
  }
  __syncwarp();
  const int nn = S - nans;  // the merged row's NaNs come last

  // 3. jmp[p]: the first valid slot at or after p (S if none; NaNs are
  // never kept), from the row's end by ballots; the marks cleared
  int carry = S;
  for (int base = (S - 1) / T * T; base >= 0; base -= T) {
    unsigned b[NC];
    unsigned short e[NC];
#pragma unroll
    for (int c = 0; c < NC; ++c) e[c] = msrc[min(base + 32 * c + lane, S - 1)];
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int p = base + 32 * c + lane;
      b[c] = __ballot_sync(kAll, (p < nn) & ((e[c] & kValid) != 0));
    }
#pragma unroll
    for (int c = NC - 1; c >= 0; --c) {
      const int p0 = base + 32 * c, p = p0 + lane;
      const unsigned here = b[c] & (kAll << lane);
      if (p < S) {
        jmp[p] = (unsigned short)(here ? p0 + __ffs(here) - 1 : carry);
        kept[p] = 0;
      }
      carry = b[c] ? p0 + __ffs(b[c]) - 1 : carry;
    }
  }
  if (lane == 0) {
    jmp[S] = (unsigned short)S;
    nxt[S] = (unsigned short)S;
  }
  __syncwarp();

  // 4. the keep-chain's successors: nxt[p], the first valid slot k > p with
  // z_k - z_p >= min_dist (monotone in k on the sorted row, so the first k
  // where it holds, then jmp the valid one from there): the four slots
  // after p first, side by side, then, for the warp's lanes none of them
  // settles, a binary search from p + 5. The chain's head the same from
  // -1e10, as the plain version starts, in every lane alike. A row whose
  // every valid slot's successor is the next valid one keeps them all.
  const int top = highest_pow2(nn);
  int head;
  {
    float v[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) v[k] = mz[max(min(k, nn - 1), 0)];
    head = 4;
#pragma unroll
    for (int k = 3; k >= 0; --k) head = (k < nn) & (v[k] - (-1e10f) >= min_dist) ? k : head;
    if (head == 4 && 4 < nn) {
      // a probe past nn reads the last slot: if the test fails there, it
      // fails on all of [0, nn), and head, clamped to nn, is nn
      for (int step = top; step > 0; step >>= 1) {
        const int probe = head + step;
        head = !(mz[min(probe, nn) - 1] - (-1e10f) >= min_dist) ? probe : head;
      }
    }
    head = jmp[min(head, nn)];
  }
  bool all_next = true;
  for (int base = 0; base < S; base += T) {
    int pos[NC];
    float zp[NC], w[NC][4];
    unsigned short e[NC];
    bool open = false;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int p = base + 32 * c + lane;
      zp[c] = mz[min(p, S - 1)];
      e[c] = msrc[min(p, S - 1)];
#pragma unroll
      for (int k = 0; k < 4; ++k) w[c][k] = mz[max(min(p + 1 + k, nn - 1), 0)];
    }
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int p = base + 32 * c + lane;
      pos[c] = p + 5;
#pragma unroll
      for (int k = 3; k >= 0; --k) {
        pos[c] = (p + 1 + k < nn) & (w[c][k] - zp[c] >= min_dist) ? p + 1 + k : pos[c];
      }
      // only a valid slot's successor is ever followed
      open = open | ((pos[c] == p + 5) & (p + 5 < nn) & ((e[c] & kValid) != 0));
    }
    if (__any_sync(kAll, open)) {
      // a settled lane's probes find the test holding (or, past nn, the
      // last slot failing it, and pos is clamped to nn below)
      for (int step = top; step > 0; step >>= 1) {
        float v[NC];
#pragma unroll
        for (int c = 0; c < NC; ++c) v[c] = mz[min(pos[c] + step, nn) - 1];
#pragma unroll
        for (int c = 0; c < NC; ++c) pos[c] = !(v[c] - zp[c] >= min_dist) ? pos[c] + step : pos[c];
      }
    }
    int jn[NC], jp[NC];
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int p = base + 32 * c + lane;
      jn[c] = jmp[min(pos[c], nn)];
      jp[c] = jmp[min(p + 1, S)];
    }
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int p = base + 32 * c + lane;
      const int n = p < nn ? jn[c] : S;
      const bool jump = (p < nn) & ((e[c] & kValid) != 0) & (n != jp[c]);
      all_next = all_next & !jump;
      if (p < S) nxt[p] = (unsigned short)n;
    }
  }
  all_next = __all_sync(kAll, all_next) && head == jmp[0];
  __syncwarp();

  // 5. mark the chain head, nxt[head], ... by pointer doubling (with
  // all_next: every valid slot, which the compaction reads from kValid):
  // before round k the chain's first 2^k slots are marked and J jumps 2^k
  // links; each marked slot marks its jump's end (only chain slots are ever
  // marked). Done when J[head] passes the end. J and Jn hold S + 1
  // entries, the last S.
  if (!all_next && head < S) {
    if (lane == 0) kept[head] = 1;
    unsigned short *J = nxt, *Jn = jmp;
    __syncwarp();
    while (J[head] < S) {
      for (int base = 0; base < S; base += T) {
        int j[NC];
        uint8_t marked[NC];
        unsigned short jj[NC];
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const int pc = min(base + 32 * c + lane, S);
          j[c] = J[pc];
          marked[c] = kept[pc];
        }
#pragma unroll
        for (int c = 0; c < NC; ++c) jj[c] = J[j[c]];
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const int p = base + 32 * c + lane;
          if ((p < S) & (j[c] < S) & (marked[c] != 0)) kept[j[c]] = 1;
          if (p < S) Jn[p] = jj[c];
        }
      }
      unsigned short *t = J;
      J = Jn;
      Jn = t;
      __syncwarp();
    }
  }
  __syncwarp();

  // 6. the compaction: the stable order of (kept ? z : kInvalidZ), so the
  // kept slots below kInvalidZ, then every slot at kInvalidZ (the dropped
  // ones), then kept slots above it, each group in merge order
  int g[NC];
  bool k_[NC];
  unsigned short e_[NC];
  float z_[NC];
  unsigned b[NC][3];
  auto classify = [&](int base) {
    uint8_t f[NC];
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int pc = min(base + 32 * c + lane, S - 1);
      e_[c] = msrc[pc];
      z_[c] = mz[pc];
      f[c] = kept[pc];
    }
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int p = base + 32 * c + lane;
      k_[c] = all_next ? (p < nn) & ((e_[c] & kValid) != 0) : f[c] != 0;
      g[c] = p >= S ? 3 : (k_[c] && z_[c] < kInvalidZ ? 0 : (k_[c] && z_[c] > kInvalidZ ? 2 : 1));
#pragma unroll
      for (int k = 0; k < 3; ++k) b[c][k] = __ballot_sync(kAll, g[c] == k);
    }
  };
  int n0 = 0, n1 = 0;
  for (int base = 0; base < S; base += T) {
    classify(base);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      n0 += __popc(b[c][0]);
      n1 += __popc(b[c][1]);
    }
  }
  int at[3] = {0, n0, n0 + n1};
  const unsigned below = (1u << lane) - 1u;
  for (int base = 0; base < S; base += T) {
    if (!one_tile) classify(base);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int gc = min(g[c], 2);
      const int q = at[gc] + __popc(b[c][gc] & below);
      if (g[c] < 3) {
        oz[q] = k_[c] ? z_[c] : kInvalidZ;
        osrc[q] = (unsigned short)((e_[c] & kSource) | (k_[c] ? kKept : 0));
      }
#pragma unroll
      for (int k = 0; k < 3; ++k) at[k] += __popc(b[c][k]);
    }
  }
  __syncwarp();

  // 7. the outputs, coalesced: z, the mask, dt as update_dt gives it (from
  // the next slot, the last kept one's from t_far) and the values, a lane a
  // float of the row's S x C
  for (int base = 0; base < S; base += T) {
    unsigned short o[NC], on[NC];
    float z[NC], zn[NC];
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int q = base + 32 * c + lane, qc = min(q, S - 1), qn = min(q + 1, S - 1);
      o[c] = osrc[qc];
      on[c] = osrc[qn];
      z[c] = oz[qc];
      zn[c] = oz[qn];
    }
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int q = base + 32 * c + lane;
      const bool is_kept = (o[c] & kKept) != 0;
      const bool next_kept = (q + 1 < S) & ((on[c] & kKept) != 0);
      if (q < S) {
        z_out[q] = z[c];
        mask_out[q] = is_kept ? 1 : 0;
        dt_out[q] = is_kept ? clamp_dt((next_kept ? zn[c] : tf) - z[c], mdt) : 0.0f;
      }
    }
  }
  if (C == 0) return;
  if (staged) {
    __pipeline_wait_prior(0);
    __syncwarp();
  }
  // element e = q C + cc of the row's values, advanced by 32 a chunk
  int q = lane / C, cc = lane - (lane / C) * C;
  const int dq = 32 / C, dc = 32 - (32 / C) * C;
  for (int base = 0; base < S * C; base += kTile) {
    int at[kChunks];
    float v[kChunks];
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      at[c] = (osrc[min(q, S - 1)] & kSource) * C + cc;
      cc += dc;
      q += dq;
      if (cc >= C) {
        cc -= C;
        ++q;
      }
    }
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const int e = base + 32 * c + lane;
      v[c] = staged ? sv[min(at[c], S * C - 1)]
                    : (e < S * C ? (at[c] < Sa * C ? va[at[c]] : vb[at[c] - Sa * C]) : 0.0f);
    }
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const int e = base + 32 * c + lane;
      if (e < S * C) v_out[e] = v[c];
    }
  }
}

}  // namespace

// one kernel a tile width NC (1-4 chunks of 32 slots); the launcher takes
// the narrowest tile that holds the row
#define COMBINE_SAMPLES_KERNEL(name, NC)                                                  \
  extern "C" __global__ void __launch_bounds__(32 * kWarpsPerBlock) name(                      \
      const float *__restrict__ za, const uint8_t *__restrict__ ma,                            \
      const float *__restrict__ zb, const uint8_t *__restrict__ mb,                            \
      const float *__restrict__ va, const float *__restrict__ vb,                              \
      const float *__restrict__ t_far, const float *__restrict__ max_dt_a,                     \
      const float *__restrict__ max_dt_b, float min_dist, float *__restrict__ z_out,           \
      uint8_t *__restrict__ mask_out, float *__restrict__ dt_out, float *__restrict__ v_out,   \
      float *__restrict__ max_dt_out, int Sa, int Sb, int C, int staged, long long R) {        \
    extern __shared__ __align__(16) unsigned char combine_smem[];                              \
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;                                \
    const long long r = (long long)blockIdx.x * (blockDim.x >> 5) + warp;                      \
    if (r >= R) return; /* the whole warp; no block barrier below */                           \
    const int S = Sa + Sb;                                                                     \
    const float mdt = fmaxf(max_dt_a[r], max_dt_b[r]);                                         \
    combine_ray<NC>(za + r * Sa, ma + r * Sa, zb + r * Sb, mb + r * Sb,                  \
                          C ? va + r * Sa * C : va, C ? vb + r * Sb * C : vb, t_far[r], mdt,   \
                          min_dist, z_out + r * S, mask_out + r * S, dt_out + r * S,           \
                          C ? v_out + r * S * C : v_out, Sa, Sb, C, staged != 0,               \
                          combine_smem + warp * combine_warp_bytes(S, staged ? S * C : 0),    \
                          lane);                                                               \
    if (lane == 0) max_dt_out[r] = mdt;                                                        \
  }

COMBINE_SAMPLES_KERNEL(combine_samples_c1_kernel, 1)
COMBINE_SAMPLES_KERNEL(combine_samples_c2_kernel, 2)
COMBINE_SAMPLES_KERNEL(combine_samples_c3_kernel, 3)
COMBINE_SAMPLES_KERNEL(combine_samples_c4_kernel, 4)

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

// One ray of K8c (kNerf false: K SDFs a sample) or K8d (kNerf true: one
// density a sample, K = 1), a warp a ray. staged: whether the ray's row is
// copied into shared memory (it is unless its S x K fields exceed what a
// block may take; then they are read in place). The two differ only in the
// alphas: sdf2alpha of consecutive SDFs at beta (0 at a ray's last valid
// sample), or nerf_weights' clip(1 - exp(-sigma dt), 0, 1) of each valid
// sample's density.
template <bool kNerf>
__device__ __forceinline__ void importance_ray(
    const float *__restrict__ z, const float *__restrict__ dt, const uint8_t *__restrict__ mask,
    const float *__restrict__ sdfs, const float *__restrict__ jitter, float beta,
    float *__restrict__ z_imp, uint8_t *__restrict__ mask_imp, int S, int K, int n,
    long long r, int staged, float *importance_smem, int warp, int lane) {
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
    // 1. the alphas, the transmittance scan, the weights (into wk) and their sum
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
        if (kNerf) {
          const float al = fminf(fmaxf(1.0f - expf(-sdf[jj] * dtr[jj]), 0.0f), 1.0f);
          a[c] = m[c] ? al : 0.0f;
        } else {
          const bool pair = m[c] && j + 1 < S && mr[j + 1] != 0;
          const float al = neus_alpha(sdf[jj * K + k], sdf[jn * K + k], dtr[jj], beta);
          a[c] = pair ? al : 0.0f;
        }
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

#define IMPORTANCE_KERNEL(name, nerf)                                                         \
  extern "C" __global__ void __launch_bounds__(32 * kWarpsPerBlock) name(                      \
      const float *__restrict__ z, const float *__restrict__ dt,                               \
      const uint8_t *__restrict__ mask, const float *__restrict__ fields,                      \
      const float *__restrict__ jitter, float beta, float *__restrict__ z_imp,                 \
      uint8_t *__restrict__ mask_imp, int S, int K, int n, long long R, int staged) {          \
    extern __shared__ __align__(16) float importance_smem[];                                   \
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;                                \
    const long long r = (long long)blockIdx.x * (blockDim.x >> 5) + warp;                      \
    if (r >= R) return; /* the whole warp; no block barrier below */                           \
    importance_ray<nerf>(z, dt, mask, fields, jitter, beta, z_imp, mask_imp, S, K, n, r,       \
                         staged, importance_smem, warp, lane);                                 \
  }

IMPORTANCE_KERNEL(neus_importance_kernel, false)
IMPORTANCE_KERNEL(nerf_importance_kernel, true)

// A warp a ray, kWarpsPerBlock rays a block while their shared memory fits
// the static 48 KB, fewer for long rows; one ray's row past 48 KB (S > 3,400
// slots) raises the kernel's limit.
extern "C" int vs_combine_samples(const void *za, const void *ma, const void *zb, const void *mb,
                                  const void *va, const void *vb, const void *t_far,
                                  const void *max_dt_a, const void *max_dt_b, float min_dist,
                                  void *z, void *mask, void *dt, void *v, void *max_dt, int Sa,
                                  int Sb, int C, long long R, void *stream) {
  typedef void (*Kernel)(const float *, const uint8_t *, const float *, const uint8_t *,
                         const float *, const float *, const float *, const float *,
                         const float *, float, float *, uint8_t *, float *, float *, float *, int,
                         int, int, int, long long);
  static const Kernel kernels[4] = {combine_samples_c1_kernel, combine_samples_c2_kernel,
                                     combine_samples_c3_kernel, combine_samples_c4_kernel};
  static size_t allowed[4] = {};
  if (R > 0) {
    const int S = Sa + Sb;
    const int nc = S <= 32 ? 1 : S <= 64 ? 2 : S <= 96 ? 3 : 4;
    const Kernel kernel = kernels[nc - 1];
    const int staged = C > 0 && (long long)S * C <= kStagedValues;
    const size_t per_warp = combine_warp_bytes(S, staged ? S * C : 0);
    int warps = kWarpsPerBlock;
    while (warps > 1 && warps * per_warp > kSmemLimit) warps >>= 1;
    const size_t smem = warps * per_warp;
    const cudaError_t err = allow_smem((const void *)kernel, smem, allowed[nc - 1]);
    if (err != cudaSuccess) return (int)err;
    const unsigned blocks = (unsigned)((R + warps - 1) / warps);
    kernel<<<blocks, 32 * warps, smem, (cudaStream_t)stream>>>(
        (const float *)za, (const uint8_t *)ma, (const float *)zb, (const uint8_t *)mb,
        (const float *)va, (const float *)vb, (const float *)t_far, (const float *)max_dt_a,
        (const float *)max_dt_b, min_dist, (float *)z, (uint8_t *)mask, (float *)dt,
        (float *)v, (float *)max_dt, Sa, Sb, C, staged, R);
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
// K8c (nerf 0: K SDFs a sample, beta) or K8d (nerf 1: one density a
// sample, K = 1, beta unused)
extern "C" int vs_importance(const void *z, const void *dt, const void *mask, const void *fields,
                             const void *jitter, float beta, void *z_imp, void *mask_imp, int S,
                             int K, int n, long long R, int nerf, void *stream) {
  typedef void (*Kernel)(const float *, const float *, const uint8_t *, const float *,
                         const float *, float, float *, uint8_t *, int, int, int, long long, int);
  static const Kernel kernels[2] = {neus_importance_kernel, nerf_importance_kernel};
  static size_t allowed[2] = {};
  static int optin = 0;
  if (R > 0) {
    if (optin == 0) {
      int dev = 0;
      cudaError_t err = cudaGetDevice(&dev);
      if (err == cudaSuccess) {
        err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
      }
      if (err != cudaSuccess) return (int)err;
    }
    const Kernel kernel = kernels[nerf != 0];
    const int staged =
        (size_t)importance_warp_floats(S, K, true) * sizeof(float) <= (size_t)optin;
    const size_t per_warp = (size_t)importance_warp_floats(S, K, staged) * sizeof(float);
    int warps = kWarpsPerBlock;
    while (warps > 1 && warps * per_warp > kSmemLimit) warps >>= 1;
    const size_t smem = warps * per_warp;
    const cudaError_t err = allow_smem((const void *)kernel, smem, allowed[nerf != 0]);
    if (err != cudaSuccess) return (int)err;
    const unsigned blocks = (unsigned)((R + warps - 1) / warps);
    kernel<<<blocks, 32 * warps, smem, (cudaStream_t)stream>>>(
        (const float *)z, (const float *)dt, (const uint8_t *)mask, (const float *)fields,
        (const float *)jitter, beta, (float *)z_imp, (uint8_t *)mask_imp, S, K, n, R, staged);
  }
  return (int)cudaGetLastError();
}
