// K1: row scatter-add of hash-table gradients, out[rows[m], f] += upd[m, f].
//
// Replaces the TPU kernel volsurfs_tpu/ops/pallas/scatter_add.py
// (scatter_add_levels, pl.pallas_call at :107, body _make_kernel :45-93),
// which kept each level's table in VMEM and applied updates one at a time
// through a read-modify-write of a 128-lane tile. On Hopper the table lives
// in device memory and the L2 (50 MB) resolves the float atomics.
//
// Bound: bytes. Each update reads a 4-byte row index and F*4 bytes of values
// and makes F atomic additions; there is no arithmetic to speak of. At the
// volsurfs train step one call is 16 levels x 8,192 updates of F=2 into a
// 355,278-row table: 1.5 MB read and 2.8 MB of table written, about 1.3 us
// at 3.35 TB/s, so the fixed cost of each device operation counts as much
// as the traffic. The launcher therefore zeroes the output itself on the
// caller's stream (cudaMemsetAsync) and runs one kernel. For F=2 a thread
// takes one update: its row index and its 8 bytes of values, coalesced, and
// one float2 atomicAdd, a native vector atomic of compute capability 9.x,
// so there are half as many atomics as values. Other F take one thread and
// one f32 atomicAdd per value.
//
// The coarse direct levels (324 to 15,129 rows) collide heavily, and their
// first rows take thousands of atomics each: exact up to the order of the
// f32 sums, which changes from run to run.
//
// Rows outside [0, total_rows) are dropped, as a JAX scatter drops them.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

}  // namespace

// C names, so that ptxas -v reports each kernel under its own name
extern "C" __global__ void __launch_bounds__(kThreads)
scatter_add_rows_f2_kernel(const int *__restrict__ rows,
                           const float2 *__restrict__ upd,
                           float2 *__restrict__ out, long long nr_updates,
                           long long total_rows) {
  long long m = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (m >= nr_updates) return;
  long long r = rows[m];
  if (r < 0 || r >= total_rows) return;
  atomicAdd(out + r, upd[m]);
}

extern "C" __global__ void __launch_bounds__(kThreads)
scatter_add_rows_kernel(const int *__restrict__ rows,
                        const float *__restrict__ upd,
                        float *__restrict__ out, long long n_values,
                        int nr_feat, long long total_rows) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_values) return;
  long long m = i / nr_feat;
  int f = (int)(i - m * nr_feat);
  long long r = rows[m];
  if (r < 0 || r >= total_rows) return;
  atomicAdd(out + r * nr_feat + f, upd[i]);
}

// out: total_rows * nr_feat floats (any contents), zeroed here first.
extern "C" int vs_scatter_add_rows(const void *rows, const void *upd,
                                   void *out, long long nr_updates,
                                   int nr_feat, long long total_rows,
                                   void *stream) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(
      out, 0, (size_t)total_rows * nr_feat * sizeof(float), s);
  if (err != cudaSuccess) return (int)err;
  // the float2 path needs 8-byte aligned values (a view may be offset)
  const bool pairs = nr_feat == 2 && (uintptr_t)upd % sizeof(float2) == 0;
  long long n_threads = pairs ? nr_updates : nr_updates * nr_feat;
  if (n_threads > 0) {
    unsigned int blocks = (unsigned int)((n_threads + kThreads - 1) / kThreads);
    if (pairs) {
      scatter_add_rows_f2_kernel<<<blocks, kThreads, 0, s>>>(
          (const int *)rows, (const float2 *)upd, (float2 *)out, nr_updates,
          total_rows);
    } else {
      scatter_add_rows_kernel<<<blocks, kThreads, 0, s>>>(
          (const int *)rows, (const float *)upd, (float *)out, n_threads,
          nr_feat, total_rows);
    }
  }
  return (int)cudaGetLastError();
}
