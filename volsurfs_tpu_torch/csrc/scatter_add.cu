// K1: row scatter-add of hash-table gradients, out[rows[m], f] += upd[m, f].
//
// Replaces the TPU kernel volsurfs_tpu/ops/pallas/scatter_add.py
// (scatter_add_levels, pl.pallas_call at :107, body _make_kernel :45-93),
// which kept each level's table in VMEM and applied updates one at a time
// through a read-modify-write of a 128-lane tile. On Hopper the table lives
// in device memory and the L2 (50 MB) resolves the float atomics, so the
// kernel is one thread per (update, feature) doing an f32 atomicAdd into an
// output that the caller has zeroed.
//
// Bound: bytes. Each update reads a 4-byte row index and F*4 bytes of values
// and makes F atomic read-modify-writes; there is no arithmetic to speak of.
// At the volsurfs train step (40 textures x 4 lerp corners x 512 rays x 16
// levels x 4 corners, about 5.2M updates a step) that is about 12 B read
// and 8 B of atomics per update, plus zeroing the gradient tables.
// The coarse direct levels (324 to 15,129 rows) collide heavily, and their
// first rows take thousands of atomics each: slow, but exact up to the
// order of the f32 sums, which changes from run to run.
//
// Rows outside [0, total_rows) are dropped, as a JAX scatter drops them.

#include <cuda_runtime.h>

namespace {

__global__ void scatter_add_rows_kernel(const int *__restrict__ rows,
                                        const float *__restrict__ upd,
                                        float *__restrict__ out,
                                        long long n_values, int nr_feat,
                                        long long total_rows) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_values) return;
  long long m = i / nr_feat;
  int f = (int)(i - m * nr_feat);
  long long r = rows[m];
  if (r < 0 || r >= total_rows) return;
  atomicAdd(out + r * nr_feat + f, upd[i]);
}

}  // namespace

extern "C" int vs_scatter_add_rows(const void *rows, const void *upd,
                                   void *out, long long nr_updates,
                                   int nr_feat, long long total_rows,
                                   void *stream) {
  long long n_values = nr_updates * nr_feat;
  if (n_values > 0) {
    const int threads = 256;
    long long blocks = (n_values + threads - 1) / threads;
    scatter_add_rows_kernel<<<(unsigned int)blocks, threads, 0,
                              (cudaStream_t)stream>>>(
        (const int *)rows, (const float *)upd, (float *)out, n_values,
        nr_feat, total_rows);
  }
  return (int)cudaGetLastError();
}
