// Small-table row lookup: out[i] = table[idx[i]] for 0 <= idx[i] < T, else 0.
//
// Replaces the TPU kernel lightgbm_tpu/ops/table.py _take_pallas (a radix
// one-hot contraction on the MXU, which the TPU needs because it has no
// fast gather).  On Hopper a gather from a table in shared memory is cheap,
// so the design is the direct one: each block stages the table (T <= 2048
// f32, 8 KB) in shared memory and each thread maps one row.
//
// Bound on the H100: bytes.  4 B of index read and 4 B of value written per
// row; the table is read once per block and stays in L2.  The out-of-range
// rule matches the TPU kernel exactly: it pads the table with zeros to a
// multiple of 128 and its one-hot never matches a negative or too-large
// index, so every index outside [0, T) reads 0.

#include <cuda_runtime.h>

namespace {

constexpr int kSmemTable = 2048;

__global__ void take_smem_kernel(const int* __restrict__ idx, long n,
                                 const float* __restrict__ table, int T,
                                 float* __restrict__ out) {
  __shared__ float tab[kSmemTable];
  for (int i = threadIdx.x; i < T; i += blockDim.x) tab[i] = table[i];
  __syncthreads();
  long stride = (long)gridDim.x * blockDim.x;
  for (long i = (long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    int j = idx[i];
    out[i] = (j >= 0 && j < T) ? tab[j] : 0.0f;
  }
}

__global__ void take_global_kernel(const int* __restrict__ idx, long n,
                                   const float* __restrict__ table, int T,
                                   float* __restrict__ out) {
  long stride = (long)gridDim.x * blockDim.x;
  for (long i = (long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    int j = idx[i];
    out[i] = (j >= 0 && j < T) ? __ldg(table + j) : 0.0f;
  }
}

}  // namespace

extern "C" int lgbt_take(const int* idx, long n, const float* table, int T,
                         float* out, void* stream) {
  if (n <= 0) return 0;
  const int threads = 256;
  long want = (n + threads - 1) / threads;
  int blocks = (int)(want < 132L * 16 ? want : 132L * 16);
  cudaStream_t s = (cudaStream_t)stream;
  if (T <= kSmemTable) {
    take_smem_kernel<<<blocks, threads, 0, s>>>(idx, n, table, T, out);
  } else {
    take_global_kernel<<<blocks, threads, 0, s>>>(idx, n, table, T, out);
  }
  return (int)cudaGetLastError();
}
