// Masked K-leaf (grad, hess, count) histograms.
//
// Replaces two TPU kernels of lightgbm_tpu/ops/hist_pallas.py:
//   * _histogram_leaves_impl (via histogram_leaves_pallas): bins_t u8 [F, n],
//     grad/hess f32 [n], leaf_of_row i32 [n], leaves i32 [K];
//   * histogram_payload_pallas: the compacted i32 payload [S, W+3] (4 bin
//     bytes per word, grad bits, hess bits, leaf id), rows at position
//     >= cnt excluded, cnt read on the device.
// Both produce f32 [K, F, B, 4] with channel 3 zero; a slot whose leaf id
// repeats an earlier slot gets a copy of that slot's histogram.
//
// The TPU kernels build one-hot tiles and contract them on the MXU, carrying
// the accumulator across a sequential grid.  Hopper blocks run in no order,
// and shared-memory atomics make the scatter cheap, so the design is the
// reference CUDA learner's (cuda_histogram_constructor.cu): one block per
// (feature, row chunk, slot group) keeps a [slots, B, 3] accumulator in
// shared memory (129 KB at K=42, B=256: the dynamic-smem opt-in), adds each
// selected row with shared atomics, and flushes the non-zero cells to a
// global accumulator with global atomics.  A second kernel converts the
// global accumulator to f32 and copies repeated slots.  A row's slot comes
// from a leaf->first-slot table in shared memory (a row belongs to one leaf);
// leaf ids outside the table fall back to a linear search.
//
// Modes (argument ``mode``):
//   0  int8 levels: grad/hess carry small integer levels; values go through
//      f32 -> i32 -> i8 exactly like the TPU kernel and sum in int32, so the
//      result is exact and deterministic (one f32 rounding at exit);
//   1  float32: f32 shared and global atomics.  The summation order changes
//      from run to run, so this mode is deterministic only on integer-valued
//      inputs (exact sums below 2^24);
//   2  bfloat16: values rounded to bf16 (as the TPU casts them), f32 sums as
//      in mode 1.
// Excluded rows are skipped before their grad/hess are read, so a NaN on an
// excluded row never enters a sum (the TPU kernel's where() masking).
//
// Bound on the H100: bytes.  Each input is read once (F + 12 bytes a row for
// the masked pass, 4(W+3) for the payload pass) and K*F*B*16 bytes written.
// This first version re-reads grad/hess/leaf once per feature (from L2) and
// serializes on shared atomics where many rows share a bin; both are what a
// later version should attack.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kLeafTable = 2048;  // leaf ids in [0, 2048) map via the table
constexpr int kThreads = 1024;
constexpr int kFixedInts = kLeafTable + 4;  // table + use-table flag (+pad)

template <int MODE>
struct Val;
template <>
struct Val<0> {
  typedef int T;
  __device__ static int cvt(float v) {
    return (int)(signed char)__float2int_rz(v);
  }
};
template <>
struct Val<1> {
  typedef float T;
  __device__ static float cvt(float v) { return v; }
};
template <>
struct Val<2> {
  typedef float T;
  __device__ static float cvt(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
  }
};

// leaf -> first slot holding it, in shared memory; *use_tab = 0 when some
// leaf id falls outside the table (then slot_of searches linearly)
__device__ inline void build_slot_table(int* tab, int* use_tab,
                                        const int* leaves, int K) {
  for (int i = threadIdx.x; i < kLeafTable; i += blockDim.x) tab[i] = INT_MAX;
  if (threadIdx.x == 0) *use_tab = 1;
  __syncthreads();
  for (int k = threadIdx.x; k < K; k += blockDim.x) {
    int l = leaves[k];
    if (l >= 0 && l < kLeafTable) {
      atomicMin(&tab[l], k);
    } else {
      *use_tab = 0;
    }
  }
  __syncthreads();
}

__device__ inline int slot_of(int leaf, const int* tab, int use_tab,
                              const int* __restrict__ leaves, int K) {
  if (use_tab) {
    if (leaf < 0 || leaf >= kLeafTable) return -1;
    int k = tab[leaf];
    return k == INT_MAX ? -1 : k;
  }
  for (int k = 0; k < K; ++k)
    if (__ldg(leaves + k) == leaf) return k;
  return -1;
}

template <int MODE>
__device__ inline void add_row(typename Val<MODE>::T* acc, int slot, int bin,
                               int n_bins, float g, float h) {
  typedef typename Val<MODE>::T T;
  T* a = acc + ((long)slot * n_bins + bin) * 3;
  atomicAdd(a, Val<MODE>::cvt(g));
  atomicAdd(a + 1, Val<MODE>::cvt(h));
  atomicAdd(a + 2, (T)1);
}

template <typename T>
__device__ inline void flush(const T* acc, T* glob, int k0, int nslots, int f,
                             int num_f, int n_bins) {
  const int per = n_bins * 3;
  const int total = nslots * per;
  for (int i = threadIdx.x; i < total; i += blockDim.x) {
    T v = acc[i];
    if (v != (T)0) {
      int s = i / per;
      int rem = i - s * per;
      atomicAdd(glob + ((long)(k0 + s) * num_f + f) * per + rem, v);
    }
  }
}

template <int MODE>
__global__ void __launch_bounds__(kThreads)
    hist_leaves_kernel(const uint8_t* __restrict__ bins_t, long n, int num_f,
                       const float* __restrict__ grad,
                       const float* __restrict__ hess,
                       const int* __restrict__ lor,
                       const int* __restrict__ leaves, int K, int n_bins,
                       int slots_per_group, long rows_per_chunk,
                       typename Val<MODE>::T* __restrict__ glob) {
  typedef typename Val<MODE>::T T;
  extern __shared__ __align__(16) unsigned char smem[];
  int* tab = reinterpret_cast<int*>(smem);
  int* use_tab = tab + kLeafTable;
  T* acc = reinterpret_cast<T*>(smem + kFixedInts * sizeof(int));
  const int f = blockIdx.x;
  const long r0 = (long)blockIdx.y * rows_per_chunk;
  const long r1 = min(n, r0 + rows_per_chunk);
  const int k0 = blockIdx.z * slots_per_group;
  const int nslots = min(K - k0, slots_per_group);
  for (int i = threadIdx.x; i < nslots * n_bins * 3; i += blockDim.x)
    acc[i] = (T)0;
  build_slot_table(tab, use_tab, leaves, K);
  const int ut = *use_tab;
  const uint8_t* col = bins_t + (long)f * n;
  for (long r = r0 + threadIdx.x; r < r1; r += blockDim.x) {
    int k = slot_of(lor[r], tab, ut, leaves, K) - k0;
    if (k < 0 || k >= nslots) continue;
    int b = col[r];
    if (b >= n_bins) continue;
    add_row<MODE>(acc, k, b, n_bins, grad[r], hess[r]);
  }
  __syncthreads();
  flush(acc, glob, k0, nslots, f, num_f, n_bins);
}

template <int MODE>
__global__ void __launch_bounds__(kThreads)
    hist_payload_kernel(const int* __restrict__ payload, long S, int W,
                        int num_f, const int* __restrict__ leaves, int K,
                        const int* __restrict__ cnt, int n_bins,
                        int slots_per_group, long rows_per_chunk,
                        typename Val<MODE>::T* __restrict__ glob) {
  typedef typename Val<MODE>::T T;
  extern __shared__ __align__(16) unsigned char smem[];
  int* tab = reinterpret_cast<int*>(smem);
  int* use_tab = tab + kLeafTable;
  T* acc = reinterpret_cast<T*>(smem + kFixedInts * sizeof(int));
  const int f = blockIdx.x;
  const long limit = min(S, (long)max(*cnt, 0));
  const long r0 = (long)blockIdx.y * rows_per_chunk;
  const long r1 = min(limit, r0 + rows_per_chunk);
  const int k0 = blockIdx.z * slots_per_group;
  const int nslots = min(K - k0, slots_per_group);
  for (int i = threadIdx.x; i < nslots * n_bins * 3; i += blockDim.x)
    acc[i] = (T)0;
  build_slot_table(tab, use_tab, leaves, K);
  const int ut = *use_tab;
  const int wp3 = W + 3;
  const int word = f >> 2;
  const int shift = (f & 3) * 8;
  for (long r = r0 + threadIdx.x; r < r1; r += blockDim.x) {
    const int* row = payload + r * wp3;
    int k = slot_of(row[W + 2], tab, ut, leaves, K) - k0;
    if (k < 0 || k >= nslots) continue;
    int b = (row[word] >> shift) & 255;
    if (b >= n_bins) continue;
    add_row<MODE>(acc, k, b, n_bins, __int_as_float(row[W]),
                  __int_as_float(row[W + 1]));
  }
  __syncthreads();
  flush(acc, glob, k0, nslots, f, num_f, n_bins);
}

// glob [K, F, B, 3] -> out f32 [K, F, B, 4]; repeated slots copy the first
template <typename T>
__global__ void finalize_kernel(const T* __restrict__ glob,
                                const int* __restrict__ leaves, int K,
                                int num_f, int n_bins,
                                float4* __restrict__ out) {
  const long per = (long)num_f * n_bins;
  const long total = (long)K * per;
  const long stride = (long)gridDim.x * blockDim.x;
  for (long i = (long)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += stride) {
    int k = (int)(i / per);
    long rem = i - (long)k * per;
    int l = leaves[k];
    int kf = k;
    for (int j = 0; j < k; ++j) {
      if (leaves[j] == l) {
        kf = j;
        break;
      }
    }
    const T* src = glob + ((long)kf * per + rem) * 3;
    out[i] = make_float4((float)src[0], (float)src[1], (float)src[2], 0.0f);
  }
}

// slots per block so the accumulator fits the opt-in shared memory
int plan_slots(int K, int n_bins, size_t elem, size_t* smem, int* groups) {
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev);
  if (e != cudaSuccess) return (int)e;
  size_t fixed = kFixedInts * sizeof(int);
  size_t per_slot = (size_t)n_bins * 3 * elem;
  if ((size_t)optin < fixed + per_slot) return (int)cudaErrorInvalidValue;
  size_t spg = ((size_t)optin - fixed) / per_slot;
  if (spg > (size_t)K) spg = K;
  *groups = (int)((K + spg - 1) / spg);
  *smem = fixed + spg * per_slot;
  return 0;
}

long plan_chunks(long rows, int blocks_per_chunk) {
  // about four waves of one-block-per-SM over the 132 SMs, >= 1024 rows each
  long want = (4L * 132 + blocks_per_chunk - 1) / blocks_per_chunk;
  long most = (rows + 1023) / 1024;
  if (want > most) want = most;
  if (want < 1) want = 1;
  if (want > 65535) want = 65535;
  return want;
}

template <typename T>
int launch_finalize(const T* glob, const int* leaves, int K, int num_f,
                    int n_bins, float* out, cudaStream_t s) {
  long total = (long)K * num_f * n_bins;
  if (total <= 0) return 0;
  long want = (total + 255) / 256;
  int blocks = (int)(want < 132L * 32 ? want : 132L * 32);
  finalize_kernel<T><<<blocks, 256, 0, s>>>(glob, leaves, K, num_f, n_bins,
                                            reinterpret_cast<float4*>(out));
  return (int)cudaGetLastError();
}

template <int MODE>
int run_leaves(const uint8_t* bins_t, long n, int num_f, const float* grad,
               const float* hess, const int* lor, const int* leaves, int K,
               int n_bins, void* scratch, float* out, cudaStream_t s) {
  typedef typename Val<MODE>::T T;
  T* glob = reinterpret_cast<T*>(scratch);
  if (n > 0 && K > 0 && num_f > 0) {
    size_t smem = 0;
    int groups = 1;
    int err = plan_slots(K, n_bins, sizeof(T), &smem, &groups);
    if (err) return err;
    int spg = (K + groups - 1) / groups;
    err = (int)cudaFuncSetAttribute(hist_leaves_kernel<MODE>,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    (int)smem);
    if (err) return err;
    long chunks = plan_chunks(n, num_f * groups);
    long rows_per_chunk = (n + chunks - 1) / chunks;
    dim3 grid(num_f, (unsigned)chunks, groups);
    hist_leaves_kernel<MODE><<<grid, kThreads, smem, s>>>(
        bins_t, n, num_f, grad, hess, lor, leaves, K, n_bins, spg,
        rows_per_chunk, glob);
    err = (int)cudaGetLastError();
    if (err) return err;
  }
  return launch_finalize<T>(glob, leaves, K, num_f, n_bins, out, s);
}

template <int MODE>
int run_payload(const int* payload, long S, int W, int num_f,
                const int* leaves, int K, const int* cnt, int n_bins,
                void* scratch, float* out, cudaStream_t s) {
  typedef typename Val<MODE>::T T;
  T* glob = reinterpret_cast<T*>(scratch);
  if (S > 0 && K > 0 && num_f > 0) {
    size_t smem = 0;
    int groups = 1;
    int err = plan_slots(K, n_bins, sizeof(T), &smem, &groups);
    if (err) return err;
    int spg = (K + groups - 1) / groups;
    err = (int)cudaFuncSetAttribute(hist_payload_kernel<MODE>,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    (int)smem);
    if (err) return err;
    long chunks = plan_chunks(S, num_f * groups);
    long rows_per_chunk = (S + chunks - 1) / chunks;
    dim3 grid(num_f, (unsigned)chunks, groups);
    hist_payload_kernel<MODE><<<grid, kThreads, smem, s>>>(
        payload, S, W, num_f, leaves, K, cnt, n_bins, spg, rows_per_chunk,
        glob);
    err = (int)cudaGetLastError();
    if (err) return err;
  }
  return launch_finalize<T>(glob, leaves, K, num_f, n_bins, out, s);
}

}  // namespace

// scratch: zero-filled [K, num_f, n_bins, 3] int32 (mode 0) or f32 (1, 2)
extern "C" int lgbt_hist_leaves(const uint8_t* bins_t, long n, int num_f,
                                const float* grad, const float* hess,
                                const int* lor, const int* leaves, int K,
                                int n_bins, int mode, void* scratch,
                                float* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (mode) {
    case 0:
      return run_leaves<0>(bins_t, n, num_f, grad, hess, lor, leaves, K,
                           n_bins, scratch, out, s);
    case 1:
      return run_leaves<1>(bins_t, n, num_f, grad, hess, lor, leaves, K,
                           n_bins, scratch, out, s);
    case 2:
      return run_leaves<2>(bins_t, n, num_f, grad, hess, lor, leaves, K,
                           n_bins, scratch, out, s);
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" int lgbt_hist_payload(const int* payload, long S, int W, int num_f,
                                 const int* leaves, int K, const int* cnt,
                                 int n_bins, int mode, void* scratch,
                                 float* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (mode) {
    case 0:
      return run_payload<0>(payload, S, W, num_f, leaves, K, cnt, n_bins,
                            scratch, out, s);
    case 1:
      return run_payload<1>(payload, S, W, num_f, leaves, K, cnt, n_bins,
                            scratch, out, s);
    case 2:
      return run_payload<2>(payload, S, W, num_f, leaves, K, cnt, n_bins,
                            scratch, out, s);
  }
  return (int)cudaErrorInvalidValue;
}
