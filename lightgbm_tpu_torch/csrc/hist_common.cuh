// What the histogram kernels of masked.cuh, radix.cu, rows.cu and
// partition.cu share: the value arithmetic of the three modes, the scale
// pass of pass_scale, the leaf -> first-slot table, the row sources'
// names and the host caches of shared-memory limits.
//
// Every histogram kernel computes the same function as the TPU kernels it
// replaces: each selected row adds (grad, hess, 1) to the cell (slot of its
// leaf, feature, bin); rows outside the selection and bins >= n_bins add
// nothing; the result is f32 [K, F, B, 4] with channel 3 zero, and a slot
// whose leaf id repeats an earlier slot's gets a copy of that slot's
// histogram.
//
// Modes (``MODE``).  Every mode sums integers, so the order in which blocks
// and atomics land cannot change a bit: the same inputs give the same
// histogram on every call.
//   0  int8 levels: grad/hess carry small integer levels; values go through
//      f32 -> i32 -> i8 exactly like the TPU kernels and sum in int32, so the
//      result is exact (one f32 rounding at exit);
//   1  float32: each value becomes a 64-bit fixed-point integer
//      round(v * 2^s) and sums in int64.  The power-of-two scale 2^s is
//      chosen per call and per channel on the device (fixed_shift of the
//      largest finite |value| of the pass keeps any sum of the pass's values
//      below 2^62), and each sum is rounded once to f32.  Integer-valued
//      inputs (and any value on the 2^-s grid) are summed exactly, so the
//      result is the correctly rounded exact sum;
//   2  bfloat16: values rounded to bf16 (as the TPU casts them), then as 1.
// Excluded rows are skipped before their grad/hess are read, so a NaN on an
// excluded row never enters a sum (the TPU kernels' where() masking); the
// scale ignores NaN and infinite values for the same reason.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <limits.h>
#include <stdint.h>

#include <mutex>

namespace {

constexpr int kLeafTable = 2048;  // leaf ids in [0, 2048) map via the table
constexpr int kFixedInts = kLeafTable + 4;  // table + use-table flag (+pad)
constexpr int kSMs = 132;         // H100 SXM

inline bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// The fixed-point exponent of one channel: at most n values of magnitude
// below 2^e (vmax < 2^e) scaled by 2^s sum to less than 2^62.
__device__ inline int fixed_shift(unsigned vmax_bits, long n) {
  const float vmax = __uint_as_float(vmax_bits);
  if (!(vmax > 0.0f)) return 0;
  int e;
  frexpf(vmax, &e);
  const int k = 64 - __clzll((unsigned long long)(n > 1 ? n : 1));  // n < 2^k
  return 62 - k - e;
}

// A mode's sum type and its conversion of a sum to f32 at the scale 2^s
// (cluster_hist.cuh Cvt converts the values in)
struct Fixed {
  typedef unsigned long long T;  // two's complement sums wrap correctly
  __device__ static float out(T v, int s) {
    return scalbnf(__ll2float_rn((long long)v), -s);
  }
};

template <int MODE>
struct Val;
template <>
struct Val<0> {
  typedef int T;
  __device__ static int cvt(float v, int) {
    return (int)(signed char)__float2int_rz(v);
  }
  __device__ static float out(int v, int) { return (float)v; }
};
template <>
struct Val<1> : Fixed {};
template <>
struct Val<2> : Fixed {};

// Largest finite |v| of v[0, n) as float bits into *out (zeroed by the
// caller; pass_scale, the strict grower's once-per-tree scale);
// non-negative floats order as their bit patterns, so an integer atomicMax
// finds it.
__global__ void absmax_kernel(const float* __restrict__ v, long n,
                              unsigned* __restrict__ out) {
  unsigned m = 0;
  for (long r = (long)blockIdx.x * blockDim.x + threadIdx.x; r < n;
       r += (long)gridDim.x * blockDim.x) {
    const float a = fabsf(v[r]);
    if (a <= FLT_MAX && __float_as_uint(a) > m) m = __float_as_uint(a);
  }
  for (int o = 16; o > 0; o >>= 1)
    m = max(m, __shfl_xor_sync(0xffffffffu, m, o));
  if ((threadIdx.x & 31) == 0 && m != 0) atomicMax(out, m);
}

int launch_absmax(const float* v, long n, unsigned* out, cudaStream_t s) {
  if (n <= 0) return 0;
  long want = (n + 255) / 256;
  int blocks = (int)(want < kSMs * 4L ? want : kSMs * 4L);
  absmax_kernel<<<blocks, 256, 0, s>>>(v, n, out);
  return (int)cudaGetLastError();
}

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

// Where a row's bins come from (masked.cuh's row sources)
enum { SRC_BYTES = 0,     // bins_t u8 [F, n]: one byte row per feature
       SRC_WORDS = 1,     // words_t i32 [W, n]: byte j of word w = feature 4w+j
       SRC_PAYLOAD = 2,   // payload i32 [S, W+3]: bin words, grad bits, hess
                          // bits, leaf id; rows at >= *cnt excluded
       SRC_ROWS = 3 };    // bins u8 [n, F] row-major: a row's F bytes

// Host side: the opt-in shared memory limit of the current device and the
// dynamic shared memory each kernel was last allowed, both cached, so a
// launch queries and sets nothing once a kernel has run at a size.
struct SmemCache {
  std::mutex mu;
  int optin[16] = {0};
  struct Entry {
    const void* fn;
    int dev;
    int bytes;
  } e[64];
  int used = 0;
};

inline SmemCache& smem_cache() {
  static SmemCache c;
  return c;
}

inline int optin_smem(int* optin) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  SmemCache& c = smem_cache();
  std::lock_guard<std::mutex> g(c.mu);
  if (dev < 16 && c.optin[dev] > 0) {
    *optin = c.optin[dev];
    return 0;
  }
  err = cudaDeviceGetAttribute(optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (err == cudaSuccess && dev < 16) c.optin[dev] = *optin;
  return (int)err;
}

// cudaFuncSetAttribute(fn, MaxDynamicSharedMemorySize) once per kernel,
// device and larger size
inline int allow_smem(const void* fn, size_t bytes) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  SmemCache& c = smem_cache();
  std::lock_guard<std::mutex> g(c.mu);
  int k = 0;
  for (; k < c.used; ++k)
    if (c.e[k].fn == fn && c.e[k].dev == dev) break;
  if (k < c.used && c.e[k].bytes >= (int)bytes) return 0;
  err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bytes);
  if (err != cudaSuccess) return (int)err;
  if (k == c.used) {
    if (c.used == 64) return 0;  // full: set again on every launch
    c.e[c.used++] = {fn, dev, (int)bytes};
  } else {
    c.e[k].bytes = (int)bytes;
  }
  return 0;
}

}  // namespace
