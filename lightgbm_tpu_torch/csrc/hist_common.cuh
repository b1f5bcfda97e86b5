// Shared core of the masked (grad, hess, count) histogram kernels of
// hist.cu, radix.cu and packed.cu.
//
// Every kernel computes the same function as the TPU kernels it replaces:
// each selected row adds (grad, hess, 1) to the cell (slot of its leaf,
// feature, bin); rows outside the selection and bins >= n_bins add nothing;
// the result is f32 [K, F, B, 4] with channel 3 zero, and a slot whose leaf
// id repeats an earlier slot's gets a copy of that slot's histogram.
//
// Design (the reference CUDA learner's, cuda_histogram_constructor.cu): a
// block owns (a group of features, a chunk of rows, a group of slots) and
// keeps its [copies][slots][features][B][3] accumulator in shared memory.
// Each selected row is added with shared atomics; at the end the copies are
// summed and the non-zero cells go to a global [K, F, B, 3] accumulator with
// global atomics.  A second kernel converts that to f32 and copies repeated
// slots.  Several features per block read a row's leaf, grad and hess once
// for all of them; several private copies (one per group of warps) spread
// rows that hit the same cell over several addresses.
//
// Modes (``MODE``):
//   0  int8 levels: grad/hess carry small integer levels; values go through
//      f32 -> i32 -> i8 exactly like the TPU kernels and sum in int32, so the
//      result is exact and deterministic (one f32 rounding at exit);
//   1  float32: f32 shared and global atomics.  The summation order changes
//      from run to run, so this mode is deterministic only on integer-valued
//      inputs (exact sums below 2^24);
//   2  bfloat16: values rounded to bf16 (as the TPU casts them), f32 sums as
//      in mode 1.
// Excluded rows are skipped before their grad/hess are read, so a NaN on an
// excluded row never enters a sum (the TPU kernels' where() masking).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kLeafTable = 2048;  // leaf ids in [0, 2048) map via the table
constexpr int kThreads = 1024;
constexpr int kFixedInts = kLeafTable + 4;  // table + use-table flag (+pad)
constexpr int kFewSlots = 4;      // SEL_FEW keeps up to 4 leaf ids in registers
constexpr int kSMs = 132;         // H100 SXM

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

// How a row finds its slot
enum { SEL_ROOT = 0,    // slot 0 when leaf_of_row >= 0 (the root pass)
       SEL_FEW = 1,     // first of K <= kFewSlots leaf ids, in registers
       SEL_TABLE = 2 };  // the leaf -> first-slot table in shared memory
// Where a row's bins come from
enum { SRC_BYTES = 0,     // bins_t u8 [F, n]: one byte row per feature
       SRC_WORDS = 1,     // words_t i32 [W, n]: byte j of word w = feature 4w+j
       SRC_PAYLOAD = 2 };  // payload i32 [n, W+3]: bin words, grad bits, hess
                           // bits, leaf id; rows at >= *cnt excluded

struct Task {
  const uint8_t* bins_t;  // SRC_BYTES
  const int* words_t;     // SRC_WORDS
  long n;
  int num_f;
  const float* grad;
  const float* hess;
  const int* lor;
  const int* leaves;  // null for SEL_ROOT
  int K;
  int n_bins;
  int fpb;     // features per block (SRC_WORDS: 4, one word)
  int spg;     // slots per block (the slot group)
  int copies;  // private accumulator copies
  long rows_per_chunk;
  const int* payload;  // SRC_PAYLOAD (grad, hess, lor unused)
  int W;               // SRC_PAYLOAD: bin words per row
  const int* cnt;      // SRC_PAYLOAD: rows in use, read on the device
};

// One block's share: features [f0, f0+fpb) x rows of chunk blockIdx.y x
// slots of group blockIdx.z, flushed into glob [K, F, B, 3].
template <int MODE, int SEL, int SRC>
__device__ inline void hist_block(const Task& t,
                                  typename Val<MODE>::T* __restrict__ glob) {
  typedef typename Val<MODE>::T T;
  extern __shared__ __align__(16) unsigned char smem[];
  int* tab = reinterpret_cast<int*>(smem);
  int* use_tab = tab + kLeafTable;
  T* acc = reinterpret_cast<T*>(
      smem + (SEL == SEL_TABLE ? kFixedInts * sizeof(int) : 0));
  const int f0 = blockIdx.x * t.fpb;
  const int nf = min(t.fpb, t.num_f - f0);
  const long limit =
      SRC == SRC_PAYLOAD ? min(t.n, (long)max(*t.cnt, 0)) : t.n;
  const long r0 = (long)blockIdx.y * t.rows_per_chunk;
  const long r1 = min(limit, r0 + t.rows_per_chunk);
  const int k0 = blockIdx.z * t.spg;
  const int ns = min(t.K - k0, t.spg);
  const int cell = t.n_bins * 3;
  const int slot_stride = t.fpb * cell;
  const int per_copy = ns * slot_stride;
  for (int i = threadIdx.x; i < t.copies * per_copy; i += blockDim.x)
    acc[i] = (T)0;
  int few[kFewSlots];
  if (SEL == SEL_FEW) {
#pragma unroll
    for (int j = 0; j < kFewSlots; ++j) few[j] = j < t.K ? t.leaves[j] : -1;
  }
  int ut = 0;
  if (SEL == SEL_TABLE) {
    build_slot_table(tab, use_tab, t.leaves, t.K);  // syncs the zeroing too
    ut = *use_tab;
  } else {
    __syncthreads();
  }
  T* a = acc + ((threadIdx.x >> 5) % t.copies) * per_copy;
  for (long r = r0 + threadIdx.x; r < r1; r += blockDim.x) {
    const int* prow = SRC == SRC_PAYLOAD ? t.payload + r * (t.W + 3) : nullptr;
    const int l = SRC == SRC_PAYLOAD ? prow[t.W + 2] : t.lor[r];
    int k;
    if (SEL == SEL_ROOT) {
      k = l >= 0 ? 0 : -1;
    } else if (SEL == SEL_FEW) {
      k = -1;
#pragma unroll
      for (int j = kFewSlots - 1; j >= 0; --j)
        if (j < t.K && few[j] == l) k = j;  // the first matching slot
    } else {
      k = slot_of(l, tab, ut, t.leaves, t.K);
    }
    k -= k0;
    if (k < 0 || k >= ns) continue;
    const float g = SRC == SRC_PAYLOAD ? __int_as_float(prow[t.W]) : t.grad[r];
    const float h =
        SRC == SRC_PAYLOAD ? __int_as_float(prow[t.W + 1]) : t.hess[r];
    T* as = a + k * slot_stride;
    if (SRC == SRC_PAYLOAD) {
      for (int j = 0; j < nf; ++j) {
        const int f = f0 + j;
        const int b = (prow[f >> 2] >> ((f & 3) * 8)) & 255;
        if (b < t.n_bins) add_row<MODE>(as, j, b, t.n_bins, g, h);
      }
    } else if (SRC == SRC_WORDS) {
      const unsigned w = (unsigned)t.words_t[(long)(f0 >> 2) * t.n + r];
      for (int j = 0; j < nf; ++j) {
        const int b = (w >> (8 * j)) & 255;
        if (b < t.n_bins) add_row<MODE>(as, j, b, t.n_bins, g, h);
      }
    } else {
      for (int j = 0; j < nf; ++j) {
        const int b = t.bins_t[(long)(f0 + j) * t.n + r];
        if (b < t.n_bins) add_row<MODE>(as, j, b, t.n_bins, g, h);
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < per_copy; i += blockDim.x) {
    T v = acc[i];
    for (int c = 1; c < t.copies; ++c) v += acc[c * per_copy + i];
    if (v == (T)0) continue;
    const int s = i / slot_stride;
    const int rem = i - s * slot_stride;
    const int j = rem / cell;
    if (j >= nf) continue;
    atomicAdd(glob + ((long)(k0 + s) * t.num_f + f0 + j) * cell + rem -
                  j * cell,
              v);
  }
}

// glob [K, F, B, 3] -> out f32 [K, F, B, 4]; repeated slots copy the first
// (leaves may be null: no repeats)
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
    int kf = k;
    if (leaves != nullptr) {
      int l = leaves[k];
      for (int j = 0; j < k; ++j) {
        if (leaves[j] == l) {
          kf = j;
          break;
        }
      }
    }
    const T* src = glob + ((long)kf * per + rem) * 3;
    out[i] = make_float4((float)src[0], (float)src[1], (float)src[2], 0.0f);
  }
}

template <typename T>
int launch_finalize(const T* glob, const int* leaves, int K, int num_f,
                    int n_bins, float* out, cudaStream_t s) {
  long total = (long)K * num_f * n_bins;
  if (total <= 0) return 0;
  long want = (total + 255) / 256;
  int blocks = (int)(want < kSMs * 32L ? want : kSMs * 32L);
  finalize_kernel<T><<<blocks, 256, 0, s>>>(glob, leaves, K, num_f, n_bins,
                                            reinterpret_cast<float4*>(out));
  return (int)cudaGetLastError();
}

long plan_chunks(long rows, int blocks_per_chunk) {
  // about four waves of one-block-per-SM over the SMs, >= 1024 rows each
  long want = (4L * kSMs + blocks_per_chunk - 1) / blocks_per_chunk;
  long most = (rows + 1023) / 1024;
  if (want > most) want = most;
  if (want < 1) want = 1;
  if (want > 65535) want = 65535;
  return want;
}

// Shape of a hist_block launch: the most features per block (up to
// fpb_max; exactly fpb_max when fixed) whose accumulator for all K slots
// fits the opt-in shared memory, else one feature group with the slots
// split into groups.
struct Plan {
  int fpb, spg, fgroups, sgroups;
  size_t smem;
};

int plan_blocks(int K, int num_f, int n_bins, size_t elem, int fpb_max,
                bool fixed, int copies, size_t fixed_bytes, Plan* p) {
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev);
  if (e != cudaSuccess) return (int)e;
  const size_t cell = (size_t)n_bins * 3 * elem * copies;
  int lo = fixed ? fpb_max : 1;
  for (int f = fpb_max; f >= lo; --f) {
    size_t need = fixed_bytes + (size_t)K * f * cell;
    if (need <= (size_t)optin) {
      p->fpb = f;
      p->spg = K;
      p->sgroups = 1;
      p->smem = need;
      p->fgroups = (num_f + f - 1) / f;
      return 0;
    }
  }
  const int f = lo;
  const size_t per_slot = (size_t)f * cell;
  if ((size_t)optin < fixed_bytes + per_slot) return (int)cudaErrorInvalidValue;
  int spg = (int)(((size_t)optin - fixed_bytes) / per_slot);
  int groups = (K + spg - 1) / spg;
  p->fpb = f;
  p->spg = (K + groups - 1) / groups;
  p->sgroups = groups;
  p->smem = fixed_bytes + (size_t)p->spg * per_slot;
  p->fgroups = (num_f + f - 1) / f;
  return 0;
}

// Plan, launch ``kernel`` (a __global__ wrapper of hist_block) over the
// zero-filled global accumulator ``scratch`` and finalize into ``out``.
template <typename T, typename Kernel>
int run_hist(Kernel kernel, Task t, int fpb_max, bool fpb_fixed, int copies,
             bool table, void* scratch, float* out, cudaStream_t s) {
  T* glob = reinterpret_cast<T*>(scratch);
  if (t.n > 0 && t.K > 0 && t.num_f > 0) {
    Plan p;
    int err = plan_blocks(t.K, t.num_f, t.n_bins, sizeof(T), fpb_max,
                          fpb_fixed, copies,
                          table ? kFixedInts * sizeof(int) : 0, &p);
    if (err) return err;
    err = (int)cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.smem);
    if (err) return err;
    const long chunks = plan_chunks(t.n, p.fgroups * p.sgroups);
    t.fpb = p.fpb;
    t.spg = p.spg;
    t.copies = copies;
    t.rows_per_chunk = (t.n + chunks - 1) / chunks;
    dim3 grid(p.fgroups, (unsigned)chunks, p.sgroups);
    kernel<<<grid, kThreads, p.smem, s>>>(t, glob);
    err = (int)cudaGetLastError();
    if (err) return err;
  }
  return launch_finalize<T>(glob, t.leaves, t.K, t.num_f, t.n_bins, out, s);
}

}  // namespace
