// The one-launch histograms of radix.cu (radix_single up to 131,072 rows),
// rows.cu and masked.cuh: Acc (a shared-memory plane of 64-bit sums on
// 32-bit native atomics) and Cvt (the fixed-point conversion with its
// scale taken once) serve all three; the rest serves the clusters of
// radix_single and masked.cuh, each covering every row: the blocks of a
// cluster find the float32 scale together (each block's max |value|,
// combined through distributed shared memory), sum their shared-memory
// histograms through distributed shared memory and write the f32 result
// themselves.  No global accumulator, no memset, no finalize kernel.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <utility>

#include "hist_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxCluster = 8;  // portable cluster size

// A block's shared accumulator of ``cells`` cells, plane by plane (the
// callers put the bin innermost, so the 32 lanes of a warp adding rows to
// random bins of one plane hit 32 banks): int32 cells in int8 mode, else
// 64-bit cells kept as a low-word array w[0, cells) and a high-word array
// w[cells, 2 cells).  On sm_90a a 64-bit shared atomicAdd compiles to a
// compare-and-swap loop (LDS.64 + ATOMS.CAST.SPIN.64); add() splits it into
// two native 32-bit ATOMS.ADD, the carry taken from the old low word the
// first returns.  The words hold the two's complement sum modulo 2^64, so
// the bits are those of a 64-bit add in any order.
template <int MODE>
struct Acc {
  typedef typename Val<MODE>::T T;
  static constexpr int kWords = MODE == 0 ? 1 : 2;
  unsigned* w;
  int cells;
  __device__ void add(int i, T v) const {
    if (MODE == 0) {
      atomicAdd(reinterpret_cast<int*>(w) + i, (int)v);
    } else {
      const unsigned lo = (unsigned)v;
      const unsigned old = atomicAdd(w + i, lo);
      const unsigned hi = (unsigned)((unsigned long long)v >> 32) +
                          (old + lo < old ? 1u : 0u);
      if (hi) atomicAdd(w + cells + i, hi);
    }
  }
  // +1: the low word only, exact below 2^32 adds (the wrappers refuse
  // n >= 2^31)
  __device__ void inc(int i) const { atomicAdd(w + i, 1u); }
  __device__ T get(const unsigned* ws, int i) const {
    if (MODE == 0) return (T)(int)ws[i];
    return (T)((unsigned long long)ws[cells + i] << 32 | ws[i]);
  }
  __device__ void set(int i, T v) const {
    w[i] = (unsigned)v;
    if (MODE != 0) w[cells + i] = (unsigned)((unsigned long long)v >> 32);
  }
};

// A value into its mode's sum type, the scale taken once, f = 2^s: int8
// levels through f32 -> i32 -> i8 (Val<0>::cvt); float32 (bfloat16 after
// rounding to bf16) as round((double)v * f), which is scalbn((double)v, s)
// rounded, exactly (2^s and the product are normal doubles for every s
// fixed_shift gives).
template <int MODE>
struct Cvt {
  typedef typename Val<MODE>::T T;
  double f;
  __device__ T operator()(float v) const {
    if (MODE == 0) return Val<0>::cvt(v, 0);
    const float x = MODE == 2 ? __bfloat162float(__float2bfloat16_rn(v)) : v;
    return (T)__double2ll_rn((double)x * f);
  }
};

// Largest finite |a| and |b| of rows [r0, r1) as float bits, into out[0]
// and out[1] (shared words, zeroed and synced by the caller) with warp and
// shared atomic maxima.  VEC = 4: r0 and r1 multiples of 4, a and b
// 16-byte aligned; both arrays' loads of a step in flight at once.
template <int VEC>
__device__ inline void block_absmax2(const float* __restrict__ a,
                                     const float* __restrict__ b, long r0,
                                     long r1, unsigned* out) {
  unsigned m[2] = {0u, 0u};
  for (long r = r0 + VEC * threadIdx.x; r < r1;
       r += (long)VEC * blockDim.x) {
    float x[2][4];
    if (VEC == 4) {
      const float4 p = *reinterpret_cast<const float4*>(a + r);
      const float4 q = *reinterpret_cast<const float4*>(b + r);
      x[0][0] = p.x, x[0][1] = p.y, x[0][2] = p.z, x[0][3] = p.w;
      x[1][0] = q.x, x[1][1] = q.y, x[1][2] = q.z, x[1][3] = q.w;
    } else {
      x[0][0] = a[r];
      x[1][0] = b[r];
    }
#pragma unroll
    for (int k = 0; k < 2; ++k)
#pragma unroll
      for (int u = 0; u < VEC; ++u) {
        const float y = fabsf(x[k][u]);
        if (y <= FLT_MAX && __float_as_uint(y) > m[k])
          m[k] = __float_as_uint(y);
      }
  }
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const unsigned y = __reduce_max_sync(0xffffffffu, m[k]);
    if ((threadIdx.x & 31) == 0 && y != 0) atomicMax(out + k, y);
  }
}

// The cluster-wide maximum of word ``i`` of every block's ``part`` (after
// a cluster barrier that published them)
__device__ inline unsigned cluster_max(cg::cluster_group& cl, unsigned* part,
                                       int i) {
  unsigned m = 0;
  for (unsigned q = 0; q < cl.num_blocks(); ++q)
    m = max(m, cl.map_shared_rank(part, q)[i]);
  return m;
}

// After a cluster barrier: block q of the cluster takes its share of the
// n_out outputs; output o sums accumulator cell cell_of(o) (< 0: none) of
// every block's ``acc`` and ``write(o, sum)`` stores it.  A remote read
// costs a long round trip, so every read a thread makes is issued before
// any is used: ``g`` lanes (a power of two, as many as the block has
// threads for) share an output, each reading kMaxCluster / g blocks, and
// add up by shuffles.  The block size must be a multiple of 32.
template <int MODE, typename CellOf, typename Write>
__device__ inline void cluster_write(cg::cluster_group& cl,
                                     const Acc<MODE>& acc, int n_out,
                                     CellOf cell_of, Write write) {
  typedef typename Val<MODE>::T T;
  const int nb = (int)cl.num_blocks();
  const int share = (n_out + nb - 1) / nb;
  const int o0 = (int)cl.block_rank() * share;
  const int o1 = min(n_out, o0 + share);
  int g = kMaxCluster;
  while (g > 1 && share * g > (int)blockDim.x) g >>= 1;
  const int lane = threadIdx.x % g;
  const int per = (share * g + blockDim.x - 1) / blockDim.x;  // steps
  for (int step = 0; step < per; ++step) {
    const int o = o0 + (step * (int)blockDim.x + (int)threadIdx.x) / g;
    const int c = o < o1 ? cell_of(o) : -1;
    T part[kMaxCluster];
#pragma unroll
    for (int k = 0; k < kMaxCluster; ++k) {
      const int q = lane + k * g;
      part[k] = 0;
      if (q < nb && k * g < kMaxCluster && c >= 0)
        part[k] = acc.get(cl.map_shared_rank(acc.w, q), c);
    }
    T v = 0;
#pragma unroll
    for (int k = 0; k < kMaxCluster; ++k) v += part[k];
    for (int m = 1; m < g; m <<= 1) v += __shfl_xor_sync(0xffffffffu, v, m);
    if (lane == 0 && o < o1) write(o, v);
  }
}

// The launch of ``kernel`` over ``grid`` as clusters of (1, grid.y, 1)
// (attr: storage for the cluster attribute)
inline cudaLaunchConfig_t cluster_config(dim3 grid, int threads, size_t smem,
                                         cudaStream_t s,
                                         cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = 1;
  attr->val.clusterDim.y = grid.y;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Launch ``kernel`` over ``grid`` as clusters of (1, grid.y, 1)
template <typename... Args, typename... Act>
int launch_clusters(void (*kernel)(Args...), dim3 grid, int threads,
                    size_t smem, cudaStream_t s, Act&&... args) {
  int err = allow_smem(reinterpret_cast<const void*>(kernel), smem);
  if (err) return err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(grid, threads, smem, s, &attr);
  err = (int)cudaLaunchKernelEx(&cfg, kernel, std::forward<Act>(args)...);
  if (err) return err;
  return (int)cudaGetLastError();
}

}  // namespace
