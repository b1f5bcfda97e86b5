// The forest predictor: every tree of a model over a block of rows.
//
// Replaces the JAX package's lightgbm_tpu/models/predict.py
// predict_numeric_forest, predict_bitset_forest and predict_forest_leaves
// (XLA programs, no pallas_call).  Those match rows to leaves by counting
// path conditions with two [L, ni] x [ni, n] products a tree, because a
// gather is the TPU's slowest primitive.  On Hopper a row walks its trees
// directly: one thread owns a row and walks the trees in model order, a
// node going left when `bin == nan_bin ? default_left : bin <= threshold`
// (a categorical node when its membership table holds the bin), until a
// child is a leaf (`-(leaf + 1)`, the model text's encoding; an empty tree's
// -1 children send every row to leaf 0).  The leaf is the one the path
// count selects, an exact integer, so:
//   values mode adds value[t, leaf] into one float32 register per class,
//     the class's trees in model order (the plain version's `out[:, cls] +=`
//     sequence, so the bits are the same), and writes out[n, k] once;
//   leaves mode writes leaves[t, n] (i32), equal to the plain version's.
//
// A block of 256 threads takes 256 rows.  Their bins are staged once into
// shared memory as one int per (feature, row) (coalesced loads from the
// feature-major bins_t [F, ld]; a thread then reads its own column, no bank
// conflicts); each tree's nodes (int4 {feature, threshold, left, right} and
// int2 {nan bin, flags}: bit 0 default-left, bits 1.. categorical slot + 1)
// and its categorical membership bytes [C, Bc] are staged in shared memory
// before the block walks it.  Wider data (F > 96) or larger trees read the
// same tables from device memory instead.
//
// Linear leaves (values mode, the JAX package's LinearLeaves extension of
// predict_bitset_forest): when the leaf-linear tables are given, a leaf with
// features outputs const + sum_j coeff_j x_j over its features in index
// order (each product rounded, then each sum: the plain version's
// additions in its order, so the bits stay the same), x read from the
// feature-major raw values raw_t [Fr, ldr] (NaN as 0, +-inf as the largest
// float); a row with a NaN in one of the leaf's features, and a leaf with
// no feature, outputs the plain leaf value.
//
// Bound on the H100: operations, not bytes.  The bins (n F bytes), the
// output (4 n k) and the forest are read or written once (~32 MB at
// n = 1M, F = 28, k = 1: 0.01 ms at 3.35 TB/s); the walk is n T depth
// dependent node steps (~1e9 at 1M rows x 100 trees of 255 leaves), each a
// few shared-memory loads, a compare and a branch.

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kRows = 256;            // rows (threads) of a block
constexpr int kStageBinsMaxF = 96;    // features staged: 96 KB of ints
constexpr long kStageNodesMax = 96 * 1024;  // bytes of one staged tree

template <typename BinT>
__global__ void __launch_bounds__(kRows)
    forest_kernel(const BinT* __restrict__ bins, long n, long ld, int F,
                  int stage_bins, const int4* __restrict__ nodes,
                  const int2* __restrict__ meta, int T, int ni,
                  int stage_nodes, const unsigned char* __restrict__ catb,
                  int C, int Bc, const float* __restrict__ value, int L,
                  const int* __restrict__ cls, int k,
                  const float* __restrict__ raw_t, long ldr,
                  const int* __restrict__ lin_feat,
                  const float* __restrict__ lin_coef,
                  const float* __restrict__ lin_const, int Kl,
                  float* __restrict__ out_values,
                  int* __restrict__ out_leaves) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* s_bins = reinterpret_cast<int*>(smem);
  const size_t bins_bytes = stage_bins ? (size_t)F * kRows * sizeof(int) : 0;
  int4* s_nodes = reinterpret_cast<int4*>(smem + bins_bytes);
  int2* s_meta = reinterpret_cast<int2*>(smem + bins_bytes + (size_t)ni * 16);
  unsigned char* s_catb = smem + bins_bytes + (size_t)ni * 24;

  const long r = (long)blockIdx.x * kRows + threadIdx.x;
  const bool live = r < n;
  if (stage_bins) {
    // each thread reads back only its own column: no barrier needed
    for (int f = 0; f < F; ++f)
      s_bins[f * kRows + threadIdx.x] = live ? (int)bins[f * ld + r] : 0;
  }
  const int passes = out_values != nullptr ? k : 1;
  for (int c = 0; c < passes; ++c) {
    float acc = 0.0f;
    for (int t = 0; t < T; ++t) {
      if (out_values != nullptr && __ldg(cls + t) != c) continue;  // uniform
      const int4* tn = nodes + (long)t * ni;
      const int2* tm = meta + (long)t * ni;
      const unsigned char* tc = catb + (long)t * C * Bc;
      if (stage_nodes) {
        __syncthreads();  // the last tree's readers are done with it
        for (int i = threadIdx.x; i < ni; i += kRows) {
          s_nodes[i] = __ldg(tn + i);
          s_meta[i] = __ldg(tm + i);
        }
        for (int i = threadIdx.x; i < C * Bc; i += kRows)
          s_catb[i] = __ldg(tc + i);
        __syncthreads();
        tn = s_nodes;
        tm = s_meta;
        tc = s_catb;
      }
      if (!live) continue;
      int node = 0, leaf = 0;
      for (int step = 0; step < ni; ++step) {
        const int4 nd = tn[node];
        const int2 mt = tm[node];
        const int f = min(max(nd.x, 0), F - 1);
        const int b = stage_bins ? s_bins[f * kRows + threadIdx.x]
                                 : (int)bins[f * ld + r];
        const int slot = (mt.y >> 1) - 1;
        bool left;
        if (slot >= 0)
          left = (unsigned)b < (unsigned)Bc && tc[slot * Bc + b] != 0;
        else
          left = b == mt.x ? (mt.y & 1) != 0 : b <= nd.y;
        const int child = left ? nd.z : nd.w;
        if (child < 0) {
          leaf = -child - 1;
          break;
        }
        if (child >= ni) break;  // not a tree: leaf 0
        node = child;
      }
      if (out_values != nullptr) {
        float v = __ldg(value + (long)t * L + leaf);
        if (lin_feat != nullptr) {
          const long base = ((long)t * L + leaf) * Kl;
          if (__ldg(lin_feat + base) >= 0) {
            float lacc = 0.0f;
            bool bad = false;
            for (int j = 0; j < Kl; ++j) {
              const int f = __ldg(lin_feat + base + j);
              if (f < 0) break;
              float x = raw_t[(long)f * ldr + r];
              bad |= isnan(x);
              if (isnan(x)) x = 0.0f;
              else if (isinf(x)) x = x > 0.0f ? FLT_MAX : -FLT_MAX;
              lacc = __fadd_rn(lacc,
                               __fmul_rn(__ldg(lin_coef + base + j), x));
            }
            if (!bad)
              v = __fadd_rn(lacc, __ldg(lin_const + (long)t * L + leaf));
          }
        }
        acc = __fadd_rn(acc, v);
      } else
        out_leaves[(long)t * n + r] = leaf;
    }
    if (out_values != nullptr && live) out_values[r * k + c] = acc;
  }
}

template <typename BinT>
int launch(const BinT* bins, long n, long ld, int F, const int4* nodes,
           const int2* meta, int T, int ni, const unsigned char* catb, int C,
           int Bc, const float* value, int L, const int* cls, int k,
           const float* raw_t, long ldr, const int* lin_feat,
           const float* lin_coef, const float* lin_const, int Kl,
           float* out_values, int* out_leaves, cudaStream_t stream) {
  const int stage_bins = F <= kStageBinsMaxF;
  const long tree_bytes = (long)ni * 24 + (long)C * Bc;
  const int stage_nodes = tree_bytes <= kStageNodesMax;
  const size_t smem = (stage_bins ? (size_t)F * kRows * sizeof(int) : 0) +
                      (stage_nodes ? (size_t)tree_bytes : 0);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        forest_kernel<BinT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const long blocks = (n + kRows - 1) / kRows;
  forest_kernel<BinT><<<(unsigned)blocks, kRows, smem, stream>>>(
      bins, n, ld, F, stage_bins, nodes, meta, T, ni, stage_nodes, catb, C,
      Bc, value, L, cls, k, raw_t, ldr, lin_feat, lin_coef, lin_const, Kl,
      out_values, out_leaves);
  return (int)cudaGetLastError();
}

}  // namespace

// bins: u8 (bins_i32 = 0) or i32 [F, ld] feature-major, rows [0, n) used;
// nodes i32 [T, ni, 4], meta i32 [T, ni, 2], catb u8 [T, C, Bc] (C may be
// 0), value f32 [T, L], cls i32 [T].  Exactly one of out_values (f32
// [n, k]) and out_leaves (i32 [T, n]) is given.  Linear leaves (values mode;
// lin_feat null: none): raw_t f32 [Fr, ldr] feature-major raw values, rows
// [0, n); lin_feat i32 [T, L, Kl] each leaf's raw columns in increasing
// order, -1 after the last (-1 first: no feature); lin_coef f32 [T, L, Kl];
// lin_const f32 [T, L].
extern "C" int lgbt_forest(const void* bins, int bins_i32, long n, long ld,
                           int F, const int* nodes, const int* meta, int T,
                           int ni, const unsigned char* catb, int C, int Bc,
                           const float* value, int L, const int* cls, int k,
                           const float* raw_t, long ldr, const int* lin_feat,
                           const float* lin_coef, const float* lin_const,
                           int Kl, float* out_values, int* out_leaves,
                           void* stream) {
  if (n <= 0) return 0;
  const int4* n4 = reinterpret_cast<const int4*>(nodes);
  const int2* m2 = reinterpret_cast<const int2*>(meta);
  cudaStream_t s = (cudaStream_t)stream;
  if (bins_i32)
    return launch(static_cast<const int*>(bins), n, ld, F, n4, m2, T, ni,
                  catb, C, Bc, value, L, cls, k, raw_t, ldr, lin_feat,
                  lin_coef, lin_const, Kl, out_values, out_leaves, s);
  return launch(static_cast<const unsigned char*>(bins), n, ld, F, n4, m2, T,
                ni, catb, C, Bc, value, L, cls, k, raw_t, ldr, lin_feat,
                lin_coef, lin_const, Kl, out_values, out_leaves, s);
}
