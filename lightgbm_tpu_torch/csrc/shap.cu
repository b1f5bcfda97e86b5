// TreeSHAP's slot recurrences: one tree's SHAP values of a chunk of rows.
//
// Replaces the JAX package's lightgbm_tpu/models/shap.py _phi_slots and
// its "nls,lsf->nf" contraction (a jitted XLA program, no pallas_call).
// That program steps all (row, leaf) pairs at once through O(S^2) array
// operations; as plain PyTorch on the card that is ~10 launches a step.
// Here one thread owns one (row, leaf) and runs the whole recurrence on its
// own path state:
//   o[s]   the one-fraction of slot s: the AND of the row's decisions
//          (go-left bytes gl[row, node]) along the slot's edges, from the
//          tree's edge table (slot_ptr, edge_node, edge_dir); the host
//          copies gl [n, ni] (ni bytes a row) instead of o [n, L, S];
//   p[0..S] the extend recurrence over the leaf's D = m[l] slots, in
//          registers for S <= 8, 16 or 32 (one template each), in a global
//          scratch [n, L, S + 1] above;
//   then each slot's unwound sum and its contribution (o - z) w v.
// A block takes one row: its leaves' contributions go to shared memory
// [L, S] (global scratch when that is too large), then thread f sums
// column f's slots in the fixed order of the tree's column table (col_ptr,
// col_idx: by feature, then leaf, then slot) and writes phi[row, f].  No
// float atomics: every run gives the same bits.  The arithmetic is the
// plain version's, operation for operation, with correctly rounded
// multiplies, adds and divides (__fmul_rn and friends, never contracted),
// and the extend's coefficients come from the same float32 tables (ck, cs
// [S, S + 1]); only the final sum's order differs from the plain einsum.
//
// Bound on the H100: operations.  n L (S^2 + S) multiply-adds for a chunk
// (the extend ~S^2 / 2, the unwound sums ~S^2 / 2 and more for each slot);
// the bytes are small (gl n ni, phi 4 n (F + 1)).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kFlagCoef = 1;     // ck / cs staged in shared memory
constexpr int kFlagContrib = 2;  // the [L, S] contributions in shared memory
constexpr int kFlagGl = 4;       // the row's go-left bytes in shared memory

template <int N>
struct PReg {  // path state in registers (loops over it fully unrolled)
  float v[N];
  __device__ float& operator[](int i) { return v[i]; }
};

struct PMem {  // path state in global scratch
  float* ptr;
  __device__ float& operator[](int i) { return ptr[i]; }
};

struct Row {
  const unsigned char* gl;  // the row's go-left bytes [ni]
  const int* slot_ptr;      // [L S + 1] edge range of each flat slot
  const int* edge_node;
  const unsigned char* edge_dir;
};

// the one-fraction (0 or 1) of flat slot q: its edges all toward the leaf
__device__ inline float one_fraction(const Row& rw, int q) {
  const int e1 = __ldg(rw.slot_ptr + q + 1);
  bool ok = true;
  for (int e = __ldg(rw.slot_ptr + q); e < e1; ++e)
    ok &= (rw.gl[__ldg(rw.edge_node + e)] != 0) == (__ldg(rw.edge_dir + e) != 0);
  return ok ? 1.0f : 0.0f;
}

// leaf l's slot contributions: contrib[s] for s < m[l]
template <int SMAX, class P>
__device__ void leaf_slots(P& p, const Row& rw, int l, int S,
                           const float* __restrict__ z, int D, float v,
                           const float* ck, const float* cs, float* contrib) {
  constexpr bool kReg = SMAX > 0;
  const int SB = kReg ? SMAX : S;
  const float* zl = z + (long)l * S;
  const int q0 = l * S;
#pragma unroll
  for (int pos = 0; pos <= SB; ++pos) p[pos] = pos == 0 ? 1.0f : 0.0f;
  // extend: p_new[pos] = (z p[pos]) ck[pos] + (o p[pos - 1]) cs[pos] for
  // pos <= d = j + 1 (higher positions stay exactly 0), descending so
  // p[pos - 1] is still the old value
#pragma unroll 1
  for (int j = 0; j < D; ++j) {
    const float zj = __ldg(zl + j);
    const float oj = one_fraction(rw, q0 + j);
    const float* ckj = ck + j * (S + 1);
    const float* csj = cs + j * (S + 1);
#pragma unroll
    for (int pos = SB; pos >= 0; --pos) {
      if (pos <= j + 1) {
        const float prev = pos > 0 ? p[pos > 0 ? pos - 1 : 0] : 0.0f;
        p[pos] = __fadd_rn(__fmul_rn(__fmul_rn(zj, p[pos]), ckj[pos]),
                           __fmul_rn(__fmul_rn(oj, prev), csj[pos]));
      }
    }
  }
  float pD = 0.0f;
#pragma unroll
  for (int pos = 0; pos <= SB; ++pos)
    if (pos == D) pD = p[pos];
  const float Dp1 = (float)(D + 1);
  // the unwound path sum of each slot i, positions jj = D - 1 .. 0
#pragma unroll 1
  for (int i = 0; i < D; ++i) {
    const float oi = one_fraction(rw, q0 + i);
    const float zi = __ldg(zl + i);
    const bool one = oi > 0.5f;
    float nxt = pD, tot = 0.0f;
#pragma unroll
    for (int jj = SB - 1; jj >= 0; --jj) {
      if (jj < D) {
        const float tmp = __fdiv_rn(__fmul_rn(nxt, Dp1), (float)(jj + 1));
        float step;
        if (one) {
          step = tmp;
          nxt = __fsub_rn(p[jj],
                          __fmul_rn(__fmul_rn(tmp, zi),
                                    __fdiv_rn((float)(D - jj), Dp1)));
        } else {
          step = __fmul_rn(__fdiv_rn(p[jj], zi),
                           __fdiv_rn(Dp1, fmaxf((float)(D - jj), 0.5f)));
        }
        tot = __fadd_rn(tot, step);
      }
    }
    contrib[q0 + i] = __fmul_rn(__fmul_rn(__fsub_rn(oi, zi), tot), v);
  }
}

template <int SMAX>
__global__ void shap_kernel(const unsigned char* __restrict__ gl, int ni,
                            const int* __restrict__ slot_ptr,
                            const int* __restrict__ edge_node,
                            const unsigned char* __restrict__ edge_dir,
                            const float* __restrict__ z,
                            const int* __restrict__ m,
                            const float* __restrict__ values, int L, int S,
                            const float* __restrict__ ck,
                            const float* __restrict__ cs,
                            const int* __restrict__ col_ptr,
                            const int* __restrict__ col_idx, int F1,
                            int flags, float* __restrict__ c_scratch,
                            float* __restrict__ p_scratch,
                            float* __restrict__ phi) {
  extern __shared__ __align__(16) unsigned char smem[];
  const long row = blockIdx.x;
  const int coef_n = (flags & kFlagCoef) ? S * (S + 1) : 0;
  const int contrib_n = (flags & kFlagContrib) ? L * S : 0;
  float* s_ck = reinterpret_cast<float*>(smem);
  float* s_cs = s_ck + coef_n;
  float* s_contrib = s_cs + coef_n;
  unsigned char* s_gl = reinterpret_cast<unsigned char*>(s_contrib + contrib_n);

  const unsigned char* grow = gl + row * (long)ni;
  for (int i = threadIdx.x; i < coef_n; i += blockDim.x) {
    s_ck[i] = __ldg(ck + i);
    s_cs[i] = __ldg(cs + i);
  }
  if (flags & kFlagGl)
    for (int i = threadIdx.x; i < ni; i += blockDim.x) s_gl[i] = __ldg(grow + i);
  __syncthreads();
  const float* CK = coef_n ? s_ck : ck;
  const float* CS = coef_n ? s_cs : cs;
  float* contrib = contrib_n ? s_contrib : c_scratch + row * (long)L * S;
  const Row rw{(flags & kFlagGl) ? s_gl : grow, slot_ptr, edge_node, edge_dir};

  for (int l = threadIdx.x; l < L; l += blockDim.x) {
    const int D = __ldg(m + l);
    if (D <= 0) continue;
    if constexpr (SMAX > 0) {
      PReg<SMAX + 1> p;
      leaf_slots<SMAX>(p, rw, l, S, z, D, __ldg(values + l), CK, CS, contrib);
    } else {
      PMem p{p_scratch + (row * L + l) * (long)(S + 1)};
      leaf_slots<0>(p, rw, l, S, z, D, __ldg(values + l), CK, CS, contrib);
    }
  }
  __syncthreads();
  for (int f = threadIdx.x; f < F1; f += blockDim.x) {
    float acc = 0.0f;
    const int q1 = __ldg(col_ptr + f + 1);
    for (int q = __ldg(col_ptr + f); q < q1; ++q)
      acc = __fadd_rn(acc, contrib[__ldg(col_idx + q)]);
    phi[row * F1 + f] = acc;
  }
}

template <int SMAX>
int launch(long n, int threads, size_t smem, cudaStream_t stream,
           const unsigned char* gl, int ni, const int* slot_ptr,
           const int* edge_node, const unsigned char* edge_dir,
           const float* z, const int* m, const float* values, int L, int S,
           const float* ck, const float* cs, const int* col_ptr,
           const int* col_idx, int F1, int flags, float* c_scratch,
           float* p_scratch, float* phi) {
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        shap_kernel<SMAX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  shap_kernel<SMAX><<<(unsigned)n, threads, smem, stream>>>(
      gl, ni, slot_ptr, edge_node, edge_dir, z, m, values, L, S, ck, cs,
      col_ptr, col_idx, F1, flags, c_scratch, p_scratch, phi);
  return (int)cudaGetLastError();
}

}  // namespace

// gl u8 [n, ni]; slot_ptr i32 [L S + 1]; edge_node i32 [E]; edge_dir u8
// [E]; z f32 [L, S]; m i32 [L]; values f32 [L]; ck, cs f32 [S, S + 1];
// col_ptr i32 [F1 + 1]; col_idx i32 [nnz]; flags: kFlag* bits; c_scratch
// f32 [n, L S] when the contributions are not staged, p_scratch f32
// [n, L, S + 1] when S > 32; phi f32 [n, F1] (written whole).
extern "C" int lgbt_shap(const unsigned char* gl, long n, int ni,
                         const int* slot_ptr, const int* edge_node,
                         const unsigned char* edge_dir, const float* z,
                         const int* m, const float* values, int L, int S,
                         const float* ck, const float* cs,
                         const int* col_ptr, const int* col_idx, int F1,
                         int flags, float* c_scratch, float* p_scratch,
                         float* phi, void* stream) {
  if (n <= 0) return 0;
  int threads = (L + 31) / 32 * 32;
  threads = threads < 32 ? 32 : threads > 256 ? 256 : threads;
  const size_t smem =
      ((flags & kFlagCoef) ? 2 * (size_t)S * (S + 1) * 4 : 0) +
      ((flags & kFlagContrib) ? (size_t)L * S * 4 : 0) +
      ((flags & kFlagGl) ? (size_t)ni : 0);
  cudaStream_t s = (cudaStream_t)stream;
#define LGBT_SHAP_LAUNCH(SM)                                                  \
  return launch<SM>(n, threads, smem, s, gl, ni, slot_ptr, edge_node,        \
                    edge_dir, z, m, values, L, S, ck, cs, col_ptr, col_idx,  \
                    F1, flags, c_scratch, p_scratch, phi)
  if (S <= 8) LGBT_SHAP_LAUNCH(8);
  if (S <= 16) LGBT_SHAP_LAUNCH(16);
  if (S <= 32) LGBT_SHAP_LAUNCH(32);
  LGBT_SHAP_LAUNCH(0);
#undef LGBT_SHAP_LAUNCH
}
