// Linear trees: the per-leaf normal equations of the ridge fit and the
// linear leaf scores.
//
// Replaces the JAX package's lightgbm_tpu/learner/linear.py (XLA, no
// pallas_call): fit_linear_leaves accumulates, for every leaf l, the
// normal equations of its ridge model over its rows,
//   XtHX[l] = sum_r h_r x_r x_r^T,  Xtg[l] = sum_r g_r x_r,  cnt[l] = sum_r w_r
// with x_r = [the row's raw values of the leaf's (at most 16) numeric path
// features | 1] (D <= 17), rows whose used values hold a NaN and rows out of
// the bag weighted 0, as a blockwise one-hot [rows -> leaves] contraction
// on the MXU.  linear_leaf_scores then computes const[l] + coeff[l] . x_r
// for every row, the plain leaf value where a used feature is NaN.
//
// lgbt_linear_normal.  The rows come in leaf order (a stable sort of the
// leaf ids, made by the caller), cut into chunks of kChunk rows that never
// cross a leaf.  A block takes one chunk: it stages kTile rows' D values,
// weight-scaled gradient and hessian at a time in shared memory, and each
// of its first E = D(D+1)/2 + D + 1 threads owns one output (a pair i <= j
// of XtHX, an entry of Xtg, or the count) and adds the tile's rows to it in
// row order.  It writes its E partial sums, and the leaf's last block to
// finish (an integer ticket per leaf) adds the leaf's partials in chunk
// order and writes the leaf's equations (XtHX mirrored).  No float atomics:
// two calls give the same bits.  Products are rounded as the JAX package
// rounds them, (x_i x_j) h, and nothing is contracted into an FMA.
//
// lgbt_linear_scores.  A thread a row: the leaf's coefficients in feature
// order (a zero coefficient is not used), acc += c x (rounded product, then
// rounded sum), acc + const; the plain version's operations in its order.
//
// Bound on the H100: bytes.  The normal equations read each row's leaf,
// g, h, mask and its D - 1 raw values once (scattered 4-byte reads of the
// row-major raw matrix); the scores read the row's leaf and its used raw
// values and write one float.

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 2048;  // rows a block
constexpr int kTile = 128;    // rows staged at once
constexpr int kMaxD = 17;     // 16 features and the constant
constexpr int kMaxE = kMaxD * (kMaxD + 1) / 2 + kMaxD + 1;

__device__ __forceinline__ float finite_or_max(float v) {
  // nan_to_num: NaN is 0, +-inf the largest finite float
  if (isnan(v)) return 0.0f;
  if (isinf(v)) return v > 0.0f ? FLT_MAX : -FLT_MAX;
  return v;
}

__global__ void __launch_bounds__(kThreads)
    normal_kernel(const float* __restrict__ raw, long ld, int F,
                  const int* __restrict__ order,
                  const long long* __restrict__ seg_start,
                  const long long* __restrict__ seg_len,
                  const int* __restrict__ chunk_start, int L,
                  const int* __restrict__ feat, int Kf,
                  const float* __restrict__ grad,
                  const float* __restrict__ hess,
                  const unsigned char* __restrict__ mask,
                  float* __restrict__ partial, int* __restrict__ done,
                  float* __restrict__ xthx, float* __restrict__ xtg,
                  float* __restrict__ cnt) {
  __shared__ float s_x[kTile][kMaxD];
  __shared__ float s_g[kTile], s_h[kTile], s_w[kTile];
  __shared__ int s_feat[kMaxD];
  __shared__ unsigned char s_pi[kMaxE], s_pj[kMaxE];
  __shared__ int s_leaf;
  __shared__ bool s_last;

  const int b = blockIdx.x;
  const int total = chunk_start[L];
  if (b >= total) return;  // the grid is an upper bound of the chunks
  const int D = Kf + 1;
  const int P = D * (D + 1) / 2;
  const int E = P + D + 1;
  if (threadIdx.x == 0) {
    // the leaf whose chunk range holds b: the last l with start <= b
    int lo = 0, hi = L - 1;
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (chunk_start[mid] <= b) lo = mid; else hi = mid - 1;
    }
    s_leaf = lo;
  }
  if (threadIdx.x < E) {
    // output e -> (i, j): pairs of XtHX first, then Xtg, then the count
    int e = threadIdx.x, i = 0;
    if (e < P) {
      while (e >= D - i) { e -= D - i; ++i; }
      s_pi[threadIdx.x] = (unsigned char)i;
      s_pj[threadIdx.x] = (unsigned char)(i + e);
    }
  }
  __syncthreads();
  const int l = s_leaf;
  if (threadIdx.x < Kf)
    s_feat[threadIdx.x] = feat[(long)l * Kf + threadIdx.x];
  const long long first =
      seg_start[l] + (long long)(b - chunk_start[l]) * kChunk;
  const long long end =
      min(seg_start[l] + seg_len[l], first + (long long)kChunk);
  __syncthreads();

  float acc = 0.0f;
  const int e = threadIdx.x;
  for (long long t0 = first; t0 < end; t0 += kTile) {
    const int rows = (int)min((long long)kTile, end - t0);
    for (int k = threadIdx.x; k < rows * Kf; k += kThreads) {
      const int r = k / Kf, j = k - r * Kf;
      const long row = order[t0 + r];
      const int f = s_feat[j];
      s_x[r][j] = f < F ? raw[row * ld + f] : 0.0f;
    }
    __syncthreads();
    if (threadIdx.x < rows) {
      const int r = threadIdx.x;
      const long row = order[t0 + r];
      bool bad = false;
      for (int j = 0; j < Kf; ++j) {
        const float v = s_x[r][j];
        bad |= isnan(v);
        s_x[r][j] = finite_or_max(v);
      }
      s_x[r][Kf] = 1.0f;
      float w = bad ? 0.0f : 1.0f;
      if (mask != nullptr && mask[row] == 0) w = 0.0f;
      s_w[r] = w;
      s_g[r] = __fmul_rn(grad[row], w);
      s_h[r] = __fmul_rn(hess[row], w);
    }
    __syncthreads();
    if (e < P) {
      const int i = s_pi[e], j = s_pj[e];
      for (int r = 0; r < rows; ++r)
        acc = __fadd_rn(acc, __fmul_rn(__fmul_rn(s_x[r][i], s_x[r][j]),
                                       s_h[r]));
    } else if (e < P + D) {
      const int i = e - P;
      for (int r = 0; r < rows; ++r)
        acc = __fadd_rn(acc, __fmul_rn(s_x[r][i], s_g[r]));
    } else if (e < E) {
      for (int r = 0; r < rows; ++r) acc = __fadd_rn(acc, s_w[r]);
    }
    __syncthreads();
  }
  if (e < E) partial[(long)b * E + e] = acc;
  __threadfence();
  __syncthreads();
  const int nchunks = chunk_start[l + 1] - chunk_start[l];
  if (threadIdx.x == 0) s_last = atomicAdd(done + l, 1) == nchunks - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  if (e >= E) return;
  // the leaf's last block: its partials in chunk order
  float sum = 0.0f;
  for (int c = chunk_start[l]; c < chunk_start[l + 1]; ++c)
    sum = __fadd_rn(sum, __ldcg(partial + (long)c * E + e));
  if (e < P) {
    const int i = s_pi[e], j = s_pj[e];
    xthx[((long)l * D + i) * D + j] = sum;
    xthx[((long)l * D + j) * D + i] = sum;
  } else if (e < P + D) {
    xtg[(long)l * D + (e - P)] = sum;
  } else {
    cnt[l] = sum;
  }
}

__global__ void __launch_bounds__(kThreads)
    scores_kernel(const float* __restrict__ raw, long ld,
                  const int* __restrict__ lor, long n,
                  const int* __restrict__ feat,
                  const float* __restrict__ coef, int Kf,
                  const float* __restrict__ cst,
                  const float* __restrict__ leaf_value,
                  float* __restrict__ out) {
  const long r = (long)blockIdx.x * kThreads + threadIdx.x;
  if (r >= n) return;
  const int l = lor[r];
  const int* lf = feat + (long)l * Kf;
  const float* lc = coef + (long)l * Kf;
  float acc = 0.0f;
  bool bad = false;
  for (int j = 0; j < Kf; ++j) {
    const float c = __ldg(lc + j);
    if (c == 0.0f) continue;
    const float v = raw[r * ld + __ldg(lf + j)];
    bad |= isnan(v);
    acc = __fadd_rn(acc, __fmul_rn(c, finite_or_max(v)));
  }
  out[r] = bad ? __ldg(leaf_value + l) : __fadd_rn(acc, __ldg(cst + l));
}

}  // namespace

// raw f32 [n, ld] row-major (F used columns); order i32 [n]: the rows
// stably sorted by leaf; seg_start / seg_len i64 [L]: each leaf's run in
// `order`; chunk_start i32 [L + 1]: exclusive prefix of each leaf's
// ceil(len / 2048) chunks; feat i32 [L, Kf] (F: no feature); grad, hess f32
// [n]; mask u8 [n] or null; partial f32 [grid, E] scratch; done i32 [L]
// zeroed; xthx f32 [L, D, D], xtg f32 [L, D], cnt f32 [L] zeroed (a leaf
// with no rows keeps its zeros).  grid >= the chunks (n / 2048 + L).
extern "C" int lgbt_linear_normal(const float* raw, long ld, int F, long n,
                                  const int* order,
                                  const long long* seg_start,
                                  const long long* seg_len,
                                  const int* chunk_start, int L,
                                  const int* feat, int Kf, const float* grad,
                                  const float* hess,
                                  const unsigned char* mask, float* partial,
                                  long grid, int* done, float* xthx,
                                  float* xtg, float* cnt, void* stream) {
  if (n <= 0 || L <= 0) return 0;
  if (Kf + 1 > kMaxD) return (int)cudaErrorInvalidValue;
  normal_kernel<<<(unsigned)grid, kThreads, 0, (cudaStream_t)stream>>>(
      raw, ld, F, order, seg_start, seg_len, chunk_start, L, feat, Kf, grad,
      hess, mask, partial, done, xthx, xtg, cnt);
  return (int)cudaGetLastError();
}

// raw f32 [n, ld] row-major; lor i32 [n]; feat i32 [L, Kf] and coef f32
// [L, Kf] (a zero coefficient is not used); cst, leaf_value f32 [L]; out
// f32 [n] (written).
extern "C" int lgbt_linear_scores(const float* raw, long ld, const int* lor,
                                  long n, const int* feat, const float* coef,
                                  int Kf, const float* cst,
                                  const float* leaf_value, float* out,
                                  void* stream) {
  if (n <= 0) return 0;
  const long blocks = (n + kThreads - 1) / kThreads;
  scores_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      raw, ld, lor, n, feat, coef, Kf, cst, leaf_value, out);
  return (int)cudaGetLastError();
}
