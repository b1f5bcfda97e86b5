// Lambdarank gradients: one thread block a query.
//
// Replaces no TPU kernel: the JAX package computes these gradients in XLA
// (lightgbm_tpu/objectives.py:585 _lambdarank_pair_accum over its query
// length buckets).  Its formulation materialises some twenty float32
// [nq_b, T, Q_b] pair tensors a bucket, several GB at MSLR-WEB30K's 2.27M
// documents, and that is the whole device cost of a ranking round's
// gradients; this kernel keeps every pair in registers.
//
// What it computes, per query (documents [bounds[q], bounds[q + 1])):
// the documents sorted by descending score, ties by lower index (the
// stable argsort of -score); every pair of sorted positions a < b with
// a < T = min(trunc, Q) and different labels gives
//   delta = |(gain_a - gain_b) (disc_a - disc_b)| inv_dcg[q],
//   disc_p = 1 / log2(p + 2),
//   rho = 1 / (1 + exp(sigma clip(s_high - s_low, +-50 / sigma))),
//   lam = -sigma rho delta,  hes = sigma^2 rho (1 - rho) delta,
// +-lam to a (+ when a has the higher label) and the negation to b, hes
// to both; with norm, each query's sums scaled by log2(1 + S) / S, S the
// sum of |lam| (1 when S is 0); then times the weight.
//
// Design.  The block stages the query's scores, and its sorted scores,
// labels, gains and document indices, in shared memory (queries up to
// kStage documents), or in a global scratch buffer at the query's offset
// (longer queries, the same code through the same pointers).  A
// document's sorted position is found by counting (O(Q^2) compares, no
// sort); thread p then owns sorted positions p, p + blockDim, ... and sums
// each one's pairs itself, as the higher member (p < T, b ascending) and
// as the lower (a < min(T, p), ascending): every pair is evaluated twice,
// once by each member, so there are no float atomics and two calls give
// the same bits.  The norm's sum is a block reduction in a fixed order.
// Each document belongs to one query, so the outputs are written, never
// added.  Full-precision expf / log2f (no --use_fast_math); the products
// that feed a sum are __fmul_rn, so no multiply-add is contracted and the
// arithmetic is the plain version's, operation for operation.
//
// Bound on the H100: operations.  ~25 float operations a pair over
// sum_q min(T, Q_q) Q_q pairs (each pair once) plus a sort's Q log2 Q
// compares a query, against 20 B a document of reads and writes.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kStage = 2048;  // documents staged in shared memory (40 KB)

// a sort key that orders NaN below every score, so the positions found by
// counting stay a permutation
__device__ __forceinline__ float sort_key(float x) {
  return isnan(x) ? -INFINITY : x;
}

__global__ void __launch_bounds__(kThreads)
    lambdarank_kernel(const float* __restrict__ score,
                      const float* __restrict__ label,
                      const float* __restrict__ gain,
                      const int* __restrict__ bounds,
                      const float* __restrict__ inv_dcg,
                      const float* __restrict__ weight, long n, float sigma,
                      int trunc, int norm, float* __restrict__ grad,
                      float* __restrict__ hess, float* __restrict__ scratch) {
  __shared__ float smem[5][kStage];
  __shared__ float red[kThreads];
  const int q = blockIdx.x;
  const int tid = threadIdx.x;
  const long beg = bounds[q];
  const int cnt = bounds[q + 1] - bounds[q];
  if (cnt <= 0) return;
  const float inv = inv_dcg[q];
  if (cnt == 1 || inv == 0.0f) {  // no pair, or every delta is 0
    for (int i = tid; i < cnt; i += kThreads) {
      grad[beg + i] = 0.0f;
      hess[beg + i] = 0.0f;
    }
    return;
  }
  // key (then the discounts), sorted score, label, gain, document index
  float* key;
  float* ssc;
  float* slb;
  float* sgn;
  int* six;
  if (cnt <= kStage) {
    key = smem[0];
    ssc = smem[1];
    slb = smem[2];
    sgn = smem[3];
    six = reinterpret_cast<int*>(smem[4]);
  } else {
    key = scratch + beg;
    ssc = scratch + n + beg;
    slb = scratch + 2 * n + beg;
    sgn = scratch + 3 * n + beg;
    six = reinterpret_cast<int*>(scratch + 4 * n + beg);
  }
  for (int i = tid; i < cnt; i += kThreads) key[i] = sort_key(score[beg + i]);
  __syncthreads();
  // sorted position of document i: the documents ahead of it
  for (int i = tid; i < cnt; i += kThreads) {
    const float ki = key[i];
    int r = 0;
    for (int j = 0; j < cnt; ++j) {
      const float kj = key[j];
      r += (kj > ki) | ((kj == ki) & (j < i));
    }
    ssc[r] = score[beg + i];
    slb[r] = label[beg + i];
    sgn[r] = gain[beg + i];
    six[r] = i;
  }
  __syncthreads();
  float* disc = key;  // the keys are spent
  for (int p = tid; p < cnt; p += kThreads)
    disc[p] = 1.0f / log2f((float)p + 2.0f);
  __syncthreads();

  const int T = trunc < cnt ? trunc : cnt;
  const float lim = 50.0f / sigma;
  const float s2 = sigma * sigma;
  float abs_sum = 0.0f;  // this thread's |lam| of the pairs it heads
  // the pair (a, b), a above b: the contribution to a and the hessian
  auto pair = [&](int a, int b, float& ga, float& hab) {
    const float la = slb[a], lb = slb[b];
    if (la == lb) {
      ga = 0.0f;
      hab = 0.0f;
      return;
    }
    const float delta = fabsf((sgn[a] - sgn[b]) * (disc[a] - disc[b])) * inv;
    const bool a_better = la > lb;
    float diff = a_better ? ssc[a] - ssc[b] : ssc[b] - ssc[a];
    diff = fminf(fmaxf(diff, -lim), lim);
    const float rho = 1.0f / (1.0f + expf(sigma * diff));
    const float lam = __fmul_rn(-sigma * rho, delta);
    hab = __fmul_rn(s2 * rho * (1.0f - rho), delta);
    ga = a_better ? lam : -lam;
  };
  // sorted position p's sums, parked at grad / hess [beg + p] (the
  // query's own range) until every pair is done
  for (int p = tid; p < cnt; p += kThreads) {
    float g_hi = 0.0f, h_hi = 0.0f, g_lo = 0.0f, h_lo = 0.0f;
    if (p < T) {
      for (int b = p + 1; b < cnt; ++b) {
        float ga, hab;
        pair(p, b, ga, hab);
        g_hi += ga;
        h_hi += hab;
        abs_sum += fabsf(ga);
      }
    }
    const int top = p < T ? p : T;
    for (int a = 0; a < top; ++a) {
      float ga, hab;
      pair(a, p, ga, hab);
      g_lo += ga;
      h_lo += hab;
    }
    grad[beg + p] = g_hi - g_lo;
    hess[beg + p] = h_hi + h_lo;
  }
  float nf = 1.0f;
  if (norm) {
    red[tid] = abs_sum;
    __syncthreads();
    for (int w = kThreads / 2; w > 0; w >>= 1) {
      if (tid < w) red[tid] += red[tid + w];
      __syncthreads();
    }
    const float tot = red[0];
    if (tot > 0.0f) nf = log2f(1.0f + tot) / fmaxf(tot, 1e-20f);
  }
  // move the sums to their documents through the staging buffer (the
  // sorted scores and gains are spent)
  __syncthreads();
  for (int p = tid; p < cnt; p += kThreads) {
    ssc[p] = grad[beg + p];
    sgn[p] = hess[beg + p];
  }
  __syncthreads();
  for (int p = tid; p < cnt; p += kThreads) {
    float g = ssc[p], h = sgn[p];
    if (norm) {
      g = g * nf;
      h = h * nf;
    }
    const long d = beg + six[p];
    if (weight != nullptr) {
      g = g * weight[d];
      h = h * weight[d];
    }
    grad[d] = g;
    hess[d] = h;
  }
}

}  // namespace

// score, label, gain f32 [n]; bounds i32 [nq + 1]; inv_dcg f32 [nq];
// weight f32 [n] or null; grad, hess f32 [n] (written); scratch f32 [5 n]
// when a query is longer than kStage, else null
extern "C" int lgbt_lambdarank(const float* score, const float* label,
                               const float* gain, const int* bounds,
                               const float* inv_dcg, const float* weight,
                               int nq, long n, float sigma, int trunc,
                               int norm, float* grad, float* hess,
                               float* scratch, void* stream) {
  if (nq <= 0) return 0;
  lambdarank_kernel<<<nq, kThreads, 0, (cudaStream_t)stream>>>(
      score, label, gain, bounds, inv_dcg, weight, n, sigma, trunc, norm,
      grad, hess, scratch);
  return (int)cudaGetLastError();
}
