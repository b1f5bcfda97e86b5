// Fused batched-round partition: K splits applied in one row pass, with the
// next histogram pass's compaction key (and, for the payload variant, its
// payload) written in the same pass.
//
// Replaces two TPU kernels of lightgbm_tpu/ops/round_fuse.py:
//   * partition_payload_pallas -> lgbt_partition_payload;
//   * partition_select_pallas -> lgbt_partition_select, the same pass
//     without the payload (the bounded histogram pool's rounds, whose
//     extended leaf set builds its own keys).
// Per row r (elementwise, so one thread per row; one loop, partition_kernel,
// with the payload behind a template flag):
//   * slot k moves r when validk[k] and parents[k] == lor[r]; the split
//     column is bins_t[feats[k], r] (0 for a feature index out of range, as
//     the TPU one-hot gives), and the row goes left when
//     col == nanb[k] ? dl[k] : col <= thr[k] (round_fuse.py:217-225);
//     moved rows take new_leaves[k] (summed over matching slots, exactly as
//     the TPU kernel sums its one-hot row);
//   * lor_m = mask[r] ? new_lor : -1, key = lor_m in smaller ? r : r | 2^30;
//   * payload row = [words[r, :W], bits(grad[r]), bits(hess[r]), lor_m].
// The eight [K] slot descriptors are staged in shared memory.
//
// Bound on the H100: bytes.  The payload variant reads about 45 B (one bin
// byte, W words, grad, hess, leaf, mask) and writes 4(W+3) + 8 B per row:
// ~93 B at W = 7.  The select variant reads the leaf, the mask and one bin
// byte per matching slot (9 B) and writes 8 B per row.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <bool PAYLOAD>
__global__ void partition_kernel(
    const uint8_t* __restrict__ bins_t, long n, int num_f,
    const int* __restrict__ words, int W, const float* __restrict__ grad,
    const float* __restrict__ hess, const int* __restrict__ lor,
    const int* __restrict__ mask, const int* __restrict__ desc, int K,
    int* __restrict__ out_lor, int* __restrict__ out_key,
    int* __restrict__ out_pay) {
  extern __shared__ int d[];
  for (int i = threadIdx.x; i < 8 * K; i += blockDim.x) d[i] = desc[i];
  __syncthreads();
  const int* feats = d;
  const int* thr = d + K;
  const int* dl = d + 2 * K;
  const int* nanb = d + 3 * K;
  const int* par = d + 4 * K;
  const int* nl = d + 5 * K;
  const int* vk = d + 6 * K;
  const int* sm = d + 7 * K;
  const long stride = (long)gridDim.x * blockDim.x;
  for (long r = (long)blockIdx.x * blockDim.x + threadIdx.x; r < n;
       r += stride) {
    const int l = lor[r];
    int tgt = 0, moved = 0;
    for (int k = 0; k < K; ++k) {
      const int in_par = (par[k] == l) ? vk[k] : 0;
      if (in_par == 0) continue;
      const int f = feats[k];
      const int col = (f >= 0 && f < num_f) ? (int)bins_t[(long)f * n + r] : 0;
      const int isnan = col == nanb[k];
      const int le = col <= thr[k];
      const int go_left = isnan * dl[k] + (1 - isnan) * le;
      const int move = in_par * (1 - go_left);
      tgt += move * nl[k];
      moved += move;
    }
    const int new_l = moved > 0 ? tgt : l;
    out_lor[r] = new_l;
    const int lm = mask[r] != 0 ? new_l : -1;
    int sel = 0;
    for (int k = 0; k < K; ++k) sel += (lm == sm[k]);
    out_key[r] = sel > 0 ? (int)r : ((int)r | (1 << 30));
    if (PAYLOAD) {
      int* prow = out_pay + r * (W + 3);
      const int* wrow = words + r * W;
      for (int j = 0; j < W; ++j) prow[j] = wrow[j];
      prow[W] = __float_as_int(grad[r]);
      prow[W + 1] = __float_as_int(hess[r]);
      prow[W + 2] = lm;
    }
  }
}

template <bool PAYLOAD>
int launch(const uint8_t* bins_t, long n, int num_f, const int* words, int W,
           const float* grad, const float* hess, const int* lor,
           const int* mask, const int* desc, int K, int* out_lor,
           int* out_key, int* out_pay, void* stream) {
  if (n <= 0) return 0;
  const int threads = 256;
  long want = (n + threads - 1) / threads;
  int blocks = (int)(want < 132L * 16 ? want : 132L * 16);
  size_t smem = (size_t)8 * K * sizeof(int);
  partition_kernel<PAYLOAD><<<blocks, threads, smem, (cudaStream_t)stream>>>(
      bins_t, n, num_f, words, W, grad, hess, lor, mask, desc, K, out_lor,
      out_key, out_pay);
  return (int)cudaGetLastError();
}

}  // namespace

// desc: i32 [8, K] = feats, thr, dl, nanb, parents, new_leaves, validk,
// smaller
extern "C" int lgbt_partition_payload(const uint8_t* bins_t, long n,
                                      int num_f, const int* words, int W,
                                      const float* grad, const float* hess,
                                      const int* lor, const int* mask,
                                      const int* desc, int K, int* out_lor,
                                      int* out_key, int* out_pay,
                                      void* stream) {
  return launch<true>(bins_t, n, num_f, words, W, grad, hess, lor, mask, desc,
                      K, out_lor, out_key, out_pay, stream);
}

extern "C" int lgbt_partition_select(const uint8_t* bins_t, long n,
                                     int num_f, const int* lor,
                                     const int* mask, const int* desc, int K,
                                     int* out_lor, int* out_key,
                                     void* stream) {
  return launch<false>(bins_t, n, num_f, nullptr, 0, nullptr, nullptr, lor,
                       mask, desc, K, out_lor, out_key, nullptr, stream);
}
