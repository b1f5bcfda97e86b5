// Masked K-leaf histogram from the packed word mirror (hist_kernel=auto below
// 128 bins, and hist_kernel=packed).
//
// Replaces histogram_leaves_packed_pallas (lightgbm_tpu/ops/hist_pallas.py):
// words_t i32 [W, n], byte j of word w (little-endian) the bin of feature
// 4w + j; grad/hess f32 [n]; leaf_of_row i32 [n]; leaves i32 [K].  Result
// f32 [K, num_f, B, 4]; features >= num_f in the last word are dropped, and
// slots repeating an earlier slot's leaf get copies.
//
// The TPU kernel compares 4 bins per 32-bit lane with SWAR byte tricks to
// halve its one-hot build; on Hopper the function is a scatter into shared
// memory (hist_common.cuh), and the packed layout pays off differently: a
// block owns one word, so each row costs ONE coalesced 4-byte read for four
// features, and the row's leaf, grad and hess are read once for those four
// instead of once per feature.  The accumulator holds 4 features x K slots
// (129 KB at K = 42, B = 64), beside the leaf -> slot table.
//
// Bound on the H100: bytes.  A 1M-row pass at W = 7 reads 28 MB of words and
// 12 MB of grad, hess and leaf ids and writes K*F*B*16 bytes (1.2 MB at
// K = 42, F = 28, B = 64): ~41 MB, ~0.012 ms at 3.35 TB/s.  This first
// version flushes one global atomic per non-zero cell per block, which a
// later version should attack.

#include "hist_common.cuh"

namespace {

template <int MODE>
__global__ void __launch_bounds__(kThreads)
    packed_kernel(Task t, typename Val<MODE>::T* __restrict__ glob) {
  hist_block<MODE, SEL_TABLE, SRC_WORDS>(t, glob);
}

template <int MODE>
int run(Task t, void* scratch, float* out, cudaStream_t s) {
  return run_hist<typename Val<MODE>::T>(packed_kernel<MODE>, t, 4, true, 1,
                                         true, scratch, out, s);
}

}  // namespace

// scratch: zero-filled [K, num_f, n_bins, 3] int32 (mode 0) or f32 (1, 2)
extern "C" int lgbt_hist_packed(const int* words_t, int W, long n, int num_f,
                                const float* grad, const float* hess,
                                const int* lor, const int* leaves, int K,
                                int n_bins, int mode, void* scratch,
                                float* out, void* stream) {
  if (4 * W < num_f) return (int)cudaErrorInvalidValue;
  Task t = {nullptr, words_t, n, num_f, grad, hess, lor, leaves, K, n_bins};
  cudaStream_t s = (cudaStream_t)stream;
  switch (mode) {
    case 0:
      return run<0>(t, scratch, out, s);
    case 1:
      return run<1>(t, scratch, out, s);
    case 2:
      return run<2>(t, scratch, out, s);
  }
  return (int)cudaErrorInvalidValue;
}
