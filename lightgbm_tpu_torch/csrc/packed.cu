// Masked K-leaf histogram from the packed word mirror (hist_kernel=auto below
// 128 bins, and hist_kernel=packed): every masked pass of max_bin=63, the
// root (K = 1) included.
//
// Replaces histogram_leaves_packed_pallas (lightgbm_tpu/ops/hist_pallas.py):
// words_t i32 [W, n], byte j of word w (little-endian) the bin of feature
// 4w + j; grad/hess f32 [n]; leaf_of_row i32 [n]; leaves i32 [K].  Result
// f32 [K, num_f, B, 4]; bytes past num_f in the last word are dropped
// whatever they hold, and slots repeating an earlier slot's leaf get copies.
//
// The TPU kernel compares 4 bins per 32-bit lane with SWAR byte tricks to
// halve its one-hot build; on Hopper the function is the scatter of
// masked.cuh, and this file only gives that one-launch cluster kernel its
// row source: the packed words (SRC_WORDS).  A block owns the features of
// one word (four at F = 28), so a quad of rows costs one 16-byte load of
// words_t[w, r:r+4] for its four features (a 4 x 4 byte transpose puts it
// in the layout of four bins_t rows), and the rows' leaf ids, grad and hess
// are read once for those four.  The plan may also split a word between
// blocks (its bytes shifted into place) and, for this source, takes
// clusters of up to 16 blocks (non-portable), so 7 words fill 112 SMs.
// Modes: int8 levels exact in int32; float32 and bfloat16 in 64-bit fixed
// point at the all-rows scale (the bits of histogram_leaves_fixed on the
// unpacked bins).  No global accumulator, memset, finalize or global atomic.
//
// Bound on the H100: bytes.  A 1M-row pass at W = 7 reads 28 MB of words and
// 12 MB of grad, hess and leaf ids and writes K*F*B*16 bytes (1.2 MB at
// K = 42, F = 28, B = 64): ~41 MB, ~0.012 ms at 3.35 TB/s.

#include "masked.cuh"

// out: f32 [K, num_f, n_bins, 4]; mode 0 int8, 1 float32, 2 bfloat16;
// gate: null, or i32 [1] read on the device, 0 = launch nothing
extern "C" int lgbt_hist_packed(const int* words_t, int W, long n, int num_f,
                                const float* grad, const float* hess,
                                const int* lor, const int* leaves, int K,
                                int n_bins, int mode, float* out,
                                const int* gate, void* stream) {
  if (4 * W < num_f) return (int)cudaErrorInvalidValue;
  return run_masked_words(words_t, n, num_f, grad, hess, lor, leaves, K,
                          n_bins, mode, out, gate, (cudaStream_t)stream);
}
