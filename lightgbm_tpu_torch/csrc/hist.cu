// Masked K-leaf (grad, hess, count) histograms.
//
// Replaces two TPU kernels of lightgbm_tpu/ops/hist_pallas.py:
//   * _histogram_leaves_impl: bins_t u8 [F, n] (histogram_leaves_pallas)
//     or bins u8 [S, F] row-major (histogram_leaves_rows_pallas), grad/hess
//     f32 [n], leaf_of_row i32 [n], leaves i32 [K]: lgbt_hist_leaves (the
//     function radix.cu's lgbt_hist_radix2 computes too) and
//     lgbt_hist_leaves_rows;
//   * histogram_payload_pallas: the compacted i32 payload [S, W+3] (4 bin
//     bytes per word, grad bits, hess bits, leaf id), rows at position
//     >= cnt excluded, cnt read on the device: lgbt_hist_payload.
// All three launch the one-launch cluster kernel of masked.cuh (row-major
// bins are its fourth row source, SRC_ROWS: at F % 4 == 0 one 32-bit load
// gives a row's four bins of a block's features; payload rows its third,
// SRC_PAYLOAD) and produce f32 [K, F, B, 4] with channel 3 zero; a slot
// whose leaf id repeats an earlier slot gets a copy of that slot's
// histogram.
//
// The TPU kernels build one-hot tiles and contract them on the MXU, carrying
// the accumulator across a sequential grid.  Hopper blocks run in no order,
// and shared-memory atomics make the scatter cheap: a cluster per (feature
// group, slot group) sums its rows into shared memory and reduces through
// distributed shared memory (masked.cuh).  For the payload, the row chunks
// of a cluster split the first *cnt rows, each block reading cnt on the
// device, and stage their rows in shared memory a tile at a time (160
// contiguous bytes a quad of rows at W = 7; 16-byte cp.async copies, the
// next tile in flight while the block adds this one's rows);
// the float32 and bfloat16 scale is the one over all S rows, rows >= cnt
// included, found in the launch.  Modes (int8 exact, float32, bfloat16):
// hist_common.cuh.
//
// Bound on the H100: bytes.  Each input is read once (F + 12 bytes a row for
// the masked pass, either bin layout; 4(W+3) bytes a row below cnt for the
// payload pass, 40 at W = 7) and K*F*B*16 bytes written (4.8 MB at K = 42,
// F = 28, B = 256).  Each feature group re-reads the payload rows from L2,
// and a feature group of the row-major pass reads a 4-byte word of each
// row's F bytes (a 32-byte sector holds a word of 8 rows at F = 28).

#include "masked.cuh"

namespace {

// The masked pass over the compacted payload i32 [S, W+3] (4W >= num_f;
// 16-byte aligned), rows at positions >= *cnt excluded (cnt read on the
// device); the float32 and bfloat16 scale is over all S rows
int run_masked_payload(const int* payload, long S, int W, int num_f,
                              const int* leaves, int K, const int* cnt,
                              int n_bins, int mode, float* out,
                              const int* rows, cudaStream_t s) {
  Masked t = {nullptr, nullptr, S, num_f, nullptr, nullptr, nullptr, leaves,
              K, n_bins, 0, 0, 0, reinterpret_cast<float4*>(out)};
  t.payload = payload;
  t.W = W;
  t.cnt = cnt;
  t.rows = rows;
  t.tile_rows = payload_tile_rows(W);
  if (!aligned(payload, 16)) return (int)cudaErrorMisalignedAddress;
  return dispatch_masked<SRC_PAYLOAD>(t, true, mode, s);
}

// The masked pass over row-major bins u8 [n, F] (masked.cuh SRC_ROWS)
int run_masked_rows(const uint8_t* bins_rows, long n, int num_f,
                    const float* grad, const float* hess, const int* lor,
                    const int* leaves, int K, int n_bins, int mode,
                    float* out, cudaStream_t s) {
  const Masked t = {bins_rows, nullptr, n, num_f, grad, hess, lor, leaves,
                    K, n_bins, 0, 0, 0, reinterpret_cast<float4*>(out)};
  const bool vec = n % 4 == 0 && num_f % 4 == 0 && aligned(bins_rows, 4) &&
                   aligned(grad, 16) && aligned(hess, 16) && aligned(lor, 16);
  return dispatch_masked<SRC_ROWS>(t, vec, mode, s);
}

}  // namespace

// out: f32 [K, num_f, n_bins, 4] (masked.cuh run_masked); gate: null, or
// i32 [1] read on the device, 0 = launch nothing
extern "C" int lgbt_hist_leaves(const uint8_t* bins_t, long n, int num_f,
                                const float* grad, const float* hess,
                                const int* lor, const int* leaves, int K,
                                int n_bins, int mode, float* out,
                                const int* gate, void* stream) {
  return run_masked(bins_t, n, num_f, grad, hess, lor, leaves, K, n_bins,
                    mode, out, gate, (cudaStream_t)stream);
}

// bins_rows: u8 [n, num_f]; out: f32 [K, num_f, n_bins, 4] (run_masked_rows)
extern "C" int lgbt_hist_leaves_rows(const uint8_t* bins_rows, long n,
                                     int num_f, const float* grad,
                                     const float* hess, const int* lor,
                                     const int* leaves, int K, int n_bins,
                                     int mode, float* out, void* stream) {
  return run_masked_rows(bins_rows, n, num_f, grad, hess, lor, leaves, K,
                         n_bins, mode, out, (cudaStream_t)stream);
}

// out: f32 [K, num_f, n_bins, 4] (run_masked_payload); mode 0 int8, 1
// float32, 2 bfloat16; rows: null, or i32 [1], the pass's S (<= S, >= *cnt,
// read on the device: the float32 and bfloat16 scale is taken over the
// first *rows payload rows)
extern "C" int lgbt_hist_payload(const int* payload, long S, int W, int num_f,
                                 const int* leaves, int K, const int* cnt,
                                 int n_bins, int mode, float* out,
                                 const int* rows, void* stream) {
  if (W < 1 || 4 * W < num_f) return (int)cudaErrorInvalidValue;
  return run_masked_payload(payload, S, W, num_f, leaves, K, cnt, n_bins,
                            mode, out, rows, (cudaStream_t)stream);
}
