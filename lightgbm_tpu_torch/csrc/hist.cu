// Masked K-leaf (grad, hess, count) histograms.
//
// Replaces two TPU kernels of lightgbm_tpu/ops/hist_pallas.py:
//   * _histogram_leaves_impl (via histogram_leaves_pallas): bins_t u8 [F, n],
//     grad/hess f32 [n], leaf_of_row i32 [n], leaves i32 [K]:
//     lgbt_hist_leaves, the one-launch cluster kernel of masked.cuh (the
//     function radix.cu's lgbt_hist_radix2 computes too);
//   * histogram_payload_pallas: the compacted i32 payload [S, W+3] (4 bin
//     bytes per word, grad bits, hess bits, leaf id), rows at position
//     >= cnt excluded, cnt read on the device: lgbt_hist_payload.
// Both produce f32 [K, F, B, 4] with channel 3 zero; a slot whose leaf id
// repeats an earlier slot gets a copy of that slot's histogram.
//
// The TPU kernels build one-hot tiles and contract them on the MXU, carrying
// the accumulator across a sequential grid.  Hopper blocks run in no order,
// and shared-memory atomics make the scatter cheap.  The payload pass keeps
// the design of the reference CUDA learner (hist_common.cuh): one block per
// (feature, row chunk, slot group) keeps a [slots, B, 3] accumulator in
// shared memory, adds each selected row with shared atomics, and flushes the
// non-zero cells to a global accumulator with global atomics; a second
// kernel converts it to f32 and copies repeated slots.  A row's slot comes
// from a leaf->first-slot table in shared memory (a row belongs to one
// leaf); leaf ids outside the table fall back to a linear search.  Modes
// (int8 exact, float32, bfloat16): hist_common.cuh.
//
// Bound on the H100: bytes.  Each input is read once (F + 12 bytes a row for
// the masked pass, 4(W+3) for the payload pass) and K*F*B*16 bytes written.
// The payload pass re-reads its rows once per feature (from L2) and
// flushes one global atomic per non-zero cell per block.

#include "masked.cuh"

namespace {

template <int MODE>
__global__ void __launch_bounds__(kThreads)
    hist_payload_kernel(Task t, typename Val<MODE>::T* __restrict__ glob) {
  hist_block<MODE, SEL_TABLE, SRC_PAYLOAD>(t, glob);
}

template <int MODE>
int run_payload(const int* payload, long S, int W, int num_f,
                const int* leaves, int K, const int* cnt, int n_bins,
                void* scratch, float* out, cudaStream_t s) {
  Task t = {nullptr, S, num_f, nullptr, nullptr, nullptr, leaves, K,
            n_bins};
  t.payload = payload;
  t.W = W;
  t.cnt = cnt;
  return run_hist<MODE>(hist_payload_kernel<MODE>, t, 1, true, 1, true,
                        scratch, out, s);
}

}  // namespace

// out: f32 [K, num_f, n_bins, 4] (masked.cuh run_masked)
extern "C" int lgbt_hist_leaves(const uint8_t* bins_t, long n, int num_f,
                                const float* grad, const float* hess,
                                const int* lor, const int* leaves, int K,
                                int n_bins, int mode, float* out,
                                void* stream) {
  return run_masked(bins_t, n, num_f, grad, hess, lor, leaves, K, n_bins,
                    mode, out, (cudaStream_t)stream);
}

// scratch: zero-filled [K, num_f, n_bins, 3] int32 (mode 0) or int64 (1,
// 2) plus one int64 for the modes' scale (hist_common.cuh run_hist)
extern "C" int lgbt_hist_payload(const int* payload, long S, int W, int num_f,
                                 const int* leaves, int K, const int* cnt,
                                 int n_bins, int mode, void* scratch,
                                 float* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (mode) {
    case 0:
      return run_payload<0>(payload, S, W, num_f, leaves, K, cnt, n_bins,
                            scratch, out, s);
    case 1:
      return run_payload<1>(payload, S, W, num_f, leaves, K, cnt, n_bins,
                            scratch, out, s);
    case 2:
      return run_payload<2>(payload, S, W, num_f, leaves, K, cnt, n_bins,
                            scratch, out, s);
  }
  return (int)cudaErrorInvalidValue;
}
