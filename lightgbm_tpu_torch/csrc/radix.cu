// The three radix histogram kernels of hist_kernel=auto at >= 128 bins.
//
// Replaces three TPU kernels of lightgbm_tpu/ops/hist_pallas.py, each over
// bins_t u8 [F, n], grad/hess f32 [n] and leaf_of_row i32 [n]:
//   * histogram_radix_single_pallas -> lgbt_hist_radix_single: the root
//     pass, f32 [F, B, 4]; rows with leaf_of_row < 0 are excluded;
//   * histogram_radix_joint_pallas -> lgbt_hist_radix_joint: the masked
//     pass of G <= 4 leaves (the warm-up ladder's widths 1 and 4),
//     f32 [G, F, B, 4];
//   * histogram_leaves_radix2_pallas -> lgbt_hist_radix2: the masked pass of
//     K > 4 leaves (width 16 and every K = 42 full pass), f32 [K, F, B, 4].
// Slots repeating an earlier slot's leaf get identical copies.
//
// The TPU kernels split bin = 16*hi + lo and contract nibble one-hots on the
// MXU, with p-fold off-diagonal waste, because the TPU has no fast scatter.
// None of that carries over: on Hopper the function is a scatter into
// shared memory (hist_common.cuh), and the kernels differ in how a row finds
// its slot and how a block's shared memory is spent:
//   * radix_single: every row of the pass goes to one slot, so rows that
//     share a bin collide on one shared address.  The block keeps 8 private
//     copies of its accumulator (one per four warps) and 4 features, so a
//     row's leaf, grad and hess are read once for four features (96 KB at
//     B = 256: two blocks fit an SM);
//   * radix_joint: G <= 4 leaf ids sit in registers (no slot table); 4
//     features x G slots x 2 copies (96 KB at G = 4, B = 256);
//   * radix2: the leaf -> slot table in shared memory; as many features per
//     block as fit beside K slots (4 at K = 16, 1 at K = 42, 129 KB).
//
// Bound on the H100: bytes.  A 1M-row pass at F = 28 reads 28 MB of bins and
// 12 MB of grad, hess and leaf ids and writes K*F*B*16 bytes (0.46 MB per
// slot): 40-45 MB, ~0.012-0.013 ms at 3.35 TB/s.  The integer atomics are
// below the operation bound.  These first versions still re-read a row's
// leaf, grad and hess once per feature group (from L2) and flush one global
// atomic per non-zero cell per block; both are what a later version should
// attack.

#include "hist_common.cuh"

namespace {

template <int MODE>
__global__ void __launch_bounds__(kThreads)
    radix_single_kernel(Task t, typename Val<MODE>::T* __restrict__ glob) {
  hist_block<MODE, SEL_ROOT, SRC_BYTES>(t, glob);
}

template <int MODE>
__global__ void __launch_bounds__(kThreads)
    radix_joint_kernel(Task t, typename Val<MODE>::T* __restrict__ glob) {
  hist_block<MODE, SEL_FEW, SRC_BYTES>(t, glob);
}

template <int MODE>
__global__ void __launch_bounds__(kThreads)
    radix2_kernel(Task t, typename Val<MODE>::T* __restrict__ glob) {
  hist_block<MODE, SEL_TABLE, SRC_BYTES>(t, glob);
}

enum { KIND_SINGLE = 0, KIND_JOINT = 1, KIND_RADIX2 = 2 };

template <int MODE>
int run(int kind, Task t, void* scratch, float* out, cudaStream_t s) {
  typedef typename Val<MODE>::T T;
  switch (kind) {
    case KIND_SINGLE:
      return run_hist<T>(radix_single_kernel<MODE>, t, 4, false, 8, false,
                         scratch, out, s);
    case KIND_JOINT:
      return run_hist<T>(radix_joint_kernel<MODE>, t, 4, false, 2, false,
                         scratch, out, s);
    case KIND_RADIX2:
      return run_hist<T>(radix2_kernel<MODE>, t, 4, false, 1, true, scratch,
                         out, s);
  }
  return (int)cudaErrorInvalidValue;
}

int dispatch(int kind, int mode, Task t, void* scratch, float* out,
             void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (mode) {
    case 0:
      return run<0>(kind, t, scratch, out, s);
    case 1:
      return run<1>(kind, t, scratch, out, s);
    case 2:
      return run<2>(kind, t, scratch, out, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// scratch: zero-filled [K, num_f, n_bins, 3] int32 (mode 0) or f32 (1, 2);
// out: f32 [K, num_f, n_bins, 4] (K = 1 for the root pass)
extern "C" int lgbt_hist_radix_single(const uint8_t* bins_t, long n,
                                      int num_f, const float* grad,
                                      const float* hess, const int* lor,
                                      int n_bins, int mode, void* scratch,
                                      float* out, void* stream) {
  Task t = {bins_t, nullptr, n, num_f, grad, hess, lor, nullptr, 1, n_bins};
  return dispatch(KIND_SINGLE, mode, t, scratch, out, stream);
}

extern "C" int lgbt_hist_radix_joint(const uint8_t* bins_t, long n,
                                     int num_f, const float* grad,
                                     const float* hess, const int* lor,
                                     const int* leaves, int G, int n_bins,
                                     int mode, void* scratch, float* out,
                                     void* stream) {
  if (G > kFewSlots) return (int)cudaErrorInvalidValue;
  Task t = {bins_t, nullptr, n, num_f, grad, hess, lor, leaves, G, n_bins};
  return dispatch(KIND_JOINT, mode, t, scratch, out, stream);
}

extern "C" int lgbt_hist_radix2(const uint8_t* bins_t, long n, int num_f,
                                const float* grad, const float* hess,
                                const int* lor, const int* leaves, int K,
                                int n_bins, int mode, void* scratch,
                                float* out, void* stream) {
  Task t = {bins_t, nullptr, n, num_f, grad, hess, lor, leaves, K, n_bins};
  return dispatch(KIND_RADIX2, mode, t, scratch, out, stream);
}
