// Histogram of a row set with C value channels.
//
// Replaces the TPU kernel histogram_pallas (lightgbm_tpu/ops/hist_pallas.py):
// bins_t u8 [F, S], vals_t f32 [C, S] -> f32 [F, B, C] with
//   hist[f, b, c] = sum over r of [bins_t[f, r] == b] * vals_t[c, r],
// bins >= n_bins dropped.  The strict grower's bucketed per-leaf pass calls
// it on the compacted rows of the smaller child (C = 4: grad, hess, valid,
// 0); rows that must not count carry zeros (the callers mask, as in JAX).
//
// The TPU kernel contracts a [C, R] value block with a [F*B, R] one-hot on
// the MXU, carrying the [C, F*B] sum across a sequential grid.  On Hopper
// the function is a scatter: a block owns (a group of features, a chunk of
// rows) and keeps a [features][B][C] accumulator in shared memory; each row
// converts its C values once per channel and adds each non-zero one to the
// cell of every feature in the group with shared atomics; the non-zero cells
// go to a global [F, B, C] accumulator with global atomics, and a second
// kernel converts it to f32.  Modes as hist_common.cuh: int8 sums
// (int8)(int32)v in int32 exactly; float32 and bfloat16 sum 64-bit fixed
// point at a power-of-two scale per channel (absmax_kernel over that
// channel), so every call gives the same bits.
//
// Bound on the H100: bytes.  F*S bin bytes and 4*C*S value bytes are read
// and 4*F*B*C written: 2.1 MB at the main path's S = 45,056, F = 28,
// C = 4, B = 256, 0.6 us at 3.35 TB/s.  The three launches (scale, pass,
// finalize) cost more than that; only a fused caller could hide them.

#include "hist_common.cuh"

namespace {

constexpr int kRowsThreads = 256;

template <int MODE>
__global__ void __launch_bounds__(kRowsThreads)
    rows_kernel(const uint8_t* __restrict__ bins_t, long S, int num_f,
                const float* __restrict__ vals_t, int C, int n_bins, int fpb,
                long rows_per_chunk, const unsigned* __restrict__ vmax,
                typename Val<MODE>::T* __restrict__ glob) {
  typedef typename Val<MODE>::T T;
  extern __shared__ __align__(16) unsigned char smem[];
  T* acc = reinterpret_cast<T*>(smem);
  int* shift = reinterpret_cast<int*>(acc + (long)fpb * n_bins * C);
  const int f0 = blockIdx.x * fpb;
  const int nf = min(fpb, num_f - f0);
  const long r0 = (long)blockIdx.y * rows_per_chunk;
  const long r1 = min(S, r0 + rows_per_chunk);
  const int per = nf * n_bins * C;
  for (int i = threadIdx.x; i < per; i += blockDim.x) acc[i] = (T)0;
  for (int c = threadIdx.x; c < C; c += blockDim.x)
    shift[c] = MODE == 0 ? 0 : fixed_shift(vmax[c], S);
  __syncthreads();
  for (long r = r0 + threadIdx.x; r < r1; r += blockDim.x) {
    for (int c = 0; c < C; ++c) {
      const T q = Val<MODE>::cvt(vals_t[(long)c * S + r], shift[c]);
      if (q == (T)0) continue;
      for (int j = 0; j < nf; ++j) {
        const int b = bins_t[(long)(f0 + j) * S + r];
        if (b < n_bins) atomicAdd(acc + ((long)j * n_bins + b) * C + c, q);
      }
    }
  }
  __syncthreads();
  T* g = glob + (long)f0 * n_bins * C;
  for (int i = threadIdx.x; i < per; i += blockDim.x) {
    const T v = acc[i];
    if (v != (T)0) atomicAdd(g + i, v);
  }
}

template <int MODE>
__global__ void rows_finalize(const typename Val<MODE>::T* __restrict__ glob,
                              long total, int C, long S,
                              const unsigned* __restrict__ vmax,
                              float* __restrict__ out) {
  for (long i = (long)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (long)gridDim.x * blockDim.x) {
    const int c = (int)(i % C);
    out[i] = Val<MODE>::out(glob[i], MODE == 0 ? 0 : fixed_shift(vmax[c], S));
  }
}

template <int MODE>
int run(const uint8_t* bins_t, long S, int num_f, const float* vals_t, int C,
        int n_bins, void* scratch, float* out, cudaStream_t s) {
  typedef typename Val<MODE>::T T;
  T* glob = reinterpret_cast<T*>(scratch);
  const long total = (long)num_f * n_bins * C;
  unsigned* vmax = reinterpret_cast<unsigned*>(glob + total);
  if (total <= 0) return 0;
  int err = 0;
  if (MODE != 0) {
    err = launch_absmax(vals_t, S, 1, S, C, vmax, s);
    if (err) return err;
  }
  if (S > 0) {
    int optin = 0;
    err = optin_smem(&optin);
    if (err) return err;
    // the most features per block whose accumulator fits 48 KB (a few
    // blocks per SM), at least one within the opt-in limit
    const size_t per_f = (size_t)n_bins * C * sizeof(T);
    const size_t fixed = (size_t)C * sizeof(int);
    int fpb = (int)((48u << 10) / per_f);
    fpb = fpb < 1 ? 1 : (fpb > num_f ? num_f : fpb);
    const size_t smem = fixed + fpb * per_f;
    if (smem > (size_t)optin) return (int)cudaErrorInvalidValue;
    err = (int)cudaFuncSetAttribute(
        rows_kernel<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err) return err;
    const int fgroups = (num_f + fpb - 1) / fpb;
    const long chunks = plan_chunks(S, fgroups);
    const long rpc = (S + chunks - 1) / chunks;
    rows_kernel<MODE><<<dim3(fgroups, (unsigned)chunks), kRowsThreads, smem,
                        s>>>(bins_t, S, num_f, vals_t, C, n_bins, fpb, rpc,
                             vmax, glob);
    err = (int)cudaGetLastError();
    if (err) return err;
  }
  long want = (total + 255) / 256;
  int blocks = (int)(want < kSMs * 32L ? want : kSMs * 32L);
  rows_finalize<MODE><<<blocks, 256, 0, s>>>(glob, total, C, S, vmax, out);
  return (int)cudaGetLastError();
}

}  // namespace

// scratch: zero-filled [F, n_bins, C] int32 (mode 0) or int64 (1, 2), then
// (C + 1) / 2 zero int64 that receive the modes' per-channel scale;
// out: f32 [F, n_bins, C]
extern "C" int lgbt_hist_rows(const uint8_t* bins_t, long S, int num_f,
                              const float* vals_t, int C, int n_bins,
                              int mode, void* scratch, float* out,
                              void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (mode) {
    case 0:
      return run<0>(bins_t, S, num_f, vals_t, C, n_bins, scratch, out, s);
    case 1:
      return run<1>(bins_t, S, num_f, vals_t, C, n_bins, scratch, out, s);
    case 2:
      return run<2>(bins_t, S, num_f, vals_t, C, n_bins, scratch, out, s);
  }
  return (int)cudaErrorInvalidValue;
}
