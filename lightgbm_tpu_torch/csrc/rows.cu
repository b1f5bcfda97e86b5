// Histogram of a row set with C value channels.
//
// Replaces the TPU kernel histogram_pallas (lightgbm_tpu/ops/hist_pallas.py):
// bins_t u8 [F, S], vals_t f32 [C, S] -> f32 [F, B, C] with
//   hist[f, b, c] = sum over r of [bins_t[f, r] == b] * vals_t[c, r],
// bins >= n_bins dropped.  The strict grower's bucketed per-leaf pass calls
// it on the compacted rows of the smaller child (C = 4: grad, hess, valid,
// 0; S = 5,632 ... 90,112 at 90k rows); rows that must not count carry
// zeros (the callers mask, as in JAX).
//
// The TPU kernel contracts a [C, R] value block with a [F*B, R] one-hot on
// the MXU, carrying the [C, F*B] sum across a sequential grid.  On Hopper
// the function is a scatter.  Modes as hist_common.cuh: int8 sums
// (int8)(int32)v in int32 exactly; float32 and bfloat16 sum 64-bit fixed
// point at a power-of-two scale per channel, fixed_shift(max finite |value|
// of the channel, S), so every call gives the same bits.
//
// Design: ONE launch, one block per (feature, channel): F * C blocks (112
// at F = 28, C = 4), each over every row of the set.  A block reads its
// feature's bin bytes and its channel's values four rows to a load, keeps
// its first kHeld steps of rows in registers, finds the channel's max
// |value| itself (a block reduction: the scale pass, the memset and the
// finalize of the first version are gone), converts each value once with
// one multiply, and adds the non-zero ones to a single 256-cell plane in
// shared memory (64-bit sums as two native 32-bit atomics, the bin
// innermost so a warp's lanes hit different banks); then it writes its
// f32 column itself.  No global accumulator and no global atomics.  The
// first version (feature groups x row chunks, all channels per block,
// three more launches) re-read and re-converted each value for every
// feature group and paid a scale pass and a finalize per call; a one-launch
// version with a cluster of row chunks per feature, all channels per block
// (summed through distributed shared memory), ran 1.8-3.4x slower than
// this one at every S of the strict path.
//
// Bound on the H100: bytes.  F*S bin bytes and 4*C*S value bytes are read
// and 4*F*B*C written: 2.1 MB at S = 45,056, F = 28, C = 4, B = 256
// (0.6 us at 3.35 TB/s), 0.38 MB at S = 5,632 (0.1 us).  Each block re-reads
// its feature's bins once per channel and its channel's values once per
// feature (from L2), and at the strict path's sizes the launch, the block
// reduction and the atomics' latency set the pace.

#include "cluster_hist.cuh"  // Acc, Cvt, aligned

namespace {

constexpr int kHeld = 4;  // row steps a thread keeps in registers

// Four rows' (VEC = 4) or one row's bins and values from r on
template <int VEC>
struct Quad {
  unsigned bins;  // byte u: the bin of row r + u
  float v[4];
  __device__ void load(const uint8_t* __restrict__ bp,
                       const float* __restrict__ vp, long r) {
    if (VEC == 4) {
      bins = *reinterpret_cast<const unsigned*>(bp + r);
      const float4 q = *reinterpret_cast<const float4*>(vp + r);
      v[0] = q.x;
      v[1] = q.y;
      v[2] = q.z;
      v[3] = q.w;
    } else {
      bins = bp[r];
      v[0] = vp[r];
    }
  }
};

// Block blockIdx.x = f * C + c: channel c of feature f over all S rows.
// Shared memory: one plane of B cells (Acc) and the block's max |value|.
// A thread's first kHeld steps of rows stay in registers from the scale
// pass to the scatter.  VEC = 4: S % 4 == 0 and aligned operands.
template <int MODE, int VEC>
__global__ void __launch_bounds__(1024)
    rows_channel(const uint8_t* __restrict__ bins_t, long S,
                 const float* __restrict__ vals_t, int C, int n_bins,
                 float* __restrict__ out) {
  typedef typename Val<MODE>::T T;
  extern __shared__ __align__(16) unsigned char smem[];
  const int f = blockIdx.x / C;
  const int c = blockIdx.x % C;
  const uint8_t* bp = bins_t + (long)f * S;
  const float* vp = vals_t + (long)c * S;
  const int words = n_bins * Acc<MODE>::kWords;
  unsigned* w = reinterpret_cast<unsigned*>(smem);
  unsigned* part = w + words;
  for (int i = threadIdx.x; i < words; i += blockDim.x) w[i] = 0;
  if (threadIdx.x == 0) *part = 0;
  const long step = (long)VEC * blockDim.x;
  const long rt = VEC * threadIdx.x;  // this thread's first row
  Quad<VEC> held[kHeld];
#pragma unroll
  for (int k = 0; k < kHeld; ++k)
    if (rt + k * step < S) held[k].load(bp, vp, rt + k * step);
  __syncthreads();
  int s = 0;
  if (MODE != 0) {
    unsigned m = 0;
    auto see = [&](const Quad<VEC>& x) {
#pragma unroll
      for (int u = 0; u < VEC; ++u) {
        const float y = fabsf(x.v[u]);
        if (y <= FLT_MAX && __float_as_uint(y) > m) m = __float_as_uint(y);
      }
    };
#pragma unroll
    for (int k = 0; k < kHeld; ++k)
      if (rt + k * step < S) see(held[k]);
    for (long r = rt + kHeld * step; r < S; r += step) {
      Quad<VEC> x;
      x.load(bp, vp, r);
      see(x);
    }
    m = __reduce_max_sync(0xffffffffu, m);
    if ((threadIdx.x & 31) == 0 && m != 0) atomicMax(part, m);
    __syncthreads();
    s = fixed_shift(*part, S);
  }
  const Cvt<MODE> cvt = {ldexp(1.0, s)};
  const Acc<MODE> a = {w, n_bins};
  auto add = [&](const Quad<VEC>& x) {
#pragma unroll
    for (int u = 0; u < VEC; ++u) {
      const int b = (x.bins >> (8 * u)) & 255;
      const T q = cvt(x.v[u]);
      if (b < n_bins && q != (T)0) a.add(b, q);
    }
  };
#pragma unroll
  for (int k = 0; k < kHeld; ++k)
    if (rt + k * step < S) add(held[k]);
  for (long r = rt + kHeld * step; r < S; r += step) {
    Quad<VEC> x;
    x.load(bp, vp, r);
    add(x);
  }
  __syncthreads();
  // out [F, B, C]: bin b of this (feature, channel) at (f * B + b) * C + c
  float* o = out + (long)f * n_bins * C + c;
  for (int b = threadIdx.x; b < n_bins; b += blockDim.x)
    o[(long)b * C] = Val<MODE>::out(a.get(w, b), s);
}

template <int MODE>
int run(const uint8_t* bins_t, long S, int num_f, const float* vals_t, int C,
        int n_bins, float* out, cudaStream_t s) {
  typedef typename Val<MODE>::T T;
  if (num_f <= 0 || C <= 0) return 0;
  if ((long)num_f * C > 0x7fffffffL) return (int)cudaErrorInvalidValue;
  // a thread per two steps of rows, up to 1024 (kHeld steps in registers)
  long threads = ((S + 7) / 8 + 31) / 32 * 32;
  threads = threads < 64 ? 64 : (threads > 1024 ? 1024 : threads);
  const size_t smem = (size_t)n_bins * sizeof(T) + 16;
  const bool vec = S % 4 == 0 && aligned(bins_t, 4) && aligned(vals_t, 16);
  auto kernel = vec ? rows_channel<MODE, 4> : rows_channel<MODE, 1>;
  int err = allow_smem(reinterpret_cast<const void*>(kernel), smem);
  if (err) return err;
  kernel<<<num_f * C, (int)threads, smem, s>>>(bins_t, S, vals_t, C, n_bins,
                                                out);
  return (int)cudaGetLastError();
}

}  // namespace

// out: f32 [F, n_bins, C]
extern "C" int lgbt_hist_rows(const uint8_t* bins_t, long S, int num_f,
                              const float* vals_t, int C, int n_bins,
                              int mode, float* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (mode) {
    case 0:
      return run<0>(bins_t, S, num_f, vals_t, C, n_bins, out, s);
    case 1:
      return run<1>(bins_t, S, num_f, vals_t, C, n_bins, out, s);
    case 2:
      return run<2>(bins_t, S, num_f, vals_t, C, n_bins, out, s);
  }
  return (int)cudaErrorInvalidValue;
}
