// The three radix histogram kernels of hist_kernel=auto at >= 128 bins.
//
// Replaces three TPU kernels of lightgbm_tpu/ops/hist_pallas.py, each over
// bins_t u8 [F, n], grad/hess f32 [n] and leaf_of_row i32 [n]:
//   * histogram_radix_single_pallas -> lgbt_hist_radix_single: the root
//     pass and the strict grower's per-split pass, f32 [F, B, 4]; rows with
//     leaf_of_row < 0 are excluded;
//   * histogram_radix_joint_pallas -> lgbt_hist_radix_joint: the masked
//     pass of G <= 4 leaves (the warm-up ladder's widths 1 and 4),
//     f32 [G, F, B, 4];
//   * histogram_leaves_radix2_pallas -> lgbt_hist_radix2: the masked pass of
//     K > 4 leaves (width 16 and every K = 42 full pass), f32 [K, F, B, 4]:
//     the one-launch cluster kernel of masked.cuh (the function hist.cu's
//     lgbt_hist_leaves computes too).
// Slots repeating an earlier slot's leaf get identical copies.
//
// The TPU kernels split bin = 16*hi + lo and contract nibble one-hots on the
// MXU, with p-fold off-diagonal waste, because the TPU has no fast scatter.
// None of that carries over: on Hopper the function is a scatter into
// shared memory, and the kernels differ in how a row finds its slot and how
// a block's shared memory is spent:
//   * radix_single up to 131,072 rows (the strict grower runs below 100k):
//     one cluster of up to 8 blocks per feature group covers every row
//     (cluster_hist.cuh), one feature per block at F = 28 (224 blocks of
//     512 threads).  Each block scans its chunk of leaf ids four rows at a
//     time, two quads in flight (one 16-byte load each; grad, hess and the
//     feature's four bin bytes in one load each, only for quads holding a
//     selected row), into one accumulator of [3][features][B] in shared
//     memory (6 KB per feature in float32), values converted with one
//     multiply, 64-bit sums as two native 32-bit atomics; then the cluster
//     sums its blocks' accumulators through distributed shared memory and
//     writes f32 itself.  One launch: no global accumulator, memset,
//     finalize or global atomics.
//     The float32/bfloat16 scale comes from the caller (pass_scale, once per
//     tree) or, when not given, from the cluster's own max |grad|, |hess|
//     over all rows, inside the same launch;
//   * radix_single above that (the 1M-row root pass of the default recipe):
//     hist_common.cuh's block core with 8 private copies (one per four
//     warps) and 4 features, so a row's leaf, grad and hess are read once
//     for four features (96 KB at B = 256 in int8, two blocks per SM; the
//     64-bit sums of float32 and bfloat16 take 192 KB);
//   * radix_joint: G <= 4 leaf ids sit in registers (no slot table); 4
//     features x G slots x 2 copies (96 KB at G = 4, B = 256).
//
// Bound on the H100: bytes.  A 1M-row pass at F = 28 reads 28 MB of bins and
// 12 MB of grad, hess and leaf ids and writes K*F*B*16 bytes (0.46 MB per
// slot): 40-45 MB, ~0.012-0.013 ms at 3.35 TB/s.  A strict split reads the
// n leaf ids and, for its selected rows only, 28 bin bytes and grad/hess:
// 0.5-2.1 MB at 90k rows, under a microsecond.  What sets the cluster
// kernel's pace is latency: each step waits for its leaf ids, then for the
// selected rows' values (about half its time at 1/32 of rows selected),
// then come two cluster barriers and the reduction through distributed
// shared memory (a quarter).
// The block core still re-reads a row's leaf, grad and hess once per
// feature group (from L2) and flushes one global atomic per non-zero cell
// per block.

#include "masked.cuh"

namespace {

template <int MODE>
__global__ void __launch_bounds__(kThreads)
    radix_single_kernel(Task t, typename Val<MODE>::T* __restrict__ glob) {
  hist_block<MODE, SEL_ROOT>(t, glob);
}

template <int MODE>
__global__ void __launch_bounds__(kThreads)
    radix_joint_kernel(Task t, typename Val<MODE>::T* __restrict__ glob) {
  hist_block<MODE, SEL_FEW>(t, glob);
}

constexpr int kRadixThreads = 512;
constexpr int kRadixMaxFpb = 4;
constexpr long kClusterRows = 16384;  // most rows per block of the cluster

// radix_single over one cluster per feature group (blockIdx.x), block q of
// the cluster taking rows [q rpb, (q + 1) rpb).  Shared memory: one
// accumulator of planes (channel, feature) x B bins (Acc; a second private
// copy measured no faster at 90k rows), then two words for the block's
// max |grad|, |hess| (OWN: the scale is found here).
// VEC = 4: n % 4 == 0 and aligned operands; a thread takes two quads of
// rows per step, both quads' loads in flight together.
template <int MODE, bool OWN, int VEC>
__global__ void __launch_bounds__(kRadixThreads, 2)
    radix_single_cluster(const uint8_t* __restrict__ bins_t, long n,
                         int num_f, const float* __restrict__ grad,
                         const float* __restrict__ hess,
                         const int* __restrict__ lor, int n_bins, int fpb,
                         long rpb,
                         const unsigned* __restrict__ vmax,
                         float* __restrict__ out) {
  typedef typename Val<MODE>::T T;
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cl = cg::this_cluster();
  const int f0 = blockIdx.x * fpb;
  const int nf = min(fpb, num_f - f0);
  const long r0 = (long)cl.block_rank() * rpb;
  const long r1 = min(n, r0 + rpb);
  const int cells = 3 * fpb * n_bins;  // planes (channel, feature)
  const int words = cells * Acc<MODE>::kWords;
  unsigned* w = reinterpret_cast<unsigned*>(smem);
  unsigned* part = w + words;
  for (int i = threadIdx.x; i < words; i += blockDim.x) w[i] = 0;
  if (threadIdx.x < 2) part[threadIdx.x] = 0;
  __syncthreads();
  int sg = 0, sh = 0;
  if (MODE != 0) {
    unsigned vg, vh;
    if (OWN) {
      block_absmax2<VEC>(grad, hess, r0, r1, part);
      cl.sync();
      vg = cluster_max(cl, part, 0);
      vh = cluster_max(cl, part, 1);
    } else {
      vg = vmax[0];
      vh = vmax[1];
    }
    sg = fixed_shift(vg, n);
    sh = fixed_shift(vh, n);
  }
  const Acc<MODE> a = {w, cells};
  const int plane = fpb * n_bins;
  const Cvt<MODE> cg_ = {ldexp(1.0, sg)}, ch_ = {ldexp(1.0, sh)};
  // one selected row: (grad, hess, 1) into each feature's planes
  auto row = [&](float gv, float hv, const unsigned* bw, int u) {
    const T g = cg_(gv);
    const T h = ch_(hv);
#pragma unroll
    for (int j = 0; j < kRadixMaxFpb; ++j) {
      const int b = (bw[j] >> (8 * u)) & 255;
      if (j < nf && b < n_bins) {
        const int c = j * n_bins + b;
        a.add(c, g);
        a.add(plane + c, h);
        a.inc(2 * plane + c);
      }
    }
  };
  if (VEC == 4) {
    const long step = 4L * blockDim.x;
    for (long r = r0 + 4L * threadIdx.x; r < r1; r += 2 * step) {
      const long rr[2] = {r, r + step};
      int4 l4[2];
      bool any[2];
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        l4[k] = rr[k] < r1 ? *reinterpret_cast<const int4*>(lor + rr[k])
                           : make_int4(-1, -1, -1, -1);
        any[k] = (l4[k].x & l4[k].y & l4[k].z & l4[k].w) >= 0;
      }
      float4 g4[2], h4[2];
      unsigned bw[2][kRadixMaxFpb];
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        if (any[k]) {
          g4[k] = *reinterpret_cast<const float4*>(grad + rr[k]);
          h4[k] = *reinterpret_cast<const float4*>(hess + rr[k]);
        }
#pragma unroll
        for (int j = 0; j < kRadixMaxFpb; ++j)
          bw[k][j] = any[k] && j < nf
                         ? *reinterpret_cast<const unsigned*>(
                               bins_t + (long)(f0 + j) * n + rr[k])
                         : 0u;
      }
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        if (!any[k]) continue;
        if (l4[k].x >= 0) row(g4[k].x, h4[k].x, bw[k], 0);
        if (l4[k].y >= 0) row(g4[k].y, h4[k].y, bw[k], 1);
        if (l4[k].z >= 0) row(g4[k].z, h4[k].z, bw[k], 2);
        if (l4[k].w >= 0) row(g4[k].w, h4[k].w, bw[k], 3);
      }
    }
  } else {
    for (long r = r0 + threadIdx.x; r < r1; r += blockDim.x) {
      if (lor[r] < 0) continue;
      unsigned bw[kRadixMaxFpb];
#pragma unroll
      for (int j = 0; j < kRadixMaxFpb; ++j)
        bw[j] = j < nf ? bins_t[(long)(f0 + j) * n + r] : 0u;
      row(grad[r], hess[r], bw, 0);
    }
  }
  __syncthreads();
  cl.sync();
  // out [F, B, 4]: output o of this feature group is (feature j, bin b,
  // channel o & 3), channel 3 zero
  float* o = out + (long)f0 * n_bins * 4;
  cluster_write<MODE>(
      cl, a, nf * n_bins * 4,
      [&](int i) { return (i & 3) == 3 ? -1 : (i & 3) * plane + (i >> 2); },
      [&](int i, T v) {
        const int ch = i & 3;
        o[i] = ch == 3 ? 0.0f
                       : Val<MODE>::out(v, ch == 0 ? sg : (ch == 1 ? sh : 0));
      });
  cl.sync();  // no block leaves while another reads its shared memory
}

// The cluster path's shape for n rows, or false when n needs the block
// core (more than kClusterRows rows per block)
struct ClusterPlan {
  int cs, fpb, groups;
  long rpb;
};

bool plan_single(long n, int num_f, ClusterPlan* p) {
  long cs = (n + 2047) / 2048;
  p->cs = (int)(cs < 1 ? 1 : (cs > kMaxCluster ? kMaxCluster : cs));
  p->rpb = ((n + p->cs - 1) / p->cs + 3) / 4 * 4;
  if (p->rpb > kClusterRows) return false;
  // the fewest features per block that still gives every SM a block
  int fpb = num_f * p->cs / kSMs;
  p->fpb = fpb < 1 ? 1 : (fpb > kRadixMaxFpb ? kRadixMaxFpb : fpb);
  p->groups = (num_f + p->fpb - 1) / p->fpb;
  return true;
}

template <int MODE>
int run_single(Task t, void* scratch, float* out, cudaStream_t s) {
  typedef typename Val<MODE>::T T;
  if (t.num_f <= 0) return 0;
  ClusterPlan p;
  if (!plan_single(t.n, t.num_f, &p))
    return run_hist<MODE>(radix_single_kernel<MODE>, t, 4, false, 8, false,
                          scratch, out, s);
  const size_t smem =
      (size_t)p.fpb * t.n_bins * 3 * sizeof(T) + 16;
  const bool vec = t.n % 4 == 0 && aligned(t.bins_t, 4) &&
                   aligned(t.grad, 16) && aligned(t.hess, 16) &&
                   aligned(t.lor, 16);
  const bool own = MODE != 0 && t.vmax == nullptr;
#define LGBT_SINGLE(OWN, VEC)                                              \
  return launch_clusters(radix_single_cluster<MODE, OWN, VEC>,            \
                         dim3(p.groups, p.cs), kRadixThreads, smem, s,    \
                         t.bins_t, t.n, t.num_f, t.grad, t.hess, t.lor,   \
                         t.n_bins, p.fpb, p.rpb, t.vmax, out)
  if (own) {
    if (vec) LGBT_SINGLE(true, 4);
    LGBT_SINGLE(true, 1);
  }
  if (vec) LGBT_SINGLE(false, 4);
  LGBT_SINGLE(false, 1);
#undef LGBT_SINGLE
}

enum { KIND_SINGLE = 0, KIND_JOINT = 1 };

template <int MODE>
int run(int kind, Task t, void* scratch, float* out, cudaStream_t s) {
  switch (kind) {
    case KIND_SINGLE:
      return run_single<MODE>(t, scratch, out, s);
    case KIND_JOINT:
      return run_hist<MODE>(radix_joint_kernel<MODE>, t, 4, false, 2, false,
                            scratch, out, s);
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

// scratch: zero-filled [K, num_f, n_bins, 3] int32 (mode 0) or int64 (1,
// 2) plus one int64 for the modes' scale (hist_common.cuh run_hist);
// out: f32 [K, num_f, n_bins, 4] (K = 1 for the root pass).
// radix_single: vmax, when not null, holds the float bits of max finite
// |grad| and |hess| (lgbt_pass_scale); scratch is read only when
// lgbt_radix_single_scratch says so, and may be null otherwise.
extern "C" int lgbt_radix_single_scratch(long n, int num_f) {
  ClusterPlan p;
  return num_f > 0 && !plan_single(n, num_f, &p);
}

extern "C" int lgbt_hist_radix_single(const uint8_t* bins_t, long n,
                                      int num_f, const float* grad,
                                      const float* hess, const int* lor,
                                      int n_bins, int mode,
                                      const unsigned* vmax, void* scratch,
                                      float* out, void* stream) {
  Task t = {bins_t, n, num_f, grad, hess, lor, nullptr, 1, n_bins};
  t.vmax = vmax;
  return dispatch(KIND_SINGLE, mode, t, scratch, out, stream);
}

// out: zero-filled u32 [2] <- the float bits of max finite |grad|, |hess|
extern "C" int lgbt_pass_scale(const float* grad, const float* hess, long n,
                               unsigned* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  int err = launch_absmax(grad, n, out, s);
  if (!err) err = launch_absmax(hess, n, out + 1, s);
  return err;
}

extern "C" int lgbt_hist_radix_joint(const uint8_t* bins_t, long n,
                                     int num_f, const float* grad,
                                     const float* hess, const int* lor,
                                     const int* leaves, int G, int n_bins,
                                     int mode, void* scratch, float* out,
                                     void* stream) {
  if (G > kFewSlots) return (int)cudaErrorInvalidValue;
  Task t = {bins_t, n, num_f, grad, hess, lor, leaves, G, n_bins};
  return dispatch(KIND_JOINT, mode, t, scratch, out, stream);
}

// out: f32 [K, num_f, n_bins, 4] (masked.cuh run_masked)
extern "C" int lgbt_hist_radix2(const uint8_t* bins_t, long n, int num_f,
                                const float* grad, const float* hess,
                                const int* lor, const int* leaves, int K,
                                int n_bins, int mode, float* out,
                                void* stream) {
  return run_masked(bins_t, n, num_f, grad, hess, lor, leaves, K, n_bins,
                    mode, out, (cudaStream_t)stream);
}
