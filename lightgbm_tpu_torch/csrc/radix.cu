// The three radix histogram kernels of hist_kernel=auto at >= 128 bins.
//
// Replaces three TPU kernels of lightgbm_tpu/ops/hist_pallas.py, each over
// bins_t u8 [F, n], grad/hess f32 [n] and leaf_of_row i32 [n]:
//   * histogram_radix_single_pallas -> lgbt_hist_radix_single: the root
//     pass and the strict grower's per-split pass, f32 [F, B, 4]; every row
//     whose leaf_of_row is >= 0 counts, whatever its id;
//   * histogram_radix_joint_pallas (G <= 4 leaves, the warm-up ladder's
//     widths 1 and 4) and histogram_leaves_radix2_pallas (K > 4 leaves,
//     width 16 and every K = 42 full pass) -> lgbt_hist_radix2: the masked
//     pass, f32 [K, F, B, 4], slots repeating an earlier slot's leaf
//     getting copies: the one-launch cluster kernel of masked.cuh (the
//     function hist.cu's lgbt_hist_leaves computes too), whose plan picks
//     the features per block and the cluster size for the K it is given.
//
// The TPU kernels split bin = 16*hi + lo and contract nibble one-hots on the
// MXU, with p-fold off-diagonal waste, because the TPU has no fast scatter.
// None of that carries over: on Hopper the function is a scatter into
// shared memory, summed across a thread-block cluster through distributed
// shared memory, in one launch (no global accumulator, memset, finalize or
// global atomic).  radix_single takes one of two cluster kernels:
//   * up to 131,072 rows (the strict grower runs below 100k): one cluster
//     of up to 8 blocks per feature group covers every row
//     (cluster_hist.cuh), one feature per block at F = 28 (224 blocks of
//     512 threads).  Each block scans its chunk of leaf ids four rows at a
//     time, two quads in flight (one 16-byte load each; grad, hess and the
//     feature's four bin bytes in one load each, only for quads holding a
//     selected row), into one accumulator of [3][features][B] in shared
//     memory (6 KB per feature in float32), values converted with one
//     multiply, 64-bit sums as two native 32-bit atomics; then the cluster
//     sums its blocks' accumulators through distributed shared memory and
//     writes f32 itself;
//   * above that (the 1M-row root pass of the default recipe): masked.cuh's
//     cluster kernel with the PICK_ANY selector (slot 0 for every row whose
//     leaf id is >= 0; K = 1, no slot table), planned like the masked pass.
// The float32/bfloat16 scale comes from the caller (pass_scale, once per
// tree) or, when not given, from the cluster's own max |grad|, |hess| over
// all rows, inside the same launch.
//
// Bound on the H100: bytes.  A 1M-row pass at F = 28 reads 28 MB of bins and
// 12 MB of grad, hess and leaf ids and writes K*F*B*16 bytes (0.46 MB per
// slot): 40-45 MB, ~0.012-0.013 ms at 3.35 TB/s.  A strict split reads the
// n leaf ids and, for its selected rows only, 28 bin bytes and grad/hess:
// 0.5-2.1 MB at 90k rows, under a microsecond.  What sets the small cluster
// kernel's pace is latency: each step waits for its leaf ids, then for the
// selected rows' values (about half its time at 1/32 of rows selected),
// then come two cluster barriers and the reduction through distributed
// shared memory (a quarter).

#include "masked.cuh"

namespace {

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

// The cluster path's shape for n rows, or false when n takes masked.cuh's
// kernel (more than kClusterRows rows per block)
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
int run_single(const ClusterPlan& p, const uint8_t* bins_t, long n,
               int num_f, const float* grad, const float* hess,
               const int* lor, int n_bins, const unsigned* vmax, bool vec,
               float* out, cudaStream_t s) {
  typedef typename Val<MODE>::T T;
  const size_t smem = (size_t)p.fpb * n_bins * 3 * sizeof(T) + 16;
  const bool own = MODE != 0 && vmax == nullptr;
#define LGBT_SINGLE(OWN, VEC)                                              \
  return launch_clusters(radix_single_cluster<MODE, OWN, VEC>,            \
                         dim3(p.groups, p.cs), kRadixThreads, smem, s,    \
                         bins_t, n, num_f, grad, hess, lor, n_bins, p.fpb, \
                         p.rpb, vmax, out)
  if (own) {
    if (vec) LGBT_SINGLE(true, 4);
    LGBT_SINGLE(true, 1);
  }
  if (vec) LGBT_SINGLE(false, 4);
  LGBT_SINGLE(false, 1);
#undef LGBT_SINGLE
}

}  // namespace

// out: f32 [num_f, n_bins, 4]; mode 0 int8, 1 float32, 2 bfloat16; vmax,
// when not null, holds the float bits of max finite |grad| and |hess|
// (lgbt_pass_scale), else the launch finds them.
extern "C" int lgbt_hist_radix_single(const uint8_t* bins_t, long n,
                                      int num_f, const float* grad,
                                      const float* hess, const int* lor,
                                      int n_bins, int mode,
                                      const unsigned* vmax, float* out,
                                      void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (num_f <= 0) return 0;
  const bool vec = n % 4 == 0 && aligned(bins_t, 4) && aligned(grad, 16) &&
                   aligned(hess, 16) && aligned(lor, 16);
  ClusterPlan p;
  if (!plan_single(n, num_f, &p)) {  // masked.cuh's kernel, PICK_ANY
    Masked t = {bins_t, nullptr, n, num_f, grad, hess, lor, nullptr, 1,
                n_bins, 0, 0, 0, reinterpret_cast<float4*>(out)};
    t.vmax = vmax;
    return dispatch_masked<SRC_BYTES, PICK_ANY>(t, vec, mode, s);
  }
  switch (mode) {
    case 0:
      return run_single<0>(p, bins_t, n, num_f, grad, hess, lor, n_bins,
                           vmax, vec, out, s);
    case 1:
      return run_single<1>(p, bins_t, n, num_f, grad, hess, lor, n_bins,
                           vmax, vec, out, s);
    case 2:
      return run_single<2>(p, bins_t, n, num_f, grad, hess, lor, n_bins,
                           vmax, vec, out, s);
  }
  return (int)cudaErrorInvalidValue;
}

// out: zero-filled u32 [2] <- the float bits of max finite |grad|, |hess|
extern "C" int lgbt_pass_scale(const float* grad, const float* hess, long n,
                               unsigned* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  int err = launch_absmax(grad, n, out, s);
  if (!err) err = launch_absmax(hess, n, out + 1, s);
  return err;
}

// out: f32 [K, num_f, n_bins, 4] (masked.cuh run_masked): the kernel of
// histogram_radix_joint and histogram_leaves_radix2; gate: null, or i32 [1]
// read on the device, 0 = launch nothing
extern "C" int lgbt_hist_radix2(const uint8_t* bins_t, long n, int num_f,
                                const float* grad, const float* hess,
                                const int* lor, const int* leaves, int K,
                                int n_bins, int mode, float* out,
                                const int* gate, void* stream) {
  return run_masked(bins_t, n, num_f, grad, hess, lor, leaves, K, n_bins,
                    mode, out, gate, (cudaStream_t)stream);
}
