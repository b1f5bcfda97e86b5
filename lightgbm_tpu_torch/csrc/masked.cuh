// The masked K-leaf (grad, hess, count) histogram of hist.cu
// (histogram_leaves, every masked pass of hist_kernel=onehot and the pooled
// rounds' extended pass; histogram_leaves_rows, the same from row-major
// bins; histogram_payload, the compacted passes of the default recipe),
// radix.cu (histogram_leaves_radix2 and histogram_radix_joint, the masked
// passes of hist_kernel=auto at K > 4 and K <= 4, and the root pass of
// histogram_radix_single above 131,072 rows) and packed.cu
// (histogram_leaves_packed, every masked pass below 128 bins): all compute
// the same function and launch the same kernel, reading bins_t u8 [F, n]
// (SRC_BYTES), the packed mirror words_t i32 [W, n] (SRC_WORDS: one
// 16-byte load gives four rows of a word's four features, transposed into
// the layout of four bins_t rows), row-major bins u8 [n, F] (SRC_ROWS: a
// 32-bit word of each of four rows, transposed the same way, at F % 4 ==
// 0) or the compacted payload i32 [S, W+3] (SRC_PAYLOAD: only its first
// *cnt rows, staged in shared memory a tile at a time; the scale is over
// all S rows, n = S).  A row finds its slot in the leaf -> first-slot table
// of leaves[0, K) (PICK_TABLE), or, in the root pass, takes slot 0 when its
// leaf id is >= 0 (PICK_ANY: K = 1, no leaf ids, no table).
//
// Function: each row whose leaf id is one of leaves[0, K) adds (grad, hess,
// 1) to the cell (first slot of its leaf, feature, bin); bins >= n_bins add
// nothing; the result is f32 [K, F, B, 4] with channel 3 zero, and a slot
// whose leaf id repeats an earlier slot's gets a copy of that slot.  Modes
// as hist_common.cuh: int8 levels summed exactly in int32; float32 and
// bfloat16 in 64-bit fixed point at 2^fixed_shift(max finite |grad|
// (|hess|) over all n rows, n), so every call gives the same bits.
//
// Design: ONE launch of thread-block clusters, one cluster per (feature
// group, slot group) covering all n rows, block q of the cluster taking the
// q-th chunk of rows.  A block keeps the leaf -> first-slot table and an
// accumulator of planes (slot, channel, feature) x B bins in shared memory
// (Acc: int32 cells, or 64-bit sums as two native 32-bit atomics; the bin
// innermost, so the lanes of a warp adding rows to random bins spread over
// the banks).  It scans its rows four to a 16-byte load of leaf ids, two
// quads in flight, finds each row's slot in the table (leaf ids outside
// [0, 2048) fall back to a linear search over the K ids), and loads grad,
// hess and each feature's four bin bytes (one 32-bit load) only for quads
// that hold a row of its slot group.  In float32/bfloat16 the blocks first
// find their chunk's max |grad|, |hess| and combine them through
// distributed shared memory, so the scale is the one over all rows.  After
// a cluster barrier the blocks sum the cluster's accumulators through
// distributed shared memory, each taking a share of the outputs, and write
// f32 [K, F, B, 4] themselves: a repeated slot is written from the first
// slot's sums (the per-block table of first slots says which).  No global
// accumulator, memset, finalize kernel or global atomic.  A caller that
// holds the float32/bfloat16 scale of the pass (pass_scale) hands it in
// and the blocks skip their scan.
//
// The payload's rows are 40 contiguous bytes at W = 7: a block brings them
// in 1,024-row tiles (a row a thread), two in a ring, with 16-byte
// cp.async copies, and takes a row's leaf id, grad, hess and bin word from
// shared memory.  Every feature group's cluster reads the rows again from
// L2, which sets the pace in int8 (on an H100 80GB HBM3 at 700 W the same
// kernel without its shared-memory adds ran in 85% of the time); in
// float32 and bfloat16 every cluster also scans all S rows for the scale.
//
// The plan (plan_masked) weighs the features per block and slot groups
// that the shared memory holds against the cluster size (up to the
// portable 8 for bins_t and row-major bins; up to 16, non-portable, for the
// words, whose F = 28 makes only 7 groups of four features, and the
// payload) and the clusters cudaOccupancyMaxActiveClusters lets run at
// once.  At K <= 4 and K = 1 (n = 1M, F = 28, B = 256) it takes two
// features a block in clusters of 8, the fastest of every (features a
// block, cluster size) forced on an H100 80GB HBM3.  A shape no plan
// fits, or a cluster launch the device refuses, returns its CUDA error:
// there is no other path.  (cluster_write, which radix_single's
// clusters use, writes one float a lane and made this kernel 10% slower at
// K = 42 than its own float4 loop.)
//
// Bound on the H100: bytes.  A 1M-row pass at F = 28 reads 28 MB of bins and
// 12 MB of grad, hess and leaf ids and writes K*F*B*16 bytes (4.8 MB at
// K = 42, B = 256): 44.8 MB, 0.0134 ms at 3.35 TB/s.  At K = 42 in int8 a
// block holds one feature's 129 KB, so 28 clusters of 4 blocks run on 112
// of the 132 SMs, each block over 250,000 rows, and every cluster re-reads
// the leaf ids, grad and hess (from L2).  Development variants put the pace
// in that per-row path, not in the atomics: without its shared-memory
// atomics the kernel ran 6% faster, with one quad in flight as fast as
// with two, with four slower.

#pragma once

#include "cluster_hist.cuh"

namespace {

constexpr int kMaskedThreads = 1024;
constexpr int kMaskedMaxFpb = 4;
constexpr int kReduceBatch = 4;  // remote reads in flight per channel
constexpr int kMaxClusterWords = 16;  // non-portable: the packed source
                                      // and the payload

// How a row finds its slot (masked_cluster's fourth template argument)
enum { PICK_TABLE = 0,  // the first of leaves[0, K) equal to its leaf id,
                        // through the leaf -> first-slot table
       PICK_ANY = 1 };  // slot 0 when its leaf id is >= 0 (K = 1, no ids:
                        // the root pass of histogram_radix_single)

// PICK_ANY's private accumulator copies, lane i adding into copy
// i % kAnyCopies (each copy one word further along the banks): with every
// row in one slot, the lanes of a warp that share a bin share an address,
// and a feature of few values serializes the warp's adds.  1M-row root
// pass, int8, bins of 3 of the 28 features taking 3 values (NVIDIA H100
// 80GB HBM3, 700 W): 1 copy 0.1025 ms, 2 0.0940, 4 0.0832, 8 0.0714; on
// uniform bins 0.0627 with 1 copy, 0.0641 with 8.
constexpr int kAnyCopies = 8;

struct Masked {
  const uint8_t* bins_t;     // SRC_BYTES: u8 [F, n]; SRC_ROWS: u8 [n, F]
  const unsigned* words_t;   // SRC_WORDS: i32 [W, n], byte j = feature 4w+j
  long n;                    // rows (SRC_PAYLOAD: S, the scale's count)
  int num_f;
  const float* grad;
  const float* hess;
  union {
    const int* lor;   // the sources but SRC_PAYLOAD: i32 [n] leaf of row
    const int* rows;  // SRC_PAYLOAD: null, or i32 [1]: the pass's S when
                      // below n (the rows its float32 scale is taken
                      // over; *cnt <= it)
  };
  const int* leaves;
  int K;
  int n_bins;
  int fpb;   // features per block
  int spg;   // slots per slot group
  long rpb;  // rows per block, a multiple of 4
  float4* out;
  union {
    const int* payload;    // SRC_PAYLOAD: i32 [S, W+3]: W bin words, grad
                           // bits, hess bits, leaf id; rows at >= *cnt
                           // excluded
    const unsigned* vmax;  // PICK_ANY: null, or the float bits of max
                           // finite |grad|, |hess| over all n rows
                           // (pass_scale): no scan
  };
  int W;               // SRC_PAYLOAD: bin words a row
  union {
    const int* cnt;    // SRC_PAYLOAD: i32 [1], read on the device
    const int* gate;   // the other sources: null, or i32 [1]: 0 = the
                       // whole launch exits at once and writes nothing
                       // (the device bucket dispatch launches both
                       // passes, the masked one gated)
  };
  int tile_rows;       // SRC_PAYLOAD: rows of each row tile
};
// (gate and rows share the fields of cnt and lor, which their sources do
// not read: the struct keeps its size and layout, which the payload
// pass's speed depends on: with gate and rows as fields of their own the
// int8 pass ran 2-9% slower at the four buckets of 1M rows, chip_smoke.py
// --ab on an NVIDIA H100 80GB HBM3 at 700 W)

// SRC_PAYLOAD's row tiles in shared memory: kStages tiles of at most
// kTileBytes / kStages bytes each, kStages - 1 of them in flight (two of
// 1,024 rows measured faster than three of 680 or four of 512, which
// leave threads without a row; H100 80GB HBM3, 700 W)
constexpr int kStages = 2;
constexpr int kTileBytes = 80 << 10;

// Rows of a payload row tile: 1,024 rows (a row a thread) of W + 3 words at
// W = 7, a multiple of 4 (so a tile of a chunk that starts at a multiple of
// 4 starts 16-byte aligned)
__host__ __device__ inline int payload_tile_rows(int W) {
  const int r = kTileBytes / kStages / (4 * (W + 3)) / 4 * 4;
  return r < 4 ? 4 : (r > kMaskedThreads ? kMaskedThreads : r);
}

// Shared-memory bytes of the accumulator of ``slots`` slots and ``fpb``
// features in ``copies`` copies (more than one: a word of padding each, so
// that a bin's cell falls in another bank in every copy), rounded up to 16
// (the row tiles follow it)
__host__ __device__ inline size_t masked_acc_bytes(int slots, int fpb,
                                                   int n_bins, int words,
                                                   int copies) {
  return ((size_t)copies * ((size_t)slots * 3 * fpb * n_bins * words +
                            (copies > 1 ? 1 : 0)) * sizeof(unsigned) + 15) /
         16 * 16;
}

// cp.async: a 16-byte (both addresses 16-byte aligned) or 4-byte copy from
// device memory into shared memory that no register holds; commit closes a
// group of copies, wait<N> waits until at most N groups are in flight
__device__ inline void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}
__device__ inline void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ inline void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ inline void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}

// The block's copy of ``bytes`` (a multiple of 4; both 16-byte aligned)
// from src to dst: 16 bytes a thread, the rest in words, with cp.async
__device__ inline void copy_tile(int* dst, const int* src, int bytes) {
  const int n16 = bytes >> 4;
  for (int i = threadIdx.x; i < n16; i += blockDim.x)
    cp_async16(dst + 4 * i, src + 4 * i);
  for (int i = 4 * n16 + threadIdx.x; i < bytes >> 2; i += blockDim.x)
    cp_async4(dst + i, src + i);
}

// Largest finite |grad| and |hess| (payload columns W and W + 1) of rows
// [r0, r1) as float bits into out[0], out[1] (as block_absmax2; four rows
// a thread in flight measured slower on an H100 80GB HBM3 at 700 W)
__device__ inline void block_absmax_payload(const int* __restrict__ payload,
                                            int W, long r0, long r1,
                                            unsigned* out) {
  unsigned m[2] = {0u, 0u};
  for (long r = r0 + threadIdx.x; r < r1; r += blockDim.x) {
    const int* p = payload + r * (W + 3) + W;
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const float y = fabsf(__int_as_float(__ldg(p + k)));
      if (y <= FLT_MAX && __float_as_uint(y) > m[k]) m[k] = __float_as_uint(y);
    }
  }
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const unsigned y = __reduce_max_sync(0xffffffffu, m[k]);
    if ((threadIdx.x & 31) == 0 && y != 0) atomicMax(out + k, y);
  }
}

// Shared memory before the accumulator: the slot table, four header words
// (use the table, owned slots, max |grad|, max |hess|), first[K], own[K]
__host__ __device__ inline size_t masked_head_bytes(int K) {
  return ((size_t)(kFixedInts + 2 * K) * sizeof(int) + 15) / 16 * 16;
}

// Byte u of m[u'] is feature u of row u' -> byte u' of bw[u] (a 4 x 4 byte
// transpose: four rows of a word into the layout of four bins_t rows)
__device__ inline void rows_to_features(unsigned m0, unsigned m1, unsigned m2,
                                        unsigned m3, unsigned* bw) {
  const unsigned t0 = __byte_perm(m0, m1, 0x5140);  // m0.0 m1.0 m0.1 m1.1
  const unsigned t1 = __byte_perm(m0, m1, 0x7362);  // m0.2 m1.2 m0.3 m1.3
  const unsigned t2 = __byte_perm(m2, m3, 0x5140);
  const unsigned t3 = __byte_perm(m2, m3, 0x7362);
  bw[0] = __byte_perm(t0, t2, 0x5410);
  bw[1] = __byte_perm(t0, t2, 0x7632);
  bw[2] = __byte_perm(t1, t3, 0x5410);
  bw[3] = __byte_perm(t1, t3, 0x7632);
}

// SRC: SRC_BYTES (hist_common.cuh) reads feature f's row of bins_t; SRC_WORDS
// reads word f >> 2 of words_t, shifted so that byte j is feature f0 + j;
// SRC_PAYLOAD reads word f >> 2 of a payload row in a shared-memory tile;
// SRC_ROWS reads a row's bytes f0.. of bins_t (VEC = 4: word f0 >> 2 of
// four rows, F % 4 == 0, transposed as the words are).  PICK: PICK_TABLE
// or PICK_ANY.
template <int MODE, int VEC, int SRC, int PICK>
__global__ void __launch_bounds__(kMaskedThreads, 1)
    masked_cluster(const Masked t) {
  // the gate's load is issued here and waited for after the accumulator's
  // zeroing; every block of every cluster reads the same gate, so all
  // leave together, before the first cluster barrier (the payload pass
  // has none: the dispatch gives it a count of 0 instead)
  const int on =
      SRC == SRC_PAYLOAD || t.gate == nullptr ? 1 : __ldg(t.gate);
  typedef typename Val<MODE>::T T;
  constexpr int kCopies = PICK == PICK_ANY ? kAnyCopies : 1;
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cl = cg::this_cluster();
  int* tab = reinterpret_cast<int*>(smem);
  int* hdr = tab + kLeafTable;
  unsigned* part = reinterpret_cast<unsigned*>(hdr + 2);
  int* first = tab + kFixedInts;  // slot k -> first slot of its leaf
  int* own = first + t.K;         // slots written by this slot group
  unsigned* w = reinterpret_cast<unsigned*>(smem + masked_head_bytes(t.K));
  int* tiles = reinterpret_cast<int*>(
      smem + masked_head_bytes(t.K) +
      masked_acc_bytes(t.spg, t.fpb, t.n_bins, Acc<MODE>::kWords, kCopies));
  const int f0 = blockIdx.x * t.fpb;
  const int nf = min(t.fpb, t.num_f - f0);
  const unsigned* wrow = SRC == SRC_WORDS ? t.words_t + (long)(f0 >> 2) * t.n
                                          : nullptr;
  const int wsh = 8 * (f0 & 3);
  const int k0 = blockIdx.z * t.spg;
  const int ns = min(t.spg, t.K - k0);
  const long r0 = (long)cl.block_rank() * t.rpb;
  const long r1 = min(t.n, r0 + t.rpb);
  const int nb = t.n_bins;
  const int plane = t.fpb * nb;  // one (slot, channel): features x bins
  const int cells = ns * 3 * plane;
  // words of one accumulator copy (masked_acc_bytes)
  const int cw = cells * Acc<MODE>::kWords + (kCopies > 1 ? 1 : 0);
  for (int i = threadIdx.x; i < kCopies * cw; i += blockDim.x) w[i] = 0;
  if (threadIdx.x < 3) hdr[1 + threadIdx.x] = 0;
  if (on == 0) return;
  int ut = 0;
  if constexpr (PICK == PICK_TABLE) {
    build_slot_table(tab, hdr, t.leaves, t.K);  // syncs the zeroing too
    ut = hdr[0];
    for (int k = threadIdx.x; k < t.K; k += blockDim.x)
      first[k] = slot_of(__ldg(t.leaves + k), tab, ut, t.leaves, t.K);
    __syncthreads();
    if (threadIdx.x == 0) {  // in slot order: every block deals the same list
      int m = 0;
      for (int k = 0; k < t.K; ++k)
        if (first[k] >= k0 && first[k] < k0 + ns) own[m++] = k;
      hdr[1] = m;
    }
  } else {
    if (threadIdx.x == 0) {  // the one slot, after thread 0 zeroed hdr[1]
      first[0] = own[0] = 0;
      hdr[1] = 1;
    }
    __syncthreads();
  }
  int sg = 0, sh = 0;
  if (PICK == PICK_ANY && MODE != 0 && t.vmax != nullptr) {  // no scan
    __syncthreads();
    sg = fixed_shift(__ldg(t.vmax), t.n);
    sh = fixed_shift(__ldg(t.vmax + 1), t.n);
  } else if (MODE != 0) {
    // the rows the scale is taken over: the pass's n, or the payload
    // pass's S (the buffer's rows, or the first *rows of them)
    long s_rows = t.n;
    if constexpr (SRC == SRC_PAYLOAD) {  // all S rows, over every block
      if (t.rows != nullptr) s_rows = min(t.n, (long)max(__ldg(t.rows), 0));
      const long nbl = (long)cl.num_blocks();
      const long ra = (s_rows + nbl - 1) / nbl;
      const long a0 = (long)cl.block_rank() * ra;
      block_absmax_payload(t.payload, t.W, a0, min(s_rows, a0 + ra), part);
    } else {
      block_absmax2<VEC>(t.grad, t.hess, r0, r1, part);
    }
    cl.sync();
    sg = fixed_shift(cluster_max(cl, part, 0), s_rows);
    sh = fixed_shift(cluster_max(cl, part, 1), s_rows);
  } else {
    __syncthreads();
  }
  // a row's slot in this group, or -1
  auto slot = [&](int l) {
    if constexpr (PICK == PICK_ANY) {
      return l >= 0 ? 0 : -1;
    } else {
      const int s = slot_of(l, tab, ut, t.leaves, t.K) - k0;
      return s >= 0 && s < ns ? s : -1;
    }
  };
  const Acc<MODE> a = {
      kCopies > 1 ? w + (int)(threadIdx.x % kCopies) * cw : w, cells};
  const Cvt<MODE> cvg = {ldexp(1.0, sg)}, cvh = {ldexp(1.0, sh)};
  // one row of local slot s: (grad, hess, 1) into each feature's planes;
  // byte u of bw[j] is the row's bin of feature f0 + j
  auto add = [&](float gv, float hv, const unsigned* bw, int u, int s) {
    const T g = cvg(gv);
    const T h = cvh(hv);
    const int c0 = s * 3 * plane;
#pragma unroll
    for (int j = 0; j < kMaskedMaxFpb; ++j) {
      const int b = (bw[j] >> (8 * u)) & 255;
      if (j < nf && b < nb) {
        const int c = c0 + j * nb + b;
        a.add(c, g);
        a.add(c + plane, h);
        a.inc(c + 2 * plane);
      }
    }
  };
  if constexpr (SRC == SRC_PAYLOAD) {
    // rows [0, cnt) dealt to the blocks of the cluster in chunks of a
    // multiple of 4, each chunk through two row tiles in shared memory,
    // the next in flight (16-byte cp.async copies) while the block adds
    // the rows of this one, a row a thread
    // cnt <= *rows where rows is given: the buffer's bound holds either way
    const long c = min(t.n, (long)max(__ldg(t.cnt), 0));
    const long ncs = (long)cl.num_blocks();
    const long rp = ((c + ncs - 1) / ncs + 3) / 4 * 4;
    const long p0 = (long)cl.block_rank() * rp;
    const long p1 = min(c, p0 + rp);
    const int wp = t.W + 3;
    const int R = t.tile_rows;
    const int fw = f0 >> 2;
    static_assert(kStages == 2, "the staging toggles two tiles");
    auto copy = [&](long q, int buf) {  // rows [q, q + R) of the chunk
      copy_tile(tiles + buf * R * wp, t.payload + q * wp,
                (int)min((long)R, p1 - q) * wp * 4);
    };
    if (p0 < p1) copy(p0, 0);
    cp_async_commit();
    int buf = 0;
    for (long q = p0; q < p1; q += R, buf ^= 1) {
      if (q + R < p1) copy(q + R, buf ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
      __syncthreads();
      const int* tile = tiles + buf * R * wp;
      const int rows = (int)min((long)R, p1 - q);
      for (int r = threadIdx.x; r < rows; r += blockDim.x) {
        const int* row = tile + r * wp;
        const int s = slot(row[wp - 1]);
        if (s < 0) continue;
        const unsigned m = (unsigned)row[fw] >> wsh;
        unsigned bw[kMaskedMaxFpb];
#pragma unroll
        for (int j = 0; j < kMaskedMaxFpb; ++j) bw[j] = m >> (8 * j);
        add(__int_as_float(row[t.W]), __int_as_float(row[t.W + 1]), bw, 0,
            s);
      }
      __syncthreads();  // the tile is free for the copy after next
    }
  } else if (VEC == 4) {
    const long step = 4L * blockDim.x;
    for (long r = r0 + 4L * threadIdx.x; r < r1; r += 2 * step) {
      const long rr[2] = {r, r + step};
      int s[2][4];
      bool any[2];
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int4 l = rr[k] < r1
                           ? __ldg(reinterpret_cast<const int4*>(t.lor + rr[k]))
                           : make_int4(-1, -1, -1, -1);
        s[k][0] = slot(l.x);
        s[k][1] = slot(l.y);
        s[k][2] = slot(l.z);
        s[k][3] = slot(l.w);
        any[k] = (s[k][0] & s[k][1] & s[k][2] & s[k][3]) >= 0;
      }
      float4 g4[2], h4[2];
      unsigned bw[2][kMaskedMaxFpb];
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        if (any[k]) {
          g4[k] = __ldg(reinterpret_cast<const float4*>(t.grad + rr[k]));
          h4[k] = __ldg(reinterpret_cast<const float4*>(t.hess + rr[k]));
        }
        if (SRC == SRC_WORDS) {
          const uint4 m = any[k] ? __ldg(reinterpret_cast<const uint4*>(
                                       wrow + rr[k]))
                                 : make_uint4(0u, 0u, 0u, 0u);
          rows_to_features(m.x >> wsh, m.y >> wsh, m.z >> wsh, m.w >> wsh,
                           bw[k]);
        } else if (SRC == SRC_ROWS) {
          // word f0 >> 2 of each of the four rows (F / 4 words a row)
          const unsigned* rw = reinterpret_cast<const unsigned*>(
                                   t.bins_t) + rr[k] * (t.num_f >> 2) +
                               (f0 >> 2);
          unsigned m[4] = {0u, 0u, 0u, 0u};
          if (any[k]) {
#pragma unroll
            for (int u = 0; u < 4; ++u)
              m[u] = __ldg(rw + u * (t.num_f >> 2)) >> wsh;
          }
          rows_to_features(m[0], m[1], m[2], m[3], bw[k]);
        } else {
#pragma unroll
          for (int j = 0; j < kMaskedMaxFpb; ++j)
            bw[k][j] = any[k] && j < nf
                           ? __ldg(reinterpret_cast<const unsigned*>(
                                 t.bins_t + (long)(f0 + j) * t.n + rr[k]))
                           : 0u;
        }
      }
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        if (!any[k]) continue;
        if (s[k][0] >= 0) add(g4[k].x, h4[k].x, bw[k], 0, s[k][0]);
        if (s[k][1] >= 0) add(g4[k].y, h4[k].y, bw[k], 1, s[k][1]);
        if (s[k][2] >= 0) add(g4[k].z, h4[k].z, bw[k], 2, s[k][2]);
        if (s[k][3] >= 0) add(g4[k].w, h4[k].w, bw[k], 3, s[k][3]);
      }
    }
  } else {
    for (long r = r0 + threadIdx.x; r < r1; r += blockDim.x) {
      const int s = slot(__ldg(t.lor + r));
      if (s < 0) continue;
      unsigned bw[kMaskedMaxFpb];
      const unsigned m = SRC == SRC_WORDS ? __ldg(wrow + r) >> wsh : 0u;
#pragma unroll
      for (int j = 0; j < kMaskedMaxFpb; ++j) {
        if (SRC == SRC_WORDS)
          bw[j] = m >> (8 * j);
        else if (j >= nf)
          bw[j] = 0u;
        else if (SRC == SRC_ROWS)
          bw[j] = __ldg(t.bins_t + r * t.num_f + f0 + j);
        else
          bw[j] = __ldg(t.bins_t + (long)(f0 + j) * t.n + r);
      }
      add(__ldg(t.grad + r), __ldg(t.hess + r), bw, 0, s);
    }
  }
  if constexpr (kCopies > 1) {  // fold the copies into copy 0
    __syncthreads();
    const Acc<MODE> a0 = {w, cells};
    for (int i = threadIdx.x; i < cells; i += blockDim.x) {
      T v = a0.get(w, i);
#pragma unroll
      for (int q = 1; q < kCopies; ++q) v += a0.get(w + q * cw, i);
      a0.set(i, v);
    }
  }
  cl.sync();
  // outputs (owned slot, feature, bin), bin fastest, dealt to the blocks of
  // the cluster a block-width at a time; each sums its cell of every
  // block's accumulator (an owned slot reads its first slot's), a batch of
  // remote reads per channel in flight, and writes one float4
  const int nbl = (int)cl.num_blocks();
  const int n_out = hdr[1] * nf * nb;
  for (int o = (int)cl.block_rank() * blockDim.x + threadIdx.x; o < n_out;
       o += nbl * blockDim.x) {
    const int b = o % nb;
    const int j = o / nb % nf;
    const int k = own[o / nb / nf];
    const int c = (first[k] - k0) * 3 * plane + j * nb + b;
    T v[3] = {0, 0, 0};
    for (int q0 = 0; q0 < nbl; q0 += kReduceBatch) {
      T p[3][kReduceBatch];
#pragma unroll
      for (int u = 0; u < kReduceBatch; ++u) {
        const bool in = q0 + u < nbl;
        const unsigned* ws = cl.map_shared_rank(w, in ? q0 + u : 0);
#pragma unroll
        for (int ch = 0; ch < 3; ++ch)
          p[ch][u] = in ? a.get(ws, c + ch * plane) : (T)0;
      }
#pragma unroll
      for (int u = 0; u < kReduceBatch; ++u)
#pragma unroll
        for (int ch = 0; ch < 3; ++ch) v[ch] += p[ch][u];
    }
    t.out[((long)k * t.num_f + f0 + j) * nb + b] =
        make_float4(Val<MODE>::out(v[0], sg), Val<MODE>::out(v[1], sh),
                    Val<MODE>::out(v[2], 0), 0.0f);
  }
  cl.sync();  // no block leaves while another reads its shared memory
}

struct MaskedPlan {
  dim3 grid;  // (feature groups, cluster size, slot groups)
  int fpb, spg;
  long rpb;
  size_t smem;
};

// cudaOccupancyMaxActiveClusters of ``fn`` over ``grid`` (0: the device
// takes no cluster of that size)
inline int max_clusters(const void* fn, dim3 grid, size_t smem) {
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      cluster_config(grid, kMaskedThreads, smem, 0, &attr);
  int n = 0;
  if (cudaOccupancyMaxActiveClusters(&n, fn, &cfg) != cudaSuccess) {
    cudaGetLastError();
    return 0;
  }
  return n;
}

// The launch of ``fn`` for n rows, F features, K slots, B bins at ``words``
// 32-bit words a cell, ``copies`` accumulator copies and ``tiles`` bytes of
// row tiles: for each features-per-block (4, 2, 1) with the fewest slot
// groups that fit, and each cluster size up to ``max_cs`` that the device
// takes at that shared memory, the cost waves x rows per block x
// (2 + features per block) (a row's leaf id, slot and values, then its bin
// and three atomics per feature); the cheapest wins, the smaller cluster
// on a tie.  Sizes above the portable 8 need the non-portable attribute.
inline int plan_masked(const void* fn, long n, int num_f, int K, int n_bins,
                       int words, int copies, int max_cs, size_t tiles,
                       MaskedPlan* best) {
  int optin = 0;
  int err = optin_smem(&optin);
  if (err) return err;
  if (max_cs > kMaxCluster &&
      cudaFuncSetAttribute(fn, cudaFuncAttributeNonPortableClusterSizeAllowed,
                           1) != cudaSuccess) {
    cudaGetLastError();
    max_cs = kMaxCluster;
  }
  // 16: rounding; 4 a copy: its padding word
  const size_t head = masked_head_bytes(K) + tiles + 16 + 4 * copies;
  const size_t per = (size_t)3 * n_bins * sizeof(unsigned) * words * copies;
  double best_cost = -1.0;
  for (int fpb = kMaskedMaxFpb; fpb >= 1; fpb >>= 1) {
    if (fpb > num_f && fpb > 1) continue;
    if (head + per * fpb > (size_t)optin) continue;
    int spg = (int)(((size_t)optin - head) / (per * fpb));
    const int sgroups = (K + spg - 1) / spg;
    spg = (K + sgroups - 1) / sgroups;
    const size_t smem = masked_head_bytes(K) +
                        masked_acc_bytes(spg, fpb, n_bins, words, copies) +
                        tiles;
    const int fgroups = (num_f + fpb - 1) / fpb;
    err = allow_smem(fn, smem);
    if (err) return err;
    for (int cs = 1; cs <= max_cs; ++cs) {
      const dim3 grid(fgroups, cs, sgroups);
      const int active = max_clusters(fn, grid, smem);
      if (active <= 0) continue;
      const long clusters = (long)fgroups * sgroups;
      const long waves = (clusters + active - 1) / active;
      const long rpb = ((n + cs - 1) / cs + 3) / 4 * 4;
      const double cost = (double)waves * (double)rpb * (2.0 + fpb);
      if (best_cost < 0 || cost < best_cost) {
        best_cost = cost;
        *best = {grid, fpb, spg, rpb, smem};
      }
    }
  }
  return best_cost < 0 ? (int)cudaErrorInvalidConfiguration : 0;
}

// plan_masked's plans, cached per (kernel, device, n, F, K, B, tiles): a
// launch plans nothing once its shape has run
struct PlanCache {
  std::mutex mu;
  struct Entry {
    const void* fn;
    int dev, num_f, K, n_bins;
    long n;
    size_t tiles;
    MaskedPlan p;
  } e[64];
  int used = 0, next = 0;
};

inline int cached_plan(const void* fn, long n, int num_f, int K, int n_bins,
                       int words, int copies, int max_cs, size_t tiles,
                       MaskedPlan* p) {
  static PlanCache c;
  int dev = 0;
  int err = (int)cudaGetDevice(&dev);
  if (err) return err;
  std::lock_guard<std::mutex> g(c.mu);
  for (int k = 0; k < c.used; ++k) {
    const PlanCache::Entry& x = c.e[k];
    if (x.fn == fn && x.dev == dev && x.n == n && x.num_f == num_f &&
        x.K == K && x.n_bins == n_bins && x.tiles == tiles) {
      *p = x.p;
      return 0;
    }
  }
  err = plan_masked(fn, n, num_f, K, n_bins, words, copies, max_cs, tiles,
                    p);
  if (err) return err;
  c.e[c.next] = {fn, dev, num_f, K, n_bins, n, tiles, *p};
  c.next = (c.next + 1) % 64;
  if (c.used < 64) ++c.used;
  return 0;
}

template <int MODE, int VEC, int SRC, int PICK>
int launch_masked(Masked t, cudaStream_t s) {
  const void* fn =
      reinterpret_cast<const void*>(masked_cluster<MODE, VEC, SRC, PICK>);
  MaskedPlan p;
  // the payload's two row tiles
  const size_t tiles =
      SRC == SRC_PAYLOAD ? (size_t)kStages * t.tile_rows * (t.W + 3) * 4 : 0;
  int err = cached_plan(
      fn, t.n, t.num_f, t.K, t.n_bins, Acc<MODE>::kWords,
      PICK == PICK_ANY ? kAnyCopies : 1,
      SRC == SRC_BYTES || SRC == SRC_ROWS ? kMaxCluster : kMaxClusterWords,
      tiles, &p);
  if (err) return err;
  t.fpb = p.fpb;
  t.spg = p.spg;
  t.rpb = p.rpb;
  return launch_clusters(masked_cluster<MODE, VEC, SRC, PICK>, p.grid,
                         kMaskedThreads, p.smem, s, t);
}

// VEC = 4 when the row source takes 16-byte loads (the payload always:
// run_masked_payload refuses an unaligned one)
template <int MODE, int SRC, int PICK>
int launch_vec(const Masked& t, bool vec, cudaStream_t s) {
  if constexpr (SRC == SRC_PAYLOAD) {
    return launch_masked<MODE, 4, SRC, PICK>(t, s);
  } else {
    return vec ? launch_masked<MODE, 4, SRC, PICK>(t, s)
               : launch_masked<MODE, 1, SRC, PICK>(t, s);
  }
}

template <int SRC, int PICK = PICK_TABLE>
int dispatch_masked(const Masked& t, bool vec, int mode, cudaStream_t s) {
  if (t.K <= 0 || t.num_f <= 0) return 0;
  switch (mode) {
    case 0:
      return launch_vec<0, SRC, PICK>(t, vec, s);
    case 1:
      return launch_vec<1, SRC, PICK>(t, vec, s);
    case 2:
      return launch_vec<2, SRC, PICK>(t, vec, s);
  }
  return (int)cudaErrorInvalidValue;
}

// The masked pass over bins_t u8 [F, n] into out f32 [K, num_f, n_bins, 4];
// mode 0 int8, 1 float32, 2 bfloat16.  An empty output launches nothing.
inline int run_masked(const uint8_t* bins_t, long n, int num_f,
                      const float* grad, const float* hess, const int* lor,
                      const int* leaves, int K, int n_bins, int mode,
                      float* out, const int* gate, cudaStream_t s) {
  Masked t = {bins_t, nullptr, n, num_f, grad, hess, lor, leaves, K,
              n_bins, 0, 0, 0, reinterpret_cast<float4*>(out)};
  t.gate = gate;
  const bool vec = n % 4 == 0 && aligned(bins_t, 4) && aligned(grad, 16) &&
                   aligned(hess, 16) && aligned(lor, 16);
  return dispatch_masked<SRC_BYTES>(t, vec, mode, s);
}

// The same pass over the packed mirror words_t i32 [W, n] (4W >= num_f;
// bytes past num_f are dropped)
inline int run_masked_words(const int* words_t, long n, int num_f,
                            const float* grad, const float* hess,
                            const int* lor, const int* leaves, int K,
                            int n_bins, int mode, float* out,
                            const int* gate, cudaStream_t s) {
  Masked t = {nullptr, reinterpret_cast<const unsigned*>(words_t), n,
              num_f, grad, hess, lor, leaves, K, n_bins, 0, 0, 0,
              reinterpret_cast<float4*>(out)};
  t.gate = gate;
  const bool vec = n % 4 == 0 && aligned(words_t, 16) && aligned(grad, 16) &&
                   aligned(hess, 16) && aligned(lor, 16);
  return dispatch_masked<SRC_WORDS>(t, vec, mode, s);
}

}  // namespace
