// Fused batched-round partition: K splits applied in one row pass, with the
// next histogram pass's compaction key (and, for the payload variant, its
// payload) written in the same pass.
//
// Replaces two TPU kernels of lightgbm_tpu/ops/round_fuse.py:
//   * partition_payload_pallas -> lgbt_partition_payload;
//   * partition_select_pallas -> lgbt_partition_select, the same pass
//     without the payload (the bounded histogram pool's rounds, whose
//     extended leaf set builds its own keys).
// Each has a decision-table variant (template flag TABLE, a non-null `tab`:
// EFB-bundled rounds, which the JAX package partitions in XLA,
// lightgbm_tpu/learner/batch_grower.py:866-884): feats[k] is then the
// physical column slot k reads and the row goes left when
// tab[k * B + col] (u8 [K, B], 0/1; a bin col >= B goes right), in place of
// the numeric rule below; thr, dl and nanb are not read.  The caller builds
// the table from the bundle plan's inverse table (ops/round_fuse.py
// decision_table); a categorical bitset fills the same table.
// Per row r, exactly the TPU kernels' function (round_fuse.py:217-225):
//   * slot k moves r when validk[k] and parents[k] == lor[r]; the split
//     column is the bin of feature feats[k] (0 for a feature outside
//     [0, num_f), as the TPU one-hot gives), and the row goes left when
//     col == nanb[k] ? dl[k] : col <= thr[k]; move = validk[k] *
//     (1 - go_left), and the row takes sum(move * new_leaves) when
//     sum(move) > 0;
//   * lor_m = mask[r] ? new_lor : -1, key = lor_m in smaller (any of the K
//     entries, valid or not) ? r : r | 2^30;
//   * payload row = [words[r, :W], bits(grad[r]), bits(hess[r]), lor_m].
// The table variant stages its K x B bytes in shared memory beside the
// descriptors (10.75 KB at K = 42, B = 256; 21.5 KB at the pooled K = 84),
// with 16-byte loads where the table is aligned; with the payload tile
// (at most kPartTileBytes) and the leaf table that is under 66 KB a block
// at K = 84, far below the 227 KB a block may use.
//
// Design.  One launch of a persistent grid (a few blocks per SM), each
// block walking the same number of tiles of up to 1,024 rows (the tile cut
// to make it so), four rows a thread with 16-byte
// loads of lor, mask, grad and hess and 16-byte stores of new_lor and the
// key (scalar loads for a ragged tail or misaligned operands).  A block
// first builds, in shared memory:
//   * a leaf -> slot table over leaf ids [0, 2048): the one valid slot
//     (validk == 1) whose parent is that leaf, -1 for none, or -2 where
//     several valid slots share the parent or a validk is neither 0 nor 1:
//     such a leaf's rows (and leaf ids outside the table, when a valid
//     parent is outside it) take the loop over all K slots, which sums as
//     the TPU kernel does;
//   * a bitmap of the `smaller` ids in [0, 2048), a flag for -1 (a masked
//     row's lor_m) and one for ids outside [-1, 2048) (then the loop).
// So a row costs one table read instead of two passes over K slots.  The
// payload variant stages its tile of words through shared memory in the
// payload's own row layout ([rows][W + 3], 16-byte loads), takes each
// row's split column from there (byte f & 3 of word f >> 2, the caller
// keeping bins_words == bins_to_words(bins_t.T)), fills in grad, hess and
// lor_m, and stores the tile with 16-byte stores: no strided scalar access
// to device memory.  The select variant reads the split column from
// bins_t, one byte for each row that a slot moves.
//
// Bound on the H100: bytes.  The payload variant reads 4W + 16 B a row
// (words, grad, hess, leaf, mask) and writes 4(W+3) + 8 B: 92 B at W = 7,
// 0.0275 ms for 1M rows at 3.35 TB/s (the table variant: W of the bundle
// columns, plus the K x B table once).  The select variant reads the leaf,
// the mask and one bin byte per row of a valid parent and writes 8 B a
// row: at most 17 B, ~0.005 ms.  The old kernel's pace was its payload
// copy (W scalar loads and W + 3 scalar stores a thread at a 28- and
// 40-byte stride).  On an H100 (700 W, 1M rows, warm L2) this one runs
// the payload variant at 1.35x its bound.  The select variant at K = 1
// moves few rows, and each block's head sets its pace: the descriptor
// reads and the barrier after them (0.0020 ms: the row pass alone streams
// in 0.0044), then the tables (0.0002): 0.0066 in all, where the
// one-thread-a-row kernel took 0.0056 plus 0.0012 for the launch that
// stacked its descriptors.  Read in one thread, the eight descriptor
// arrays cost eight L2 round trips (0.0011 more); a block reads them one
// word a thread.

#include <algorithm>

#include "hist_common.cuh"

namespace {

constexpr int kPartThreads = 256;
constexpr int kPartMaxRows = 4 * kPartThreads;  // rows per tile
constexpr int kPartTileBytes = 32 * 1024;  // the payload tile's budget
// blocks per SM at most (select, payload): the select variant ran faster
// at 4 (two tiles a block) than at 8 or 2; the payload variant, held to 5
// by its shared memory, ran slower at 4
constexpr int kPartBlocksPerSM[2] = {4, 8};
constexpr int kMoveLoop = -2;  // a table entry: the rows take the K loop

struct Part {
  const uint8_t* bins_t;  // u8 [F, n] (select variant)
  const uint8_t* tab;     // u8 [K, B] go-left bits (table variant)
  int B;
  long n;
  int num_f;
  const int* words;  // i32 [n, W] (payload variant)
  int W;
  const float* grad;
  const float* hess;
  const int* lor;
  const int* mask;
  const int* desc[8];  // i32 [K] each: feats, thr, dl, nanb, parents,
                       // new_leaves, validk, smaller
  int K;
  int rows;  // rows per tile, a multiple of 4
  int* out_lor;
  int* out_key;
  int* out_pay;  // i32 [n, W + 3]
};

// Shared memory before the payload tile: the leaf -> slot table, the
// smaller bitmap, four header words, the [8, K] descriptors
__host__ __device__ inline size_t part_head_ints(int K) {
  return ((size_t)kLeafTable + kLeafTable / 32 + 4 + 8 * K + 3) / 4 * 4;
}

// ... then the decision table's K x B bytes (table variant), in whole
// 16-byte units, then the payload tile
__host__ __device__ inline size_t part_tab_ints(int K, int B) {
  return ((size_t)K * B + 15) / 16 * 4;
}

template <bool PAYLOAD, int VEC, bool TABLE>
__global__ void __launch_bounds__(kPartThreads)
    partition_kernel(const Part p) {
  extern __shared__ __align__(16) int sh[];
  int* mv = sh;  // leaf -> slot, -1 none, kMoveLoop
  unsigned* smb = reinterpret_cast<unsigned*>(mv + kLeafTable);
  int* hdr = reinterpret_cast<int*>(smb + kLeafTable / 32);
  int* d = hdr + 4;
  uint8_t* tabs = reinterpret_cast<uint8_t*>(sh + part_head_ints(p.K));
  int* tile = sh + part_head_ints(p.K) +
              (TABLE ? part_tab_ints(p.K, p.B) : 0);  // [rows][W + 3]
  const int K = p.K, B = p.B;
  for (int i = threadIdx.x; i < kLeafTable; i += blockDim.x) mv[i] = -1;
  for (int i = threadIdx.x; i < kLeafTable / 32; i += blockDim.x) smb[i] = 0;
  if (threadIdx.x < 4) hdr[threadIdx.x] = 0;
  // one descriptor word a thread, all in flight at once (a loop over the
  // eight arrays in one thread waits out eight L2 round trips); the table
  // variant reads no thr, dl, nanb
  for (int i = threadIdx.x; i < 8 * K; i += blockDim.x) {
    const int j = i / K;
    if (TABLE && j >= 1 && j <= 3) continue;
    d[i] = __ldg(p.desc[j] + (i - j * K));
  }
  if (TABLE) {
    const int nb = K * B;
    if ((reinterpret_cast<uintptr_t>(p.tab) & 15) == 0 && nb % 16 == 0) {
      for (int i = threadIdx.x; i < nb / 16; i += blockDim.x)
        reinterpret_cast<int4*>(tabs)[i] =
            __ldg(reinterpret_cast<const int4*>(p.tab) + i);
    } else {
      for (int i = threadIdx.x; i < nb; i += blockDim.x)
        tabs[i] = __ldg(p.tab + i);
    }
  }
  __syncthreads();
  const int* feats = d;
  const int* thr = d + K;
  const int* dl = d + 2 * K;
  const int* nanb = d + 3 * K;
  const int* par = d + 4 * K;
  const int* nl = d + 5 * K;
  const int* vk = d + 6 * K;
  const int* sm = d + 7 * K;
  // hdr[0]: a valid parent outside the table; hdr[1]: -1 in smaller;
  // hdr[2]: an id outside [-1, 2048) in smaller
  for (int k = threadIdx.x; k < K; k += blockDim.x) {
    const int pk = par[k];
    if (vk[k] != 0) {
      if (pk < 0 || pk >= kLeafTable) {
        hdr[0] = 1;
      } else if (vk[k] != 1 || atomicCAS(&mv[pk], -1, k) != -1) {
        atomicExch(&mv[pk], kMoveLoop);
      }
    }
    const int s = sm[k];
    if (s >= 0 && s < kLeafTable) {
      atomicOr(&smb[s >> 5], 1u << (s & 31));
    } else {
      hdr[s == -1 ? 1 : 2] = 1;
    }
  }
  __syncthreads();
  const int loop_outside = hdr[0], sm_neg = hdr[1], sm_far = hdr[2];
  const int W = p.W, WP = p.W + 3;

  // the split column of feature f for row r (wrow: its words in the tile)
  auto column = [&](int f, long r, const int* wrow) -> int {
    if (f < 0 || f >= p.num_f) return 0;
    if (PAYLOAD) return (wrow[f >> 2] >> (8 * (f & 3))) & 255;
    return (int)__ldg(p.bins_t + (long)f * p.n + r);
  };
  auto moved_of = [&](int k, int col) -> int {  // validk[k] * (1 - go_left)
    if (TABLE) return vk[k] * (1 - (col < B ? (int)tabs[k * B + col] : 0));
    const int isnan = col == nanb[k];
    const int le = col <= thr[k];
    return vk[k] * (1 - (isnan * dl[k] + (1 - isnan) * le));
  };
  auto new_leaf = [&](int l, long r, const int* wrow) -> int {
    const int e = l >= 0 && l < kLeafTable ? mv[l]
                  : loop_outside ? kMoveLoop : -1;
    if (e == -1) return l;
    if (e >= 0) {
      const int move = moved_of(e, column(feats[e], r, wrow));
      return move > 0 ? move * nl[e] : l;
    }
    int tgt = 0, moved = 0;
    for (int k = 0; k < K; ++k) {
      if (par[k] != l || vk[k] == 0) continue;
      const int move = moved_of(k, column(feats[k], r, wrow));
      tgt += move * nl[k];
      moved += move;
    }
    return moved > 0 ? tgt : l;
  };
  auto key_of = [&](int lm, long r) -> int {
    bool in = false;
    if (lm >= 0 && lm < kLeafTable) {
      in = (smb[lm >> 5] >> (lm & 31)) & 1u;
    } else if (lm == -1) {
      in = sm_neg;
    } else if (sm_far) {
      for (int k = 0; k < K; ++k) in |= sm[k] == lm;
    }
    return in ? (int)r : ((int)r | (1 << 30));
  };
  // one row, scalar: returns lor_m
  auto one_row = [&](long r, int q) -> int {
    const int nlr = new_leaf(__ldg(p.lor + r), r, tile + q * WP);
    p.out_lor[r] = nlr;
    const int lm = __ldg(p.mask + r) != 0 ? nlr : -1;
    p.out_key[r] = key_of(lm, r);
    return lm;
  };

  const int q = 4 * threadIdx.x;  // this thread's rows of a tile: [q, q + 4)
  const long step = (long)gridDim.x * p.rows;
  for (long t0 = (long)blockIdx.x * p.rows; t0 < p.n; t0 += step) {
    const int nr = (int)min((long)p.rows, p.n - t0);
    const bool quad = VEC == 4 && q + 4 <= nr;  // four rows, 16-byte access
    int4 l4 = make_int4(0, 0, 0, 0), m4 = l4;
    if (quad) {  // loaded before the payload variant stages its words
      l4 = __ldg(reinterpret_cast<const int4*>(p.lor + t0 + q));
      m4 = __ldg(reinterpret_cast<const int4*>(p.mask + t0 + q));
    }
    if (PAYLOAD) {  // words of rows [t0, t0 + nr) -> tile[row][0, W)
      const int* src = p.words + t0 * W;
      const int nw = nr * W;
      int i = 4 * threadIdx.x;
      if (VEC == 4) {
        for (; i + 4 <= nw; i += 4 * blockDim.x) {
          const int4 v = __ldg(reinterpret_cast<const int4*>(src + i));
          const int x[4] = {v.x, v.y, v.z, v.w};
          int row = i / W, col = i - row * W;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            tile[row * WP + col] = x[e];
            if (++col == W) col = 0, ++row;
          }
        }
      }
      for (int j = (VEC == 4 ? nw / 4 * 4 : 0) + threadIdx.x; j < nw;
           j += blockDim.x)
        tile[j / W * WP + j % W] = __ldg(src + j);
      __syncthreads();
    }
    if (q < nr) {
      const long r = t0 + q;
      if (quad) {
        const int l[4] = {l4.x, l4.y, l4.z, l4.w};
        const int m[4] = {m4.x, m4.y, m4.z, m4.w};
        int o[4], key[4], lm[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          o[u] = new_leaf(l[u], r + u, tile + (q + u) * WP);
          lm[u] = m[u] != 0 ? o[u] : -1;
          key[u] = key_of(lm[u], r + u);
        }
        *reinterpret_cast<int4*>(p.out_lor + r) =
            make_int4(o[0], o[1], o[2], o[3]);
        *reinterpret_cast<int4*>(p.out_key + r) =
            make_int4(key[0], key[1], key[2], key[3]);
        if (PAYLOAD) {
          const float4 g4 = __ldg(reinterpret_cast<const float4*>(p.grad + r));
          const float4 h4 = __ldg(reinterpret_cast<const float4*>(p.hess + r));
          const float g[4] = {g4.x, g4.y, g4.z, g4.w};
          const float h[4] = {h4.x, h4.y, h4.z, h4.w};
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            int* row = tile + (q + u) * WP + W;
            row[0] = __float_as_int(g[u]);
            row[1] = __float_as_int(h[u]);
            row[2] = lm[u];
          }
        }
      } else {
        for (int u = 0; u < 4 && q + u < nr; ++u) {
          const int lm = one_row(r + u, q + u);
          if (PAYLOAD) {
            int* row = tile + (q + u) * WP + W;
            row[0] = __float_as_int(__ldg(p.grad + r + u));
            row[1] = __float_as_int(__ldg(p.hess + r + u));
            row[2] = lm;
          }
        }
      }
    }
    if (PAYLOAD) {  // tile -> out_pay rows [t0, t0 + nr)
      __syncthreads();
      int* dst = p.out_pay + t0 * WP;
      const int np = nr * WP;
      int i = 4 * threadIdx.x;
      if (VEC == 4)
        for (; i + 4 <= np; i += 4 * blockDim.x)
          *reinterpret_cast<int4*>(dst + i) =
              *reinterpret_cast<const int4*>(tile + i);
      for (int j = (VEC == 4 ? np / 4 * 4 : 0) + threadIdx.x; j < np;
           j += blockDim.x)
        dst[j] = tile[j];
      __syncthreads();  // the next tile's words overwrite this one
    }
  }
}

// The launch: a persistent grid of as many blocks as fit on the SMs at
// once, each taking the same number of tiles, the tile cut to the rows
// that gives (so no block walks a tile more than the others)
template <bool PAYLOAD, int VEC, bool TABLE>
int launch_part(Part p, cudaStream_t s) {
  const size_t head =
      (part_head_ints(p.K) + (TABLE ? part_tab_ints(p.K, p.B) : 0)) *
      sizeof(int);
  size_t smem = head;
  long most = kPartMaxRows;
  if (PAYLOAD) {
    const size_t row_bytes = (size_t)(p.W + 3) * sizeof(int);
    most = std::min<long>(most, (long)(kPartTileBytes / row_bytes) / 4 * 4);
    if (most < 4) return (int)cudaErrorInvalidValue;
    smem += (size_t)most * row_bytes;
  }
  const void* fn =
      reinterpret_cast<const void*>(partition_kernel<PAYLOAD, VEC, TABLE>);
  int err = allow_smem(fn, smem);
  if (err) return err;
  const long slots = kSMs * std::max<long>(
      1, std::min<long>(kPartBlocksPerSM[PAYLOAD],
                        228L * 1024 / (smem + 1024)));
  const long per_block = (p.n + slots * most - 1) / (slots * most);  // tiles
  p.rows = (int)std::min<long>(
      most, ((p.n + slots * per_block - 1) / (slots * per_block) + 3) / 4 * 4);
  const long tiles = (p.n + p.rows - 1) / p.rows;
  const int blocks = (int)((tiles + per_block - 1) / per_block);
  partition_kernel<PAYLOAD, VEC, TABLE>
      <<<blocks, kPartThreads, smem, s>>>(p);
  return (int)cudaGetLastError();
}

template <bool PAYLOAD, bool TABLE>
int run_vec(const Part& p, bool vec, cudaStream_t s) {
  return vec ? launch_part<PAYLOAD, 4, TABLE>(p, s)
             : launch_part<PAYLOAD, 1, TABLE>(p, s);
}

template <bool PAYLOAD>
int run_part(const Part& p, void* stream) {
  if (p.n <= 0) return 0;
  if (p.K < 0 || (p.tab != nullptr && (p.B < 1 || p.B > 256)))
    return (int)cudaErrorInvalidValue;
  const bool vec = aligned(p.lor, 16) && aligned(p.mask, 16) &&
                   aligned(p.out_lor, 16) && aligned(p.out_key, 16) &&
                   (!PAYLOAD || (aligned(p.words, 16) && aligned(p.grad, 16) &&
                                 aligned(p.hess, 16) &&
                                 aligned(p.out_pay, 16)));
  cudaStream_t s = (cudaStream_t)stream;
  return p.tab != nullptr ? run_vec<PAYLOAD, true>(p, vec, s)
                          : run_vec<PAYLOAD, false>(p, vec, s);
}

}  // namespace

// The slot descriptors, i32 [K] each (read on the device): feats, thr,
// dl, nanb, parents, new_leaves, validk, smaller; then K and the decision
// table u8 [K, B] (null: the numeric rule; else feats holds the physical
// columns and thr, dl and nanb may be null)
#define LGBT_DESC_ARGS                                                   \
  const int *feats, const int *thr, const int *dl, const int *nanb,      \
      const int *parents, const int *new_leaves, const int *validk,      \
      const int *smaller
#define LGBT_DESC {feats, thr, dl, nanb, parents, new_leaves, validk, smaller}
#define LGBT_TAB_ARGS int K, const uint8_t *tab, int B

// The split column comes from the words: bins_words must equal
// bins_to_words(bins_t.T) (bins_t is not read).
extern "C" int lgbt_partition_payload(long n, int num_f, const int* words,
                                      int W, const float* grad,
                                      const float* hess, const int* lor,
                                      const int* mask, LGBT_DESC_ARGS,
                                      LGBT_TAB_ARGS, int* out_lor,
                                      int* out_key, int* out_pay,
                                      void* stream) {
  if (4 * W < num_f) return (int)cudaErrorInvalidValue;
  const Part p = {nullptr, tab, B, n, num_f, words, W, grad, hess, lor, mask,
                  LGBT_DESC, K, 0, out_lor, out_key, out_pay};
  return run_part<true>(p, stream);
}

extern "C" int lgbt_partition_select(const uint8_t* bins_t, long n,
                                     int num_f, const int* lor,
                                     const int* mask, LGBT_DESC_ARGS,
                                     LGBT_TAB_ARGS, int* out_lor,
                                     int* out_key, void* stream) {
  const Part p = {bins_t, tab, B, n, num_f, nullptr, 0, nullptr, nullptr,
                  lor, mask, LGBT_DESC, K, 0, out_lor, out_key, nullptr};
  return run_part<false>(p, stream);
}
