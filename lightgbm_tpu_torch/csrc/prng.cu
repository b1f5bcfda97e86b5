// Threefry-2x32 draws for the growers' per-node randomness: one launch a
// draw family.
//
// Replaces no TPU kernel: the JAX package draws extra trees' random
// thresholds and by-node feature subsets with jax.random in XLA
// (lightgbm_tpu/ops/split.py:341-365, learner/grower.py:211
// sample_features_bynode).  Done with plain tensor operations a draw is
// some 170 launches (ops/prng.py uniform); a batched round draws for its
// 2K children, so the kernel turns several hundred launches a round into
// one or two.
//
// What it computes, for each row r of N keys (uint32 words held in int64,
// row stride key_stride, the two words adjacent): the key ciphered by the
// counters of up to three steps in turn (fold_in(k, d) is the cipher of
// (d >> 32, d & 0xffffffff) under k, key j of split(k, m) the cipher of
// (0, j): one step serves both), a step's counter of row r being
// c[r] when its array is given, else base + r * step; then n float32
// uniforms from the derived key, exactly jax.random.uniform(k, (n,)) under
// jax_threefry_partitionable: the cipher of the counters (i >> 32,
// i & 0xffffffff) of each index i, out0 ^ out1, its top 23 bits the
// mantissa of a float in [1, 2), minus 1.  out is f32 [N, n] row-major.
//
// Design.  One thread an output element; it recomputes its row's key from
// registers (a cipher a step: 20 rounds of 32-bit adds, rotates and xors,
// exact uint32 wrap-around) and then its own element.  No shared memory,
// no atomics, no fast-math: the bits equal the plain version's
// (ops/prng.py draw_plain).
//
// Bound on the H100: at the growers' shapes (84 keys x 28 features) the
// work is ~3k ciphers, microseconds of integer throughput, and a launch
// costs more; at a large draw (1M uniforms) it is integer operations
// (~120 a cipher) against 4 bytes written an element.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr uint32_t kParity = 0x1BD11BDAu;

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

// the Threefry-2x32 block cipher (20 rounds) of (x0, x1) under (k0, k1)
__device__ __forceinline__ void threefry(uint32_t k0, uint32_t k1,
                                         uint32_t& x0, uint32_t& x1) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ kParity};
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  x0 += ks[0];
  x1 += ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x0 += x1;
      x1 = rotl(x1, rot[i % 2][j]) ^ x0;
    }
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + (uint32_t)(i + 1);
  }
}

struct Step {
  const long long* c;  // counters [N], or null: base + r * step
  long long base, step;
};

__global__ void __launch_bounds__(kThreads)
    draw_kernel(const long long* __restrict__ keys, long key_stride,
                int nsteps, Step s0, Step s1, Step s2, long N, int n,
                float* __restrict__ out) {
  const long idx = (long)blockIdx.x * kThreads + threadIdx.x;
  if (idx >= N * (long)n) return;
  const long r = idx / n;
  const uint32_t i = (uint32_t)(idx - r * n);
  uint32_t k0 = (uint32_t)keys[r * key_stride];
  uint32_t k1 = (uint32_t)keys[r * key_stride + 1];
  const Step steps[3] = {s0, s1, s2};
#pragma unroll
  for (int s = 0; s < 3; ++s) {
    if (s < nsteps) {
      const Step& st = steps[s];
      const unsigned long long c =
          (unsigned long long)(st.c ? st.c[r] : st.base + r * st.step);
      uint32_t x0 = (uint32_t)(c >> 32), x1 = (uint32_t)c;
      threefry(k0, k1, x0, x1);
      k0 = x0;
      k1 = x1;
    }
  }
  uint32_t y0 = 0, y1 = i;  // n < 2^31: the high counter word is 0
  threefry(k0, k1, y0, y1);
  const uint32_t bits = ((y0 ^ y1) >> 9) | 0x3F800000u;
  out[idx] = fmaxf(__uint_as_float(bits) - 1.0f, 0.0f);
}

}  // namespace

// keys int64 [N, 2] at row stride key_stride (0: one key for every row);
// nsteps <= 3 steps, each (c, base, step); out f32 [N, n] (written)
extern "C" int lgbt_threefry_draw(const long long* keys, long key_stride,
                                  int nsteps, const long long* c0,
                                  long long b0, long long d0,
                                  const long long* c1, long long b1,
                                  long long d1, const long long* c2,
                                  long long b2, long long d2, long N, int n,
                                  float* out, void* stream) {
  const long total = N * (long)n;
  if (total <= 0) return 0;
  const Step s0{c0, b0, d0}, s1{c1, b1, d1}, s2{c2, b2, d2};
  const long blocks = (total + kThreads - 1) / kThreads;
  draw_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      keys, key_stride, nsteps, s0, s1, s2, N, n, out);
  return (int)cudaGetLastError();
}
