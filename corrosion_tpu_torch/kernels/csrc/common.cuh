// Device helpers shared by the simulator's kernels.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace common {

// -- jax.random's threefry2x32 (jax/_src/prng.py _threefry2x32_lowering,
// 20 rounds) and the uniform / randint epilogues of jax/_src/random.py,
// shared by the kernels that draw in-thread.

__device__ __forceinline__ uint32_t rotl32(uint32_t x, uint32_t d) {
  return (x << d) | (x >> (32u - d));
}

#define TF_ROUND(r)         \
  x0 += x1;                 \
  x1 = rotl32(x1, (r));     \
  x1 ^= x0;

// Both output words of threefry2x32 under key (k0, k1) on the counter
// pair (x0, x1): a split or fold_in key, or the two halves of a draw.
__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1,
                                             uint32_t x0, uint32_t x1,
                                             uint32_t& o0, uint32_t& o1) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  x0 += k0;
  x1 += k1;
  TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
  x0 += k1; x1 += k2 + 1u;
  TF_ROUND(17) TF_ROUND(29) TF_ROUND(16) TF_ROUND(24)
  x0 += k2; x1 += k0 + 2u;
  TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
  x0 += k0; x1 += k1 + 3u;
  TF_ROUND(17) TF_ROUND(29) TF_ROUND(16) TF_ROUND(24)
  x0 += k1; x1 += k2 + 4u;
  TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
  x0 += k2; x1 += k0 + 5u;
  o0 = x0;
  o1 = x1;
}

#undef TF_ROUND

// The random word at flat index i of a draw under key (k0, k1): the
// xor of the two output words on the counter (i >> 32, i & 0xFFFFFFFF).
__device__ __forceinline__ uint32_t threefry_xor(uint32_t k0, uint32_t k1,
                                                 unsigned long long i) {
  uint32_t o0, o1;
  threefry2x32(k0, k1, (uint32_t)(i >> 32), (uint32_t)i, o0, o1);
  return o0 ^ o1;
}

// uniform: the top 23 bits as a mantissa in [1, 2), minus 1
__device__ __forceinline__ float uniform_of(uint32_t bits) {
  return __uint_as_float((bits >> 9) | 0x3F800000u) - 1.0f;
}

// randint: ((hi % span) * mult + lo % span) % span in wrapping uint32
// arithmetic, plus minval (hi, lo the words under split(key)[0], [1])
__device__ __forceinline__ int randint_of(uint32_t hi, uint32_t lo,
                                          uint32_t span, uint32_t mult,
                                          int minval) {
  return minval + (int)(((hi % span) * mult + lo % span) % span);
}

// -- The same hash over U consecutive counters a thread, its work spread
// over both integer pipes (sent_sampler.cu's filter, threefry.cu).  An
// SM's integer instructions run on the ALU (IADD3, LOP3, SHF) or the
// FMA pipe (IMAD, IMAD.WIDE), each taking a warp instruction every
// other clock on a scheduler, so a hash reaches the dispatch rate only
// when the two pipes are busy for equal times (kernels/sass.py counts
// their instructions).  The adds run as IMAD by a multiplier of 1 that
// ptxas cannot see (a launch argument, `one`), and the rotates of the
// rounds set in a kernel's WIDE mask (bit r for round r) as a 32 x 32
// -> 64 multiply by 2**r on the FMA pipe, whose halves the xor's LOP3
// folds.  An IMAD.WIDE holds the FMA pipe longer than an IMAD, so each
// kernel's mask is the one its timings chose (PERF.md rows 1 and 10).

// threefry2x32's rotation of round r
__host__ __device__ constexpr int rot_of(int r) {
  constexpr int rots[8] = {13, 15, 26, 6, 17, 29, 16, 24};
  return rots[r % 8];
}

// a + b as an IMAD (a * one + b): the FMA pipe's share of the adds
__device__ __forceinline__ uint32_t add_fma(uint32_t a, uint32_t b,
                                            uint32_t one) {
  uint32_t d;
  asm("mad.lo.u32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(one), "r"(b));
  return d;
}

// One threefry2x32 round on each of U independent counters.
template <unsigned WIDE, int R, int U>
__device__ __forceinline__ void tf_round(uint32_t (&x0)[U],
                                         uint32_t (&x1)[U], uint32_t one) {
  constexpr int rot = rot_of(R);
#pragma unroll
  for (int u = 0; u < U; ++u) {
    x0[u] = add_fma(x1[u], x0[u], one);
    if constexpr ((WIDE >> R) & 1u) {
      // x1 * 2**rot in 64 bits: the low word is x1 << rot, the high
      // word x1 >> (32 - rot); the multiplier comes from one so that
      // ptxas keeps the multiply, and the halves go straight to a LOP3
      uint32_t lo, hi;
      asm("{\n\t.reg .u64 t;\n\tmul.wide.u32 t, %2, %3;\n\t"
          "mov.b64 {%0, %1}, t;\n\t}"
          : "=r"(lo), "=r"(hi)
          : "r"(x1[u]), "r"(one << rot));
      x1[u] = (lo | hi) ^ x0[u];
    } else {
      x1[u] = rotl32(x1[u], rot) ^ x0[u];
    }
  }
}

template <unsigned WIDE, int R, int U>
__device__ __forceinline__ void tf_four(uint32_t (&x0)[U], uint32_t (&x1)[U],
                                        uint32_t one) {
  tf_round<WIDE, R, U>(x0, x1, one);
  tf_round<WIDE, R + 1, U>(x0, x1, one);
  tf_round<WIDE, R + 2, U>(x0, x1, one);
  tf_round<WIDE, R + 3, U>(x0, x1, one);
}

template <int U>
__device__ __forceinline__ void tf_inject(uint32_t (&x0)[U],
                                          uint32_t (&x1)[U], uint32_t ka,
                                          uint32_t kb, uint32_t one) {
#pragma unroll
  for (int u = 0; u < U; ++u) {
    x0[u] = add_fma(x0[u], ka, one);
    x1[u] = add_fma(x1[u], kb, one);
  }
}

// threefry_xor of U consecutive counters (hi, lo + u), x0 = hi + k0 and
// x1 = lo + k1 given: out[u] the word of counter u
template <unsigned WIDE, int U>
__device__ __forceinline__ void hash_run(uint32_t x0_0, uint32_t x1_0,
                                         uint32_t k0, uint32_t k1,
                                         uint32_t k2, uint32_t one,
                                         uint32_t (&out)[U]) {
  uint32_t x0[U], x1[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    x0[u] = x0_0;
    x1[u] = x1_0 + (uint32_t)u;
  }
  tf_four<WIDE, 0, U>(x0, x1, one);
  tf_inject<U>(x0, x1, k1, k2 + 1u, one);
  tf_four<WIDE, 4, U>(x0, x1, one);
  tf_inject<U>(x0, x1, k2, k0 + 2u, one);
  tf_four<WIDE, 8, U>(x0, x1, one);
  tf_inject<U>(x0, x1, k0, k1 + 3u, one);
  tf_four<WIDE, 12, U>(x0, x1, one);
  tf_inject<U>(x0, x1, k1, k2 + 4u, one);
  tf_four<WIDE, 16, U>(x0, x1, one);
#pragma unroll
  for (int u = 0; u < U; ++u)
    out[u] = add_fma(x0[u], k2, one) ^ add_fma(x1[u], k0 + 5u, one);
}

// "not infected yet" hop depth (models/broadcast.py HOP_UNSET)
constexpr int HOP_UNSET = 1 << 30;

// A node's R packed keys to or from registers (R a template
// parameter): 16-byte vector accesses when R % 4 == 0 (the wrappers
// check 16-byte alignment).

template <int R>
__device__ __forceinline__ void load_row(const int* __restrict__ p,
                                         int (&v)[R]) {
  if constexpr (R % 4 == 0) {
    const int4* q = reinterpret_cast<const int4*>(p);
#pragma unroll
    for (int c = 0; c < R / 4; ++c) {
      const int4 w = q[c];
      v[4 * c] = w.x;
      v[4 * c + 1] = w.y;
      v[4 * c + 2] = w.z;
      v[4 * c + 3] = w.w;
    }
  } else {
#pragma unroll
    for (int c = 0; c < R; ++c) v[c] = p[c];
  }
}

template <int R>
__device__ __forceinline__ void store_row(int* __restrict__ p,
                                          const int (&v)[R]) {
  if constexpr (R % 4 == 0) {
    int4* q = reinterpret_cast<int4*>(p);
#pragma unroll
    for (int c = 0; c < R / 4; ++c)
      q[c] = make_int4(v[4 * c], v[4 * c + 1], v[4 * c + 2], v[4 * c + 3]);
  } else {
#pragma unroll
    for (int c = 0; c < R; ++c) p[c] = v[c];
  }
}

// True where traffic from block src to block dst is cut while the
// partition is in force: any two different blocks when sev is null
// (symmetric), else the listed directions of the b x b severance
// matrix (ids clamped to its all-false pad row); bidirectional cuts a
// link when either direction is listed.
__device__ __forceinline__ bool blocks_cross(int src, int dst,
                                             const unsigned char* sev, int b,
                                             bool bidirectional) {
  if (sev == nullptr) return src != dst;
  const int s = min(src, b - 1), d = min(dst, b - 1);
  return sev[s * b + d] != 0 || (bidirectional && sev[d * b + s] != 0);
}

}  // namespace common
