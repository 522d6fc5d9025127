// threefry_bits: the counter-based random draws of the simulator.
//
// Replaces jax.random under partitionable threefry2x32
// (jax/_src/prng.py _threefry_random_bits_partitionable, and the
// uniform / randint epilogues of jax/_src/random.py), which the
// reference calls for every draw on its tick: the loss uniforms
// (models/broadcast.py:381), the per-column permutation scores
// (:322), the ring0 fallback offsets (:316) and the sync peers
// (models/common.py:44).
//
// Word i of a draw under key (k0, k1) is the xor of threefry2x32's two
// output words (20 rounds) on the counter pair (i >> 32, i & 0xFFFFFFFF),
// then the epilogue, one kernel instantiation a mode:
//   BITS     raw uint32 bits;
//   UNIFORM  float32 uniform in [0, 1): the top 23 bits as a mantissa in
//            [1, 2), minus 1;
//   RANDINT  int32 randint: a second hash under the second key, folded
//            as ((hi % span) * mult + lo % span) % span in wrapping
//            uint32 arithmetic, plus minval.
//
// Bound on the H100: integer operations, about 70 a hash against 4
// bytes written.  An SM's 4 schedulers dispatch one warp instruction a
// clock each, and integer instructions go to two pipes that take one
// every other clock, the ALU (LOP3, SHF, IADD3) and the FMA pipe (IMAD),
// so the kernel reaches the dispatch rate only when the two carry equal
// shares.  Written plainly, every rotate is a funnel shift on the ALU
// beside the xors and the ALU carries nearly twice the FMA pipe's count
// (PERF.md row 1).  The design:
// - Both pipes: the hash is common.cuh's hash_run, every add an IMAD by
//   a launch-argument 1 (`one`) on the FMA pipe, the rotates funnel
//   shifts and the xors LOP3s on the ALU.  hash_run can also rotate a
//   set of rounds by a 32 x 32 -> 64 multiply on the FMA pipe, which
//   evens the two pipes' instruction counts (4 such rounds of 20 bring
//   a word's ALU and FMA counts within 10%), but each such round made
//   this kernel slower on the H100, by 0.4-0.9 us at 12.8M words, as if
//   an IMAD.WIDE held the FMA pipe for three to four IMADs (PERF.md row
//   1), so WIDE_ROUNDS is empty.
// - Four words a thread: a group of U consecutive counters (hi, lo + u)
//   starting at a multiple of U, so one high word serves the group (a
//   group never straddles 2**32), the U hash chains are independent, and
//   the group is one 16-byte store when `out` is 16-byte aligned and the
//   group is whole (scalar stores otherwise: a misaligned view, the last
//   group).
// - One mode a kernel: the mode is a template parameter, so each loop
//   holds one hash body (two for randint) and its own epilogue, no
//   branch.
// - A persistent grid of the card's resident blocks, striding over the
//   groups with a 32-bit group index wherever the groups and the grid's
//   stride fit 32 bits (n < 2**34 words at U = 4); the word index stays
//   64-bit.
// - randint divides by no runtime span: each remainder is Lemire's
//   fastmod, a % span = umulhi64(m * a, span) with m = floor((2**64 -
//   1) / span) + 1 (64-bit, 0 for span 1) computed on the host
//   (kernels/threefry.py fastmod_m), exact for every uint32 a and span
//   >= 1.
// Nothing goes through shared memory and each word is written once.

#include <cstdint>
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int U = 4;  // consecutive words a thread a step
// the rounds (bit r) whose rotate runs as a multiply on the FMA pipe:
// none (the design note above)
constexpr unsigned WIDE_ROUNDS = 0u;

enum Mode { BITS = 0, UNIFORM = 1, RANDINT = 2 };

struct TfArgs {
  uint32_t* out;
  long long n;                // words
  unsigned long long groups;  // ceil(n / U)
  uint32_t ka0, ka1, kb0, kb1;
  uint32_t span, mult;
  int minval;
  unsigned long long fastmod_m;
  uint32_t one;  // 1, a multiplier ptxas cannot fold away
  int vec;       // out is aligned for a group's vector store
};

// a % span, m = fastmod_m(span)
__device__ __forceinline__ uint32_t fastmod(uint32_t a, unsigned long long m,
                                            uint32_t span) {
  const unsigned long long low = m * a;
  const uint32_t lo = (uint32_t)low, hi = (uint32_t)(low >> 32);
  return (uint32_t)(((unsigned long long)hi * span + __umulhi(lo, span)) >>
                    32);
}

// the group's U words at flat index base: one vector store when it is
// whole and out aligned, else a scalar store each below n
__device__ __forceinline__ void store_group(const TfArgs& a,
                                            unsigned long long base,
                                            bool whole,
                                            const uint32_t (&w)[U]) {
  uint32_t* p = a.out + base;
  if (whole && a.vec) {
    if constexpr (U == 2) {
      *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
    } else {
#pragma unroll
      for (int q = 0; q < U / 4; ++q)
        reinterpret_cast<uint4*>(p)[q] =
            make_uint4(w[4 * q], w[4 * q + 1], w[4 * q + 2], w[4 * q + 3]);
    }
  } else {
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (base + u < (unsigned long long)a.n) p[u] = w[u];
  }
}

template <int MODE, typename G>
__global__ void __launch_bounds__(THREADS) threefry_kernel(const TfArgs a) {
  const uint32_t one = a.one;
  const uint32_t ka2 = a.ka0 ^ a.ka1 ^ 0x1BD11BDAu;
  const G groups = (G)a.groups, whole = (G)((unsigned long long)a.n / U);
  const G stride = (G)gridDim.x * THREADS;
  for (G g = (G)blockIdx.x * THREADS + threadIdx.x; g < groups; g += stride) {
    const unsigned long long base = (unsigned long long)g * U;
    const uint32_t hi = (uint32_t)(base >> 32), lo = (uint32_t)base;
    uint32_t w[U];
    common::hash_run<WIDE_ROUNDS, U>(hi + a.ka0, lo + a.ka1, a.ka0, a.ka1,
                                     ka2, one, w);
    if constexpr (MODE == UNIFORM) {
#pragma unroll
      for (int u = 0; u < U; ++u)
        w[u] = __float_as_uint(common::uniform_of(w[u]));
    } else if constexpr (MODE == RANDINT) {
      uint32_t l[U];
      common::hash_run<WIDE_ROUNDS, U>(hi + a.kb0, lo + a.kb1, a.kb0, a.kb1,
                                       a.kb0 ^ a.kb1 ^ 0x1BD11BDAu, one, l);
      const unsigned long long m = a.fastmod_m;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const uint32_t off = fastmod(w[u], m, a.span) * a.mult +
                             fastmod(l[u], m, a.span);
        w[u] = (uint32_t)a.minval + fastmod(off, m, a.span);
      }
    }
    store_group(a, base, g < whole, w);
  }
}

// the card's SMs (the current device's)
int sm_count() {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms > 0 ? sms : 1;
}

// the persistent grid: as many blocks as the card holds at once, or
// fewer when the groups need fewer
template <int MODE, typename G>
int launch(const TfArgs& a, cudaStream_t stream) {
  static int per_sm = 0;
  if (per_sm == 0 &&
      (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, threefry_kernel<MODE, G>, THREADS, 0) != cudaSuccess ||
       per_sm < 1))
    per_sm = 1;
  unsigned long long blocks = (a.groups + THREADS - 1) / THREADS;
  const unsigned long long cap = (unsigned long long)per_sm * sm_count();
  if (blocks > cap) blocks = cap;
  threefry_kernel<MODE, G><<<(unsigned)blocks, THREADS, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename G>
int launch_mode(int mode, const TfArgs& a, cudaStream_t stream) {
  if (mode == BITS) return launch<BITS, G>(a, stream);
  if (mode == UNIFORM) return launch<UNIFORM, G>(a, stream);
  return launch<RANDINT, G>(a, stream);
}

}  // namespace

// fastmod_m: kernels/threefry.py fastmod_m(span) (randint only);
// index64: stride with a 64-bit group index even where 32 bits would do
extern "C" int threefry_launch(void* out, long long n, unsigned ka0,
                               unsigned ka1, unsigned kb0, unsigned kb1,
                               int mode, unsigned span, unsigned mult,
                               int minval, unsigned long long fastmod_m,
                               int index64, void* stream) {
  if (n <= 0) return 0;
  if (mode < BITS || mode > RANDINT || (mode == RANDINT && span == 0))
    return (int)cudaErrorInvalidValue;
  TfArgs a;
  a.out = static_cast<uint32_t*>(out);
  a.n = n;
  a.groups = ((unsigned long long)n + U - 1) / U;
  a.ka0 = ka0;
  a.ka1 = ka1;
  a.kb0 = kb0;
  a.kb1 = kb1;
  a.span = span;
  a.mult = mult;
  a.minval = minval;
  a.fastmod_m = fastmod_m;
  a.one = 1u;
  a.vec = (reinterpret_cast<uintptr_t>(out) % (4 * (U < 4 ? U : 4))) == 0;
  const cudaStream_t s = (cudaStream_t)stream;
  // a 32-bit group index g never wraps: g < groups, so g + stride stays
  // under groups + the largest grid (2048 threads an SM)
  const unsigned long long most = 2048ull * sm_count();
  if (!index64 && a.groups + most <= 0xFFFFFFFFull)
    return launch_mode<uint32_t>(mode, a, s);
  return launch_mode<unsigned long long>(mode, a, s);
}
