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
// One thread per output word: 20 rounds of threefry2x32 under the key
// on the counter pair (i >> 32, i & 0xFFFFFFFF) of the word's flat
// index i, output bits1 ^ bits2, then the epilogue:
//   mode 0  raw uint32 bits;
//   mode 1  float32 uniform in [0, 1): the top 23 bits as a mantissa in
//           [1, 2), minus 1;
//   mode 2  int32 randint: a second hash under the second key, folded
//           as ((hi % span) * mult + lo % span) % span in wrapping
//           uint32 arithmetic, plus minval.
//
// Bound on the H100: about 100 integer operations per hash against 4
// bytes written, so the integer pipes bound it, not memory (the bound
// the smoke script reports counts both).  The design keeps the whole
// hash in registers, writes each word once, fuses the epilogue so no
// bits array goes through memory, and needs no shared memory.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ uint32_t rotl32(uint32_t x, uint32_t d) {
  return (x << d) | (x >> (32u - d));
}

#define TF_ROUND(r)        \
  x0 += x1;                \
  x1 = rotl32(x1, (r));    \
  x1 ^= x0;

__device__ __forceinline__ uint32_t threefry_xor(uint32_t k0, uint32_t k1,
                                                 uint32_t x0, uint32_t x1) {
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
  return x0 ^ x1;
}

__global__ void threefry_kernel(void* __restrict__ out, long long n,
                                uint32_t ka0, uint32_t ka1, uint32_t kb0,
                                uint32_t kb1, int mode, uint32_t span,
                                uint32_t mult, int minval) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const uint32_t hi = (uint32_t)((unsigned long long)i >> 32);
    const uint32_t lo = (uint32_t)i;
    const uint32_t b = threefry_xor(ka0, ka1, hi, lo);
    if (mode == 0) {
      static_cast<uint32_t*>(out)[i] = b;
    } else if (mode == 1) {
      static_cast<float*>(out)[i] =
          __uint_as_float((b >> 9) | 0x3F800000u) - 1.0f;
    } else {
      const uint32_t lb = threefry_xor(kb0, kb1, hi, lo);
      const uint32_t off = ((b % span) * mult + lb % span) % span;
      static_cast<int*>(out)[i] = minval + (int)off;
    }
  }
}

}  // namespace

extern "C" int threefry_launch(void* out, long long n, unsigned ka0,
                               unsigned ka1, unsigned kb0, unsigned kb1,
                               int mode, unsigned span, unsigned mult,
                               int minval, void* stream) {
  if (n <= 0) return 0;
  if (mode == 2 && span == 0) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  long long blocks = (n + threads - 1) / threads;
  if (blocks > (1 << 20)) blocks = 1 << 20;
  threefry_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      out, n, ka0, ka1, kb0, kb1, mode, span, mult, minval);
  return (int)cudaGetLastError();
}
