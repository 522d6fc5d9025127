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

#include "common.cuh"

namespace {

using common::threefry_xor;

__global__ void threefry_kernel(void* __restrict__ out, long long n,
                                uint32_t ka0, uint32_t ka1, uint32_t kb0,
                                uint32_t kb1, int mode, uint32_t span,
                                uint32_t mult, int minval) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const uint32_t b = threefry_xor(ka0, ka1, (unsigned long long)i);
    if (mode == 0) {
      static_cast<uint32_t*>(out)[i] = b;
    } else if (mode == 1) {
      static_cast<float*>(out)[i] = common::uniform_of(b);
    } else {
      const uint32_t lb = threefry_xor(kb0, kb1, (unsigned long long)i);
      static_cast<int*>(out)[i] =
          common::randint_of(b, lb, span, mult, minval);
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
