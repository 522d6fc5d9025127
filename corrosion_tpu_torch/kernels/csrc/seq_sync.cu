// seq_sync: one anti-entropy round over partially reassembled
// changesets, and the per-universe statistics of the tick.
//
// Replaces corrosion_tpu/models/sync.py seq_sync_step (:166-212) with
// its session_msgs charge (:66) and the peer draw of
// models/common.py rand_peers (:35); seq_stats replaces the per-tick
// reductions of corrosion_tpu/sim/antientropy.py _scan_chunk (:77-82).
// The reference gathers [N, P, S] peer bitmaps, ranks the needed seqs
// with a cumsum, expands a [N, P, budget] loss draw onto each seq's
// chunk, OR-reduces over peers and charges the sessions with a
// scatter-add.
//
// seq_sync: one thread per client node i, its row held as W 64-bit
// masks (S <= 64 W; loaded as 16-byte vectors when a row is 16-byte
// aligned, each 0/1 byte folded into a bit by a carry-free multiply).
// For each of its P draws it forms the peer (randint under the split
// peer key at flat index i * P + q, folded into the universe as
// base + (local + offset) % u), loads the peer's row, and masks the
// needs peer & ~mine.  A session serves the first budget * spc needed
// seqs in ascending order: chunk b holds the needed seqs of 0-based
// rank b * spc .. (b + 1) * spc - 1, and is lost where the uniform at
// counter (i * P + q) * budget + b is below the loss (drawn for the
// chunks the session uses).  With nothing lost and nothing past the
// budget the whole needs mask lands at once; otherwise the thread walks
// the set bits in ascending order.  The server half of the handshake
// plus ceil(served / spc) chunk messages go to the peer with an
// integer atomicAdd (exact in any order), the client half per session
// to the node itself.  Peers read the old bitmap, so the merged row
// goes to a fresh buffer; msgs_out arrives holding a copy of msgs.
//
// seq_stats: one block per universe over its contiguous [n, S] slab:
// "every seq held by every node" (no zero byte, __syncthreads_or) and
// the exact int64 msgs sum, written as the float32 mean sum / n, both
// rounded once (the plain version does the same operations).
//
// Bound on the H100: bytes — the own row, one random peer row per
// draw, the written row and the [N] counters (about 64 MB per tick at
// config #4's 320k x 64), then the stats pass re-reads the bitmap and
// msgs (20.5 MB).  The loss draws are one hash per used chunk, not per
// seq, so the integer pipes stay below the memory time.  (A first
// version ran a warp per node; 320k short warps made it latency-bound
// at 9x its bytes bound.)

#include <cstdint>
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr unsigned FULL = 0xffffffffu;

struct SeqArgs {
  const unsigned char* bits;  // [N, S] bool
  unsigned char* bits_out;
  int* msgs_out;  // [N], holding msgs
  int n, s, p, u;
  uint32_t ph0, ph1, pl0, pl1;  // split(k_peers): randint's two keys
  uint32_t span, mult;
  uint32_t kd0, kd1;  // k_drop
  int spc, budget;
  float loss;
  int handshake;
  int vec;  // rows are 16-byte aligned, S % 16 == 0
};

// the four 0/1 bytes of w as four bits, byte 0 lowest (the partial
// products of the multiply occupy disjoint bits, so nothing carries)
__device__ __forceinline__ uint32_t nibble_of(uint32_t w) {
  return ((w * 0x01020408u) >> 24) & 0xFu;
}

// four bits as four 0/1 bytes, bit 0 in byte 0
__device__ __forceinline__ uint32_t bytes_of(uint32_t v) {
  return (v * 0x00204081u) & 0x01010101u;
}

// row of s bools -> W masks; vec: s % 16 == 0 and the row 16-byte
// aligned
template <int W>
__device__ __forceinline__ void load_bits(const unsigned char* row, int s,
                                          bool vec, uint64_t (&m)[W]) {
#pragma unroll
  for (int w = 0; w < W; ++w) m[w] = 0;
  if (vec) {
    const uint4* v = reinterpret_cast<const uint4*>(row);
#pragma unroll
    for (int c = 0; c < 4 * W; ++c) {
      if (16 * c < s) {
        const uint4 x = v[c];
        const uint64_t b = nibble_of(x.x) | nibble_of(x.y) << 4 |
                           nibble_of(x.z) << 8 | nibble_of(x.w) << 12;
        m[c / 4] |= b << (16 * (c % 4));
      }
    }
  } else {
#pragma unroll
    for (int w = 0; w < W; ++w)
      for (int k = 0; k < 64 && 64 * w + k < s; ++k)
        if (row[64 * w + k]) m[w] |= 1ull << k;
  }
}

template <int W>
__device__ __forceinline__ void store_bits(unsigned char* row, int s,
                                           bool vec, const uint64_t (&m)[W]) {
  if (vec) {
    uint4* v = reinterpret_cast<uint4*>(row);
#pragma unroll
    for (int c = 0; c < 4 * W; ++c) {
      if (16 * c < s) {
        const uint32_t b = (uint32_t)(m[c / 4] >> (16 * (c % 4)));
        v[c] = make_uint4(bytes_of(b & 0xFu), bytes_of((b >> 4) & 0xFu),
                          bytes_of((b >> 8) & 0xFu),
                          bytes_of((b >> 12) & 0xFu));
      }
    }
  } else {
#pragma unroll
    for (int w = 0; w < W; ++w)
      for (int k = 0; k < 64 && 64 * w + k < s; ++k)
        row[64 * w + k] = (m[w] >> k) & 1u;
  }
}

template <int W>
__global__ void seq_sync_kernel(const SeqArgs a) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.n) return;
  const int local = (int)(i % a.u);
  const int base = (int)i - local;
  const int cap = a.budget * a.spc;
  uint64_t own[W], acc[W];
  load_bits<W>(a.bits + (size_t)i * a.s, a.s, a.vec, own);
#pragma unroll
  for (int w = 0; w < W; ++w) acc[w] = own[w];
  const int server_half = a.handshake - a.handshake / 2;
  for (int q = 0; q < a.p; ++q) {
    const unsigned long long idx = (unsigned long long)i * a.p + q;
    const uint32_t hi = common::threefry_xor(a.ph0, a.ph1, idx);
    const uint32_t lo = common::threefry_xor(a.pl0, a.pl1, idx);
    const int peer =
        base + (local + common::randint_of(hi, lo, a.span, a.mult, 1)) % a.u;
    uint64_t need[W];
    load_bits<W>(a.bits + (size_t)peer * a.s, a.s, a.vec, need);
    int total = 0;
#pragma unroll
    for (int w = 0; w < W; ++w) {
      need[w] &= ~own[w];
      total += __popcll(need[w]);
    }
    const int served = min(total, cap);
    const int chunks = (served + a.spc - 1) / a.spc;
    uint32_t dropped = 0;  // bit b: chunk b of this session lost
    if (a.loss > 0.0f)
      for (int b = 0; b < chunks; ++b) {
        const uint32_t r = common::threefry_xor(
            a.kd0, a.kd1, idx * (unsigned long long)a.budget + b);
        if (common::uniform_of(r) < a.loss) dropped |= 1u << b;
      }
    if (dropped == 0 && total <= cap) {
#pragma unroll
      for (int w = 0; w < W; ++w) acc[w] |= need[w];
    } else {
      int rank = 0;  // 0-based rank of the next needed seq
#pragma unroll
      for (int w = 0; w < W; ++w) {
        uint64_t m = need[w];
        while (m != 0 && rank < served) {
          const uint64_t bit = m & (~m + 1);
          m ^= bit;
          if (!((dropped >> (rank / a.spc)) & 1u)) acc[w] |= bit;
          ++rank;
        }
      }
    }
    atomicAdd(a.msgs_out + peer, server_half + chunks);
  }
  atomicAdd(a.msgs_out + i, a.p * (a.handshake / 2));
  store_bits<W>(a.bits_out + (size_t)i * a.s, a.s, a.vec, acc);
}

constexpr int STATS_THREADS = 1024;

// a zero byte anywhere in v
__device__ __forceinline__ bool has_zero_byte(uint32_t v) {
  return ((v - 0x01010101u) & ~v & 0x80808080u) != 0;
}

__global__ void __launch_bounds__(STATS_THREADS)
seq_stats_kernel(const unsigned char* __restrict__ bits,
                 const int* __restrict__ msgs, float* __restrict__ out,
                 int n, int s, int vec) {
  __shared__ long long partial[STATS_THREADS / 32];
  const int g = blockIdx.x;
  const size_t slab = (size_t)n * s;
  const unsigned char* b = bits + (size_t)g * slab;
  int missing = 0;
  if (vec) {  // slab and base 16-byte aligned
    const uint4* v = reinterpret_cast<const uint4*>(b);
    for (size_t k = threadIdx.x; k < slab / 16; k += STATS_THREADS) {
      const uint4 x = v[k];
      missing |= has_zero_byte(x.x) | has_zero_byte(x.y) |
                 has_zero_byte(x.z) | has_zero_byte(x.w);
    }
  } else {
    for (size_t k = threadIdx.x; k < slab; k += STATS_THREADS)
      missing |= b[k] == 0;
  }
  long long sum = 0;
  const int* m = msgs + (size_t)g * n;
  for (int k = threadIdx.x; k < n; k += STATS_THREADS) sum += m[k];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) sum += __shfl_down_sync(FULL, sum, o);
  if ((threadIdx.x & 31) == 0) partial[threadIdx.x >> 5] = sum;
  missing = __syncthreads_or(missing);
  if (threadIdx.x == 0) {
    long long total = 0;
    for (int w = 0; w < STATS_THREADS / 32; ++w) total += partial[w];
    out[2 * g] = missing ? 0.0f : 1.0f;
    out[2 * g + 1] = __fdiv_rn(__ll2float_rn(total), __int2float_rn(n));
  }
}

}  // namespace

extern "C" int seq_sync_launch(const void* bits, void* bits_out,
                               void* msgs_out, int n, int s, int p, int u,
                               unsigned ph0, unsigned ph1, unsigned pl0,
                               unsigned pl1, unsigned span, unsigned mult,
                               unsigned kd0, unsigned kd1, int spc,
                               int budget, float loss, int handshake,
                               void* stream) {
  if (n <= 0) return 0;
  if (s < 1 || s > 128 || p < 1 || u < 1 || spc < 1 || budget < 1 ||
      budget > 32 || span == 0)
    return (int)cudaErrorInvalidValue;
  SeqArgs a;
  a.bits = static_cast<const unsigned char*>(bits);
  a.bits_out = static_cast<unsigned char*>(bits_out);
  a.msgs_out = static_cast<int*>(msgs_out);
  a.n = n;
  a.s = s;
  a.p = p;
  a.u = u;
  a.ph0 = ph0;
  a.ph1 = ph1;
  a.pl0 = pl0;
  a.pl1 = pl1;
  a.span = span;
  a.mult = mult;
  a.kd0 = kd0;
  a.kd1 = kd1;
  a.spc = spc;
  a.budget = budget;
  a.loss = loss;
  a.handshake = handshake;
  a.vec = s % 16 == 0 && reinterpret_cast<uintptr_t>(bits) % 16 == 0 &&
          reinterpret_cast<uintptr_t>(bits_out) % 16 == 0;
  const int threads = 256;
  const unsigned blocks = (unsigned)((n + threads - 1) / threads);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (s <= 64)
    seq_sync_kernel<1><<<blocks, threads, 0, st>>>(a);
  else
    seq_sync_kernel<2><<<blocks, threads, 0, st>>>(a);
  return (int)cudaGetLastError();
}

extern "C" int seq_stats_launch(const void* bits, const void* msgs, void* out,
                                int universes, int n, int s, void* stream) {
  if (universes <= 0) return 0;
  if (n <= 0 || s <= 0) return (int)cudaErrorInvalidValue;
  const int vec = ((size_t)n * s) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(bits) % 16 == 0;
  seq_stats_kernel<<<universes, STATS_THREADS, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned char*>(bits), static_cast<const int*>(msgs),
      static_cast<float*>(out), n, s, vec);
  return (int)cudaGetLastError();
}
