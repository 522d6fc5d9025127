// exact_commit's warp-a-tile kernel at 16, 8 or 4 positions a lane, and
// with shared memory that leaves room for fewer blocks an SM
// (exact_commit_lanes.py).
#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int THREADS = 256;

struct CommitArgs {
  const unsigned char* infected;
  const unsigned char* new_inf;
  int* tx;
  int* next_send;
  const int* tier;
  long long ld_inf, ld_new;
  int s, n, tick, max_tx;
  unsigned tiles;
  int vec;
};

__device__ __forceinline__ unsigned learned4(unsigned nw, unsigned inf) {
  const unsigned m = __vcmpne4(nw, 0u) & __vcmpeq4(inf, 0u) & 0x80808080u;
  return ((m >> 7) * 0x00204081u) >> 21 & 0xFu;
}

template <int LP>
__device__ __forceinline__ unsigned load_bits(const unsigned char* nw,
                                              const unsigned char* inf) {
  if constexpr (LP == 16) {
    const uint4 a = __ldg(reinterpret_cast<const uint4*>(nw));
    const uint4 b = __ldg(reinterpret_cast<const uint4*>(inf));
    return learned4(a.x, b.x) | learned4(a.y, b.y) << 4 |
           learned4(a.z, b.z) << 8 | learned4(a.w, b.w) << 12;
  } else if constexpr (LP == 8) {
    const uint2 a = __ldg(reinterpret_cast<const uint2*>(nw));
    const uint2 b = __ldg(reinterpret_cast<const uint2*>(inf));
    return learned4(a.x, b.x) | learned4(a.y, b.y) << 4;
  } else {
    const unsigned a = __ldg(reinterpret_cast<const unsigned*>(nw));
    const unsigned b = __ldg(reinterpret_cast<const unsigned*>(inf));
    return learned4(a, b);
  }
}

// LP positions a lane by one LP-byte load of each mask; a warp 32 LP.
// UNROLL: a row's edge bytes loaded without a chain between them, and
// every shuffle of the store loop issued at once (no per-step skip).
template <int LP, bool UNROLL>
__global__ void __launch_bounds__(THREADS) var_kernel(const CommitArgs c) {
  constexpr int TILE = 32 * LP;
  constexpr int PER = 32 / LP;  // lanes owning a 32-position step
  extern __shared__ int pad[];
  (void)pad;
  const unsigned lane = threadIdx.x & 31;
  const unsigned t = blockIdx.x * (THREADS / 32) + threadIdx.x / 32;
  if (t >= (unsigned)c.s * c.tiles) return;
  const unsigned row = t / c.tiles;
  const unsigned char* nw = c.new_inf + (size_t)row * c.ld_new;
  const unsigned char* inf = c.infected + (size_t)row * c.ld_inf;
  const int base = (int)(t - row * c.tiles) * TILE -
                   (int)(reinterpret_cast<uintptr_t>(nw) & (LP - 1));
  const int p0 = base + (int)lane * LP;
  unsigned bits = 0;
  if (c.vec && p0 >= 0 && p0 + LP <= c.n) {
    bits = load_bits<LP>(nw + p0, inf + p0);
  } else if constexpr (UNROLL) {
#pragma unroll
    for (int i = 0; i < LP; ++i) {
      const int p = p0 + i;
      if (p >= 0 && p < c.n)
        bits |= (unsigned)((nw[p] != 0) & (inf[p] == 0)) << i;
    }
  } else {
    for (int i = 0; i < LP; ++i) {
      const int p = p0 + i;
      if (p >= 0 && p < c.n && nw[p] && !inf[p]) bits |= 1u << i;
    }
  }
  const unsigned busy = __ballot_sync(FULL, bits != 0);
  if (!busy) return;
  int* tx = c.tx + (size_t)row * c.n;
  int* ns = c.next_send + (size_t)row * c.n;
  if constexpr (UNROLL) {
#pragma unroll
    for (int j = 0; j < LP; ++j) {
      const unsigned mine =
          __shfl_sync(FULL, bits, PER * j + (int)(lane / LP));
      if (mine >> (lane % LP) & 1u) {
        const int p = base + 32 * j + (int)lane;
        tx[p] = c.max_tx;
        ns[p] = c.tick + (c.tier ? __ldg(c.tier + p) : 1);
      }
    }
  } else {
    for (int j = 0; j < LP; ++j) {
      if (!(busy >> (PER * j) & ((1u << PER) - 1u))) continue;
      const unsigned mine =
          __shfl_sync(FULL, bits, PER * j + (int)(lane / LP));
      if (mine >> (lane % LP) & 1u) {
        const int p = base + 32 * j + (int)lane;
        tx[p] = c.max_tx;
        ns[p] = c.tick + (c.tier ? __ldg(c.tier + p) : 1);
      }
    }
  }
}

template <int LP, bool UNROLL>
int go(const void* inf, const void* nw, long long ld_inf, long long ld_new,
       void* tx, void* ns, const void* tier, int s, int n, int tick,
       int max_tx, int per_sm, void* st) {
  const uintptr_t apart = reinterpret_cast<uintptr_t>(inf) -
                          reinterpret_cast<uintptr_t>(nw);
  CommitArgs c{(const unsigned char*)inf, (const unsigned char*)nw,
               (int*)tx, (int*)ns, (const int*)tier, ld_inf, ld_new,
               s, n, tick, max_tx,
               (unsigned)(((long long)n + LP - 1 + 32 * LP - 1) / (32 * LP)),
               (int)(apart % LP == 0 && (ld_inf - ld_new) % LP == 0)};
  const size_t warps = (size_t)s * c.tiles;
  // per_sm > 0: shared memory that leaves room for per_sm blocks an SM
  size_t smem = 0;
  if (per_sm > 0) {
    smem = (size_t)(227 * 1024) / per_sm - 1024;
    cudaFuncSetAttribute(var_kernel<LP, UNROLL>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
  }
  var_kernel<LP, UNROLL><<<(unsigned)((warps + 7) / 8), THREADS, smem,
                   (cudaStream_t)st>>>(c);
  return (int)cudaGetLastError();
}

}  // namespace

// lp: 16, 8 or 4 positions a lane; a negative lp the UNROLL variant
extern "C" int var_launch(int lp, const void* inf, const void* nw,
                          long long ld_inf, long long ld_new, void* tx,
                          void* ns, const void* tier, int s, int n, int tick,
                          int max_tx, int per_sm, void* st) {
#define GO(L, U)                                                          \
  return go<L, U>(inf, nw, ld_inf, ld_new, tx, ns, tier, s, n, tick,     \
                  max_tx, per_sm, st)
  switch (lp) {
    case 16: GO(16, false);
    case 8: GO(8, false);
    case 4: GO(4, false);
    case -16: GO(16, true);
    case -8: GO(8, true);
    default: GO(4, true);
  }
#undef GO
}
