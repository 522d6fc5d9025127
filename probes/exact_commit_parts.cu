// exact_commit's cost taken apart (exact_commit_parts.py): the byte
// loads alone, 16-byte loads alone, the learners' stores alone, the
// thread-a-byte kernel without its 64-bit modulo, and the warp-a-tile
// design (16 positions a lane) on a persistent or a plain grid.
#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int THREADS = 256;
constexpr int LANE_POS = 16;
constexpr int TILE = 32 * LANE_POS;

// byte loads only (the parent's grid, no stores unless flag)
__global__ void loads_byte_kernel(const unsigned char* __restrict__ inf,
                                  const unsigned char* __restrict__ nw,
                                  size_t total, int* sink, int flag) {
  const size_t g = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= total) return;
  const unsigned char a = nw[g], b = inf[g];
  if (flag && a && !b) sink[0] = (int)g;
}

// 16-byte loads only, a thread 16 positions (contiguous aligned masks)
__global__ void loads_vec_kernel(const uint4* __restrict__ inf,
                                 const uint4* __restrict__ nw, size_t groups,
                                 int* sink, int flag) {
  const size_t g = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= groups) return;
  const uint4 a = __ldg(nw + g), b = __ldg(inf + g);
  const unsigned x = (a.x & ~b.x) | (a.y & ~b.y) | (a.z & ~b.z) |
                     (a.w & ~b.w);
  if (flag && x) sink[0] = (int)g;
}

// the learners' stores alone, a thread a listed learner (in order)
__global__ void stores_list_kernel(const int* __restrict__ idx, int count,
                                   int* tx, int* ns, const int* tier, int n,
                                   int tick, int max_tx) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= count) return;
  const int g = idx[t];
  tx[g] = max_tx;
  ns[g] = tick + (tier ? tier[g % n] : 1);
}

// the parent's kernel with a 2D grid: tier by column, no 64-bit modulo
__global__ void nomod_kernel(const unsigned char* __restrict__ inf,
                             const unsigned char* __restrict__ nw, int* tx,
                             int* ns, const int* tier, int n, int tick,
                             int max_tx) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= n) return;
  const size_t g = (size_t)blockIdx.y * n + c;
  if (!nw[g] || inf[g]) return;
  tx[g] = max_tx;
  ns[g] = tick + (tier ? tier[c] : 1);
}

__device__ __forceinline__ unsigned learned4(unsigned nw, unsigned inf) {
  const unsigned m = __vcmpne4(nw, 0u) & __vcmpeq4(inf, 0u) & 0x80808080u;
  return ((m >> 7) * 0x00204081u) >> 21 & 0xFu;
}

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

// the candidate: a warp a tile of 512 positions, 16 a lane by one 16-byte
// load of each mask, the learners' stores by the lane of their position
__global__ void __launch_bounds__(THREADS) cand_kernel(const CommitArgs c) {
  const unsigned lane = threadIdx.x & 31;
  const unsigned stride = gridDim.x * (THREADS / 32);
  const unsigned total = (unsigned)c.s * c.tiles;
  for (unsigned t = blockIdx.x * (THREADS / 32) + threadIdx.x / 32;
       t < total; t += stride) {
    const unsigned row = t / c.tiles;
    const int tile = (int)(t - row * c.tiles);
    const unsigned char* nw = c.new_inf + (size_t)row * c.ld_new;
    const unsigned char* inf = c.infected + (size_t)row * c.ld_inf;
    const int base =
        tile * TILE - (int)(reinterpret_cast<uintptr_t>(nw) & 15u);
    const int p0 = base + (int)lane * LANE_POS;
    unsigned bits = 0;
    if (c.vec && p0 >= 0 && p0 + LANE_POS <= c.n) {
      const uint4 a = __ldg(reinterpret_cast<const uint4*>(nw + p0));
      const uint4 b = __ldg(reinterpret_cast<const uint4*>(inf + p0));
      bits = learned4(a.x, b.x) | learned4(a.y, b.y) << 4 |
             learned4(a.z, b.z) << 8 | learned4(a.w, b.w) << 12;
    } else {
      for (int i = 0; i < LANE_POS; ++i) {
        const int p = p0 + i;
        if (p >= 0 && p < c.n && nw[p] && !inf[p]) bits |= 1u << i;
      }
    }
    const unsigned busy = __ballot_sync(FULL, bits != 0);
    if (!busy) continue;
    int* tx = c.tx + (size_t)row * c.n;
    int* ns = c.next_send + (size_t)row * c.n;
    for (int j = 0; j < LANE_POS; ++j) {
      if (!(busy >> 2 * j & 3u)) continue;
      const unsigned mine = __shfl_sync(FULL, bits, 2 * j + (int)(lane >> 4));
      if (mine >> (lane & 15u) & 1u) {
        const int p = base + 32 * j + (int)lane;
        tx[p] = c.max_tx;
        ns[p] = c.tick + (c.tier ? c.tier[p] : 1);
      }
    }
  }
}

}  // namespace

extern "C" int loads_byte_launch(const void* inf, const void* nw,
                                 long long total, void* sink, int flag,
                                 void* st) {
  loads_byte_kernel<<<(unsigned)((total + 255) / 256), 256, 0,
                      (cudaStream_t)st>>>((const unsigned char*)inf,
                                          (const unsigned char*)nw,
                                          (size_t)total, (int*)sink, flag);
  return (int)cudaGetLastError();
}

extern "C" int loads_vec_launch(const void* inf, const void* nw,
                                long long total, void* sink, int flag,
                                void* st) {
  const size_t groups = (size_t)total / 16;
  loads_vec_kernel<<<(unsigned)((groups + 255) / 256), 256, 0,
                     (cudaStream_t)st>>>((const uint4*)inf, (const uint4*)nw,
                                         groups, (int*)sink, flag);
  return (int)cudaGetLastError();
}

extern "C" int stores_list_launch(const void* idx, int count, void* tx,
                                  void* ns, const void* tier, int n, int tick,
                                  int max_tx, void* st) {
  if (count <= 0) return 0;
  stores_list_kernel<<<(count + 255) / 256, 256, 0, (cudaStream_t)st>>>(
      (const int*)idx, count, (int*)tx, (int*)ns, (const int*)tier, n, tick,
      max_tx);
  return (int)cudaGetLastError();
}

extern "C" int nomod_launch(const void* inf, const void* nw, void* tx,
                            void* ns, const void* tier, int s, int n,
                            int tick, int max_tx, void* st) {
  dim3 grid((n + 255) / 256, s);
  nomod_kernel<<<grid, 256, 0, (cudaStream_t)st>>>(
      (const unsigned char*)inf, (const unsigned char*)nw, (int*)tx,
      (int*)ns, (const int*)tier, n, tick, max_tx);
  return (int)cudaGetLastError();
}

// persistent: 1 for as many blocks as the card holds at once, 0 for a
// block every 8 tiles
extern "C" int cand_launch(const void* inf, const void* nw, long long ld_inf,
                           long long ld_new, void* tx, void* ns,
                           const void* tier, int s, int n, int tick,
                           int max_tx, int persistent, void* st) {
  CommitArgs c{(const unsigned char*)inf, (const unsigned char*)nw,
               (int*)tx, (int*)ns, (const int*)tier, ld_inf, ld_new,
               s, n, tick, max_tx,
               (unsigned)(((long long)n + 15 + TILE - 1) / TILE),
               (int)(((uintptr_t)inf - (uintptr_t)nw) % 16 == 0 &&
                     (ld_inf - ld_new) % 16 == 0)};
  const size_t need = ((size_t)s * c.tiles + 7) / 8;
  size_t blocks = need;
  if (persistent) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, cand_kernel,
                                                  THREADS, 0);
    const size_t most = (size_t)sms * per_sm;
    blocks = need < most ? need : most;
  }
  cand_kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)st>>>(c);
  return (int)cudaGetLastError();
}
