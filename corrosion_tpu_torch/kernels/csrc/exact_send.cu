// exact_send / exact_commit: the broadcast phase of the exact sampler.
//
// Replaces the broadcast phase of corrosion_tpu/sim/calibrate.py
// packed_exact_tick (:593-661) and frontier_exact_tick (:1175-1236).
// The reference draws [N, K] candidate tuples for every node, tests
// them against the [N, ceil(N/8)] sent_to bitmap (or the [N, cap]
// target ring plus the writer's arithmetic ring0 tier), redraws the
// bad rows in a lax.while_loop until none is left, then masks the
// deliveries (loss, partition, WAN drop), scatter-mins the WAN latency
// queue, scatter-sets the infection, scatter-adds the sender's marks
// and runs the budget / backoff epilogue as separate passes.
//
// exact_send: one thread per (seed, sender row).  An active row runs
// its own rejection loop: round r draws the row's K candidates of
// randint(fold_in(k_draw, r), (n, K), 0, n) at flat indices i*K ..
// i*K+K-1, keys derived in-thread, and redraws the whole tuple until
// it holds no self hit, no duplicate and no sent hit.  A row's draws
// depend on its own index only, so this equals the reference's loop,
// which freezes rows once they are valid.  The sent test is the
// template parameter: bit c & 7 of byte sent[s, i, c >> 3], or a
// compare across the row's ring slots plus the ring0 tier.  Each
// candidate then meets the loss, partition and WAN masks in the
// reference's order; a delayed (cross-region) delivery goes to the
// target's queue slot with an atomicMin (exact in any order), any
// other delivery stores 1 into new_infected, a copy of infected
// (stores of 1 are idempotent).  The thread marks its own row in place
// (only thread i reads or writes row i of sent / ring), then updates
// its own msgs, tx and next_send (round() half-to-even as rintf on a
// float32 product).  A per-block reduction adds the active rows, their
// rejection rounds and their maximum to a small diagnostics vector.
// The latency queue's promote pass clears slots and must run before
// this kernel, never inside it, or a concurrent atomicMin is lost.
//
// exact_commit: one thread per (seed, node): a node that learned this
// tick (new_infected & ~infected) gets a fresh budget and forwards
// after one tick, its RTT tier's worth on the tiered topologies.  It
// is a second launch because it needs every sender's stores.
//
// Bound on the H100: bytes.  Every row's activity test reads 9 bytes;
// an active row moves its own leaves, K random bitmap sectors (or its
// 128-byte ring row), and K random 32-byte sectors each for the
// infection stores and the marks.  The design draws in registers, so
// no [N, K] draw array and no candidate array reaches memory, and
// inactive rows (most rows late in a run) cost their 9 bytes only.
// Offsets into the bitmap are size_t: 16 seeds x 100k x 12.5k bytes
// is 2.0e10, past 2**31.

#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int MAX_K = 8;
constexpr int MAX_SEEDS = 32;
constexpr int MAX_ROUNDS = 4096;
constexpr int THREADS = 256;

// Mirrored field for field by the ctypes structure in exact_send.py
// (which checks sizeof through exact_args_size).
struct ExactArgs {
  const unsigned char* infected;  // [S, N] bool, read
  unsigned char* new_infected;    // [S, N] bool, arrives as a copy
  int* tx;                        // [S, N]
  int* next_send;                 // [S, N]
  int* msgs;                      // [S, N]
  int* pending;                   // [S, N] or null (no latency queue)
  unsigned char* sent;            // [S, N, nb] bitmap (dense)
  int* ring;                      // [S, N, cap] targets (sparse)
  const int* tier;                // [N] RTT tier or null
  unsigned long long* diag;       // [4]: active, rounds, max, capped
  long long nb;
  int cap;
  int s;
  int n;
  int k;
  int tick;
  int max_tx;
  float backoff;
  int use_loss;
  float loss;
  int part_blocks;  // 0: no partition
  int part_active;
  int wan_blocks;   // 0: no WAN drop
  float wan_loss;
  int lat_blocks;   // 0: no latency queue
  int lat_ticks;
  int ring0_block;  // 0: no arithmetic ring0 tier (ring only)
  int writer;
  uint32_t span;  // randint(0, n)
  uint32_t mult;
  uint32_t keys[MAX_SEEDS][6];  // per seed: k_draw, k_loss, k_wan
};

__device__ __forceinline__ int block_of(int x, int blocks, int n) {
  return (int)((long long)x * blocks / n);
}

template <bool RING>
__device__ __forceinline__ bool sent_hit(const ExactArgs& a, size_t g,
                                         int i, int c) {
  if constexpr (RING) {
    const int* row = a.ring + g * a.cap;
    for (int q = 0; q < a.cap; ++q)
      if (row[q] == c) return true;
    return a.ring0_block > 0 && i == a.writer && c != a.writer &&
           c / a.ring0_block == a.writer / a.ring0_block;
  } else {
    return (a.sent[g * (size_t)a.nb + (c >> 3)] >> (c & 7)) & 1;
  }
}

// The K candidates of row i at rejection round r: row i of
// randint(fold_in(k_draw, r), (n, K), 0, n), flat indices i*K + j, the
// keys derived in-thread (i is the global row id).
__device__ __forceinline__ void draw_tuple(const ExactArgs& a,
                                           const uint32_t* key, int r, int i,
                                           int (&cand)[MAX_K]) {
  uint32_t r0, r1, h0, h1, l0, l1;
  common::threefry2x32(key[0], key[1], 0u, (uint32_t)r, r0, r1);
  common::threefry2x32(r0, r1, 0u, 0u, h0, h1);  // randint's split
  common::threefry2x32(r0, r1, 0u, 1u, l0, l1);
  const unsigned long long f0 = (unsigned long long)i * a.k;
#pragma unroll
  for (int j = 0; j < MAX_K; ++j) {
    if (j < a.k) {
      const unsigned long long f = f0 + j;
      cand[j] = common::randint_of(common::threefry_xor(h0, h1, f),
                                   common::threefry_xor(l0, l1, f), a.span,
                                   a.mult, 0);
    }
  }
}

// A self, sent or duplicate hit in row i's tuple (g: the row's index
// into sent / ring).
template <bool RING>
__device__ __forceinline__ bool tuple_bad(const ExactArgs& a, size_t g,
                                          int i, const int (&cand)[MAX_K]) {
  bool bad = false;
#pragma unroll
  for (int j = 0; j < MAX_K; ++j)
    if (j < a.k)
      bad = bad || cand[j] == i || sent_hit<RING>(a, g, i, cand[j]);
#pragma unroll
  for (int x = 0; x < MAX_K; ++x)
#pragma unroll
    for (int y = x + 1; y < MAX_K; ++y)
      if (y < a.k) bad = bad || cand[x] == cand[y];
  return bad;
}

// Row i's whole rejection loop: its accepted tuple in cand; returns the
// rounds drawn (MAX_ROUNDS with capped set when none was accepted).
template <bool RING>
__device__ __forceinline__ int reject_loop(const ExactArgs& a,
                                           const uint32_t* key, size_t g,
                                           int i, int (&cand)[MAX_K],
                                           bool& capped) {
  for (int r = 0;; ++r) {
    if (r == MAX_ROUNDS) {
      capped = true;
      return r;
    }
    draw_tuple(a, key, r, i, cand);
    if (!tuple_bad<RING>(a, g, i, cand)) return r + 1;
  }
}

enum Delivery { DROPPED = 0, NOW = 1, QUEUED = 2 };

// The fate of sender i's send j to c: the loss, partition and WAN
// masks in the reference's order, then the latency queue's split.
__device__ __forceinline__ Delivery deliver_kind(const ExactArgs& a,
                                                 const uint32_t* key, int i,
                                                 int j, int c) {
  const unsigned long long f = (unsigned long long)i * a.k + j;
  const uint32_t* kl = key + 2;
  const uint32_t* kw = key + 4;
  bool del = true;
  if (a.use_loss)
    del = common::uniform_of(common::threefry_xor(kl[0], kl[1], f)) >= a.loss;
  if (a.part_blocks && a.part_active &&
      block_of(i, a.part_blocks, a.n) != block_of(c, a.part_blocks, a.n))
    del = false;
  if (a.wan_blocks &&
      block_of(i, a.wan_blocks, a.n) != block_of(c, a.wan_blocks, a.n) &&
      common::uniform_of(common::threefry_xor(kw[0], kw[1], f)) < a.wan_loss)
    del = false;
  if (!del) return DROPPED;
  if (a.lat_blocks &&
      block_of(i, a.lat_blocks, a.n) != block_of(c, a.lat_blocks, a.n))
    return QUEUED;
  return NOW;
}

// The sender's mark of send j to c in its own row g (tx0: its budget
// before this tick's decrement picks the ring slot).
template <bool RING>
__device__ __forceinline__ void mark(const ExactArgs& a, size_t g, int tx0,
                                     int j, int c) {
  if constexpr (RING)
    a.ring[g * a.cap + (size_t)((a.max_tx - tx0) * a.k + j)] = c;
  else
    a.sent[g * (size_t)a.nb + (c >> 3)] |= (unsigned char)(1u << (c & 7));
}

// The sender's budget and backoff at its leaf index gb (tier by its
// global id i): round() half-to-even as rintf on a float32 product.
__device__ __forceinline__ void spend(const ExactArgs& a, size_t gb, int i) {
  a.msgs[gb] += a.k;
  const int tx1 = a.tx[gb] - 1;
  a.tx[gb] = tx1;
  int gap = max(1, (int)rintf(__fmul_rn(a.backoff, (float)(a.max_tx - tx1))));
  if (a.tier) gap *= a.tier[i];
  a.next_send[gb] = a.tick + gap;
}

// Adds a block's active rows, rejection rounds, their maximum and its
// capped rows to the diagnostics vector (every thread of the block
// calls it).
__device__ __forceinline__ void add_diag(unsigned long long* diag,
                                         unsigned active, unsigned rounds,
                                         unsigned capped) {
  __shared__ unsigned s_sum[3][THREADS / 32], s_max[THREADS / 32];
  const unsigned full = 0xffffffffu;
  const unsigned w_act = __reduce_add_sync(full, active);
  const unsigned w_rounds = __reduce_add_sync(full, rounds);
  const unsigned w_max = __reduce_max_sync(full, rounds);
  const unsigned w_cap = __reduce_add_sync(full, capped);
  const int warp = threadIdx.x / 32;
  if (threadIdx.x % 32 == 0) {
    s_sum[0][warp] = w_act;
    s_sum[1][warp] = w_rounds;
    s_sum[2][warp] = w_cap;
    s_max[warp] = w_max;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long b_act = 0, b_rounds = 0, b_cap = 0, b_max = 0;
    for (int w = 0; w < THREADS / 32; ++w) {
      b_act += s_sum[0][w];
      b_rounds += s_sum[1][w];
      b_cap += s_sum[2][w];
      if (s_max[w] > b_max) b_max = s_max[w];
    }
    if (b_act) {
      atomicAdd(diag, b_act);
      atomicAdd(diag + 1, b_rounds);
      atomicMax(diag + 2, b_max);
      if (b_cap) atomicAdd(diag + 3, b_cap);
    }
  }
}

template <bool RING>
__global__ void __launch_bounds__(THREADS)
    exact_send_kernel(const ExactArgs a) {
  const size_t total = (size_t)a.s * a.n;
  const size_t g = (size_t)blockIdx.x * THREADS + threadIdx.x;
  unsigned active = 0, rounds = 0, capped = 0;
  if (g < total && a.infected[g] && a.tx[g] > 0 &&
      a.next_send[g] <= a.tick) {
    active = 1;
    const int s = (int)(g / a.n);
    const int i = (int)(g - (size_t)s * a.n);
    const uint32_t* key = a.keys[s];
    int cand[MAX_K];
    bool cap_hit = false;
    rounds = reject_loop<RING>(a, key, g, i, cand, cap_hit);
    capped = cap_hit;  // the caller raises on diag[3]; the row sends nothing
    if (!cap_hit) {
      const size_t seed0 = (size_t)s * a.n;
      const int tx0 = a.tx[g];
#pragma unroll
      for (int j = 0; j < MAX_K; ++j) {
        if (j < a.k) {
          const int c = cand[j];
          const Delivery del = deliver_kind(a, key, i, j, c);
          if (del == QUEUED)
            atomicMin(a.pending + seed0 + c, a.tick + a.lat_ticks);
          else if (del == NOW)
            a.new_infected[seed0 + c] = 1;
          mark<RING>(a, g, tx0, j, c);
        }
      }
      spend(a, g, i);
    }
  }
  add_diag(a.diag, active, rounds, capped);
}

// -- one shard of the multi-device layouts -------------------------------
//
// shard_round replaces the rejection round of the three mesh layouts
// (corrosion_tpu/sim/calibrate.py:817-846, models/sharded.py:403-426,
// :659-683): a shard tests only its own rows (global ids lo + il)
// against its own bitmap or ring rows.  Here each of my active rows
// runs its whole loop in registers, as exact_send does, and writes how
// many rounds it drew (0: inactive; MAX_ROUNDS + 1: capped).  Row i's
// round-r tuple depends only on its key, its global id and its own
// memory, so "rounds > r + 1" is exactly the reference's still-bad
// mask after round r: the caller exchanges those masks round by round.
//
// shard_commit replaces the delivery and commit of the same three
// (calibrate.py:848-892, sharded.py:428-470, :685-728).  One thread
// per (seed, row) of all N rows: an active row redraws its accepted
// tuple at its final round (the count of exchanged masks that held it,
// so every shard rebuilds every tuple without moving one), applies the
// masks, and stores the infection and the queue's atomicMin for the
// targets in the target window [t_lo, t_lo + t_n) (the dense layout:
// my rows; the frontier layouts: all, replicated).  A row of mine also
// marks its own bitmap / ring row; a row in the budget window
// [b_lo, b_lo + b_n) (mine, or all where tx / next_send / msgs are
// replicated) spends its budget.  Bound on the H100: bytes — the N
// activity bytes and round counts, and per active row what exact_send
// moves.

struct ShardArgs {
  ExactArgs e;  // n = N; sent / ring: my rows; new_infected, pending: the
                // target window; tx, next_send, msgs: the budget window
  const unsigned char* active;  // round: [S, n_local]; commit: [S, N]
  int* rounds;                  // round: out [S, n_local]; commit: [S, N]
  int lo;
  int n_local;
  int t_lo;
  int t_n;
  int b_lo;
  int b_n;
};

template <bool RING>
__global__ void __launch_bounds__(THREADS)
    shard_round_kernel(const ShardArgs sa) {
  const ExactArgs& a = sa.e;
  const size_t total = (size_t)a.s * sa.n_local;
  const size_t g = (size_t)blockIdx.x * THREADS + threadIdx.x;
  unsigned active = 0, rounds = 0, capped = 0;
  if (g < total) {
    if (sa.active[g]) {
      active = 1;
      const int s = (int)(g / sa.n_local);
      const int i = sa.lo + (int)(g - (size_t)s * sa.n_local);
      int cand[MAX_K];
      bool cap_hit = false;
      rounds = reject_loop<RING>(a, a.keys[s], g, i, cand, cap_hit);
      capped = cap_hit;
    }
    sa.rounds[g] = capped ? MAX_ROUNDS + 1 : (int)rounds;
  }
  add_diag(a.diag, active, rounds, capped);
}

template <bool RING>
__global__ void __launch_bounds__(THREADS)
    shard_commit_kernel(const ShardArgs sa) {
  const ExactArgs& a = sa.e;
  const size_t total = (size_t)a.s * a.n;
  const size_t gg = (size_t)blockIdx.x * THREADS + threadIdx.x;
  if (gg >= total || !sa.active[gg]) return;
  const int s = (int)(gg / a.n);
  const int i = (int)(gg - (size_t)s * a.n);
  const uint32_t* key = a.keys[s];
  int cand[MAX_K];
  draw_tuple(a, key, sa.rounds[gg], i, cand);
  const bool mine = i >= sa.lo && i < sa.lo + sa.n_local;
  const bool budget = i >= sa.b_lo && i < sa.b_lo + sa.b_n;
  const size_t g = (size_t)s * sa.n_local + (i - sa.lo);
  const size_t gb = (size_t)s * sa.b_n + (i - sa.b_lo);
  const int tx0 = budget ? a.tx[gb] : 0;
#pragma unroll
  for (int j = 0; j < MAX_K; ++j) {
    if (j < a.k) {
      const int c = cand[j];
      const int ct = c - sa.t_lo;
      if (ct >= 0 && ct < sa.t_n) {
        const Delivery del = deliver_kind(a, key, i, j, c);
        const size_t tgt = (size_t)s * sa.t_n + ct;
        if (del == QUEUED)
          atomicMin(a.pending + tgt, a.tick + a.lat_ticks);
        else if (del == NOW)
          a.new_infected[tgt] = 1;
      }
      if (mine) mark<RING>(a, g, tx0, j, c);
    }
  }
  if (budget) spend(a, gb, i);
}

__global__ void exact_commit_kernel(const unsigned char* __restrict__ infected,
                                    const unsigned char* __restrict__ new_inf,
                                    int* __restrict__ tx,
                                    int* __restrict__ next_send,
                                    const int* __restrict__ tier,
                                    size_t total, int n, int tick,
                                    int max_tx) {
  const size_t g = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= total || !new_inf[g] || infected[g]) return;
  tx[g] = max_tx;
  next_send[g] = tick + (tier ? tier[g % n] : 1);
}

}  // namespace

extern "C" int exact_args_size() { return (int)sizeof(ExactArgs); }

extern "C" int exact_send_launch(const void* args, int ring, void* stream) {
  const ExactArgs& a = *static_cast<const ExactArgs*>(args);
  if (a.s < 1 || a.s > MAX_SEEDS || a.n < 1 || a.k < 1 || a.k > MAX_K ||
      a.span == 0 || a.diag == nullptr ||
      (ring ? a.ring == nullptr || a.cap < a.k * a.max_tx
            : a.sent == nullptr || a.nb * 8 < a.n))
    return (int)cudaErrorInvalidValue;
  const size_t total = (size_t)a.s * a.n;
  const unsigned blocks = (unsigned)((total + THREADS - 1) / THREADS);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (ring)
    exact_send_kernel<true><<<blocks, THREADS, 0, st>>>(a);
  else
    exact_send_kernel<false><<<blocks, THREADS, 0, st>>>(a);
  return (int)cudaGetLastError();
}

extern "C" int shard_args_size() { return (int)sizeof(ShardArgs); }

extern "C" int shard_launch(const void* args, int ring, int commit,
                            void* stream) {
  const ShardArgs& sa = *static_cast<const ShardArgs*>(args);
  const ExactArgs& a = sa.e;
  if (a.s < 1 || a.s > MAX_SEEDS || a.n < 1 || a.k < 1 || a.k > MAX_K ||
      a.span == 0 || sa.active == nullptr || sa.rounds == nullptr ||
      sa.n_local < 1 || sa.lo < 0 || sa.lo + sa.n_local > a.n ||
      (ring ? a.ring == nullptr || a.cap < a.k * a.max_tx
            : a.sent == nullptr || a.nb * 8 < a.n) ||
      (commit ? a.new_infected == nullptr || a.tx == nullptr ||
                    sa.t_n < 1 || sa.b_n < 1 || sa.b_lo > sa.lo ||
                    sa.b_lo + sa.b_n < sa.lo + sa.n_local
              : a.diag == nullptr))
    return (int)cudaErrorInvalidValue;
  const size_t total = (size_t)a.s * (commit ? a.n : sa.n_local);
  const unsigned blocks = (unsigned)((total + THREADS - 1) / THREADS);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (commit && ring)
    shard_commit_kernel<true><<<blocks, THREADS, 0, st>>>(sa);
  else if (commit)
    shard_commit_kernel<false><<<blocks, THREADS, 0, st>>>(sa);
  else if (ring)
    shard_round_kernel<true><<<blocks, THREADS, 0, st>>>(sa);
  else
    shard_round_kernel<false><<<blocks, THREADS, 0, st>>>(sa);
  return (int)cudaGetLastError();
}

extern "C" int exact_commit_launch(const void* infected,
                                   const void* new_infected, void* tx,
                                   void* next_send, const void* tier,
                                   long long total, int n, int tick,
                                   int max_tx, void* stream) {
  if (total <= 0) return 0;
  if (n < 1) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  const unsigned blocks = (unsigned)((total + threads - 1) / threads);
  exact_commit_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned char*>(infected),
      static_cast<const unsigned char*>(new_infected),
      static_cast<int*>(tx), static_cast<int*>(next_send),
      static_cast<const int*>(tier), (size_t)total, n, tick, max_tx);
  return (int)cudaGetLastError();
}
