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
// exact_send<Ring>: two launches.  exact_rows writes the worklist of the
// active (seed, sender row) pairs (infected, budget left, due): eight rows
// a thread, warp ballots and one atomicAdd a block, in any order.
// exact_send_ring_kernel is a persistent grid that walks the worklist, one
// thread a listed row, so warps run active rows only, however few a tick
// has.  exact_send<Bitmap> is one launch (exact_send_bitmap_kernel), a
// persistent grid with no list: each warp ballots the activity of its tiles
// of 32 rows and deals the active rows to its lanes, carrying a short batch
// into the next tile, so warps run active rows only here too (deal_rows,
// which the shard kernels below share).  A row runs
// its own rejection loop: round r draws the row's K candidates of
// randint(fold_in(k_draw, r), (n, K), 0, n) at flat indices i*K .. i*K+K-1
// and redraws the whole tuple until it holds no self hit, no duplicate and
// no sent hit.  The round's randint keys (fold_in and randint's split: 3 of
// a round's 3 + 2K hashes) depend on (seed, r) alone, so each block of the
// persistent grids derives them once for the first KEY_ROUNDS rounds
// of every seed into shared memory; a later round derives its own.  A row's
// draws depend on its own index only, so this equals the reference's loop,
// which freezes rows once they are valid.  The sent test is bit c & 7 of
// byte sent[s, i, c >> 3] (bitmap_loop), or a compare across the row's
// ring slots plus the ring0 tier (ring_loop).  The ring row (cap = max_tx * K
// int32 slots, 32 at the headline) is loaded once into registers, 16 bytes
// a load, and every candidate of every round is tested there; slots past
// RING_REGS are read from memory.  The bitmap's K bytes of a round are
// loaded together, and the accepted round's stay in registers: the marks OR
// their bits in and write each byte once, with the bits of every candidate
// that shares it, so no byte is read twice.  Each candidate then meets the
// loss, partition and WAN masks in the reference's order; a delayed
// (cross-region) delivery goes to the target's queue slot with an atomicMin
// (exact in any order), any other delivery stores 1 into new_infected, a
// copy of infected (stores of 1 are idempotent).  The thread marks its own
// row in place (only thread i reads or writes row i of sent / ring), then
// updates its own msgs, tx and next_send (round() half-to-even as rintf on
// a float32 product).  A persistent block's reduction adds the active rows,
// their rejection rounds and their maximum to a small diagnostics vector.
// The latency queue's promote pass clears slots and must run before this
// kernel, never inside it, or a concurrent atomicMin is lost.
//
// exact_commit: a node that learned this tick (new_infected & ~infected)
// gets a fresh budget and forwards after one tick, its RTT tier's worth
// on the tiered topologies.  It is a second launch because it needs
// every sender's stores.  Bound: bytes, 2 a position read and the
// learners' 32-byte sectors of tx and next_send (and of tier).  A warp
// takes a tile of 512 positions of one row, each lane 16 of them by one
// 16-byte load of each mask; a lane whose 16 cross the row's first or
// last byte, or masks that lie 16-byte aligned apart, take byte loads.
// A tile with no learner stores nothing; else lane l stores position
// 32 j + l of the tile, its learned bit shuffled from the lane that
// loaded it, so each store instruction covers 32 neighbouring ints.
// The masks may be windows of wider rows (a row stride each); tier is
// indexed by the column.  A plain grid, a warp a tile: a persistent grid
// walking the tiles measured no faster (within 5%, slower with many
// learners), and it needs an occupancy query on the host every launch.
//
// Bound on the H100: bytes.  Every row's activity test reads 9 bytes;
// an active row moves its own leaves, K random bitmap sectors (or its
// 128-byte ring row), and K random 32-byte sectors each for the
// infection stores and the marks.  The design draws in registers, so
// no [N, K] draw array and no candidate array reaches memory, and
// inactive rows cost their 9 bytes (and 4 a worklist entry for an
// active one).  Row indices are 32-bit (the wrapper keeps S * N below
// 2**31); the bitmap's row offset is size_t, as it must be: 16 seeds x
// 100k x 12.5k bytes is 2.0e10, past 2**31.

#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int MAX_K = 8;
constexpr int EXACT_FANOUT = 4;  // sim/calibrate.py headline_exact_cfg
constexpr int MAX_SEEDS = 32;
constexpr int MAX_ROUNDS = 4096;
constexpr int THREADS = 256;
constexpr int RING_REGS = 32;  // ring slots a thread holds in registers
constexpr int KEY_ROUNDS = 8;  // rounds whose keys a block derives once
constexpr int ROWS_PER_THREAD = 8;  // rows a worklist thread tests
constexpr unsigned FULL = 0xffffffffu;

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

// randint's two keys at rejection round r: split(fold_in(k_draw, r))
struct RoundKeys {
  uint32_t h0, h1, l0, l1;
};

__device__ __forceinline__ RoundKeys round_keys(const uint32_t* key, int r) {
  RoundKeys rk;
  uint32_t r0, r1;
  common::threefry2x32(key[0], key[1], 0u, (uint32_t)r, r0, r1);
  common::threefry2x32(r0, r1, 0u, 0u, rk.h0, rk.h1);  // randint's split
  common::threefry2x32(r0, r1, 0u, 1u, rk.l0, rk.l1);
  return rk;
}

// The first KEY_ROUNDS rounds' keys of every seed, derived once a block
// (every thread calls it; it ends in a barrier).
struct KeyTable {
  RoundKeys rk[MAX_SEEDS][KEY_ROUNDS];
};

__device__ __forceinline__ void fill_keys(const ExactArgs& a, KeyTable& t) {
  for (int x = threadIdx.x; x < a.s * KEY_ROUNDS; x += blockDim.x) {
    const int s = x / KEY_ROUNDS, r = x - s * KEY_ROUNDS;
    t.rk[s][r] = round_keys(a.keys[s], r);
  }
  __syncthreads();
}

// The K candidates of row i under round keys rk: row i of
// randint(fold_in(k_draw, r), (n, K), 0, n), flat indices i*K + j (i is
// the global row id); KN >= a.k the tuple's registers.
template <int KN>
__device__ __forceinline__ void draw_with(const ExactArgs& a,
                                          const RoundKeys& rk, int i,
                                          int (&cand)[KN]) {
  const unsigned long long f0 = (unsigned long long)i * a.k;
#pragma unroll
  for (int j = 0; j < KN; ++j) {
    if (j < a.k) {
      const unsigned long long f = f0 + j;
      cand[j] = common::randint_of(common::threefry_xor(rk.h0, rk.h1, f),
                                   common::threefry_xor(rk.l0, rk.l1, f),
                                   a.span, a.mult, 0);
    }
  }
}

template <int KN>
__device__ __forceinline__ void draw_tuple(const ExactArgs& a,
                                           const uint32_t* key, int r, int i,
                                           int (&cand)[KN]) {
  draw_with(a, round_keys(key, r), i, cand);
}

// What a ring row's sent test reads, loaded once a row: its ring slots
// (the first RING_REGS in registers, -1 past cap, which no candidate
// equals) and whether the writer's ring0 tier applies.
struct RingRow {
  int slot[RING_REGS];
  const int* row;
  bool tier;
  __device__ __forceinline__ void load(const ExactArgs& a, unsigned g, int i) {
    row = a.ring + (size_t)g * (unsigned)a.cap;
    tier = a.ring0_block > 0 && i == a.writer;
    if ((a.cap & 3) == 0 && (reinterpret_cast<uintptr_t>(row) & 15) == 0) {
      const int4* q = reinterpret_cast<const int4*>(row);
#pragma unroll
      for (int c = 0; c < RING_REGS / 4; ++c) {
        int4 w = make_int4(-1, -1, -1, -1);
        if (4 * c < a.cap) w = q[c];
        slot[4 * c] = w.x;
        slot[4 * c + 1] = w.y;
        slot[4 * c + 2] = w.z;
        slot[4 * c + 3] = w.w;
      }
    } else {
#pragma unroll
      for (int c = 0; c < RING_REGS; ++c) slot[c] = c < a.cap ? row[c] : -1;
    }
  }
  __device__ __forceinline__ bool hit(const ExactArgs& a, int c) const {
    bool h = false;
#pragma unroll
    for (int q = 0; q < RING_REGS; ++q) h |= slot[q] == c;
    for (int q = RING_REGS; q < a.cap; ++q) h |= row[q] == c;
    return h || (tier && c != a.writer &&
                 c / a.ring0_block == a.writer / a.ring0_block);
  }
};

// A self, sent or duplicate hit in ring row i's tuple.
template <int KN>
__device__ __forceinline__ bool tuple_bad(const ExactArgs& a,
                                          const RingRow& mem, int i,
                                          const int (&cand)[KN]) {
  bool bad = false;
#pragma unroll
  for (int j = 0; j < KN; ++j)
    if (j < a.k) bad = bad || cand[j] == i || mem.hit(a, cand[j]);
#pragma unroll
  for (int x = 0; x < KN; ++x)
#pragma unroll
    for (int y = x + 1; y < KN; ++y)
      if (y < a.k) bad = bad || cand[x] == cand[y];
  return bad;
}

// Ring row i's whole rejection loop (seed s, memory row g): its
// accepted tuple in cand; returns the rounds drawn (MAX_ROUNDS with
// capped set when none was accepted).  The first KEY_ROUNDS rounds take
// their keys from the block's table.  KN >= a.k is the tuple's
// registers.
template <int KN>
__device__ __forceinline__ int ring_loop(const ExactArgs& a,
                                         const KeyTable& keys, int s,
                                         unsigned g, int i,
                                         int (&cand)[KN], bool& capped) {
  RingRow mem;
  mem.load(a, g, i);
  for (int r = 0;; ++r) {
    if (r == MAX_ROUNDS) {
      capped = true;
      return r;
    }
    if (r < KEY_ROUNDS)
      draw_with(a, keys.rk[s][r], i, cand);
    else
      draw_tuple(a, a.keys[s], r, i, cand);
    if (!tuple_bad(a, mem, i, cand)) return r + 1;
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

// The sender's mark of send j to c in its own ring row g (tx0: its
// budget before this tick's decrement picks the slot).
__device__ __forceinline__ void mark_slot(const ExactArgs& a, unsigned g,
                                          int tx0, int j, int c) {
  a.ring[(size_t)g * (unsigned)a.cap + ((a.max_tx - tx0) * a.k + j)] = c;
}

// The marks of cand in bitmap row `row`, from the bytes its sent test
// loaded (byte j holds cand[j]'s bit): candidates that share a byte
// write it once, with all their bits, so no byte is read twice.
template <int KN>
__device__ __forceinline__ void mark_bytes(const ExactArgs& a,
                                           unsigned char* row,
                                           const int (&cand)[KN],
                                           const unsigned (&byte)[KN]) {
#pragma unroll
  for (int j = 0; j < KN; ++j) {
    if (j < a.k) {
      bool first = true;
      unsigned v = byte[j] | 1u << (cand[j] & 7);
#pragma unroll
      for (int y = 0; y < KN; ++y) {
        if (y != j && y < a.k && cand[y] >> 3 == cand[j] >> 3) {
          first &= y > j;
          v |= 1u << (cand[y] & 7);
        }
      }
      if (first) row[cand[j] >> 3] = (unsigned char)v;
    }
  }
}

// The sender's budget and backoff at its leaf index gb (tier by its
// global id i): round() half-to-even as rintf on a float32 product.
__device__ __forceinline__ void spend(const ExactArgs& a, unsigned gb, int i) {
  a.msgs[gb] += a.k;
  const int tx1 = a.tx[gb] - 1;
  a.tx[gb] = tx1;
  int gap = max(1, (int)rintf(__fmul_rn(a.backoff, (float)(a.max_tx - tx1))));
  if (a.tier) gap *= a.tier[i];
  a.next_send[gb] = a.tick + gap;
}

// Adds a block's active rows, rejection rounds, their maximum and its
// capped rows to the diagnostics vector (every thread of the block
// calls it, with its own rows' sums).
__device__ __forceinline__ void add_diag(unsigned long long* diag,
                                         unsigned active, unsigned rounds,
                                         unsigned most, unsigned capped) {
  __shared__ unsigned s_sum[3][THREADS / 32], s_max[THREADS / 32];
  const unsigned w_act = __reduce_add_sync(FULL, active);
  const unsigned w_rounds = __reduce_add_sync(FULL, rounds);
  const unsigned w_max = __reduce_max_sync(FULL, most);
  const unsigned w_cap = __reduce_add_sync(FULL, capped);
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

// The worklist: every active (seed, row) index, in any order; count
// arrives zeroed.  A thread tests ROWS_PER_THREAD rows (their loads in
// flight together), a block claims its rows' places with one atomicAdd.
__global__ void __launch_bounds__(THREADS)
    exact_rows_kernel(const ExactArgs a, unsigned* __restrict__ list,
                      unsigned* __restrict__ count) {
  __shared__ unsigned s_warp[THREADS / 32];
  __shared__ unsigned s_base;
  const unsigned total = (unsigned)a.s * (unsigned)a.n;
  const unsigned first = blockIdx.x * (THREADS * ROWS_PER_THREAD) +
                         threadIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  bool act[ROWS_PER_THREAD];
  // infected first, the budget and the due tick only where infected:
  // early and late in a run few rows are, and their 8 bytes stay unread
#pragma unroll
  for (int r = 0; r < ROWS_PER_THREAD; ++r) {
    const unsigned g = first + r * THREADS;
    act[r] = g < total && a.infected[g] && a.tx[g] > 0 &&
             a.next_send[g] <= a.tick;
  }
  unsigned ball[ROWS_PER_THREAD], mine = 0;
#pragma unroll
  for (int r = 0; r < ROWS_PER_THREAD; ++r) {
    ball[r] = __ballot_sync(FULL, act[r]);
    mine += __popc(ball[r]);
  }
  if (lane == 0) s_warp[warp] = mine;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned run = 0;
    for (int w = 0; w < THREADS / 32; ++w) {
      const unsigned c = s_warp[w];
      s_warp[w] = run;
      run += c;
    }
    s_base = run ? atomicAdd(count, run) : 0u;
  }
  __syncthreads();
  unsigned pos = s_base + s_warp[warp];
  const unsigned below = (1u << lane) - 1u;
#pragma unroll
  for (int r = 0; r < ROWS_PER_THREAD; ++r) {
    if (act[r]) list[pos + __popc(ball[r] & below)] = first + r * THREADS;
    pos += __popc(ball[r]);
  }
}

// A block's diagnostics sums (add_diag's arguments).
struct Diag {
  unsigned active = 0, rounds = 0, most = 0, capped = 0;
  // one active row that drew r rounds (capped: none accepted)
  __device__ __forceinline__ void count(int r, bool cap) {
    active += 1;
    rounds += r;
    most = max(most, (unsigned)r);
    capped += cap;
  }
};

// Active row g (seed s, global id i) of the ring sends: its rejection
// loop, then its K deliveries, marks and budget.
__device__ __forceinline__ void send_row(const ExactArgs& a,
                                         const KeyTable& keys, unsigned g,
                                         Diag& dg) {
  const int s = (int)(g / (unsigned)a.n);
  const int i = (int)(g - (unsigned)s * (unsigned)a.n);
  int cand[MAX_K];
  bool cap_hit = false;
  dg.count(ring_loop(a, keys, s, g, i, cand, cap_hit), cap_hit);
  if (cap_hit) return;  // the caller raises on diag[3]; the row sends nothing
  const uint32_t* key = a.keys[s];
  const unsigned seed0 = (unsigned)s * (unsigned)a.n;
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
      mark_slot(a, g, tx0, j, c);
    }
  }
  spend(a, g, i);
}

// The ring's send: a persistent grid over the worklist of the active
// rows, the block's key table.
__global__ void __launch_bounds__(THREADS)
    exact_send_ring_kernel(const ExactArgs a, const unsigned* __restrict__ list,
                           const unsigned* __restrict__ count) {
  __shared__ KeyTable table;
  fill_keys(a, table);
  const unsigned rows = *count;
  Diag dg;
  for (unsigned w = blockIdx.x * THREADS + threadIdx.x; w < rows;
       w += gridDim.x * THREADS)
    send_row(a, table, list[w], dg);
  add_diag(a.diag, dg.active, dg.rounds, dg.most, dg.capped);
}

// The k-th (0-based) set bit of b, for k < popc(b).
__device__ __forceinline__ int nth_set(unsigned b, int k) {
  int pos = 0;
#pragma unroll
  for (int w = 16; w > 0; w >>= 1) {
    const unsigned low = b & ((1u << w) - 1u);
    const int c = __popc(low);
    if (k >= c) {
      k -= c;
      b >>= w;
      pos += w;
    } else {
      b = low;
    }
  }
  return pos;
}

// Bitmap row i's rejection loop (seed s, its bitmap row `row`): the
// accepted tuple in cand and the bitmap bytes its sent test loaded for
// it in byte (byte j holds cand[j]'s bit); returns the rounds drawn
// (MAX_ROUNDS with capped set when none was accepted).  The first
// KEY_ROUNDS rounds take their keys from the block's table.  A round's
// K bytes are loaded together, once its tuple holds no self and no
// duplicate hit.  KN >= a.k is the tuple's registers.
template <int KN>
__device__ __forceinline__ int bitmap_loop(const ExactArgs& a,
                                           const KeyTable& keys, int s,
                                           const unsigned char* row, int i,
                                           int (&cand)[KN],
                                           unsigned (&byte)[KN],
                                           bool& capped) {
  for (int r = 0;; ++r) {
    if (r == MAX_ROUNDS) {
      capped = true;
      return r;
    }
    if (r < KEY_ROUNDS)
      draw_with(a, keys.rk[s][r], i, cand);
    else
      draw_tuple(a, a.keys[s], r, i, cand);
    bool bad = false;
#pragma unroll
    for (int j = 0; j < KN; ++j)
      if (j < a.k) bad |= cand[j] == i;
#pragma unroll
    for (int x = 0; x < KN; ++x)
#pragma unroll
      for (int y = x + 1; y < KN; ++y)
        if (y < a.k) bad |= cand[x] == cand[y];
    if (bad) continue;
#pragma unroll
    for (int j = 0; j < KN; ++j)
      if (j < a.k) byte[j] = row[cand[j] >> 3];
#pragma unroll
    for (int j = 0; j < KN; ++j)
      if (j < a.k) bad |= (byte[j] >> (cand[j] & 7)) & 1u;
    if (!bad) return r + 1;
  }
}

// Active bitmap row g: its rejection loop, K deliveries, its marks
// written from the loaded bytes (candidates that share a byte write it
// once, with all their bits) and its budget.
template <int KN>
__device__ __forceinline__ void bitmap_row(const ExactArgs& a,
                                           const KeyTable& keys, unsigned g,
                                           Diag& dg) {
  const int s = (int)(g / (unsigned)a.n);
  const int i = (int)(g - (unsigned)s * (unsigned)a.n);
  unsigned char* row = a.sent + (size_t)g * (size_t)a.nb;
  int cand[KN];
  unsigned byte[KN];
  bool cap_hit = false;
  dg.count(bitmap_loop(a, keys, s, row, i, cand, byte, cap_hit), cap_hit);
  if (cap_hit) return;  // the caller raises on diag[3]; the row sends nothing
  const uint32_t* key = a.keys[s];
  const size_t seed0 = (size_t)s * (size_t)a.n;
#pragma unroll
  for (int j = 0; j < KN; ++j) {
    if (j < a.k) {
      const int c = cand[j];
      const Delivery del = deliver_kind(a, key, i, j, c);
      if (del == QUEUED)
        atomicMin(a.pending + seed0 + c, a.tick + a.lat_ticks);
      else if (del == NOW)
        a.new_infected[seed0 + c] = 1;
    }
  }
  mark_bytes(a, row, cand, byte);
  spend(a, g, i);
}

// 32-row tiles a warp tests together: their activity loads a lane in
// flight at once.  A warp's tiles are interleaved with every other
// warp's, so their counts differ by one and the depth adds no tail; a
// deeper batch only keeps more loads live across the loops.
constexpr int TILE_DEPTH = 4;

// Where deal_rows reads activity.  SendActive: exact_send's test,
// infected, then tx and next_send only where infected.  ByteActive: a
// byte a row (the shard kernels' `active`); where `zero` is given, every
// inactive row's entry of it is stored 0 in the same pass, coalesced.
struct SendActive {
  const ExactArgs& a;
  __device__ __forceinline__ bool load(unsigned g) const {
    return a.infected[g];
  }
  __device__ __forceinline__ bool test(unsigned g, bool act) const {
    return act && a.tx[g] > 0 && a.next_send[g] <= a.tick;
  }
};

struct ByteActive {
  const unsigned char* active;
  int* zero;
  __device__ __forceinline__ bool load(unsigned g) const {
    return active[g];
  }
  __device__ __forceinline__ bool test(unsigned g, bool act) const {
    if (zero != nullptr && !act) zero[g] = 0;
    return act;
  }
};

// The activity ballots of tiles t0 + d * warps, d < TILE_DEPTH: every
// first load in flight, then each tile's test.
template <typename Src>
__device__ __forceinline__ void tile_activity(const Src& src, unsigned t0,
                                              unsigned warps, unsigned total,
                                              int lane,
                                              unsigned (&ball)[TILE_DEPTH]) {
  bool act[TILE_DEPTH];
#pragma unroll
  for (int d = 0; d < TILE_DEPTH; ++d) {
    const unsigned g = (t0 + d * warps) * 32u + lane;
    act[d] = g < total && src.load(g);
  }
#pragma unroll
  for (int d = 0; d < TILE_DEPTH; ++d) {
    const unsigned g = (t0 + d * warps) * 32u + lane;
    act[d] = g < total && src.test(g, act[d]);
  }
#pragma unroll
  for (int d = 0; d < TILE_DEPTH; ++d) ball[d] = __ballot_sync(FULL, act[d]);
}

// Runs row(g) for every active row g of [0, total) in a persistent grid
// (every thread calls it; warp-uniform).  Warp w of W takes the 32-row
// tiles w, w + W, w + 2W, ..., TILE_DEPTH at a time: it ballots their
// activity and deals the active rows to its lanes in order, carrying
// the ones that do not fill a batch of 32 into the next tile, so every
// lane runs a row while the warp has 32 left, however few rows are
// active.  One call site runs the rows (a row's code, inlined, is most
// of a kernel's instructions).  Each row is one lane's.
template <typename Src, typename Row>
__device__ __forceinline__ void deal_rows(const Src& src, unsigned total,
                                          Row&& row) {
  const unsigned tiles = (total + 31u) / 32u;
  const unsigned warps = gridDim.x * (THREADS / 32);
  const int lane = threadIdx.x & 31;
  unsigned ball[TILE_DEPTH];
  unsigned next_t0 = blockIdx.x * (THREADS / 32) + threadIdx.x / 32;
  unsigned t0 = 0;
  int dealt = TILE_DEPTH;  // tiles of the loaded ballots dealt so far
  unsigned mine = 0;       // this lane's row of the batch being dealt
  int held = 0;            // rows dealt to lanes 0 .. held - 1, not yet run
  for (;;) {
    // deal tiles (warp-uniform) until 32 rows wait or the tiles run out
    unsigned b = 0, row0 = 0;
    int c = 0;
    bool full = false;
    for (;;) {
      if (dealt == TILE_DEPTH) {
        if (next_t0 >= tiles) break;
        t0 = next_t0;
        next_t0 += TILE_DEPTH * warps;
        tile_activity(src, t0, warps, total, lane, ball);
        dealt = 0;
      }
      b = ball[0];
#pragma unroll
      for (int d = 0; d + 1 < TILE_DEPTH; ++d) ball[d] = ball[d + 1];
      row0 = (t0 + dealt * warps) * 32u;
      ++dealt;
      c = __popc(b);
      const int k = lane - held;  // this lane's place among the new rows
      if (k >= 0 && k < c) mine = row0 + nth_set(b, k);
      if (held + c >= 32) {
        full = true;
        break;
      }
      held += c;
    }
    if (!full && held == 0) break;
    if (full || lane < held) row(mine);
    if (!full) break;
    held += c - 32;  // the rest of this tile waits in lanes 0 ..
    if (lane < held) mine = row0 + nth_set(b, c - held + lane);
  }
}

// The bitmap's send: the active rows dealt to lanes (deal_rows), the
// block's key table.  Each row is one thread's, which makes its
// unsynchronised byte writes to its own bitmap row safe.  Diagnostics
// once a block.  KN >= a.k is the tuple's registers: EXACT_FANOUT, the
// exact column's, has its own instantiation (54 registers against
// MAX_K's 64, so more warps an SM).
template <int KN>
__global__ void __launch_bounds__(THREADS)
    exact_send_bitmap_kernel(const ExactArgs a) {
  __shared__ KeyTable table;
  fill_keys(a, table);
  Diag dg;
  deal_rows(SendActive{a}, (unsigned)a.s * (unsigned)a.n,
            [&](unsigned g) { bitmap_row<KN>(a, table, g, dg); });
  add_diag(a.diag, dg.active, dg.rounds, dg.most, dg.capped);
}

// -- one shard of the multi-device layouts -------------------------------
//
// shard_round replaces the rejection round of the three mesh layouts
// (corrosion_tpu/sim/calibrate.py:817-846, models/sharded.py:403-426,
// :659-683): a shard tests only its own rows (global ids lo + il)
// against its own bitmap or ring rows.  Each of my active rows runs its
// whole loop in registers, as exact_send does (the block's round keys,
// the ring row loaded once), and writes how many rounds it drew
// (MAX_ROUNDS + 1: capped); the tile pass stores 0 for every inactive
// row.  Row i's round-r tuple depends only on its key, its global id
// and its own memory, so "rounds > r + 1" is exactly the reference's
// still-bad mask after round r: the caller exchanges those masks round
// by round.
//
// shard_commit replaces the delivery and commit of the same three
// (calibrate.py:848-892, sharded.py:428-470, :685-728), over every
// (seed, row) of all N rows: an active row redraws its accepted tuple
// at its final round (the count of exchanged masks that held it, so
// every shard rebuilds every tuple without moving one), applies the
// masks, and stores the infection and the queue's atomicMin for the
// targets in the target window [t_lo, t_lo + t_n) (the dense layout:
// my rows; the frontier layouts: all, replicated).  A row of mine also
// marks its own bitmap / ring row; a row in the budget window
// [b_lo, b_lo + b_n) (mine, or all where tx / next_send / msgs are
// replicated) spends its budget.  The result is the same in any row
// order: the infection stores are idempotent, atomicMin commutes, and
// the marks and the budget touch only the row's own entries.
//
// Bound on the H100: bytes — the activity bytes of every row, and per
// active row its round count, K random 32-byte sectors of infection
// stores, its budget and its marks (its 16-byte ring slots, or K bitmap
// sectors).  Few rows are active (6.1% of the host layout's 2 x 10M at
// tick 6), so a thread a row would leave most lanes of most warps idle
// through a whole row body: shard_round and the ring's shard_commit are
// persistent grids that deal the active rows to lanes (deal_rows).  The
// bitmap's commit (the dense layout: a few hundred thousand rows, a
// third of them active) runs a thread a row over a block for every 256
// rows, which measured faster there than dealing.  Every block derives
// the first KEY_ROUNDS rounds' keys once; the bitmap's round loads a
// round's K bytes together (bitmap_loop) and its commit the K bytes it
// marks; the exact column's fanout has its own instantiations (KN = 4:
// fewer registers, so more warps an SM).

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

template <bool RING, int KN>
__global__ void __launch_bounds__(THREADS)
    shard_round_kernel(const ShardArgs sa) {
  const ExactArgs& a = sa.e;
  __shared__ KeyTable keys;
  fill_keys(a, keys);
  Diag dg;
  deal_rows(ByteActive{sa.active, sa.rounds},
            (unsigned)a.s * (unsigned)sa.n_local, [&](unsigned g) {
              const int s = (int)(g / (unsigned)sa.n_local);
              const int i =
                  sa.lo + (int)(g - (unsigned)s * (unsigned)sa.n_local);
              int cand[KN];
              bool cap_hit = false;
              int r;
              if constexpr (RING) {
                r = ring_loop(a, keys, s, g, i, cand, cap_hit);
              } else {
                unsigned byte[KN];
                r = bitmap_loop(a, keys, s, a.sent + (size_t)g * a.nb, i,
                                cand, byte, cap_hit);
              }
              dg.count(r, cap_hit);
              sa.rounds[g] = cap_hit ? MAX_ROUNDS + 1 : r;
            });
  add_diag(a.diag, dg.active, dg.rounds, dg.most, dg.capped);
}

// Row i's K marks at budget tx0 in its own row g.  The ring's K slots
// from (max_tx - tx0) * K on are contiguous: one 16-byte store at K = 4
// where they are aligned.  The bitmap's K bytes are loaded together,
// then each written once (mark_bytes).
template <bool RING, int KN>
__device__ __forceinline__ void mark_row(const ExactArgs& a, unsigned g,
                                         int tx0, const int (&cand)[KN]) {
  if constexpr (RING) {
    int* slot = a.ring + (size_t)g * (unsigned)a.cap + (a.max_tx - tx0) * a.k;
    if (a.k == 4 && (reinterpret_cast<uintptr_t>(slot) & 15) == 0) {
      *reinterpret_cast<int4*>(slot) =
          make_int4(cand[0], cand[1], cand[2], cand[3]);
      return;
    }
#pragma unroll
    for (int j = 0; j < KN; ++j)
      if (j < a.k) mark_slot(a, g, tx0, j, cand[j]);
  } else {
    unsigned char* row = a.sent + (size_t)g * (size_t)a.nb;
    unsigned byte[KN];
#pragma unroll
    for (int j = 0; j < KN; ++j)
      if (j < a.k) byte[j] = row[cand[j] >> 3];
    mark_bytes(a, row, cand, byte);
  }
}

// Active row gg = s * N + i of the commit: its tuple at its accepted
// round, its deliveries into the target window, its marks where the row
// is mine, its budget where it is in the budget window.
template <bool RING, int KN>
__device__ __forceinline__ void commit_row(const ShardArgs& sa,
                                           const KeyTable& keys,
                                           unsigned gg) {
  const ExactArgs& a = sa.e;
  const int s = (int)(gg / (unsigned)a.n);
  const int i = (int)(gg - (unsigned)s * (unsigned)a.n);
  const int r = sa.rounds[gg];
  const uint32_t* key = a.keys[s];
  int cand[KN];
  if ((unsigned)r < KEY_ROUNDS)
    draw_with(a, keys.rk[s][r], i, cand);
  else
    draw_tuple(a, key, r, i, cand);
  const bool mine = i >= sa.lo && i < sa.lo + sa.n_local;
  const bool budget = i >= sa.b_lo && i < sa.b_lo + sa.b_n;
  const unsigned gb = (unsigned)s * sa.b_n + (i - sa.b_lo);
  const int tx0 = budget ? a.tx[gb] : 0;
#pragma unroll
  for (int j = 0; j < KN; ++j) {
    if (j < a.k) {
      const int ct = cand[j] - sa.t_lo;
      if (ct >= 0 && ct < sa.t_n) {
        const Delivery del = deliver_kind(a, key, i, j, cand[j]);
        const size_t tgt = (size_t)s * sa.t_n + ct;
        if (del == QUEUED)
          atomicMin(a.pending + tgt, a.tick + a.lat_ticks);
        else if (del == NOW)
          a.new_infected[tgt] = 1;
      }
    }
  }
  if (mine)
    mark_row<RING, KN>(a, (unsigned)s * sa.n_local + (i - sa.lo), tx0,
                       cand);
  if (budget) spend(a, gb, i);
}

// The ring's commit deals its active rows to lanes in a persistent grid;
// the bitmap's runs a thread a row over a block for every 256 rows.
template <bool RING, int KN>
__global__ void __launch_bounds__(THREADS)
    shard_commit_kernel(const ShardArgs sa) {
  __shared__ KeyTable keys;
  fill_keys(sa.e, keys);
  const unsigned total = (unsigned)sa.e.s * (unsigned)sa.e.n;
  const auto row = [&](unsigned gg) { commit_row<RING, KN>(sa, keys, gg); };
  if constexpr (RING) {
    deal_rows(ByteActive{sa.active, nullptr}, total, row);
  } else {
    const unsigned gg = blockIdx.x * THREADS + threadIdx.x;
    if (gg < total && sa.active[gg]) row(gg);
  }
}

constexpr int COMMIT_LANE = 16;  // positions a lane loads: 16 bytes a mask
constexpr int COMMIT_TILE = 32 * COMMIT_LANE;  // positions a warp takes

struct CommitArgs {
  const unsigned char* infected;  // [s] rows of n bytes, ld_inf apart
  const unsigned char* new_inf;   // [s] rows of n bytes, ld_new apart
  int* tx;                        // [s, n]
  int* next_send;                 // [s, n]
  const int* tier;                // [n] or null
  long long ld_inf, ld_new;
  int s, n, tick, max_tx;
  unsigned tiles;  // warp tiles a row: its 16-byte groups, 32 at once
  int vec;         // the two masks' rows lie 16-byte aligned alike
};

// One bit a byte, in byte order: new != 0 and infected == 0.
__device__ __forceinline__ unsigned learned4(unsigned nw, unsigned inf) {
  const unsigned m = __vcmpne4(nw, 0u) & __vcmpeq4(inf, 0u) & 0x80808080u;
  return ((m >> 7) * 0x00204081u) >> 21 & 0xFu;
}

__global__ void __launch_bounds__(THREADS)
    exact_commit_kernel(const CommitArgs c) {
  const unsigned lane = threadIdx.x & 31;
  const unsigned t = blockIdx.x * (THREADS / 32) + threadIdx.x / 32;
  if (t >= (unsigned)c.s * c.tiles) return;  // the whole warp
  const unsigned row = t / c.tiles;
  const unsigned char* nw = c.new_inf + (size_t)row * c.ld_new;
  const unsigned char* inf = c.infected + (size_t)row * c.ld_inf;
  // the tile's first position: its row's tiles start at the 16-byte
  // boundary at or before the row's first byte of new_inf
  const int base = (int)(t - row * c.tiles) * COMMIT_TILE -
                   (int)(reinterpret_cast<uintptr_t>(nw) & 15u);
  const int p0 = base + (int)lane * COMMIT_LANE;
  unsigned bits = 0;
  if (c.vec && p0 >= 0 && p0 + COMMIT_LANE <= c.n) {
    const uint4 a = __ldg(reinterpret_cast<const uint4*>(nw + p0));
    const uint4 b = __ldg(reinterpret_cast<const uint4*>(inf + p0));
    bits = learned4(a.x, b.x) | learned4(a.y, b.y) << 4 |
           learned4(a.z, b.z) << 8 | learned4(a.w, b.w) << 12;
  } else {
    for (int i = 0; i < COMMIT_LANE; ++i) {
      const int p = p0 + i;
      if (p >= 0 && p < c.n && nw[p] && !inf[p]) bits |= 1u << i;
    }
  }
  const unsigned busy = __ballot_sync(FULL, bits != 0);
  if (!busy) return;
  int* tx = c.tx + (size_t)row * c.n;
  int* ns = c.next_send + (size_t)row * c.n;
  for (int j = 0; j < COMMIT_LANE; ++j) {
    // positions 32 j .. 32 j + 31 of the tile: lanes 2 j and 2 j + 1
    if (!(busy >> 2 * j & 3u)) continue;
    const unsigned mine = __shfl_sync(FULL, bits, 2 * j + (int)(lane >> 4));
    if (mine >> (lane & 15u) & 1u) {
      const int p = base + 32 * j + (int)lane;
      tx[p] = c.max_tx;
      ns[p] = c.tick + (c.tier ? __ldg(c.tier + p) : 1);
    }
  }
}

// A persistent grid of `kernel` for `rows` rows: as many blocks as the
// card holds at once, fewer when the rows need fewer.
template <typename Kernel>
unsigned persistent_blocks(Kernel kernel, size_t rows) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, 0);
  const size_t need = (rows + THREADS - 1) / THREADS;
  const size_t most = (size_t)(sms > 0 ? sms : 1) * (per_sm > 0 ? per_sm : 1);
  return (unsigned)(need < most ? (need > 0 ? need : 1) : most);
}

// One launch of shard_commit (over all S x N rows) or shard_round (over
// my S x n_local).
template <bool RING, int KN>
void shard_go(const ShardArgs& sa, int commit, cudaStream_t st) {
  const ExactArgs& a = sa.e;
  const size_t total = (size_t)a.s * a.n;
  if (commit)
    shard_commit_kernel<RING, KN>
        <<<RING ? persistent_blocks(shard_commit_kernel<RING, KN>, total)
                : (unsigned)((total + THREADS - 1) / THREADS),
           THREADS, 0, st>>>(sa);
  else
    shard_round_kernel<RING, KN>
        <<<persistent_blocks(shard_round_kernel<RING, KN>,
                             (size_t)a.s * sa.n_local),
           THREADS, 0, st>>>(sa);
}

bool args_ok(const ExactArgs& a, int ring) {
  return a.s >= 1 && a.s <= MAX_SEEDS && a.n >= 1 && a.k >= 1 &&
         a.k <= MAX_K && a.span != 0 &&
         (long long)a.s * a.n <= 0x7fffffffLL &&
         (ring ? a.ring != nullptr && a.cap >= a.k * a.max_tx
               : a.sent != nullptr && a.nb * 8 >= a.n);
}

}  // namespace

extern "C" int exact_args_size() { return (int)sizeof(ExactArgs); }

// The worklist of active rows: list [S * N] uint32, count one uint32
// (zeroed here).
extern "C" int exact_rows_launch(const void* args, void* list, void* count,
                                 void* stream) {
  const ExactArgs& a = *static_cast<const ExactArgs*>(args);
  if (!(a.s >= 1 && a.n >= 1 && (long long)a.s * a.n <= 0x7fffffffLL) ||
      list == nullptr || count == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaMemsetAsync(count, 0, sizeof(unsigned), st);
  if (e != cudaSuccess) return (int)e;
  const size_t total = (size_t)a.s * a.n;
  const size_t per_block = (size_t)THREADS * ROWS_PER_THREAD;
  exact_rows_kernel<<<(unsigned)((total + per_block - 1) / per_block),
                      THREADS, 0, st>>>(a, static_cast<unsigned*>(list),
                                        static_cast<unsigned*>(count));
  return (int)cudaGetLastError();
}

// The send: for the ring over a worklist of `count` rows (exactly the
// active rows of [S, N], as exact_rows writes it); the bitmap's over
// every row (list and count unused).
extern "C" int exact_send_launch(const void* args, int ring, const void* list,
                                 const void* count, void* stream) {
  const ExactArgs& a = *static_cast<const ExactArgs*>(args);
  if (!args_ok(a, ring) || a.diag == nullptr ||
      (ring && (list == nullptr || count == nullptr)))
    return (int)cudaErrorInvalidValue;
  const size_t total = (size_t)a.s * a.n;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned* l = static_cast<const unsigned*>(list);
  const unsigned* c = static_cast<const unsigned*>(count);
  if (ring)
    exact_send_ring_kernel<<<persistent_blocks(exact_send_ring_kernel, total),
                             THREADS, 0, st>>>(a, l, c);
  else if (a.k == EXACT_FANOUT)
    exact_send_bitmap_kernel<EXACT_FANOUT>
        <<<persistent_blocks(exact_send_bitmap_kernel<EXACT_FANOUT>, total),
           THREADS, 0, st>>>(a);
  else
    exact_send_bitmap_kernel<MAX_K>
        <<<persistent_blocks(exact_send_bitmap_kernel<MAX_K>, total),
           THREADS, 0, st>>>(a);
  return (int)cudaGetLastError();
}

extern "C" int shard_args_size() { return (int)sizeof(ShardArgs); }

extern "C" int shard_launch(const void* args, int ring, int commit,
                            void* stream) {
  const ShardArgs& sa = *static_cast<const ShardArgs*>(args);
  const ExactArgs& a = sa.e;
  if (!args_ok(a, ring) || sa.active == nullptr || sa.rounds == nullptr ||
      sa.n_local < 1 || sa.lo < 0 || sa.lo + sa.n_local > a.n ||
      (commit ? a.new_infected == nullptr || a.tx == nullptr ||
                    sa.t_n < 1 || sa.b_n < 1 || sa.b_lo > sa.lo ||
                    sa.b_lo + sa.b_n < sa.lo + sa.n_local
              : a.diag == nullptr))
    return (int)cudaErrorInvalidValue;
  // the exact column's fanout has its own instantiations (fewer
  // registers, so more warps an SM)
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool fanout = a.k == EXACT_FANOUT;
  if (ring && fanout)
    shard_go<true, EXACT_FANOUT>(sa, commit, st);
  else if (ring)
    shard_go<true, MAX_K>(sa, commit, st);
  else if (fanout)
    shard_go<false, EXACT_FANOUT>(sa, commit, st);
  else
    shard_go<false, MAX_K>(sa, commit, st);
  return (int)cudaGetLastError();
}

// The commit over [s, n]: infected / new_infected rows ld_inf / ld_new
// bytes apart (windows of wider rows allowed), tx / next_send [s, n],
// tier [n] or null.
extern "C" int exact_commit_launch(const void* infected,
                                   const void* new_infected,
                                   long long ld_inf, long long ld_new,
                                   void* tx, void* next_send,
                                   const void* tier, int s, int n, int tick,
                                   int max_tx, void* stream) {
  if (s == 0 || n == 0) return 0;
  if (s < 0 || n < 0 || n > 0x7fffffff - 2 * COMMIT_TILE ||
      (long long)s * n > 0x7fffffffLL ||
      (s > 1 && (ld_inf < n || ld_new < n)) || infected == nullptr ||
      new_infected == nullptr || tx == nullptr || next_send == nullptr)
    return (int)cudaErrorInvalidValue;
  const uintptr_t apart = reinterpret_cast<uintptr_t>(infected) -
                          reinterpret_cast<uintptr_t>(new_infected);
  const CommitArgs c{static_cast<const unsigned char*>(infected),
                     static_cast<const unsigned char*>(new_infected),
                     static_cast<int*>(tx),
                     static_cast<int*>(next_send),
                     static_cast<const int*>(tier),
                     ld_inf,
                     ld_new,
                     s,
                     n,
                     tick,
                     max_tx,
                     (unsigned)(((long long)n + 15 + COMMIT_TILE - 1) /
                                COMMIT_TILE),
                     (int)(apart % 16 == 0 && (ld_inf - ld_new) % 16 == 0)};
  const size_t warps = (size_t)s * c.tiles;
  exact_commit_kernel<<<(unsigned)((warps + THREADS / 32 - 1) /
                                   (THREADS / 32)),
                        THREADS, 0, static_cast<cudaStream_t>(stream)>>>(c);
  return (int)cudaGetLastError();
}
