// sent_sampler: the exact sent_to-excluding sampler, as two kernels.
//
// Replaces corrosion_tpu/sim/calibrate.py exact_tick (:71-121, the
// "calibration" mode) and the sent branch of
// corrosion_tpu/models/broadcast.py broadcast_step (:188-258, with the
// K scatter_merge columns of ops/merge.py:60: the "broadcast" mode).
// The reference draws an [N, N] (or per sender chunk [C, N]) block of
// uniform scores, pushes the peers a sender has already sent to, and
// itself, to +inf, sorts each row (lax.top_k / stable argsort) and
// keeps the k smallest; then it masks the deliveries, scatters the
// infection or the packed keys, scatter-mins the hop candidates, sets
// the [N, N] bool sent marks and runs the budget / backoff epilogue.
//
//   sent_select  a row group of G threads per (seed, sender row): a
//       warp (G = 32, eight rows a block) or the whole 256-thread block
//       (G = 256), chosen by N; an inactive row exits at once (its
//       outputs are dead in the reference).  Two passes find the row's
//       k smallest (uniform, column) pairs among the columns not
//       excluded (sent[s, i, c] or c == i), the reference's order:
//         filter: the group hashes every column of the row in
//           registers, UNROLL columns a thread a step (independent
//           hash chains), and keeps a column only when its word lies
//           under hit_bits, a bound the host sets so that about 2k + 16
//           columns of a row pass (kernels/sent_sampler.py hit_bits).
//           A passing column's (mantissa, column) key goes into the
//           row's shared buffer; no sent byte is read in this loop.
//           The buffer's excluded entries are then dropped (one byte
//           read each) and each remaining key ranks itself among them.
//           That is the answer when at least k remain (every column
//           left out scores above every kept one) or when the bound
//           let every column through.
//         fallback, when fewer than k remain or the buffer overflowed:
//           each thread keeps its K smallest keys of the non-excluded
//           columns in a sorted register list, then K rounds of a
//           group-wide minimum.  Exact on any input; about 1e-7 of
//           the rows at 16k take it.
//       Threads j < k deliver slot j:
//         calibration: store 1 into new_infected[t] (a copy of
//           infected) and mark sent[i, t];
//         broadcast: mark sent[i, t] (before loss: the sender cannot
//           know the message died), then the loss, partition and WAN
//           masks, in-thread at counter i * k + j; a surviving message
//           atomicMax-es the sender's packed keys into new_rows[t] (a
//           copy of rows) and atomicMin-s min(hops[i], HOP_UNSET) + 1
//           into cand[t].
//       Thread 0 writes the row's send count (inactive rows read 0:
//       the wrapper fills counts first, or sent_tick's commit writes
//       their 0).  Its blocks release the commit at their start
//       (griddepcontrol.launch_dependents), a no-op unless the commit
//       is launched behind it under programmatic dependent launch.
//   sent_commit  one thread per (seed, node): msgs plus the count, the
//       budget (calibration: a send decrements, an exhausted row
//       retires to 0; broadcast: an active row decrements), the
//       backoff next_send (times the RTT tier in broadcast mode), the
//       learners' fresh budget (calibration: new_infected & ~infected;
//       broadcast: any key of new_rows[i] != rows[i]) and the hops.
//       It is a second launch because it needs every sender's stores.
//   sent_tick_launch enqueues both from one host call, the commit under
//       programmatic dependent launch (CHAINED): its blocks start once
//       every selection block has started, load every input of the
//       tick (leaves the selection never writes) before
//       griddepcontrol.wait and the selection's outputs after it, each
//       group issued together, then compute from registers and store;
//       an inactive row's count is not loaded but written, 0, so
//       nothing is filled first.  What held the separate launch back
//       was latency (a launch of its own, and a chain of loads behind
//       the activity test's short circuit: PERF.md), not its bytes.
//
// Where the trouble is:
// - Counters.  Calibration draws uniform(fold_in(key_t, start), (ci,
//   n)) per sender chunk, start the chunk's first row, c =
//   min(sender_chunk, n), the last chunk possibly short: row r uses
//   the key of chunk r / c and counter (r % c) * n + col.  Broadcast
//   draws uniform(key_t, (n, n)): one chunk of n rows.  The counter is
//   64 bits (its high word is non-zero once n * n >= 2**32); the
//   wrapper hashes the chunk keys on the host, ceil(N / C) a tick.
// - Ties are real: at N = 16,000 the five smallest of a row's
//   uniforms fall in about 2,600 of the 2**23 float levels.  The
//   uniform of a word is (bits >> 9) * 2**-23 exactly (common.cuh
//   uniform_of), so two columns tie exactly when their mantissas
//   bits >> 9 do: one 64-bit (mantissa, column) key puts the lower
//   column first, as lax.top_k(-scores) and the stable argsort do.
//   The raw word would break those ties by its low 9 bits instead.
//   Keys are unique, so ranks are, and one thread pops each round's
//   minimum.  The filter's bound is a mantissa bound (hit_bits + 1 a
//   multiple of 512), so a column passes exactly when every column of
//   its mantissa does.
// - Counters in 32 bits.  Row r's counters base + c (base the row's
//   offset in its chunk's draw) change their high word at most once,
//   at split = 2**32 - (base mod 2**32); the filter runs the row as two
//   segments, each with a constant high word, so a column costs one
//   32-bit counter add.  The first split inside a row comes at N >=
//   65,537 with chunk = N.
// - Fewer than k available: the missing slots stay ~0 and send
//   nothing; the reference's padding targets are masked away, so the
//   kernel reads no partition or region entry for them.
// - Races.  infected, rows, tx and hops are the tick's inputs and are
//   never written; every store other rows could read goes to a fresh
//   buffer.  Only row i's group reads or writes row i of sent, and it
//   writes after the barrier that ends its reads, so sent is marked
//   in place.  atomicMax and atomicMin are order-free, so the scatters
//   equal the reference's K sequential columns bitwise.
//
// Bound on the H100: operations.  An active row hashes its N
// uniforms: 68 integer operations a hash (20 rounds of add, rotate and
// xor, x1's 4 key injections (x0's fold into three-input adds), the
// output's two adds and xor, the counter's add), and an SM dispatches
// at most one warp instruction a clock on each of its 4 schedulers, so
// 68 / 128 lane-clocks a hash: 0.52 ms a tick at 16k active rows of
// 16k, against 0.08 ms for reading their sent rows.  The integer
// operations run on two pipes of 16 lanes each a scheduler, the ALU
// (IADD3, LOP3, SHF, ISETP) and the FMA pipe (IMAD, IMAD.WIDE), so the
// bound holds only when the two carry equal shares.  The filter's loop
// gets there: its adds are written as mad.lo.u32 by a multiplier of 1
// that ptxas cannot see (SentArgs.one) and run as IMAD, and the
// rotates of WIDE_ROUNDS run as a 32 x 32 -> 64 multiply by 2**r on the
// FMA pipe whose halves the next LOP3 folds (common.cuh hash_run,
// shared with threefry.cu); the row's high counter word is a constant,
// no sent byte is read and no float is formed.  kernels/sass.py
// counts the loop's instructions by pipe (PERF.md).
// sent stays a bool [S, N, N] (the reference's leaf); a bitpacked
// layout is later work.

#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

using common::HOP_UNSET;

constexpr int MAX_K = 8;
constexpr int THREADS = 256;
constexpr int COMMIT_THREADS = 128;  // 125 blocks at 16k: an SM each
constexpr int UNROLL = 8;      // columns a thread hashes a filter step
constexpr int HIT_CAP = 128;   // a row's candidate buffer
// rows of up to this many columns take a warp each, longer ones a block
// (on the H100 a warp a row is the faster at N = 512, a block at 16,000:
// PERF.md rows 6 and 10)
constexpr int WARP_ROW_MAX_N = 4096;
constexpr unsigned FULL = 0xffffffffu;
constexpr unsigned long long NONE = ~0ull;
// the rounds (bit r) whose rotate runs as a multiply on the FMA pipe
constexpr unsigned WIDE_ROUNDS = 0x44444u;

// kernels/sent_sampler.py _Args mirrors this field for field
struct SentArgs {
  unsigned char* sent;            // [S, N, N] bool, marked in place
  const uint32_t* keys;           // [S, nchunks, 2] score keys
  const uint32_t* loss_keys;      // [S, 2, 2] loss, WAN keys (broadcast)
  const unsigned char* infected;  // [S, N]; null selects broadcast mode
  const int* tx;                  // [S, N]
  const int* next_send;           // [S, N] or null (broadcast only)
  const int* msgs;                // [S, N]
  const void* rows;               // [S, N, R] int32 or int64 (broadcast)
  const int* hops;                // [S, N] or null
  const int* part;                // [N] or null (no partition)
  const unsigned char* sev;       // [B, B] or null (symmetric)
  const int* region;              // [N] or null (no WAN drop)
  const int* tier;                // [N] or null (no RTT tiers)
  unsigned char* new_infected;    // [S, N] copy of infected
  void* new_rows;                 // [S, N, R] copy of rows
  int* cand;                      // [S, N] HOP_UNSET-filled, or null
  int* counts;                    // [S, N] zero-filled (sent_tick: not)
  int* tx_out;
  int* next_out;
  int* msgs_out;
  int* hops_out;
  int s, n, k, chunk, nchunks, r, wide, sev_b, tick, part_active, use_loss,
      max_tx;
  float loss, wan_loss, backoff;
  uint32_t one;         // 1, a multiplier ptxas cannot fold away
  uint32_t hit_bits;    // the filter's bound on a column's word
};

__device__ __forceinline__ bool row_active(const SentArgs& a, size_t g) {
  if (a.infected != nullptr && !a.infected[g]) return false;
  return a.tx[g] > 0 && (a.next_send == nullptr || a.next_send[g] <= a.tick);
}

__device__ __forceinline__ float uniform_at(const uint32_t* key,
                                            unsigned long long idx) {
  return common::uniform_of(common::threefry_xor(key[0], key[1], idx));
}

__device__ __forceinline__ unsigned long long umin64(unsigned long long x,
                                                     unsigned long long y) {
  return x < y ? x : y;
}

template <int G>
__device__ __forceinline__ void group_sync() {
  if constexpr (G == 32)
    __syncwarp();
  else
    __syncthreads();
}

// slot j of sender (s, i) = flat g goes to t: mark, mask, deliver
__device__ void deliver(const SentArgs& a, int s, int i, size_t g, int j,
                        int t) {
  const size_t gt = (size_t)s * a.n + t;
  a.sent[g * a.n + t] = 1;
  if (a.infected != nullptr) {
    a.new_infected[gt] = 1;
    return;
  }
  const unsigned long long idx = (unsigned long long)i * a.k + j;
  const uint32_t* lk = a.loss_keys + (size_t)s * 4;
  if (a.use_loss && !(uniform_at(lk, idx) >= a.loss)) return;
  if (a.part != nullptr && a.part_active &&
      common::blocks_cross(a.part[i], a.part[t], a.sev, a.sev_b, false))
    return;
  if (a.region != nullptr && a.region[i] != a.region[t] &&
      uniform_at(lk + 2, idx) < a.wan_loss)
    return;
  if (a.wide) {
    const long long* src = static_cast<const long long*>(a.rows) + g * a.r;
    long long* dst = static_cast<long long*>(a.new_rows) + gt * a.r;
    for (int c = 0; c < a.r; ++c) atomicMax(dst + c, src[c]);
  } else {
    const int* src = static_cast<const int*>(a.rows) + g * a.r;
    int* dst = static_cast<int*>(a.new_rows) + gt * a.r;
    for (int c = 0; c < a.r; ++c) atomicMax(dst + c, src[c]);
  }
  if (a.cand != nullptr) atomicMin(a.cand + gt, min(a.hops[g], HOP_UNSET) + 1);
}

// The fallback: the K smallest (mantissa, column) keys of the row's
// non-excluded columns into sel, through per-thread sorted lists and K
// rounds of a group-wide minimum.  t is the thread's rank in the group.
template <int K, int G>
__device__ void select_exact(const unsigned char* row, int n, int i,
                             unsigned long long base, uint32_t k0,
                             uint32_t k1, int t, unsigned long long* sel,
                             unsigned long long* s_warp) {
  unsigned long long best[K];
#pragma unroll
  for (int q = 0; q < K; ++q) best[q] = NONE;
  for (int c = t; c < n; c += G) {
    if (c == i || row[c]) continue;
    const uint32_t bits = common::threefry_xor(k0, k1, base + c);
    unsigned long long kv =
        ((unsigned long long)(bits >> 9) << 32) | (unsigned)c;
    if (kv < best[K - 1]) {
#pragma unroll
      for (int q = 0; q < K; ++q) {  // sorted insert
        const unsigned long long lo = umin64(kv, best[q]);
        kv = kv ^ best[q] ^ lo;
        best[q] = lo;
      }
    }
  }
  const int lane = t & 31, warp = t >> 5;
  for (int r = 0; r < K; ++r) {
    unsigned long long win = best[0];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      win = umin64(win, __shfl_xor_sync(FULL, win, o));
    if constexpr (G > 32) {
      if (lane == 0) s_warp[warp] = win;
      __syncthreads();
      win = s_warp[0];
#pragma unroll
      for (int w = 1; w < G / 32; ++w) win = umin64(win, s_warp[w]);
      __syncthreads();
    }
    if (win != NONE && best[0] == win) {  // keys are unique: one pops
#pragma unroll
      for (int q = 0; q + 1 < K; ++q) best[q] = best[q + 1];
      best[K - 1] = NONE;
    }
    if (t == 0) sel[r] = win;
  }
}

template <int K, int G>
__global__ void __launch_bounds__(THREADS) sent_select(const SentArgs a) {
  static_assert(G == 32 || G == THREADS, "a row is a warp or a block");
  constexpr int ROWS = THREADS / G;
  __shared__ unsigned long long s_hits[ROWS][HIT_CAP];
  __shared__ unsigned long long s_sel[ROWS][K];
  __shared__ unsigned long long s_warp[THREADS / 32];
  __shared__ int s_count[ROWS];
  // sent_tick's commit may start its blocks now: they load the tick's
  // inputs and wait (griddepcontrol.wait) for this grid to finish
  asm volatile("griddepcontrol.launch_dependents;");
  const int lr = threadIdx.x / G, t = threadIdx.x % G;
  const size_t g = (size_t)blockIdx.x * ROWS + lr;
  const int n = a.n;
  // a whole group leaves together, so its barriers stay whole
  if (g >= (size_t)a.s * n || !row_active(a, g)) return;
  const int s = (int)(g / n), i = (int)(g % n);
  const int ck = i / a.chunk;
  const uint32_t* key = a.keys + ((size_t)s * a.nchunks + ck) * 2;
  const uint32_t k0 = key[0], k1 = key[1];
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  const unsigned long long base = (unsigned long long)(i - ck * a.chunk) * n;
  const uint32_t base_lo = (uint32_t)base, base_hi = (uint32_t)(base >> 32);
  // columns from split on count with the high word base_hi + 1
  const int split = base_lo == 0 || 0x100000000ull - base_lo >= (unsigned)n
                        ? n
                        : (int)(0x100000000ull - base_lo);
  const unsigned char* row = a.sent + g * n;
  unsigned long long* hits = s_hits[lr];
  unsigned long long* sel = s_sel[lr];
  if (t < K) sel[t] = NONE;
  if (t == 0) s_count[lr] = 0;
  group_sync<G>();

  // filter: every column's word against hit_bits, 32-bit counters
  const uint32_t one = a.one, bound = a.hit_bits;
  for (int seg = 0; seg < 2; ++seg) {
    const int lo = seg ? split : 0, hi = seg ? n : split;
    const uint32_t x0_0 = base_hi + (uint32_t)seg + k0;
    for (int c0 = lo + t * UNROLL; c0 < hi; c0 += G * UNROLL) {
      uint32_t w[UNROLL];
      common::hash_run<WIDE_ROUNDS, UNROLL>(
          x0_0, base_lo + k1 + (uint32_t)c0, k0, k1, k2, one, w);
      bool any = false;
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) any |= w[u] <= bound;
      if (any) {
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          if (w[u] <= bound && c0 + u < hi) {
            const int pos = atomicAdd(&s_count[lr], 1);
            if (pos < HIT_CAP)
              hits[pos] = ((unsigned long long)(w[u] >> 9) << 32) |
                          (unsigned)(c0 + u);
          }
        }
      }
    }
  }
  group_sync<G>();
  const int count = s_count[lr];
  bool exact = count <= HIT_CAP;
  if (exact) {
    for (int e = t; e < count; e += G) {  // drop the excluded columns
      const int c = (int)(unsigned)hits[e];
      if (c == i || row[c]) hits[e] = NONE;
    }
    group_sync<G>();
    for (int e = t; e < count; e += G) {  // unique keys, unique ranks
      const unsigned long long kv = hits[e];
      if (kv == NONE) continue;
      int rank = 0;
      for (int f = 0; f < count; ++f) rank += hits[f] < kv;
      if (rank < K) sel[rank] = kv;
    }
    group_sync<G>();
    exact = bound == FULL || sel[K - 1] != NONE;
  }
  if (!exact) {
    select_exact<K, G>(row, n, i, base, k0, k1, t, sel, s_warp);
    group_sync<G>();
  }
  if (t < K && sel[t] != NONE)
    deliver(a, s, i, g, t, (int)(sel[t] & 0xffffffffu));
  if (t == 0) {
    int sent = 0;
    for (int j = 0; j < K; ++j) sent += sel[j] != NONE;
    a.counts[g] = sent;
  }
}

// the nth retransmission waits max(1, round(backoff * n)) ticks
// (half-to-even on a float32 product, as the reference)
__device__ __forceinline__ int backoff_gap(const SentArgs& a, int tx) {
  return max(1, (int)rintf(__fmul_rn(a.backoff, (float)(a.max_tx - tx))));
}

// a row of a [S, N, R] int32 / int64 leaf as VECS 16-byte vectors
template <int VECS>
__device__ __forceinline__ void load_row(const void* base, size_t g,
                                         uint4 (&w)[VECS]) {
  const uint4* p = static_cast<const uint4*>(base) + g * VECS;
#pragma unroll
  for (int v = 0; v < VECS; ++v) w[v] = p[v];
}

__device__ __forceinline__ bool differs(uint4 x, uint4 y) {
  return ((x.x ^ y.x) | (x.y ^ y.y) | (x.z ^ y.z) | (x.w ^ y.w)) != 0;
}

// The epilogue for (seed, node) g.  Every input of the tick is loaded
// first, unconditionally (a null leaf aside), then griddepcontrol.wait
// (behind sent_select in sent_tick_launch; at once in a plain launch),
// then sent_select's outputs; activity comes from registers.  VECS > 0:
// a broadcast row is VECS aligned 16-byte vectors, compared as 32-bit
// words (an int64 key differs exactly when one of its halves does);
// VECS = 0: r << wide words one by one, after the wait.  CHAINED (from
// sent_tick_launch): counts was not filled, so an active row's count is
// read and an inactive row's written, 0; alone every row's is read.
template <bool CALIB, int VECS, bool CHAINED>
__global__ void __launch_bounds__(COMMIT_THREADS)
    sent_commit(const SentArgs a) {
  const size_t g = (size_t)blockIdx.x * COMMIT_THREADS + threadIdx.x;
  if (g >= (size_t)a.s * a.n) return;
  const int i = (int)(g % a.n);
  const int tx = a.tx[g], msgs = a.msgs[g];
  const int ns = a.next_send != nullptr ? a.next_send[g] : 0;
  unsigned char inf = 0;
  int tier = 1, hops = 0;
  uint4 row[VECS > 0 ? VECS : 1];
  if constexpr (CALIB) {
    inf = a.infected[g];
  } else {
    if (a.tier != nullptr) tier = a.tier[i];
    if (a.hops != nullptr) hops = a.hops[g];
    if constexpr (VECS > 0) load_row<VECS>(a.rows, g, row);
  }
  const bool due = tx > 0 && (a.next_send == nullptr || ns <= a.tick);
  const bool act = CALIB ? inf && due : due;  // sent_select's row_active
  asm volatile("griddepcontrol.wait;" ::: "memory");
  int cnt = 0;
  if (!CHAINED || act)
    cnt = a.counts[g];
  else
    a.counts[g] = 0;
  if constexpr (CALIB) {
    const bool fresh = a.new_infected[g] && !inf;
    const bool sent_now = act && cnt > 0, exhausted = act && cnt == 0;
    int tx2 = sent_now ? tx - 1 : (exhausted ? 0 : tx);
    int nxt = sent_now ? a.tick + backoff_gap(a, tx2) : ns;
    if (fresh) {
      tx2 = a.max_tx;
      nxt = a.tick + 1;
    }
    a.msgs_out[g] = msgs + cnt;
    a.tx_out[g] = tx2;
    a.next_out[g] = nxt;
  } else {
    const int cand = a.hops_out != nullptr ? a.cand[g] : 0;
    bool learned = false;
    if constexpr (VECS > 0) {
      uint4 now[VECS];
      load_row<VECS>(a.new_rows, g, now);
#pragma unroll
      for (int v = 0; v < VECS; ++v) learned |= differs(row[v], now[v]);
    } else {
      const int words = a.r << a.wide;
      const uint32_t* x = static_cast<const uint32_t*>(a.rows) + g * words;
      const uint32_t* y =
          static_cast<const uint32_t*>(a.new_rows) + g * words;
      for (int c = 0; c < words; ++c) learned |= x[c] != y[c];
    }
    const int tx2 = learned ? a.max_tx : (act ? tx - 1 : tx);
    a.msgs_out[g] = msgs + cnt;
    a.tx_out[g] = tx2;
    if (a.next_out != nullptr) {
      const int nxt = act ? a.tick + backoff_gap(a, tx2) * tier : ns;
      a.next_out[g] = learned ? a.tick + tier : nxt;
    }
    if (a.hops_out != nullptr)
      a.hops_out[g] = learned ? min(hops, cand) : hops;
  }
}

// the leaves both kernels read, by mode
bool bad_leaves(const SentArgs& a) {
  return a.s < 1 || a.n < 1 || a.tx == nullptr || a.counts == nullptr ||
         (a.infected != nullptr
              ? a.new_infected == nullptr || a.next_send == nullptr
              : a.rows == nullptr || a.new_rows == nullptr || a.r < 1 ||
                    (a.cand != nullptr && a.hops == nullptr));
}

template <int K, int G>
cudaError_t launch_select(const SentArgs& a, cudaStream_t stream) {
  const unsigned long long rows = (unsigned long long)a.s * a.n;
  const unsigned long long blocks = (rows + THREADS / G - 1) / (THREADS / G);
  if (blocks > 0x7fffffffull) return cudaErrorInvalidValue;
  sent_select<K, G><<<(unsigned)blocks, THREADS, 0, stream>>>(a);
  return cudaGetLastError();
}

template <int G>
cudaError_t launch_select_g(const SentArgs& a, cudaStream_t stream) {
  switch (a.k) {
    case 1: return launch_select<1, G>(a, stream);
    case 2: return launch_select<2, G>(a, stream);
    case 3: return launch_select<3, G>(a, stream);
    case 4: return launch_select<4, G>(a, stream);
    case 5: return launch_select<5, G>(a, stream);
    case 6: return launch_select<6, G>(a, stream);
    case 7: return launch_select<7, G>(a, stream);
    case 8: return launch_select<8, G>(a, stream);
  }
  return cudaErrorInvalidValue;
}

bool bad_select(const SentArgs& a) {
  return bad_leaves(a) || a.k < 1 || a.k > MAX_K || a.chunk < 1 ||
         a.nchunks != (a.n + a.chunk - 1) / a.chunk || a.sent == nullptr ||
         a.keys == nullptr ||
         (a.infected == nullptr && a.loss_keys == nullptr) || a.one != 1u ||
         (a.hit_bits & 511u) != 511u;
}

bool bad_commit(const SentArgs& a) {
  return bad_leaves(a) || a.tx_out == nullptr || a.msgs_out == nullptr ||
         (a.infected != nullptr && a.next_out == nullptr) ||
         (a.next_out != nullptr && a.next_send == nullptr) ||
         (a.hops_out != nullptr && (a.hops == nullptr || a.cand == nullptr));
}

cudaError_t enqueue_select(const SentArgs& a, cudaStream_t st) {
  if (a.n <= WARP_ROW_MAX_N) return launch_select_g<32>(a, st);
  return launch_select_g<THREADS>(a, st);
}

// after: under programmatic dependent launch behind the kernel before
// it in the stream (its blocks may start while that one runs, up to
// their griddepcontrol.wait)
template <bool CALIB, int VECS>
cudaError_t launch_commit(const SentArgs& a, cudaStream_t st, bool after) {
  const unsigned long long total = (unsigned long long)a.s * a.n;
  const unsigned blocks =
      (unsigned)((total + COMMIT_THREADS - 1) / COMMIT_THREADS);
  if (!after) {
    sent_commit<CALIB, VECS, false><<<blocks, COMMIT_THREADS, 0, st>>>(a);
    return cudaGetLastError();
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(COMMIT_THREADS);
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, sent_commit<CALIB, VECS, true>, a);
}

// the instantiation by mode and by a broadcast row's width and
// alignment: R = 4 keys (sim_trace's) in one or two 16-byte vectors
cudaError_t enqueue_commit(const SentArgs& a, cudaStream_t st, bool after) {
  if (a.infected != nullptr) return launch_commit<true, 0>(a, st, after);
  const uintptr_t ends = reinterpret_cast<uintptr_t>(a.rows) |
                         reinterpret_cast<uintptr_t>(a.new_rows);
  if (ends % 16 == 0) {
    switch (a.r * (a.wide ? 8 : 4)) {
      case 16: return launch_commit<false, 1>(a, st, after);
      case 32: return launch_commit<false, 2>(a, st, after);
    }
  }
  return launch_commit<false, 0>(a, st, after);
}

}  // namespace

extern "C" int sent_args_size() { return (int)sizeof(SentArgs); }

extern "C" int sent_select_launch(const void* args, void* stream) {
  const SentArgs& a = *static_cast<const SentArgs*>(args);
  if (bad_select(a)) return (int)cudaErrorInvalidValue;
  return (int)enqueue_select(a, static_cast<cudaStream_t>(stream));
}

extern "C" int sent_commit_launch(const void* args, void* stream) {
  const SentArgs& a = *static_cast<const SentArgs*>(args);
  if (bad_commit(a)) return (int)cudaErrorInvalidValue;
  return (int)enqueue_commit(a, static_cast<cudaStream_t>(stream), false);
}

// one tick: sent_select, then sent_commit under programmatic dependent
// launch behind it
extern "C" int sent_tick_launch(const void* args, void* stream) {
  const SentArgs& a = *static_cast<const SentArgs*>(args);
  if (bad_select(a) || bad_commit(a)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = enqueue_select(a, st);
  if (err != cudaSuccess) return (int)err;
  return (int)enqueue_commit(a, st, true);
}
