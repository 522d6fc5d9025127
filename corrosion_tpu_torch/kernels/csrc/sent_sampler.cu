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
//   sent_select  one block per (seed, sender row); an inactive row
//       exits at once (its outputs are dead in the reference).  Each
//       thread draws the row's uniforms at its columns in-register,
//       skips the excluded columns (sent[s, i, c] or c == i) and keeps
//       its MAX_K smallest (float bits, column) keys in a sorted
//       register list; k rounds of a block-wide minimum then pick the
//       row's k smallest in the reference's order.  Threads j < k
//       deliver slot j:
//         calibration: store 1 into new_infected[t] (a copy of
//           infected) and mark sent[i, t];
//         broadcast: mark sent[i, t] (before loss: the sender cannot
//           know the message died), then the loss, partition and WAN
//           masks, in-thread at counter i * k + j; a surviving message
//           atomicMax-es the sender's packed keys into new_rows[t] (a
//           copy of rows) and atomicMin-s min(hops[i], HOP_UNSET) + 1
//           into cand[t].
//       Thread 0 writes the row's send count (zero-filled by the
//       wrapper, so inactive rows read 0).
//   sent_commit  one thread per (seed, node): msgs plus the count, the
//       budget (calibration: a send decrements, an exhausted row
//       retires to 0; broadcast: an active row decrements), the
//       backoff next_send (times the RTT tier in broadcast mode), the
//       learners' fresh budget (calibration: new_infected & ~infected;
//       broadcast: any key of new_rows[i] != rows[i]) and the hops.
//       It is a second launch because it needs every sender's stores.
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
//   scores are non-negative, so their bits order like the floats, and
//   one 64-bit (bits, column) key puts the lower column first, as
//   lax.top_k(-scores) and the stable argsort do.  Keys are unique, so
//   exactly one thread pops each round's minimum.
// - Fewer than k available: the missing slots stay ~0 and send
//   nothing; the reference's padding targets are masked away, so the
//   kernel reads no partition or region entry for them.
// - Races.  infected, rows, tx and hops are the tick's inputs and are
//   never written; every store other blocks could read goes to a
//   fresh buffer.  Only block i reads or writes row i of sent, and it
//   writes after the barrier that ends its reads, so sent is marked
//   in place.  atomicMax and atomicMin are order-free, so the scatters
//   equal the reference's K sequential columns bitwise.
//
// Bound on the H100: operations.  An active row hashes its N
// uniforms (42 INT32-pipe operations each, see threefry.cu): 0.64 ms
// a tick at 16k active rows of 16k, against 0.08 ms for reading their
// sent rows.  The design draws in registers, so no [C, N] score block
// and no sort reaches memory, skips the hash of excluded columns and
// spends inactive rows one block exit.  sent stays a bool [S, N, N]
// (the reference's leaf); a bitpacked layout is later work.

#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

using common::HOP_UNSET;

constexpr int MAX_K = 8;
constexpr int THREADS = 256;
constexpr unsigned FULL = 0xffffffffu;
constexpr unsigned long long NONE = ~0ull;

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
  int* counts;                    // [S, N] zero-filled
  int* tx_out;
  int* next_out;
  int* msgs_out;
  int* hops_out;
  int s, n, k, chunk, nchunks, r, wide, sev_b, tick, part_active, use_loss,
      max_tx;
  float loss, wan_loss, backoff;
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

__global__ void __launch_bounds__(THREADS) sent_select(const SentArgs a) {
  __shared__ unsigned long long s_warp[THREADS / 32];
  __shared__ unsigned long long s_sel[MAX_K];
  const size_t g = blockIdx.x;
  const int n = a.n;
  const int s = (int)(g / n), i = (int)(g % n);
  if (!row_active(a, g)) return;
  const int ck = i / a.chunk;
  const uint32_t* key = a.keys + ((size_t)s * a.nchunks + ck) * 2;
  const uint32_t k0 = key[0], k1 = key[1];
  const unsigned long long base = (unsigned long long)(i - ck * a.chunk) * n;
  const unsigned char* row = a.sent + g * n;

  // each thread's MAX_K smallest (float bits, column) keys, ascending
  unsigned long long best[MAX_K];
#pragma unroll
  for (int q = 0; q < MAX_K; ++q) best[q] = NONE;
  for (int c = threadIdx.x; c < n; c += THREADS) {
    if (c == i || row[c]) continue;
    const float u =
        common::uniform_of(common::threefry_xor(k0, k1, base + c));
    unsigned long long kv =
        ((unsigned long long)__float_as_uint(u) << 32) | (unsigned)c;
    if (kv < best[MAX_K - 1]) {
#pragma unroll
      for (int q = 0; q < MAX_K; ++q) {  // sorted insert
        const unsigned long long lo = umin64(kv, best[q]);
        kv = kv ^ best[q] ^ lo;
        best[q] = lo;
      }
    }
  }
  // k rounds of a block-wide minimum over the threads' heads
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int r = 0; r < a.k; ++r) {
    unsigned long long x = best[0];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      x = umin64(x, __shfl_xor_sync(FULL, x, o));
    if (lane == 0) s_warp[warp] = x;
    __syncthreads();
    unsigned long long win = s_warp[0];
#pragma unroll
    for (int w = 1; w < THREADS / 32; ++w) win = umin64(win, s_warp[w]);
    if (win != NONE && best[0] == win) {  // keys are unique: one pops
#pragma unroll
      for (int q = 0; q + 1 < MAX_K; ++q) best[q] = best[q + 1];
      best[MAX_K - 1] = NONE;
    }
    if (threadIdx.x == 0) s_sel[r] = win;
    __syncthreads();
  }
  if (threadIdx.x < a.k && s_sel[threadIdx.x] != NONE)
    deliver(a, s, i, g, threadIdx.x, (int)(s_sel[threadIdx.x] & 0xffffffffu));
  if (threadIdx.x == 0) {
    int sent = 0;
    for (int j = 0; j < a.k; ++j) sent += s_sel[j] != NONE;
    a.counts[g] = sent;
  }
}

// the nth retransmission waits max(1, round(backoff * n)) ticks
// (half-to-even on a float32 product, as the reference)
__device__ __forceinline__ int backoff_gap(const SentArgs& a, int tx) {
  return max(1, (int)rintf(__fmul_rn(a.backoff, (float)(a.max_tx - tx))));
}

__global__ void sent_commit(const SentArgs a) {
  const size_t g = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= (size_t)a.s * a.n) return;
  const int i = (int)(g % a.n);
  const bool act = row_active(a, g);
  const int cnt = a.counts[g];
  const int tx = a.tx[g];
  a.msgs_out[g] = a.msgs[g] + cnt;
  if (a.infected != nullptr) {  // calibration (exact_tick)
    const bool sent_now = act && cnt > 0, exhausted = act && cnt == 0;
    int tx2 = sent_now ? tx - 1 : (exhausted ? 0 : tx);
    int nxt = sent_now ? a.tick + backoff_gap(a, tx2) : a.next_send[g];
    if (a.new_infected[g] && !a.infected[g]) {
      tx2 = a.max_tx;
      nxt = a.tick + 1;
    }
    a.tx_out[g] = tx2;
    a.next_out[g] = nxt;
    return;
  }
  bool learned = false;
  if (a.wide) {
    const long long* x = static_cast<const long long*>(a.rows) + g * a.r;
    const long long* y = static_cast<const long long*>(a.new_rows) + g * a.r;
    for (int c = 0; c < a.r; ++c) learned |= x[c] != y[c];
  } else {
    const int* x = static_cast<const int*>(a.rows) + g * a.r;
    const int* y = static_cast<const int*>(a.new_rows) + g * a.r;
    for (int c = 0; c < a.r; ++c) learned |= x[c] != y[c];
  }
  const int tx2 = learned ? a.max_tx : (act ? tx - 1 : tx);
  a.tx_out[g] = tx2;
  if (a.next_out != nullptr) {
    int gap = backoff_gap(a, tx2), first = 1;
    if (a.tier != nullptr) {
      gap *= a.tier[i];
      first = a.tier[i];
    }
    int nxt = act ? a.tick + gap : a.next_send[g];
    a.next_out[g] = learned ? a.tick + first : nxt;
  }
  if (a.hops_out != nullptr)
    a.hops_out[g] = learned ? min(a.hops[g], a.cand[g]) : a.hops[g];
}

// the leaves both kernels read, by mode
bool bad_leaves(const SentArgs& a) {
  return a.s < 1 || a.n < 1 || a.tx == nullptr || a.counts == nullptr ||
         (a.infected != nullptr
              ? a.new_infected == nullptr || a.next_send == nullptr
              : a.rows == nullptr || a.new_rows == nullptr || a.r < 1 ||
                    (a.cand != nullptr && a.hops == nullptr));
}

}  // namespace

extern "C" int sent_args_size() { return (int)sizeof(SentArgs); }

extern "C" int sent_select_launch(const void* args, void* stream) {
  const SentArgs& a = *static_cast<const SentArgs*>(args);
  if (bad_leaves(a) || a.k < 1 || a.k > MAX_K || a.chunk < 1 ||
      a.nchunks != (a.n + a.chunk - 1) / a.chunk || a.sent == nullptr ||
      a.keys == nullptr || (a.infected == nullptr && a.loss_keys == nullptr))
    return (int)cudaErrorInvalidValue;
  const unsigned long long blocks = (unsigned long long)a.s * a.n;
  if (blocks > 0x7fffffffull) return (int)cudaErrorInvalidValue;
  sent_select<<<(unsigned)blocks, THREADS, 0,
                static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

extern "C" int sent_commit_launch(const void* args, void* stream) {
  const SentArgs& a = *static_cast<const SentArgs*>(args);
  if (bad_leaves(a) || a.tx_out == nullptr || a.msgs_out == nullptr ||
      (a.infected != nullptr && a.next_out == nullptr) ||
      (a.next_out != nullptr && a.next_send == nullptr) ||
      (a.hops_out != nullptr && (a.hops == nullptr || a.cand == nullptr)))
    return (int)cudaErrorInvalidValue;
  const unsigned long long total = (unsigned long long)a.s * a.n;
  const unsigned blocks = (unsigned)((total + THREADS - 1) / THREADS);
  sent_commit<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}
