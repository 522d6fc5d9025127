// deliver_perm: permutation-fanout gossip delivery plus the broadcast
// epilogue, one pass over the receivers; and the sharded fabrics'
// delivery from a separate source of sender rows.
//
// Replaces corrosion_tpu/models/broadcast.py _deliver_perm (:327) and
// the epilogue of broadcast_step (:243-280).  The reference gathers a
// packed [rows | sender hop | partition] row once per fanout column (K
// gathers of [N, R+2]), masks each column, max-merges, then runs the
// tx / msgs / next_send / hops epilogue as separate elementwise passes.
//
// One thread per receiver t.  It loads its own row, then for each of
// the K columns reads the sender s = senders[j][t], tests validity
// (sender active, loss draw, WAN cross-region drop, partition or
// one-way severance while the partition is in force), max-merges the
// sender's R packed keys into registers and min-merges the hop
// candidate.  learned = any key changed; then the epilogue writes
// rows, tx, msgs, hops and next_send once each.  Outputs go to fresh
// buffers: other threads still read the inputs as senders.
//
// The sharded fabrics (corrosion_tpu/models/sharded.py
// sharded_broadcast_step :121-147, sharded_broadcast_step_ring
// :253-279) run the same delivery, loss draws only, for one shard's
// receivers, the window [lo, lo + n) of the N nodes: the maps and draws
// are the global [N] (or [N, K]) arrays; a sender's row comes from a
// separate source through a slot map, row slot_of[s] of the
// all_gathered [N, R] rows (the identity where active, -1 where not)
// or of the received [Q, R] rows.  That delivery is its own kernel
// (deliver_source_kernel): a thread a receiver, SOURCE_THREADS a block
// so that one shard's 12,500 receivers spread over the card, whose K
// columns' loads are in flight together (the sender ids and loss
// draws, then the slots, then the rows), not one column after another.
//
// deliver_window_launch is the source delivery with the epidemic
// tick's sender state, for one shard's window of receivers on a
// ("seeds", "nodes") mesh (corrosion_tpu_torch/models/sharded.py
// sharded_epidemic_tick, the twin of __graft_entry__.py :183-215):
// deliver_source_kernel<R, HOPS>.  Each sender's hop candidate comes
// from shops, gathered beside the rows (hop + 1 where the sender is
// active, HOP_UNSET where not; the row is src_rows[s]), or, for a slot
// map's source, 0 where its slot is present.  On top of the loss draw
// it tests the partition (sender's block against the receiver's, while
// in force), and its epilogue is deliver_perm_kernel's: the receiver's
// own activity (tx > 0, next_send <= tick), the backoff schedule and
// the hop-min.  The topologies' WAN draws and RTT tiers stay with the
// single-device kernel.
//
// ring_receive_launch is the ring fabric's whole receive side from one
// host call, two kernels chained by programmatic dependent launch over
// a slot map that is kept between calls and never filled: each entry
// is a 64-bit tag, (the call's generation << 32) | slot, and the host
// gives every call the next generation (refilling the map with zeros,
// generation 0, once the 32-bit count wraps):
//   1. ring_slots_kernel, a thread a received slot q: tags[id] =
//      (gen << 32) | q.  It checks route_pack's contract on the
//      received ids (each source shard's section ascends within that
//      shard's rows, then -1 pads), which makes the ids unique, and
//      writes the generation into the map's flag word where it fails;
//   2. deliver_source_kernel<R, RING>: its prelude (own row, tx, msgs,
//      the K sender ids and loss draws) before griddepcontrol.wait,
//      then the K tags; a tag of an earlier generation is an absent
//      sender, so what earlier calls left in the map is never read as
//      a slot of this one and costs no row load.  Thread 0 hands the
//      flag (the flag word holds this generation) to the caller.
//
// Bound on the H100: bytes.  Each receiver reads its row, K sender
// rows at random (32 bytes each at R = 8), the K sender ids, K loss
// uniforms and a few [N] words, and writes R + 4 words: about 0.4 GB
// per tick at N = 3.2M, R = 8, K = 4.  The source path adds K random
// slot_of sectors a receiver; the ring's slot map writes one random
// sector a received id.
// The design reads each row with 16-byte vector loads when R % 4 == 0,
// keeps the merge in registers (R is a template parameter, 1..16) and
// never materialises the gathered [N, K, R] block.  round() is
// half-to-even (rintf) and the backoff product is float32, as in the
// reference.

#include <cstdint>
#include <cuda_runtime.h>

#include <type_traits>

#include "common.cuh"

namespace {

using common::HOP_UNSET;
using common::load_row;
using common::store_row;

constexpr int SOURCE_THREADS = 64;  // a block of the source delivery
constexpr int SLOT_THREADS = 256;   // a block of the ring's slot map
constexpr int COLUMNS = 4;          // columns whose loads are in flight

// deliver_source_kernel's modes: a slot map (the all_gather fabric),
// the ring's tagged slot map, the window with the senders' hops
enum SourceMode { SLOTS = 0, RING = 1, HOPS = 2 };

struct DeliverArgs {
  const int* rows;
  const int* tx;
  const int* msgs;
  const int* hops;       // may be null (hops untracked)
  const int* next_send;  // may be null (no backoff schedule)
  const int* senders;    // [K, N]
  const float* loss_u;   // [N, K] or null (no loss)
  const float* wan_u;    // [N, K] or null (not the WAN topology)
  const int* region;     // [N] or null
  const int* part;       // [N] or null (no partition)
  const unsigned char* sev;  // [B, B] or null (symmetric partition)
  int sev_b;
  const int* tier;       // [N] or null (no RTT tiers)
  int* rows_out;
  int* tx_out;
  int* msgs_out;
  int* hops_out;
  int* next_out;
  int n;
  int k;
  float loss;
  float wan_loss;
  int part_active;
  int tick;
  int max_tx;
  float backoff;
  const int* src_rows;  // sender rows: rows, or [Q, R]
  const int* slot_of;   // [N] sender -> src_rows row (-1 absent), or null
  int lo;               // first receiver's global id
  int n_global;         // N: senders' id space
};

__device__ __forceinline__ bool is_active(const DeliverArgs& a, int i) {
  return a.tx[i] > 0 && (a.next_send == nullptr || a.next_send[i] <= a.tick);
}

// The single-device delivery.  slot_of is null on its every launch (a
// delivery from a source is deliver_source_kernel's), but the kernel
// stays as written: without the branch on it, and with the sender rows
// read through rows, ptxas made another headline kernel, its column
// loop twice as long and its row loads outside the constant cache.
template <int R>
__global__ void deliver_perm_kernel(const DeliverArgs a) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;  // my receiver
  if (t >= a.n) return;
  const int tg = a.lo + t;  // its global id
  int own[R], acc[R];
  load_row<R>(a.rows + (size_t)t * R, own);
#pragma unroll
  for (int c = 0; c < R; ++c) acc[c] = own[c];
  const int rp = a.part ? a.part[tg] : 0;
  const int rr = a.region ? a.region[tg] : 0;
  int cand = HOP_UNSET;

  for (int j = 0; j < a.k; ++j) {
    const int s = a.senders[(size_t)j * a.n_global + tg];
    int src = s;
    int sh = HOP_UNSET;  // sender hop + 1, or HOP_UNSET when inactive
    if (a.slot_of) {
      src = a.slot_of[s];
      if (src >= 0) sh = 0;
    } else if (is_active(a, s)) {
      sh = a.hops ? min(a.hops[s], HOP_UNSET - 2) + 1 : 0;
    }
    bool valid = sh < HOP_UNSET;
    const size_t uj = (size_t)tg * a.k + j;
    if (valid && a.loss_u) valid = !(a.loss_u[uj] < a.loss);
    if (valid && a.wan_u)
      valid = !(a.region[s] != rr && a.wan_u[uj] < a.wan_loss);
    if (valid && a.part && a.part_active)  // flow is sender -> receiver
      valid = !common::blocks_cross(a.part[s], rp, a.sev, a.sev_b, false);
    if (valid) {
      int g[R];
      load_row<R>(a.src_rows + (size_t)src * R, g);
#pragma unroll
      for (int c = 0; c < R; ++c) acc[c] = max(acc[c], g[c]);
      cand = min(cand, sh);
    }
  }

  bool learned = false;
#pragma unroll
  for (int c = 0; c < R; ++c) learned |= acc[c] != own[c];
  store_row<R>(a.rows_out + (size_t)t * R, acc);

  // retransmit decay for an active sender; fresh budget on learning
  const bool act = is_active(a, t);
  const int tx = a.tx[t];
  const int tx2 = learned ? a.max_tx : (act ? tx - 1 : tx);
  a.tx_out[t] = tx2;
  a.msgs_out[t] = a.msgs[t] + (act ? a.k : 0);
  if (a.next_out) {
    // nth retransmission waits round(backoff * n) (>= 1) ticks, times
    // the node's RTT tier; a fresh payload forwards after one tier
    const int sent = a.max_tx - tx2;
    int gap = max(1, (int)rintf(__fmul_rn(a.backoff, (float)sent)));
    int first = 1;
    if (a.tier) {
      gap *= a.tier[tg];
      first = a.tier[tg];
    }
    int nxt = act ? a.tick + gap : a.next_send[t];
    if (learned) nxt = a.tick + first;
    a.next_out[t] = nxt;
  }
  if (a.hops_out) {
    const int h = a.hops[t];
    a.hops_out[t] = learned ? min(h, cand) : h;
  }
}

// -- the sharded fabrics' delivery from a separate source

struct SourceArgs {
  const int* rows;      // [n, R]: my receivers' rows
  const int* tx;
  const int* msgs;
  const int* senders;   // [K, N]
  const float* loss_u;  // [N, K] or null (no loss)
  const int* src_rows;  // [Q, R]
  const int* slot_of;   // [N]: a sender's row of src_rows, -1 for none
  const unsigned long long* tags;  // the ring: [N + 1], (gen << 32) | row
  int* rows_out;
  int* tx_out;
  int* msgs_out;
  int* bad_out;         // the ring: [1] this call's flag
  int n, k, lo, n_global, max_tx;
  unsigned gen;         // the ring: this call's generation, >= 1
  float loss;
  // HOPS only: the senders' hops (or, when null, slot_of's slots with
  // hop candidate 0), the receivers' hops / next_send (each may be
  // null), the partition (null: none) and the epilogue's schedule
  const int* shops;     // [N] hop + 1 of an active sender, or HOP_UNSET
  const int* hops;
  const int* next_send;
  int* hops_out;
  int* next_out;
  const int* part;
  const unsigned char* sev;
  int sev_b, part_active, tick;
  float backoff;
};

// columns j0 .. j0 + COLUMNS - 1 (those below k) of receiver tg: the
// sender ids, then whether each one's loss draw drops it
__device__ __forceinline__ void columns(const SourceArgs& a, int tg, int j0,
                                        int (&s)[COLUMNS],
                                        bool (&lost)[COLUMNS]) {
#pragma unroll
  for (int c = 0; c < COLUMNS; ++c)
    s[c] = j0 + c < a.k
               ? __ldg(a.senders + (size_t)(j0 + c) * a.n_global + tg)
               : 0;
#pragma unroll
  for (int c = 0; c < COLUMNS; ++c)
    lost[c] = j0 + c < a.k && a.loss_u != nullptr &&
              __ldg(a.loss_u + (size_t)tg * a.k + j0 + c) < a.loss;
}

// those columns' slots (on the ring, their tags; in the window, the
// senders' hops and blocks), loaded together, then the rows of the
// present ones, max-merged into acc (the window: their hop candidates
// min-merged into cand; rp the receiver's block)
template <int R, int MODE>
__device__ __forceinline__ void merge_columns(const SourceArgs& a, int j0,
                                              const int (&s)[COLUMNS],
                                              const bool (&lost)[COLUMNS],
                                              int (&acc)[R], int& cand,
                                              int rp) {
  int slot[COLUMNS], sh[COLUMNS];
#pragma unroll
  for (int c = 0; c < COLUMNS; ++c) {
    sh[c] = 0;
    if (j0 + c >= a.k) {
      slot[c] = -1;
    } else if constexpr (MODE == RING) {
      const unsigned long long tag = __ldcg(a.tags + s[c]);
      slot[c] = (unsigned)(tag >> 32) == a.gen ? (int)(unsigned)tag : -1;
    } else if constexpr (MODE == HOPS) {
      if (a.shops != nullptr) {
        sh[c] = __ldg(a.shops + s[c]);
        slot[c] = sh[c] < HOP_UNSET ? s[c] : -1;
      } else {
        slot[c] = __ldg(a.slot_of + s[c]);
      }
    } else {
      slot[c] = __ldcg(a.slot_of + s[c]);
    }
  }
  if constexpr (MODE == HOPS) {
    // flow is sender -> receiver
    if (a.part != nullptr && a.part_active) {
#pragma unroll
      for (int c = 0; c < COLUMNS; ++c)
        if (slot[c] >= 0 &&
            common::blocks_cross(__ldg(a.part + s[c]), rp, a.sev, a.sev_b,
                                 false))
          slot[c] = -1;
    }
  }
  int g[COLUMNS][R];
#pragma unroll
  for (int c = 0; c < COLUMNS; ++c)
    if (!lost[c] && slot[c] >= 0)
      load_row<R>(a.src_rows + (size_t)slot[c] * R, g[c]);
#pragma unroll
  for (int c = 0; c < COLUMNS; ++c)
    if (!lost[c] && slot[c] >= 0) {
#pragma unroll
      for (int e = 0; e < R; ++e) acc[e] = max(acc[e], g[c][e]);
      if constexpr (MODE == HOPS) cand = min(cand, sh[c]);
    }
}

template <int R, int MODE>
__global__ void __launch_bounds__(SOURCE_THREADS)
    deliver_source_kernel(const SourceArgs a) {
  const int t = blockIdx.x * SOURCE_THREADS + threadIdx.x;  // my receiver
  if (t >= a.n) return;
  const int tg = a.lo + t;  // its global id
  int own[R], acc[R], s[COLUMNS];
  bool lost[COLUMNS];
  load_row<R>(a.rows + (size_t)t * R, own);
  const int tx = a.tx[t], msgs = a.msgs[t];
  int rp = 0, cand = HOP_UNSET;
  if constexpr (MODE == HOPS)
    if (a.part != nullptr) rp = __ldg(a.part + tg);
  columns(a, tg, 0, s, lost);
  // on the ring the slot map's kernel may run until here
  asm volatile("griddepcontrol.wait;" ::: "memory");
#pragma unroll
  for (int e = 0; e < R; ++e) acc[e] = own[e];
  for (int j0 = 0;;) {
    merge_columns<R, MODE>(a, j0, s, lost, acc, cand, rp);
    j0 += COLUMNS;
    if (j0 >= a.k) break;
    columns(a, tg, j0, s, lost);
  }
  bool learned = false;
#pragma unroll
  for (int e = 0; e < R; ++e) learned |= acc[e] != own[e];
  store_row<R>(a.rows_out + (size_t)t * R, acc);
  if constexpr (MODE == HOPS) {
    // deliver_perm_kernel's epilogue, without the RTT tiers
    const bool act =
        tx > 0 && (a.next_send == nullptr || a.next_send[t] <= a.tick);
    const int tx2 = learned ? a.max_tx : (act ? tx - 1 : tx);
    a.tx_out[t] = tx2;
    a.msgs_out[t] = msgs + (act ? a.k : 0);
    if (a.next_out) {
      const int sent = a.max_tx - tx2;
      const int gap = max(1, (int)rintf(__fmul_rn(a.backoff, (float)sent)));
      int nxt = act ? a.tick + gap : a.next_send[t];
      if (learned) nxt = a.tick + 1;
      a.next_out[t] = nxt;
    }
    if (a.hops_out) {
      const int h = a.hops[t];
      a.hops_out[t] = learned ? min(h, cand) : h;
    }
  } else {
    // retransmit decay for an active sender; fresh budget on learning
    const bool act = tx > 0;
    a.tx_out[t] = learned ? a.max_tx : (act ? tx - 1 : tx);
    a.msgs_out[t] = msgs + (act ? a.k : 0);
    if (MODE == RING && t == 0)  // this call's flag
      *a.bad_out = __ldcg(a.tags + a.n_global) == a.gen;
  }
}

// the ring's slot map: received slot q's id (in source shard q / cap's
// section) gets tags[id] = (gen << 32) | q where route_pack's contract
// holds for it: an id ascends past the one before it in the section and
// lies in that shard's rows [lo, lo + n_local); a pad is -1 and only
// pads follow it.  Else the flag word tags[n_global] = gen (and the id
// is not scattered).
__global__ void __launch_bounds__(SLOT_THREADS)
    ring_slots_kernel(const int* __restrict__ ids,
                      unsigned long long* __restrict__ tags, unsigned gen,
                      int q_total, int cap, int n_local, int n_global) {
  asm volatile("griddepcontrol.launch_dependents;");
  const int q = blockIdx.x * SLOT_THREADS + threadIdx.x;
  if (q >= q_total) return;
  const int e = q / cap, lo = e * n_local;
  const bool first = q == e * cap;
  const int id = __ldg(ids + q);
  const int prev = first ? 0 : __ldg(ids + q - 1);
  const bool ok = id < 0 ? id == -1
                         : id >= lo && id < lo + n_local &&
                               (first || (prev >= 0 && prev < id));
  if (!ok)
    tags[n_global] = gen;
  else if (id >= 0)
    tags[id] = (unsigned long long)gen << 32 | (unsigned)q;
}

// f(std::integral_constant<int, r>) for r in 1..16; false for another r
template <typename F>
bool with_rows(int r, F&& f) {
  switch (r) {
#define ROWS_CASE(RR) \
  case RR:            \
    f(std::integral_constant<int, RR>{}); \
    return true;
    ROWS_CASE(1) ROWS_CASE(2) ROWS_CASE(3) ROWS_CASE(4)
    ROWS_CASE(5) ROWS_CASE(6) ROWS_CASE(7) ROWS_CASE(8)
    ROWS_CASE(9) ROWS_CASE(10) ROWS_CASE(11) ROWS_CASE(12)
    ROWS_CASE(13) ROWS_CASE(14) ROWS_CASE(15) ROWS_CASE(16)
#undef ROWS_CASE
    default:
      return false;
  }
}

unsigned blocks_of(int n, int threads) {
  return (unsigned)((n + threads - 1) / threads);
}

}  // namespace

// src_rows == rows (and no slot_of) for the single-device delivery;
// with slot_of the source delivery (loss draws only: no hops,
// next_send, WAN draws, partition or tiers)
extern "C" int deliver_perm_launch(
    const void* rows, const void* tx, const void* msgs, const void* hops,
    const void* next_send, const void* senders, const void* loss_u,
    const void* wan_u, const void* region, const void* part, const void* sev,
    int sev_b, const void* tier, void* rows_out, void* tx_out, void* msgs_out,
    void* hops_out, void* next_out, int n, int r, int k, float loss,
    float wan_loss, int part_active, int tick, int max_tx, float backoff,
    const void* src_rows, const void* slot_of, int lo, int n_global,
    void* stream) {
  if (n <= 0) return 0;
  if (src_rows == nullptr || lo < 0 || lo + n > n_global)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (slot_of != nullptr) {
    if (hops || next_send || wan_u || part || tier)
      return (int)cudaErrorInvalidValue;
    SourceArgs a = {};
    a.rows = static_cast<const int*>(rows);
    a.tx = static_cast<const int*>(tx);
    a.msgs = static_cast<const int*>(msgs);
    a.senders = static_cast<const int*>(senders);
    a.loss_u = static_cast<const float*>(loss_u);
    a.src_rows = static_cast<const int*>(src_rows);
    a.slot_of = static_cast<const int*>(slot_of);
    a.rows_out = static_cast<int*>(rows_out);
    a.tx_out = static_cast<int*>(tx_out);
    a.msgs_out = static_cast<int*>(msgs_out);
    a.n = n, a.k = k, a.lo = lo, a.n_global = n_global, a.max_tx = max_tx;
    a.loss = loss;
    if (!with_rows(r, [&](auto rc) {
          deliver_source_kernel<decltype(rc)::value, SLOTS>
              <<<blocks_of(n, SOURCE_THREADS), SOURCE_THREADS, 0, st>>>(a);
        }))
      return (int)cudaErrorInvalidValue;
    return (int)cudaGetLastError();
  }
  if (lo != 0 || n != n_global || src_rows != rows)
    return (int)cudaErrorInvalidValue;
  DeliverArgs a;
  a.rows = static_cast<const int*>(rows);
  a.tx = static_cast<const int*>(tx);
  a.msgs = static_cast<const int*>(msgs);
  a.hops = static_cast<const int*>(hops);
  a.next_send = static_cast<const int*>(next_send);
  a.senders = static_cast<const int*>(senders);
  a.loss_u = static_cast<const float*>(loss_u);
  a.wan_u = static_cast<const float*>(wan_u);
  a.region = static_cast<const int*>(region);
  a.part = static_cast<const int*>(part);
  a.sev = static_cast<const unsigned char*>(sev);
  a.sev_b = sev_b;
  a.tier = static_cast<const int*>(tier);
  a.rows_out = static_cast<int*>(rows_out);
  a.tx_out = static_cast<int*>(tx_out);
  a.msgs_out = static_cast<int*>(msgs_out);
  a.hops_out = static_cast<int*>(hops_out);
  a.next_out = static_cast<int*>(next_out);
  a.n = n;
  a.k = k;
  a.loss = loss;
  a.wan_loss = wan_loss;
  a.part_active = part_active;
  a.tick = tick;
  a.max_tx = max_tx;
  a.backoff = backoff;
  a.src_rows = static_cast<const int*>(src_rows);
  a.slot_of = nullptr;  // a source took the branch above
  a.lo = lo;
  a.n_global = n_global;
  const int threads = 256;
  if (!with_rows(r, [&](auto rc) {
        deliver_perm_kernel<decltype(rc)::value>
            <<<blocks_of(n, threads), threads, 0, st>>>(a);
      }))
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// One shard's window [lo, lo + n) of the epidemic tick's delivery:
// rows, tx, msgs, hops, next_send [n] (hops / next_send may be null);
// senders [K, N], loss_u [N, K] (null: no loss), part [N] and sev [B, B]
// (null: none / symmetric); the senders' rows src_rows with shops [N]
// ([N, R], identity) or slot_of [N] ([Q, R]), exactly one of the two
extern "C" int deliver_window_launch(
    const void* rows, const void* tx, const void* msgs, const void* hops,
    const void* next_send, const void* senders, const void* loss_u,
    const void* part, const void* sev, int sev_b, const void* src_rows,
    const void* shops, const void* slot_of, void* rows_out, void* tx_out,
    void* msgs_out, void* hops_out, void* next_out, int n, int r, int k,
    float loss, int part_active, int tick, int max_tx, float backoff, int lo,
    int n_global, void* stream) {
  if (n <= 0) return 0;
  if (src_rows == nullptr || (shops == nullptr) == (slot_of == nullptr) ||
      lo < 0 || lo + n > n_global || (hops == nullptr) != (hops_out == nullptr) ||
      (next_send == nullptr) != (next_out == nullptr))
    return (int)cudaErrorInvalidValue;
  SourceArgs a = {};
  a.rows = static_cast<const int*>(rows);
  a.tx = static_cast<const int*>(tx);
  a.msgs = static_cast<const int*>(msgs);
  a.senders = static_cast<const int*>(senders);
  a.loss_u = static_cast<const float*>(loss_u);
  a.src_rows = static_cast<const int*>(src_rows);
  a.slot_of = static_cast<const int*>(slot_of);
  a.rows_out = static_cast<int*>(rows_out);
  a.tx_out = static_cast<int*>(tx_out);
  a.msgs_out = static_cast<int*>(msgs_out);
  a.n = n, a.k = k, a.lo = lo, a.n_global = n_global, a.max_tx = max_tx;
  a.loss = loss;
  a.shops = static_cast<const int*>(shops);
  a.hops = static_cast<const int*>(hops);
  a.next_send = static_cast<const int*>(next_send);
  a.hops_out = static_cast<int*>(hops_out);
  a.next_out = static_cast<int*>(next_out);
  a.part = static_cast<const int*>(part);
  a.sev = static_cast<const unsigned char*>(sev);
  a.sev_b = sev_b, a.part_active = part_active, a.tick = tick;
  a.backoff = backoff;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!with_rows(r, [&](auto rc) {
        deliver_source_kernel<decltype(rc)::value, HOPS>
            <<<blocks_of(n, SOURCE_THREADS), SOURCE_THREADS, 0, st>>>(a);
      }))
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// The ring fabric's receive side: recv_ids [d, cap] and recv_rows
// [d, cap, r] as the all_to_all delivered them (section e from source
// shard e); tags [n_global + 1] int64, the slot map then its flag word,
// kept between calls (zero when made) and gen this call's generation,
// above every generation the map holds; outputs rows_out [n, r],
// tx_out, msgs_out [n] and bad_out [1].
extern "C" int ring_receive_launch(
    const void* rows, const void* tx, const void* msgs, const void* senders,
    const void* loss_u, const void* recv_ids, const void* recv_rows,
    void* tags, void* rows_out, void* tx_out, void* msgs_out, void* bad_out,
    int n, int r, int k, float loss, int max_tx, int lo, int n_global,
    int d, int cap, unsigned gen, void* stream) {
  if (n < 1 || d < 1 || cap < 1 || lo < 0 || lo + n > n_global ||
      n_global % d || cap > n_global / d || r < 1 || r > 16 || gen == 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  SourceArgs a = {};
  a.rows = static_cast<const int*>(rows);
  a.tx = static_cast<const int*>(tx);
  a.msgs = static_cast<const int*>(msgs);
  a.senders = static_cast<const int*>(senders);
  a.loss_u = static_cast<const float*>(loss_u);
  a.src_rows = static_cast<const int*>(recv_rows);
  a.tags = static_cast<const unsigned long long*>(tags);
  a.rows_out = static_cast<int*>(rows_out);
  a.tx_out = static_cast<int*>(tx_out);
  a.msgs_out = static_cast<int*>(msgs_out);
  a.bad_out = static_cast<int*>(bad_out);
  a.n = n, a.k = k, a.lo = lo, a.n_global = n_global, a.max_tx = max_tx;
  a.gen = gen, a.loss = loss;
  const int q = d * cap;
  ring_slots_kernel<<<blocks_of(q, SLOT_THREADS), SLOT_THREADS, 0, st>>>(
      static_cast<const int*>(recv_ids),
      static_cast<unsigned long long*>(tags), gen,
      q, cap, n_global / d, n_global);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks_of(n, SOURCE_THREADS));
  cfg.blockDim = dim3(SOURCE_THREADS);
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  with_rows(r, [&](auto rc) {
    e = cudaLaunchKernelEx(&cfg, deliver_source_kernel<decltype(rc)::value,
                                                       RING>, a);
  });
  return (int)e;
}
