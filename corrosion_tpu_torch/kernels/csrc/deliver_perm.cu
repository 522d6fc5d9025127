// deliver_perm: permutation-fanout gossip delivery plus the broadcast
// epilogue, one pass over the receivers.
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
// :253-279) run the same delivery for one shard's receivers, the
// window [lo, lo + n) of the N nodes: the maps, draws, regions,
// partition ids and tiers are the global [N] (or [N, K]) arrays; a
// sender's row comes from a separate source through the slot map:
// row slot_of[s] of the all_gathered [N, R] rows (the identity where
// active) or of the received [Q, R] rows (slot -1: the sender shipped
// nothing, inactive).  The single-device call is the case src = rows,
// the whole range, no slot map.
//
// Bound on the H100: bytes.  Each receiver reads its row, K sender
// rows at random (32 bytes each at R = 8), the K sender ids, K loss
// uniforms and a few [N] words, and writes R + 4 words: about 0.4 GB
// per tick at N = 3.2M, R = 8, K = 4.  The design reads each row with
// 16-byte vector loads when R % 4 == 0, keeps the merge in registers
// (R is a template parameter, 1..16) and never materialises the
// gathered [N, K, R] block.  round() is half-to-even (rintf) and the
// backoff product is float32, as in the reference.

#include <cstdint>
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

using common::HOP_UNSET;
using common::load_row;
using common::store_row;

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

}  // namespace

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
  if (src_rows == nullptr || lo < 0 || lo + n > n_global ||
      (hops != nullptr && slot_of != nullptr))
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
  a.slot_of = static_cast<const int*>(slot_of);
  a.lo = lo;
  a.n_global = n_global;
  const int threads = 256;
  const int blocks = (n + threads - 1) / threads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (r) {
#define DELIVER_CASE(RR) \
  case RR:               \
    deliver_perm_kernel<RR><<<blocks, threads, 0, s>>>(a); \
    break;
    DELIVER_CASE(1) DELIVER_CASE(2) DELIVER_CASE(3) DELIVER_CASE(4)
    DELIVER_CASE(5) DELIVER_CASE(6) DELIVER_CASE(7) DELIVER_CASE(8)
    DELIVER_CASE(9) DELIVER_CASE(10) DELIVER_CASE(11) DELIVER_CASE(12)
    DELIVER_CASE(13) DELIVER_CASE(14) DELIVER_CASE(15) DELIVER_CASE(16)
#undef DELIVER_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
