// swim: one SWIM protocol period for every node, as three host calls
// a tick: swim_probe_select, the dissemination (two kernels) and
// swim_settle, each kernel after the first under programmatic
// dependent launch.
//
// Replaces corrosion_tpu/models/swim.py swim_step (:107-316) and the
// per-tick detection flags of corrosion_tpu/sim/churn.py _scan_chunk
// (:86-90).  The reference runs a chain of whole-matrix phases on
// [N, N] int32 leaves (view packed as incarnation * 4 + state,
// suspect_since, update_tx); each phase reads what the previous one
// wrote to other rows, so the phases are separate kernels:
//
//   swim_probe_select  one warp per row i (design at the kernel).  It
//       runs node i's rejoin announce, draws its probe target t and
//       replays t's announce (every announce is a pure function of the
//       tick's inputs, so no launch has to publish it first), runs the
//       direct ping and the H indirect legs, charges every message of
//       the row (announce, ping, acks, ping-reqs, gossip) with integer
//       atomicAdds, and counts i's delivered ping at t.  It writes row
//       i of the view: the input row with the announce records landing
//       in it, the probe outcome at t and the suspect -> down timeout
//       applied.  It scores every column (update_tx + the tie uniform
//       drawn in-register at counter i * N + j; +inf at or past the
//       retransmission limit) and stores the row's M freshest entries
//       in the reference's top_k order (score, then lower index) with
//       their sendable flags and their gossip payload.
//   the dissemination (design above swim_spread): the gossip pass
//       scatters with atomicMax into the gossip targets' rows, the ping
//       piggyback into the probe target's row, the ack piggyback into
//       the prober's row, carrying the target's entries.  A pass sends
//       what the view held after the previous pass finished and before
//       any thread of its own pass scattered, as the reference's
//       gathers on the whole view do (:226, :253, :268).
//   swim_settle  one block per row: refutation / renewal on the
//       diagonal (the probed peer's off-diagonal record of i, which no
//       block writes here), suspect_since, and update_tx rebuilt as
//       the input plus this tick's charges, reset to 0 where the row
//       differs from the input view (the input is never written, so it
//       is the tick's snapshot).  The charges need no scatter: a row's
//       selected entries take one gossip and one ping-piggyback round
//       each when the node is alive, plus one ack round per prober
//       whose ping reached it.  It also counts, for the churn
//       scheduler, the other nodes' DOWN and ALIVE records of the
//       victim.
//
// swim_window_launch runs the same tick on one shard's window of viewer
// rows [lo, lo + nl) of the [N, N] leaves (corrosion_tpu_torch/models/
// sharded.py sharded_swim_step, the twin of the reference's swim_step
// under __graft_entry__.py swim_shardings), five host calls a tick with
// the exchanges between the shards in between (kernels/swim.py
// swim_tick_window):
//
//   W_SELECT   swim_probe_select<true>: a warp a row of mine, its global
//              id i = lo + il for the draws, the tie hashes (flat index
//              i * N + j) and the charges; the announces replayed from
//              the gathered incarnations and own records (diag_in).  Its
//              charges go to an [N] count (msgs) and its delivered pings
//              to another (pinged), summed over the shards after it.
//   W_GOSSIP   swim_gossip_w, a thread a (node, gossip target, entry) of
//              all N nodes: each gossip raise whose target row is mine,
//              from the gathered selection; then swim_collect_w reads my
//              rows' selected cells back (sent_out), the ping's payload.
//   W_PING     swim_ping_w, a thread a (prober, entry) of all N: each
//              ping raise whose target row is mine, carrying the gathered
//              post-gossip cells; swim_collect_w then reads the ack's.
//   W_ACK      swim_ack_w, a thread a (prober of mine, entry): the
//              target's gathered post-ping cells; then swim_peer_rec_w, a
//              thread a prober of all N, reads its record at its target
//              where that row is mine (0 elsewhere), summed over the
//              shards for the refutation.
//   W_SETTLE   swim_settle<true>: a block a row of mine, the probed
//              peer's record from that sum.
//
// Between passes the payload is read back from the view (nl * M cells)
// rather than shadowed: each exchange is a kernel boundary anyway.
//
// Every draw is jax.random's partitionable threefry at the
// reference's flat index (common.cuh): rand_peers' randint under the
// two split keys, the loss uniforms only when loss > 0 (the reference
// draws nothing then).  Outputs go to fresh buffers; msgs_out arrives
// holding a copy of msgs and pinged zeroed.
//
// Bound on the H100: bytes — the three [N, N] inputs read once and the
// three outputs written once (0.40 GB a tick at N = 4096); the N^2 tie
// uniforms (70 integer operations each) come second.  swim_probe_select
// alone moves view and update_tx in, view out and a sector of
// suspect_since for each suspect cell; its hashes overlap that stream.
// The design reads each input matrix in two passes (select, settle)
// and writes each output once; the dissemination touches O(N * G * M)
// cells.

#include <cstdint>
#include <cuda_runtime.h>
#include <utility>

#include "common.cuh"

namespace {

constexpr int ALIVE = 0, SUSPECT = 1, DOWN = 2;
constexpr int NEVER = 0x7fffffff;
constexpr int MAX_M = 8;  // entries one selection pass takes
constexpr int THREADS = 256;  // swim_settle's block
constexpr int DIS_THREADS = 256;  // a dissemination kernel's block
constexpr int SEL_WARPS = 4;  // rows a block of swim_probe_select
constexpr unsigned FULL = 0xffffffffu;
constexpr unsigned INF_BITS = 0x7f800000u;  // +inf as float bits
constexpr unsigned char PING_OK = 1, ACK_OK = 2;

// the tick's keys: randint's two split keys of each peer draw, then
// the loss / tie uniforms' keys (kernels/swim.py KEY_WORDS)
enum KeyWord {
  K_PROBE = 0, K_HELP = 4, K_GT = 8, K_ANN = 12,
  K_LOSS1 = 16, K_LOSS2 = 18, K_HLOSS = 20, K_GE = 22, K_GLOSS = 24,
  K_TU = 26, K_ALOSS = 28, K_WORDS = 30
};

struct SwimArgs {
  const int* view_in;
  const int* ss_in;
  const int* inc_in;
  const int* tx_in;
  const unsigned char* alive;
  const unsigned char* revived;  // null: nobody revives
  int* view;
  int* ss;
  int* inc;
  int* msgs;
  int* tx;
  int* target;  // [N]
  int* inc1;  // [N] incarnation after the announce
  unsigned char* probe;  // [N] PING_OK | ACK_OK
  int* pinged;  // [N] probers whose ping reached the node
  unsigned* ack_pay;  // [N, M] the dissemination's shadow (swim_spread)
  int* ge;  // [N, M]
  unsigned char* sendable;  // [N, M]
  int* pay;  // [N, M]
  int* flags;  // [2] or null: others' DOWN / ALIVE records of victim
  // the window form: the gathered own records, the summed records at
  // the probers' targets, a pass's gathered payload and my read-back
  const int* diag_in;  // [N]
  const int* peer_rec;  // [N]
  const int* sent;  // [N, M]
  int* sent_out;  // [nl, M]
  int* peer_rec_out;  // [N]
  int lo, nl;  // my first row's global id, my rows
  int n, h, g, m, timeout, limit, tick, victim;
  int lossy;
  float loss;
  uint32_t span, mult;
  uint32_t k[K_WORDS];
};

__device__ __forceinline__ size_t cell(int n, int i, int j) {
  return (size_t)i * n + j;
}

// rand_peers: (i + randint(1, max(n, 2))) % n at flat index idx
__device__ __forceinline__ int rand_peer(const SwimArgs& a, int kw,
                                         unsigned long long idx, int i) {
  const uint32_t hi = common::threefry_xor(a.k[kw], a.k[kw + 1], idx);
  const uint32_t lo = common::threefry_xor(a.k[kw + 2], a.k[kw + 3], idx);
  return (i + common::randint_of(hi, lo, a.span, a.mult, 1)) % a.n;
}

// lossy(): the leg survives (always, when loss == 0)
__device__ __forceinline__ bool leg_ok(const SwimArgs& a, int kw,
                                       unsigned long long idx) {
  if (!a.lossy) return true;
  return common::uniform_of(common::threefry_xor(a.k[kw], a.k[kw + 1],
                                                 idx)) >= a.loss;
}

struct Announce {
  int inc1;  // incarnation after the announce
  int diag;  // own record after the announce
  int seed;  // the seed member told, -1 when none
};

// node j's rejoin announce (:128-155); seed >= 0 iff it was delivered
// (the window reads j's record from the gathered diagonal)
template <bool WINDOW>
__device__ Announce announce(const SwimArgs& a, int j) {
  Announce r;
  r.inc1 = a.inc_in[j];
  r.diag = WINDOW ? a.diag_in[j] : a.view_in[cell(a.n, j, j)];
  r.seed = -1;
  if (a.revived != nullptr && a.revived[j]) {
    r.inc1 = max(r.inc1, r.diag / 4) + 1;
    r.diag = r.inc1 * 4 + ALIVE;
    const int seed = rand_peer(a, K_ANN, j, j);
    if (a.alive[j] && a.alive[seed] && leg_ok(a, K_ALOSS, 2ull * j) &&
        leg_ok(a, K_ALOSS, 2ull * j + 1))
      r.seed = seed;
  }
  return r;
}

// the suspicion timeout (:199-202) on cell c's value v
__device__ __forceinline__ int expire(const SwimArgs& a, size_t c, int v) {
  if (v % 4 == SUSPECT && a.tick - __ldg(a.ss_in + c) >= a.timeout)
    v = (v / 4) * 4 + DOWN;
  return v;
}

// cell (i, j) with node j's announce landing in it, for j != i, t
template <bool WINDOW>
__device__ __forceinline__ int announced(const SwimArgs& a, int i, int j,
                                         int v) {
  if (a.revived != nullptr && __ldg(a.revived + j)) {
    const Announce aj = announce<WINDOW>(a, j);
    if (aj.seed == i) v = max(v, aj.diag);
  }
  return v;
}

// the tie uniform of flat index c (the reference's uniform(k_ge, (n, n)))
__device__ __forceinline__ float tie_uniform(const SwimArgs& a, size_t c) {
  return common::uniform_of(
      common::threefry_xor(a.k[K_GE], a.k[K_GE + 1], c));
}

// column j's selection key: the score's bits (update_tx + the tie
// uniform u, one round-to-nearest add; +inf at or past the
// retransmission limit) over the column, so keys order as top_k does
__device__ __forceinline__ unsigned long long score_key(const SwimArgs& a,
                                                        int tx, float u,
                                                        int j) {
  const float s = tx < a.limit ? __fadd_rn(__int2float_rn(tx), u)
                               : __uint_as_float(INF_BITS);
  return ((unsigned long long)__float_as_uint(s) << 32) | (unsigned)j;
}

// The `take` smallest keys a warp was offered, held across its lanes:
// lane r < take keeps the r-th (~0 while empty) with its view value.
struct Taken {
  unsigned long long key = ~0ull;
  int pay = 0;
  unsigned long long bar = ~0ull;  // the take-th key: a key must be below
  int take;
  bool empty = true;  // nothing offered yet

  __device__ explicit Taken(int take_) : take(take_) {}

  // Every lane offers one key (~0 for none); returns whether any was
  // under the bar.  The first offer ranks the 32 keys by counting
  // (ties, only ~0, by lane) and hands rank r to lane r; a later one
  // shifts each key under the bar into the list, lowest lane first, at
  // the rank a ballot of the held keys gives it (a key the bar fell
  // below meanwhile ranks past the list and changes nothing).
  __device__ __forceinline__ bool offer(unsigned long long k, int v,
                                        int lane) {
    if (empty) {
      empty = false;
      int rank = 0;
#pragma unroll
      for (int o = 1; o < 32; ++o) {
        const int src = (lane + o) & 31;
        const unsigned long long y = __shfl_sync(FULL, k, src);
        rank += y < k || (y == k && src < lane);
      }
      for (int r = 0; r < take; ++r) {
        const int src = __ffs(__ballot_sync(FULL, rank == r)) - 1;
        const unsigned long long y = __shfl_sync(FULL, k, src);
        const int p = __shfl_sync(FULL, v, src);
        if (lane == r) {
          key = y;
          pay = p;
        }
      }
      bar = __shfl_sync(FULL, key, take - 1);
      return true;
    }
    unsigned cand = __ballot_sync(FULL, k < bar);
    if (!cand) return false;
    const unsigned low = (1u << take) - 1u;  // lanes 0 .. take - 1
    do {
      const int src = __ffs(cand) - 1;
      cand &= cand - 1;
      const unsigned long long x = __shfl_sync(FULL, k, src);
      const int p = __shfl_sync(FULL, v, src);
      const unsigned long long up = __shfl_up_sync(FULL, key, 1);
      const int up_pay = __shfl_up_sync(FULL, pay, 1);
      const int rank = __popc(__ballot_sync(FULL, key < x) & low);
      if (lane == rank) {
        key = x;
        pay = p;
      } else if (lane > rank) {
        key = up;
        pay = up_pay;
      }
    } while (cand);
    bar = __shfl_sync(FULL, key, take - 1);
    return true;
  }

  // Every lane offers four keys: none when no lane's least score is
  // at or under the bar's (the common case once the list fills), else
  // each lane's in ascending order until an offer finds no key under
  // the bar.
  __device__ __forceinline__ void offer4(unsigned long long (&k)[4],
                                         int (&v)[4], int lane) {
    const unsigned least =
        min(min((unsigned)(k[0] >> 32), (unsigned)(k[1] >> 32)),
            min((unsigned)(k[2] >> 32), (unsigned)(k[3] >> 32)));
    if (!__any_sync(FULL, least <= (unsigned)(bar >> 32))) return;
    sort2(k, v, 0, 1);  // a four-key sorting network
    sort2(k, v, 2, 3);
    sort2(k, v, 0, 2);
    sort2(k, v, 1, 3);
    sort2(k, v, 1, 2);
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (!offer(k[q], v[q], lane)) return;
  }

  static __device__ __forceinline__ void sort2(unsigned long long (&k)[4],
                                               int (&v)[4], int x, int y) {
    if (k[y] < k[x]) {
      const unsigned long long kt = k[x];
      const int vt = v[x];
      k[x] = k[y];
      v[x] = v[y];
      k[y] = kt;
      v[y] = vt;
    }
  }
};

template <bool B>
struct Pass {
  static constexpr bool first = B;
};

// One warp a row i.  Every lane draws i's probe target t (two hashes),
// then the warp streams the row at once: 16-byte loads of view_in and
// update_tx, a lane's next group in flight while it hashes one (a
// scalar head and tail where the row is not 16-byte aligned or N is no
// multiple of 4), each column's view value (the announces landing in
// it, the suspicion timeout) written with a 16-byte store, and its key
// offered with the value to the warp's taken list (`Taken`): once the
// list fills almost no key is under its bar, so four columns cost a
// vote.  Cells i and t are left to the prelude, which runs after the
// stream with its draws spread over the lanes (lane 0 the direct legs,
// lanes 1 and 2 the announces of i and t, every lane its share of the
// helpers once the ack is known lost), charges the messages and
// writes the two cells.  Lane r then holds the row's r-th freshest
// entry in top_k's order with its value and stores it, its sendable
// flag (its score below +inf) and its payload from registers.  A
// gossip width M above MAX_M takes ceil(M / MAX_M) passes, each later
// one offering only keys after the last one taken and reading its
// payloads back from the row written; the first pass is its own
// instantiation.  At most 64 registers, so 8 blocks (32 warps) fit an
// SM and N = 4096's rows run in one wave.  WINDOW: row il of my window
// is node i = lo + il (its cells local, its draws and ties global), its
// own outputs (target, inc1, probe, ge, sendable, pay) at il.
template <bool WINDOW>
__global__ void __launch_bounds__(SEL_WARPS * 32, 8)
swim_probe_select(const SwimArgs a) {
  // the gossip pass's draws need nothing of this kernel
  asm volatile("griddepcontrol.launch_dependents;");
  const int lane = threadIdx.x & 31;
  const int il = blockIdx.x * SEL_WARPS + (threadIdx.x >> 5);
  const int n = a.n;
  if (il >= (WINDOW ? a.nl : n)) return;  // the whole warp
  const int i = WINDOW ? a.lo + il : il;
  const size_t r0 = (size_t)il * n;  // my row's cells
  const size_t g0 = (size_t)i * n;  // its flat index in the [N, N] draw
  const int t = rand_peer(a, K_PROBE, i, i);

  // the row as a scalar head up to the first 16-byte boundary, int4
  // groups and a scalar tail; all scalar unless the three row buffers
  // share 16-byte alignment
  const bool vec = ((reinterpret_cast<uintptr_t>(a.view_in) |
                     reinterpret_cast<uintptr_t>(a.tx_in) |
                     reinterpret_cast<uintptr_t>(a.view)) & 15) == 0;
  const int head = vec ? min(n, (int)((4 - (r0 & 3)) & 3)) : n;
  const int groups = (n - head) >> 2;
  const int tail0 = head + 4 * groups;
  const int4* tx4 = reinterpret_cast<const int4*>(a.tx_in + r0 + head);
  const int4* vin4 = reinterpret_cast<const int4*>(a.view_in + r0 + head);
  int4* vout4 = reinterpret_cast<int4*>(a.view + r0 + head);

  int diag_w = 0, probe_w = 0;  // cells i and t as written
  // one pass from entry `base` on, keys <= after taken before; returns
  // the last key it takes
  auto pass = [&](auto kind, int base, unsigned long long after) {
    constexpr bool first = decltype(kind)::first;
    Taken sel(min(MAX_M, a.m - base));
    // one column: its value on the first pass (in v), its key, or ~0
    // where an earlier pass took it
    auto column = [&](int j, int& v, int tx, float u) {
      if (first) v = expire(a, r0 + j, announced<WINDOW>(a, i, j, v));
      const unsigned long long key = score_key(a, tx, u, j);
      return first || key > after ? key : ~0ull;
    };
    // columns lo .. hi - 1, a lane each
    auto scalars = [&](int lo, int hi) {
      for (int j0 = lo; j0 < hi; j0 += 32) {
        const int j = j0 + lane;
        unsigned long long key = ~0ull;
        int v = 0;
        if (j < hi) {
          const size_t c = r0 + j;
          if (first) v = __ldg(a.view_in + c);
          key = column(j, v, __ldg(a.tx_in + c), tie_uniform(a, g0 + j));
          if (first && j != i && j != t) a.view[c] = v;
        }
        sel.offer(key, v, lane);  // the warp converged
      }
    };

    scalars(0, head);
    const int4 none = make_int4(0, 0, 0, 0);
    int4 ntx = none, nv = none;
    if (lane < groups) {
      ntx = __ldg(tx4 + lane);
      if (first) nv = __ldg(vin4 + lane);
    }
    for (int g = lane; g - lane < groups; g += 32) {
      const int4 tx = ntx, v = nv;
      if (g + 32 < groups) {
        ntx = __ldg(tx4 + g + 32);
        if (first) nv = __ldg(vin4 + g + 32);
      }
      const int j0 = head + 4 * g;
      int w[4] = {v.x, v.y, v.z, v.w};
      unsigned long long k[4] = {~0ull, ~0ull, ~0ull, ~0ull};
      if (g < groups) {  // idle lanes of the last sweep offer nothing
        const size_t c = g0 + j0;
        // the four hashes first, side by side, then the columns
        const float u0 = tie_uniform(a, c), u1 = tie_uniform(a, c + 1);
        const float u2 = tie_uniform(a, c + 2), u3 = tie_uniform(a, c + 3);
        k[0] = column(j0, w[0], tx.x, u0);
        k[1] = column(j0 + 1, w[1], tx.y, u1);
        k[2] = column(j0 + 2, w[2], tx.z, u2);
        k[3] = column(j0 + 3, w[3], tx.w, u3);
        if (first) {
          if ((unsigned)(i - j0) < 4u || (unsigned)(t - j0) < 4u) {
#pragma unroll
            for (int q = 0; q < 4; ++q)
              if (j0 + q != i && j0 + q != t) a.view[r0 + j0 + q] = w[q];
          } else {
            vout4[g] = make_int4(w[0], w[1], w[2], w[3]);
          }
        }
      }
      sel.offer4(k, w, lane);
    }
    scalars(tail0, n);

    if constexpr (first) {
      // the prelude (:128-197): every draw a pure function of the
      // tick's inputs, spread over the lanes
      const bool al = __ldg(a.alive + i);
      const bool alive_t = __ldg(a.alive + t);
      bool leg1 = true, leg2 = true;
      Announce own{0, 0, -1}, at{0, 0, -1};
      if (lane == 0) {
        leg1 = leg_ok(a, K_LOSS1, i);
        leg2 = leg_ok(a, K_LOSS2, i);
      } else if (lane == 1) {
        own = announce<WINDOW>(a, i);
      } else if (lane == 2) {
        at = announce<WINDOW>(a, t);
      }
      leg1 = __shfl_sync(FULL, (int)leg1, 0);
      leg2 = __shfl_sync(FULL, (int)leg2, 0);
      // direct probe (:157-164)
      const bool ping_ok = al && leg1 && alive_t;
      const bool ack_ok = ping_ok && leg2;
      // indirect probes (:166-185): each live helper charged one
      // message for its ping, the legs of each drawn at once
      int indirect = 0;
      if (!ack_ok && al) {
        for (int q = lane; q < a.h; q += 32) {
          const unsigned long long idx = (unsigned long long)i * a.h + q;
          const int helper = rand_peer(a, K_HELP, idx, i);
          if (!__ldg(a.alive + helper)) continue;
          atomicAdd(a.msgs + helper, 1);
          indirect += alive_t & leg_ok(a, K_HLOSS, 4 * idx) &
                      leg_ok(a, K_HLOSS, 4 * idx + 1) &
                      leg_ok(a, K_HLOSS, 4 * idx + 2) &
                      leg_ok(a, K_HLOSS, 4 * idx + 3);
        }
        indirect = __reduce_add_sync(FULL, indirect);
      }
      own.inc1 = __shfl_sync(FULL, own.inc1, 1);
      own.diag = __shfl_sync(FULL, own.diag, 1);
      own.seed = __shfl_sync(FULL, own.seed, 1);
      at.inc1 = __shfl_sync(FULL, at.inc1, 2);
      at.diag = __shfl_sync(FULL, at.diag, 2);
      at.seed = __shfl_sync(FULL, at.seed, 2);
      if (lane == 0) {
        int charge = 0;  // messages node i sends this tick
        if (a.revived != nullptr && __ldg(a.revived + i)) {
          charge += 1;  // the announce
          if (own.seed >= 0) atomicAdd(a.msgs + own.seed, 1);  // its ack
        }
        charge += al;
        if (ping_ok) atomicAdd(a.pinged + t, 1);
        // t's acks: the direct one and the relayed ones
        if (ping_ok + indirect) atomicAdd(a.msgs + t, ping_ok + indirect);
        bool probe_ok = ack_ok;
        if (!ack_ok && al) {
          // the reference charges the client one message for its
          // ping-reqs (its [N, 1] `tried`, summed over one column)
          charge += 1;
          probe_ok = indirect > 0;
        }
        charge += al * a.g;  // gossip messages (:235)
        if (charge) atomicAdd(a.msgs + i, charge);
        // the probe outcome on view[i, t] (:187-197), over the input
        // cell with t's announce landing in it
        int cur = __ldg(a.view_in + r0 + t);
        if (at.seed == i) cur = max(cur, at.diag);
        int upd = cur;
        if (probe_ok && al) upd = max(cur, at.inc1 * 4 + ALIVE);
        if (!probe_ok && al && cur % 4 == ALIVE)
          upd = max(cur, (cur / 4) * 4 + SUSPECT);
        a.target[il] = t;
        a.inc1[il] = own.inc1;
        a.probe[il] = (ping_ok ? PING_OK : 0) | (ack_ok ? ACK_OK : 0);
        diag_w = expire(a, r0 + i, own.diag);
        probe_w = expire(a, r0 + t, upd);
        a.view[r0 + i] = diag_w;
        a.view[r0 + t] = probe_w;
      }
      diag_w = __shfl_sync(FULL, diag_w, 0);
      probe_w = __shfl_sync(FULL, probe_w, 0);
    }

    if (lane < sel.take) {
      const int j = (int)(sel.key & 0xffffffffu);
      int p = sel.pay;
      if (!first) p = a.view[r0 + j];
      else if (j == i) p = diag_w;
      else if (j == t) p = probe_w;
      const size_t o = (size_t)il * a.m + base + lane;
      a.ge[o] = j;
      a.sendable[o] = (unsigned)(sel.key >> 32) != INF_BITS;
      a.pay[o] = p;
    }
    return __shfl_sync(FULL, sel.key, sel.take - 1);
  };

  unsigned long long after = pass(Pass<true>{}, 0, 0);
  for (int base = MAX_M; base < a.m; base += MAX_M) {
    __syncwarp();  // the row this warp wrote is read back
    after = pass(Pass<false>{}, base, after);
  }
}

// The dissemination (:204-275, the view's part), one host call: two
// kernels chained by programmatic dependent launch:
//
//   swim_spread  the gossip pass and the ping piggyback, a thread a
//                (node, gossip target, entry) (a (node, entry) without
//                gossip targets);
//   swim_ack     the ack piggyback, a thread a (node, entry): target
//                t's selection as the ping pass left it into
//                view[i, ge[t, m]].
//
// The work is tiny (about 120,000 scattered cells at N = 4096); what
// costs is each kernel's launch, ramp and tail, a host call each, and
// reading a pass's payload: the reference re-reads the selected cells
// of the whole view after each pass (:253, :268), random cells of a
// view larger than L2.  Here no kernel reads the view.
//
// The gossip and the ping pass need no boundary between them: every
// value either scatters is the selection's payload (pay, fixed before
// the dissemination) or a max of such values, and scatter-max is order
// free.  The ping sends a selected cell as the gossip pass left it:
// the cell's own payload, sent by its entry's thread, and each gossip
// raise of it, carried on to the probe target by the gossip thread
// that made it (where the cell is a sendable selected entry of a node
// whose ping went through; a row's selected columns are distinct).
// The ack pass sends a selected cell as the ping pass left it, which
// holds raises from other nodes' threads, so it waits for them: every
// raise of a selected cell also raises that cell's shadow in ack_pay
// (order keys, order_key, so a zeroed shadow lies below every record),
// which the first kernel seeds with the selection's payload.
//
// Each kernel first does what needs nothing of the kernel before it
// (index math, the gossip legs' draws under K_GT and K_GLOSS and the
// live flags; in swim_ack the selection's loads and the view cell's
// prefetch into L2), then waits (griddepcontrol.wait: the kernel before
// it has finished and its writes are visible), then lets the next
// kernel launch.  swim_spread's draws overlap swim_probe_select, which
// lets it launch at once, and it releases swim_ack only after its own
// wait, so swim_ack's prelude runs once the selection is complete.
// Loads of what the chain writes bypass L1 (__ldcg), and each thread
// makes its loads before its first atomic, so their round trips
// overlap.

__device__ __forceinline__ void wait_prior() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

__device__ __forceinline__ void release_next() {
  asm volatile("griddepcontrol.launch_dependents;");
}

__device__ __forceinline__ long long thread_index() {
  return (long long)blockIdx.x * DIS_THREADS + threadIdx.x;
}

// an int's order as an unsigned (INT_MIN -> 0)
__device__ __forceinline__ unsigned order_key(int v) {
  return (unsigned)v ^ 0x80000000u;
}

// the selection entry of `row` whose column is col (q = -1: none) and
// its sendable flag; columns and flags loaded 8 at a time, so their L2
// round trips overlap
struct Entry {
  int q = -1;
  bool sendable = false;
};

__device__ __forceinline__ Entry entry_of(const SwimArgs& a, int row,
                                          int col) {
  const size_t r0 = (size_t)row * a.m;
  for (int q0 = 0; q0 < a.m; q0 += 8) {
    int c[8];
    unsigned char f[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const bool on = q0 + k < a.m;
      c[k] = on ? __ldcg(a.ge + r0 + q0 + k) : -1;
      f[k] = on ? __ldcg(a.sendable + r0 + q0 + k) : 0;
    }
#pragma unroll
    for (int k = 0; k < 8; ++k)
      if (c[k] == col) return Entry{q0 + k, f[k] != 0};
  }
  return Entry{};
}

// cell (row, col) of the view raised to v, and its ack shadow where
// col is row's selected entry q
__device__ __forceinline__ void raise_cell(const SwimArgs& a, int row,
                                           int col, int q, int v) {
  atomicMax(a.view + cell(a.n, row, col), v);
  if (q >= 0) atomicMax(a.ack_pay + (size_t)row * a.m + q, order_key(v));
}

__global__ void __launch_bounds__(DIS_THREADS) swim_spread(const SwimArgs a,
                                                          int gossip) {
  const long long e = thread_index();
  const int legs = gossip ? a.g : 1;  // threads an entry
  const int per = legs * a.m;
  const bool in = e < (long long)a.n * per;
  int i = 0, mm = 0, gg = 0, dest = -1;
  if (in) {
    i = (int)(e / per);
    const int slot = (int)(e - (long long)i * per);
    gg = slot / a.m;
    mm = slot - gg * a.m;
    if (gossip && __ldg(a.alive + i)) {
      const unsigned long long idx = (unsigned long long)i * a.g + gg;
      const int d = rand_peer(a, K_GT, idx, i);
      if (__ldg(a.alive + d) && leg_ok(a, K_GLOSS, idx * a.m + mm))
        dest = d;
    }
  }
  wait_prior();
  release_next();
  if (!in) return;
  // the loads first, each round trip's together: the entry, both
  // nodes' probe flags and targets; then the three searches
  const size_t o = (size_t)i * a.m + mm;
  const int d = dest >= 0 ? dest : i;
  const int v = __ldcg(a.pay + o), col = __ldcg(a.ge + o);
  const bool sent = __ldcg(a.sendable + o);
  const unsigned char probe_i = __ldcg(a.probe + i);
  const unsigned char probe_d = __ldcg(a.probe + d);
  const int t = __ldcg(a.target + i), t2 = __ldcg(a.target + d);
  // i's ping of this entry (gg = 0's thread) and the gossip leg to
  // dest, carried on by dest's ping
  const bool ping = gg == 0 && sent && (probe_i & PING_OK);
  const bool leg = dest >= 0 && sent;
  const bool dest_ping = leg && (probe_d & PING_OK);
  const int q_t = ping ? entry_of(a, t, col).q : -1;
  const Entry at_d = leg ? entry_of(a, d, col) : Entry{};
  const int q_t2 = dest_ping ? entry_of(a, t2, col).q : -1;
  if (gg == 0) atomicMax(a.ack_pay + o, order_key(v));  // the seed
  if (ping) raise_cell(a, t, col, q_t, v);
  if (leg) raise_cell(a, d, col, at_d.q, v);
  if (dest_ping && at_d.sendable) raise_cell(a, t2, col, q_t2, v);
}

// entry e = i * M + m's ack leg: target t's entry m (src = t * M + m)
// sent into cell (i, col) when i's ack came back
struct Leg {
  bool ok = false;
  int col = 0;
  size_t src = 0;
};

__device__ __forceinline__ Leg ack_leg(const SwimArgs& a, long long e) {
  Leg l;
  if (e >= (long long)a.n * a.m) return l;
  const int i = (int)(e / a.m);
  if (!(__ldcg(a.probe + i) & ACK_OK)) return l;
  const int t = __ldcg(a.target + i);
  l.src = (size_t)t * a.m + (e - (long long)i * a.m);
  l.ok = __ldcg(a.sendable + l.src);
  if (l.ok) l.col = __ldcg(a.ge + l.src);
  return l;
}

__global__ void __launch_bounds__(DIS_THREADS) swim_ack(const SwimArgs a) {
  const long long e = thread_index();
  const Leg l = ack_leg(a, e);
  int* c = a.view + cell(a.n, (int)(e / a.m), l.col);
  if (l.ok) asm volatile("prefetch.global.L2 [%0];" ::"l"(c));
  wait_prior();
  release_next();
  if (l.ok) atomicMax(c, (int)(__ldcg(a.ack_pay + l.src) ^ 0x80000000u));
}

// WINDOW: block il is my row il, node i = lo + il; the probed peer's
// record of it comes summed over the shards (peer_rec), the selection,
// targets and pings gathered (indexed by i), inc1 mine (by il)
template <bool WINDOW>
__global__ void __launch_bounds__(THREADS) swim_settle(const SwimArgs a) {
  __shared__ int s_diag, s_charge;
  wait_prior();  // launched behind swim_ack
  const int il = blockIdx.x;
  const int i = WINDOW ? a.lo + il : il;
  const int n = a.n;
  if (threadIdx.x == 0) {
    // refutation / renewal (:277-304)
    const int t = a.target[i];
    const bool al = a.alive[i];
    const int self_key = a.view[cell(n, il, i)];
    const int peer_rec = WINDOW ? a.peer_rec[i] : a.view[cell(n, t, i)];
    const bool told = al && a.alive[t] && peer_rec % 4 == DOWN &&
                      leg_ok(a, K_TU, 2ull * i) &&
                      leg_ok(a, K_TU, 2ull * i + 1);
    const int offending = max(self_key, told ? peer_rec : 0);
    const bool offended = al && (self_key % 4 != ALIVE || told);
    const int inc1 = a.inc1[il];
    const int new_inc =
        offended ? offending / 4 + 1 : max(inc1, self_key / 4);
    const int inc = max(inc1, new_inc);
    a.inc[il] = inc;
    s_diag = al ? inc * 4 + ALIVE : self_key;
    // backlog rounds of each sendable selected entry (:236-275)
    s_charge = 2 * al + a.pinged[i];
    if (a.flags != nullptr && i != a.victim) {
      const int st = a.view[cell(n, il, a.victim)] % 4;
      if (st == DOWN) atomicAdd(a.flags, 1);
      if (st == ALIVE) atomicAdd(a.flags + 1, 1);
    }
  }
  __syncthreads();
  for (int j = threadIdx.x; j < n; j += THREADS) {
    const size_t c = cell(n, il, j);
    int v = a.view[c];
    if (j == i) {
      v = s_diag;
      a.view[c] = v;
    }
    // suspect_since (:306-311)
    const bool now_suspect = v % 4 == SUSPECT;
    const int ss = a.ss_in[c];
    a.ss[c] = now_suspect ? (ss == NEVER ? a.tick : ss) : NEVER;
    // the reset of changed records (:313-314); the charges follow
    a.tx[c] = v != a.view_in[c] ? 0 : a.tx_in[c];
  }
  __syncthreads();
  // backlog charges of the row's sendable selected entries (distinct
  // columns, top_k's indices), where the record did not change
  for (int r = threadIdx.x; r < a.m; r += THREADS) {
    const size_t o = (size_t)i * a.m + r;
    if (!a.sendable[o]) continue;
    const size_t c = cell(n, il, a.ge[o]);
    if (a.view[c] == a.view_in[c]) a.tx[c] += s_charge;
  }
}

// -- the window form's dissemination passes (each raise lands in my rows)

__device__ __forceinline__ bool is_mine(const SwimArgs& a, int row) {
  return row >= a.lo && row < a.lo + a.nl;
}

// the gossip pass, a thread a (node i of all N, gossip target, entry)
__global__ void __launch_bounds__(DIS_THREADS) swim_gossip_w(const SwimArgs a) {
  const long long e = thread_index();
  const int per = a.g * a.m;
  if (e >= (long long)a.n * per) return;
  const int i = (int)(e / per);
  const int slot = (int)(e - (long long)i * per);
  const int gg = slot / a.m, mm = slot - gg * a.m;
  if (!__ldg(a.alive + i)) return;
  const unsigned long long idx = (unsigned long long)i * a.g + gg;
  const int d = rand_peer(a, K_GT, idx, i);
  if (!is_mine(a, d) || !__ldg(a.alive + d)) return;
  const size_t o = (size_t)i * a.m + mm;
  if (!__ldg(a.sendable + o) || !leg_ok(a, K_GLOSS, idx * a.m + mm)) return;
  atomicMax(a.view + cell(a.n, d - a.lo, __ldg(a.ge + o)), __ldg(a.pay + o));
}

// the ping piggyback, a thread a (prober i of all N, entry)
__global__ void __launch_bounds__(DIS_THREADS) swim_ping_w(const SwimArgs a) {
  const long long e = thread_index();
  if (e >= (long long)a.n * a.m) return;
  const int i = (int)(e / a.m);
  if (!(__ldg(a.probe + i) & PING_OK) || !__ldg(a.sendable + e)) return;
  const int t = __ldg(a.target + i);
  if (!is_mine(a, t)) return;
  atomicMax(a.view + cell(a.n, t - a.lo, __ldg(a.ge + e)), __ldg(a.sent + e));
}

// the ack piggyback, a thread a (prober of mine, entry of its target)
__global__ void __launch_bounds__(DIS_THREADS) swim_ack_w(const SwimArgs a) {
  const long long e = thread_index();
  if (e >= (long long)a.nl * a.m) return;
  const int il = (int)(e / a.m);
  const int i = a.lo + il;
  if (!(__ldg(a.probe + i) & ACK_OK)) return;
  const size_t src = (size_t)__ldg(a.target + i) * a.m + (e - (long long)il * a.m);
  if (!__ldg(a.sendable + src)) return;
  atomicMax(a.view + cell(a.n, il, __ldg(a.ge + src)), __ldg(a.sent + src));
}

// my rows' selected cells as the pass before left them
__global__ void __launch_bounds__(DIS_THREADS)
    swim_collect_w(const SwimArgs a) {
  const long long e = thread_index();
  if (e >= (long long)a.nl * a.m) return;
  const int il = (int)(e / a.m);
  const int col = __ldg(a.ge + (size_t)a.lo * a.m + e);
  a.sent_out[e] = a.view[cell(a.n, il, col)];
}

// each prober's record at its target, where the target row is mine
__global__ void __launch_bounds__(DIS_THREADS)
    swim_peer_rec_w(const SwimArgs a) {
  const long long i = thread_index();
  if (i >= a.n) return;
  const int t = __ldg(a.target + i);
  a.peer_rec_out[i] = is_mine(a, t) ? a.view[cell(a.n, t - a.lo, (int)i)] : 0;
}

unsigned blocks_for(long long work, int threads) {
  return (unsigned)((work + threads - 1) / threads);
}

// a launch under programmatic dependent launch: its blocks may start
// while the kernel before it in the stream runs, up to its
// griddepcontrol.wait
template <typename Kernel, typename... Args>
cudaError_t launch_after(Kernel kernel, unsigned blocks, int threads,
                         cudaStream_t st, Args&&... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(threads);
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, std::forward<Args>(args)...);
}

// the dissemination's two chained kernels
cudaError_t disseminate(const SwimArgs& a, bool gossip, cudaStream_t st) {
  const long long entries = (long long)a.n * a.m;
  cudaError_t err = launch_after(
      swim_spread, blocks_for(entries * (gossip ? a.g : 1), DIS_THREADS),
      DIS_THREADS, st, a, (int)gossip);
  if (err == cudaSuccess)
    err = launch_after(swim_ack, blocks_for(entries, DIS_THREADS),
                       DIS_THREADS, st, a);
  return err;
}

}  // namespace

// keys: K_WORDS uint32 words (host memory), copied into the launch's
// argument block; flags may be null (no churn victim); pinged ([N])
// and ack_pay ([N, M]) come zeroed
extern "C" int swim_launch(
    const void* view_in, const void* ss_in, const void* inc_in,
    const void* tx_in, const void* alive, const void* revived, void* view,
    void* ss, void* inc, void* msgs, void* tx, void* target, void* inc1,
    void* probe, void* pinged, void* ge, void* sendable, void* pay,
    void* ack_pay, void* flags, int n, int h, int g, int m, int timeout,
    int limit, int tick, int victim, float loss, unsigned span, unsigned mult,
    const unsigned* keys, int phase, void* stream) {
  // phase: 0 swim_probe_select; 1 the dissemination with its gossip
  // pass, 2 without; 3 swim_settle
  if (n <= 1 || m < 1 || m > n || h < 0 || g < 0 || span == 0 || tick < 0)
    return (int)cudaErrorInvalidValue;
  SwimArgs a;
  a.view_in = static_cast<const int*>(view_in);
  a.ss_in = static_cast<const int*>(ss_in);
  a.inc_in = static_cast<const int*>(inc_in);
  a.tx_in = static_cast<const int*>(tx_in);
  a.alive = static_cast<const unsigned char*>(alive);
  a.revived = static_cast<const unsigned char*>(revived);
  a.view = static_cast<int*>(view);
  a.ss = static_cast<int*>(ss);
  a.inc = static_cast<int*>(inc);
  a.msgs = static_cast<int*>(msgs);
  a.tx = static_cast<int*>(tx);
  a.target = static_cast<int*>(target);
  a.inc1 = static_cast<int*>(inc1);
  a.probe = static_cast<unsigned char*>(probe);
  a.pinged = static_cast<int*>(pinged);
  a.ack_pay = static_cast<unsigned*>(ack_pay);
  a.ge = static_cast<int*>(ge);
  a.sendable = static_cast<unsigned char*>(sendable);
  a.pay = static_cast<int*>(pay);
  a.flags = static_cast<int*>(flags);
  a.diag_in = nullptr;
  a.peer_rec = nullptr;
  a.sent = nullptr;
  a.sent_out = nullptr;
  a.peer_rec_out = nullptr;
  a.lo = 0;
  a.nl = n;
  a.n = n;
  a.h = h;
  a.g = g;
  a.m = m;
  a.timeout = timeout;
  a.limit = limit;
  a.tick = tick;
  a.victim = victim;
  a.loss = loss;
  a.lossy = loss > 0.0f;
  a.span = span;
  a.mult = mult;
  for (int w = 0; w < K_WORDS; ++w) a.k[w] = keys[w];
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (phase) {
    case 0:
      swim_probe_select<false><<<(n + SEL_WARPS - 1) / SEL_WARPS,
                                  SEL_WARPS * 32, 0, st>>>(a);
      return (int)cudaGetLastError();
    case 1:  // the dissemination with its gossip pass (gossip targets)
      if (g < 1) return (int)cudaErrorInvalidValue;
      // fall through
    case 2:  // without it
      return (int)disseminate(a, phase == 1, st);
    case 3:
      return (int)launch_after(swim_settle<false>, (unsigned)n, THREADS, st,
                               a);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// One phase of the window form (kernels/swim.py WindowCall): pointers as
// the phase reads them (kernels/swim.py _WINDOW_POINTERS), null where it
// reads none.  phase: 0 W_SELECT; 1 W_GOSSIP (the gossip pass, then the
// read-back); 2 W_COLLECT (the read-back alone: no gossip targets);
// 3 W_PING (the ping pass, then the read-back); 4 W_ACK (the ack pass,
// then the records at the targets into peer_rec); 5 W_SETTLE.
extern "C" int swim_window_launch(
    const void* view_in, const void* ss_in, const void* inc_in,
    const void* diag_in, const void* tx_in, const void* alive,
    const void* revived, void* view, void* ss, void* inc, void* msgs,
    void* pinged, void* tx, void* target, void* inc1, void* probe, void* ge,
    void* sendable, void* pay, void* sent, void* sent_out, void* peer_rec,
    void* flags, int n, int nl, int lo, int h, int g, int m, int timeout,
    int limit, int tick, int victim, float loss, unsigned span, unsigned mult,
    const unsigned* keys, int phase, void* stream) {
  if (n <= 1 || m < 1 || m > n || h < 0 || g < 0 || span == 0 || tick < 0 ||
      nl < 1 || lo < 0 || lo + nl > n)
    return (int)cudaErrorInvalidValue;
  SwimArgs a;
  a.view_in = static_cast<const int*>(view_in);
  a.ss_in = static_cast<const int*>(ss_in);
  a.inc_in = static_cast<const int*>(inc_in);
  a.tx_in = static_cast<const int*>(tx_in);
  a.alive = static_cast<const unsigned char*>(alive);
  a.revived = static_cast<const unsigned char*>(revived);
  a.view = static_cast<int*>(view);
  a.ss = static_cast<int*>(ss);
  a.inc = static_cast<int*>(inc);
  a.msgs = static_cast<int*>(msgs);
  a.tx = static_cast<int*>(tx);
  a.target = static_cast<int*>(target);
  a.inc1 = static_cast<int*>(inc1);
  a.probe = static_cast<unsigned char*>(probe);
  a.pinged = static_cast<int*>(pinged);
  a.ack_pay = nullptr;
  a.ge = static_cast<int*>(ge);
  a.sendable = static_cast<unsigned char*>(sendable);
  a.pay = static_cast<int*>(pay);
  a.flags = static_cast<int*>(flags);
  a.diag_in = static_cast<const int*>(diag_in);
  a.peer_rec = static_cast<const int*>(peer_rec);
  a.sent = static_cast<const int*>(sent);
  a.sent_out = static_cast<int*>(sent_out);
  a.peer_rec_out = static_cast<int*>(peer_rec);
  a.lo = lo;
  a.nl = nl;
  a.n = n;
  a.h = h;
  a.g = g;
  a.m = m;
  a.timeout = timeout;
  a.limit = limit;
  a.tick = tick;
  a.victim = victim;
  a.loss = loss;
  a.lossy = loss > 0.0f;
  a.span = span;
  a.mult = mult;
  for (int w = 0; w < K_WORDS; ++w) a.k[w] = keys[w];
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long rows = (long long)nl * m, all = (long long)n * m;
  switch (phase) {
    case 0:
      swim_probe_select<true><<<(nl + SEL_WARPS - 1) / SEL_WARPS,
                                 SEL_WARPS * 32, 0, st>>>(a);
      break;
    case 1:
      if (g < 1) return (int)cudaErrorInvalidValue;
      swim_gossip_w<<<blocks_for(all * g, DIS_THREADS), DIS_THREADS, 0, st>>>(
          a);
      // fall through: the read-back
    case 2:
      swim_collect_w<<<blocks_for(rows, DIS_THREADS), DIS_THREADS, 0, st>>>(a);
      break;
    case 3:
      swim_ping_w<<<blocks_for(all, DIS_THREADS), DIS_THREADS, 0, st>>>(a);
      swim_collect_w<<<blocks_for(rows, DIS_THREADS), DIS_THREADS, 0, st>>>(a);
      break;
    case 4:
      swim_ack_w<<<blocks_for(rows, DIS_THREADS), DIS_THREADS, 0, st>>>(a);
      swim_peer_rec_w<<<blocks_for(n, DIS_THREADS), DIS_THREADS, 0, st>>>(a);
      break;
    case 5:
      swim_settle<true><<<nl, THREADS, 0, st>>>(a);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
