// swim: one SWIM protocol period for every node, as four kernels run
// in order (seven launches a tick).
//
// Replaces corrosion_tpu/models/swim.py swim_step (:107-316) and the
// per-tick detection flags of corrosion_tpu/sim/churn.py _scan_chunk
// (:86-90).  The reference runs a chain of whole-matrix phases on
// [N, N] int32 leaves (view packed as incarnation * 4 + state,
// suspect_since, update_tx); each phase reads what the previous one
// wrote to other rows, so the phases are separate launches:
//
//   swim_probe_select  one block per row i.  Thread 0 runs node i's
//       rejoin announce, draws its probe target t and replays t's
//       announce (every announce is a pure function of the tick's
//       inputs, so no launch has to publish it first), runs the direct
//       ping and the H indirect legs, charges every message of the row
//       (announce, ping, acks, ping-reqs, gossip) with integer
//       atomicAdds, and counts i's delivered ping at t.  The block then
//       writes row i of the view: the input row with the announce
//       records landing in it, the probe outcome at t and the
//       suspect -> down timeout applied.  Each thread scores its
//       columns (update_tx + the tie uniform drawn in-register at
//       counter i * N + j, one round-to-nearest add; +inf at or past the
//       retransmission limit) into a sorted register list of
//       (score, index) keys, MAX_M deep, a key past the list's last
//       skipping the insert; MAX_M block-wide minimum rounds pick the
//       freshest entries in the reference's top_k order (score, then
//       lower index), and a gossip width M above MAX_M takes
//       ceil(M / MAX_M) such passes, each keeping only keys after the
//       last one taken.  It stores them with their sendable flags and
//       their gossip payload, read back from the row it just wrote.
//   swim_spread  one thread per (node, target, entry): the gossip pass
//       (mode 0) scatters with atomicMax into the gossip targets' rows;
//       the ping piggyback (mode 1) into the probe target's row; the
//       ack piggyback (mode 2) into the prober's row, carrying the
//       target's entries.
//   swim_gather  re-reads every row's selected entries into the
//       payload buffer between two spread passes: a pass sends what
//       the view held after the previous pass finished and before any
//       thread of its own pass scattered, as the reference's gathers
//       on the whole view do (:226, :253, :268).
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
// Every draw is jax.random's partitionable threefry at the
// reference's flat index (common.cuh): rand_peers' randint under the
// two split keys, the loss uniforms only when loss > 0 (the reference
// draws nothing then).  Outputs go to fresh buffers; msgs_out arrives
// holding a copy of msgs and pinged zeroed.
//
// Bound on the H100: bytes — the three [N, N] inputs read once and the
// three outputs written once (0.40 GB a tick at N = 4096); the N^2 tie
// uniforms (42 INT32-pipe operations each) come second.  The design
// reads each input matrix in two passes (select, settle) and writes
// each output once; the spread passes touch O(N * G * M) cells.

#include <cstdint>
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int ALIVE = 0, SUSPECT = 1, DOWN = 2;
constexpr int NEVER = 0x7fffffff;
constexpr int MAX_M = 8;  // entries one selection pass takes
constexpr int THREADS = 256;
constexpr unsigned FULL = 0xffffffffu;
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
  int* ge;  // [N, M]
  unsigned char* sendable;  // [N, M]
  int* pay;  // [N, M]
  int* flags;  // [2] or null: others' DOWN / ALIVE records of victim
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
__device__ Announce announce(const SwimArgs& a, int j) {
  Announce r;
  r.inc1 = a.inc_in[j];
  r.diag = a.view_in[cell(a.n, j, j)];
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

__device__ __forceinline__ unsigned long long umin64(unsigned long long x,
                                                     unsigned long long y) {
  return x < y ? x : y;
}

__global__ void __launch_bounds__(THREADS)
swim_probe_select(const SwimArgs a) {
  __shared__ int s_diag, s_target, s_probe;
  __shared__ unsigned long long s_warp[THREADS / 32];
  __shared__ unsigned long long s_sel[MAX_M];
  const int i = blockIdx.x;
  const int n = a.n;

  if (threadIdx.x == 0) {
    const Announce own = announce(a, i);
    const bool al = a.alive[i];
    int charge = 0;  // messages node i sends this tick
    if (a.revived != nullptr && a.revived[i]) {
      charge += 1;  // the announce
      if (own.seed >= 0) atomicAdd(a.msgs + own.seed, 1);  // its ack
    }
    // direct probe (:157-164)
    const int t = rand_peer(a, K_PROBE, i, i);
    const bool ping_ok = al && leg_ok(a, K_LOSS1, i) && a.alive[t];
    const bool ack_ok = ping_ok && leg_ok(a, K_LOSS2, i);
    charge += al;
    if (ping_ok) {
      atomicAdd(a.msgs + t, 1);
      atomicAdd(a.pinged + t, 1);
    }
    // indirect probes (:166-185)
    bool probe_ok = ack_ok;
    if (!ack_ok && al) {
      // the reference charges the client one message for its
      // ping-reqs (its [N, 1] `tried`, summed over one column) and each
      // live helper one for its ping
      charge += 1;
      int indirect = 0;
      for (int q = 0; q < a.h; ++q) {
        const unsigned long long idx = (unsigned long long)i * a.h + q;
        const int helper = rand_peer(a, K_HELP, idx, i);
        if (!a.alive[helper]) continue;
        atomicAdd(a.msgs + helper, 1);
        bool legs = a.alive[t];
        for (int l = 0; l < 4 && legs; ++l) legs = leg_ok(a, K_HLOSS, 4 * idx + l);
        indirect += legs;
      }
      if (indirect) atomicAdd(a.msgs + t, indirect);
      probe_ok = indirect > 0;
    }
    charge += al * a.g;  // gossip messages (:235)
    if (charge) atomicAdd(a.msgs + i, charge);
    // the probe outcome on view[i, t] (:187-197), over the input cell
    // with t's announce landing in it
    const Announce at = announce(a, t);
    int cur = a.view_in[cell(n, i, t)];
    if (at.seed == i) cur = max(cur, at.diag);
    int upd = cur;
    if (probe_ok && al) upd = max(cur, at.inc1 * 4 + ALIVE);
    if (!probe_ok && al && cur % 4 == ALIVE)
      upd = max(cur, (cur / 4) * 4 + SUSPECT);
    a.target[i] = t;
    a.inc1[i] = own.inc1;
    a.probe[i] = (ping_ok ? PING_OK : 0) | (ack_ok ? ACK_OK : 0);
    s_diag = own.diag;
    s_target = t;
    s_probe = upd;
  }
  __syncthreads();
  const int t = s_target;

  // row i of the view (written on the first pass), then the M freshest
  // entries in passes of at most MAX_M: each thread keeps its MAX_M
  // smallest (score, index) keys strictly after the last key the
  // previous pass took, and MAX_M block-wide minimum rounds pop them in
  // the reference's top_k order (score, then lower index).  The keys
  // are unique and totally ordered, so ceil(M / MAX_M) passes give the
  // exact top M.
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned long long after = 0;  // keys <= after were taken
  for (int base = 0; base < a.m; base += MAX_M) {
    const int take = min(MAX_M, a.m - base);
    unsigned long long best[MAX_M];
#pragma unroll
    for (int q = 0; q < MAX_M; ++q) best[q] = ~0ull;
    for (int j = threadIdx.x; j < n; j += THREADS) {
      const size_t c = cell(n, i, j);
      if (base == 0) {
        int v = a.view_in[c];
        if (j == i) {
          v = s_diag;
        } else if (j == t) {
          v = s_probe;
        } else if (a.revived != nullptr && a.revived[j]) {
          const Announce aj = announce(a, j);
          if (aj.seed == i) v = max(v, aj.diag);
        }
        if (v % 4 == SUSPECT && a.tick - a.ss_in[c] >= a.timeout)
          v = (v / 4) * 4 + DOWN;
        a.view[c] = v;
      }
      const int tx = a.tx_in[c];
      float score = __int_as_float(0x7f800000);  // +inf
      if (tx < a.limit)
        score = __fadd_rn(__int2float_rn(tx),
                          common::uniform_of(common::threefry_xor(
                              a.k[K_GE], a.k[K_GE + 1], c)));
      unsigned long long key =
          ((unsigned long long)__float_as_uint(score) << 32) | (unsigned)j;
      if (base > 0 && key <= after) continue;
      if (key < best[MAX_M - 1]) {
#pragma unroll
        for (int q = 0; q < MAX_M; ++q) {  // sorted insert
          const unsigned long long lo = umin64(key, best[q]);
          key = key ^ best[q] ^ lo;
          best[q] = lo;
        }
      }
    }
    // `take` rounds of a block-wide minimum over the threads' heads
    for (int r = 0; r < take; ++r) {
      unsigned long long x = best[0];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        x = umin64(x, __shfl_xor_sync(FULL, x, o));
      if (lane == 0) s_warp[warp] = x;
      __syncthreads();
      unsigned long long win = s_warp[0];
      for (int w = 1; w < THREADS / 32; ++w) win = umin64(win, s_warp[w]);
      if (best[0] == win) {  // keys are unique: one thread pops
#pragma unroll
        for (int q = 0; q + 1 < MAX_M; ++q) best[q] = best[q + 1];
        best[MAX_M - 1] = ~0ull;
      }
      if (threadIdx.x == 0) s_sel[r] = win;
      __syncthreads();
    }
    after = s_sel[take - 1];
    if (threadIdx.x < take) {
      const int j = (int)(s_sel[threadIdx.x] & 0xffffffffu);
      const size_t c = cell(n, i, j);
      const size_t o = (size_t)i * a.m + base + threadIdx.x;
      a.ge[o] = j;
      a.sendable[o] = a.tx_in[c] < a.limit;
      a.pay[o] = a.view[c];  // written by this block before the barrier
    }
    __syncthreads();  // s_sel is read above before the next pass writes it
  }
}

// mode 0 gossip, 1 ping piggyback, 2 ack piggyback
__global__ void swim_spread(const SwimArgs a, int mode) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int per = mode == 0 ? a.g * a.m : a.m;
  if (e >= (long long)a.n * per) return;
  const int i = (int)(e / per), slot = (int)(e % per);
  const int n = a.n, m = a.m;
  int src = i, dest, mm = slot;
  if (mode == 0) {
    const int gg = slot / m;
    mm = slot % m;
    if (!a.alive[i] || !a.sendable[(size_t)i * m + mm]) return;
    const unsigned long long idx = (unsigned long long)i * a.g + gg;
    dest = rand_peer(a, K_GT, idx, i);
    if (!a.alive[dest] || !leg_ok(a, K_GLOSS, idx * m + mm)) return;
  } else if (mode == 1) {
    if (!(a.probe[i] & PING_OK) || !a.sendable[(size_t)i * m + mm]) return;
    dest = a.target[i];
  } else {
    src = a.target[i];  // the target's entries ride its ack to i
    if (!(a.probe[i] & ACK_OK) || !a.sendable[(size_t)src * m + mm]) return;
    dest = i;
  }
  const size_t o = (size_t)src * m + mm;
  atomicMax(a.view + cell(n, dest, a.ge[o]), a.pay[o]);
}

__global__ void swim_gather(const SwimArgs a) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= (long long)a.n * a.m) return;
  const int i = (int)(e / a.m);
  a.pay[e] = a.view[cell(a.n, i, a.ge[e])];
}

__global__ void __launch_bounds__(THREADS) swim_settle(const SwimArgs a) {
  __shared__ int s_diag, s_charge;
  const int i = blockIdx.x;
  const int n = a.n;
  if (threadIdx.x == 0) {
    // refutation / renewal (:277-304)
    const int t = a.target[i];
    const bool al = a.alive[i];
    const int self_key = a.view[cell(n, i, i)];
    const int peer_rec = a.view[cell(n, t, i)];
    const bool told = al && a.alive[t] && peer_rec % 4 == DOWN &&
                      leg_ok(a, K_TU, 2ull * i) &&
                      leg_ok(a, K_TU, 2ull * i + 1);
    const int offending = max(self_key, told ? peer_rec : 0);
    const bool offended = al && (self_key % 4 != ALIVE || told);
    const int inc1 = a.inc1[i];
    const int new_inc =
        offended ? offending / 4 + 1 : max(inc1, self_key / 4);
    const int inc = max(inc1, new_inc);
    a.inc[i] = inc;
    s_diag = al ? inc * 4 + ALIVE : self_key;
    // backlog rounds of each sendable selected entry (:236-275)
    s_charge = 2 * al + a.pinged[i];
    if (a.flags != nullptr && i != a.victim) {
      const int st = a.view[cell(n, i, a.victim)] % 4;
      if (st == DOWN) atomicAdd(a.flags, 1);
      if (st == ALIVE) atomicAdd(a.flags + 1, 1);
    }
  }
  __syncthreads();
  for (int j = threadIdx.x; j < n; j += THREADS) {
    const size_t c = cell(n, i, j);
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
    const size_t c = cell(n, i, a.ge[o]);
    if (a.view[c] == a.view_in[c]) a.tx[c] += s_charge;
  }
}

unsigned blocks_for(long long work, int threads) {
  return (unsigned)((work + threads - 1) / threads);
}

}  // namespace

// keys: K_WORDS uint32 words (host memory), copied into the launch's
// argument block; flags may be null (no churn victim)
extern "C" int swim_launch(
    const void* view_in, const void* ss_in, const void* inc_in,
    const void* tx_in, const void* alive, const void* revived, void* view,
    void* ss, void* inc, void* msgs, void* tx, void* target, void* inc1,
    void* probe, void* pinged, void* ge, void* sendable, void* pay,
    void* flags, int n, int h, int g, int m, int timeout, int limit,
    int tick, int victim, float loss, unsigned span, unsigned mult,
    const unsigned* keys, int phase, void* stream) {
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
  a.ge = static_cast<int*>(ge);
  a.sendable = static_cast<unsigned char*>(sendable);
  a.pay = static_cast<int*>(pay);
  a.flags = static_cast<int*>(flags);
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
  const int tpb = 256;
  const unsigned entries = blocks_for((long long)n * m, tpb);
  switch (phase) {
    case 0:
      swim_probe_select<<<n, THREADS, 0, st>>>(a);
      break;
    case 1:  // the caller skips the gossip pass without gossip targets
      if (g < 1) return (int)cudaErrorInvalidValue;
      swim_spread<<<blocks_for((long long)n * g * m, tpb), tpb, 0, st>>>(
          a, 0);
      break;
    case 2:
      swim_gather<<<entries, tpb, 0, st>>>(a);
      break;
    case 3:
      swim_spread<<<entries, tpb, 0, st>>>(a, 1);
      break;
    case 4:
      swim_spread<<<entries, tpb, 0, st>>>(a, 2);
      break;
    case 5:
      swim_settle<<<n, THREADS, 0, st>>>(a);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
