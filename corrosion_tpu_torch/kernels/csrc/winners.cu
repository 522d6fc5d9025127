// The columnar CRDT winner selection of one encoded change batch:
// seg_cummax, winners_a and winners_b.
//
// Replace corrosion_tpu/ops/merge.py _winners_jax_core (:609) and its
// Hillis-Steele prefix max _seg_cummax_jnp (:599), after the two
// stable sorts (seg_sort.cu) have ordered the batch by pk (domain A,
// order oA) and by (pk, cid) (domain B, order oB).  Launch order:
// sort A, sort B, seg_cummax (A), winners_a, seg_cummax (B),
// winners_b; a launch boundary is the only synchronisation.
//
//  seg_cummax  out[i] = the max of v over the positions of i's segment
//              before i (exclusive; NEG_KEY at a segment start) or up
//              to i (inclusive), where v[i] = values[order[i]] (NEG_KEY
//              where mask[order[i]] is 0) and a segment starts where
//              seg[order[i]] changes.  One launch: each block claims a
//              tile of 1024 positions by a ticket, in claim order, and
//              scans it with the segmented-max operator on (start flag,
//              value) pairs (thread runs, warp shuffles, a scan of warp
//              totals); it publishes the tile's aggregate in one 16-byte
//              word with the call's epoch and a status (complete at once
//              where the tile holds a start), then, unless its first
//              position starts a segment, folds its predecessors' words
//              back to the first complete one, 32 at once (decoupled
//              look-back), publishes its inclusive word and writes each
//              position once.  A segment may span any number of tiles.
//              The ticket and the epoch share the scratch's first 8
//              bytes, so a tile reads its launch's epoch with its
//              ticket, and the last tile to claim one sets the count to
//              0 and advances the epoch: each launch leaves the scratch
//              ready for the next, a replayed CUDA graph's too, and
//              nothing is ever filled.
//  winners_a   domain A: the row-generation classification against
//              seed_cl and the prefix, final_cl, the or of sent_flag
//              and ensure, the LWW participation mask part[oA[i]], the
//              raise counts (one atomicAdd a block), and pk_pos[i] =
//              pk[oA[i]], pk by position, which winners_b reads.
//  winners_b   domain B: the LWW accept against seed_key and the
//              prefix, the accept count, the winner index (max over
//              the accepts of a cell), and the row-CL stamp clrow (min
//              over the changes of a row at its final causal length).
//              final_cl is complete at its launch, so the reference's
//              epilogue mask (merge.py:679-683, a winner survives only
//              at the row's final causal length) folds into the
//              accept: within a cell the accepted keys strictly rise in
//              stream order and cl is their top bits, so the last
//              accept (the winner) has the largest cl of the cell's
//              accepts, and max over {accepts with cl == final_cl}
//              equals the masked max.
//
// Both orders sort by pk first (A by pk, B by (pk, cid), each stable),
// so a row's changes hold the same run of positions in both, and
// pk[oA[i]] == pk[oB[i]] at every position i: winners_b reads pk_pos
// coalesced where it would gather pk[oB[i]].
//
// Bound on the H100: bytes (a few integer operations per change
// against some 30 to 40 bytes moved), most of them the gathers of
// per-change fields through the permutation, which no design avoids.
// seg_cummax moves 28 bytes a position in domain A (order, seg and
// values read, out written): 0.0088 ms at 2**20 at 3.35 TB/s; in B 21
// (order, seg, mask, out) and 8 more where the mask keeps the position
// (its value): 0.0071 ms at 2**20 where it keeps 22%, as in the winner
// selection's batches.  It gathers seg once a position (the start
// flag compares with the previous position's value, held by the same
// thread, its left lane, or across a warp's edge in shared memory; a
// tile reads its predecessor's once), values only where the mask keeps
// them, and loads order and stores out 16 bytes a thread.  Its random
// 8-byte gathers each take a 32-byte sector from L2, which is what
// bounds it at 2**20 in practice.  The winner passes write each output
// once a run of positions and not once a change: a row's (a cell's)
// changes are adjacent in its order, so every output is a segmented
// reduction over a run, scanned in registers and warp shuffles, four
// positions a thread with all their loads in flight together; an
// atomic only where a run crosses a warp's 128 positions, and one count
// atomic a block.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr long long NEG_KEY = -(1LL << 62);
constexpr int CM_THREADS = 256;
constexpr int CM_ITEMS = 4;
constexpr int CM_TILE = CM_THREADS * CM_ITEMS;  // 1024
// eight blocks an SM: 32 registers a thread, every 2**20 tile resident
constexpr int CM_BLOCKS_PER_SM = 8;
constexpr int CM_WARPS = CM_THREADS / 32;
constexpr int LOOK_BACK = 32;  // predecessors' words a warp loads at once
// a tile word's status, the low two bits of its tag (epoch << 2 | status)
constexpr long long TILE_PARTIAL = 1;  // the max over the tile alone
constexpr long long TILE_DONE = 2;     // the running max at its end

// the scratch's first 8 bytes (of 16), zero when made: the launch's
// epoch above the tiles it has claimed, TICKET_BITS wide; between
// launches the count is 0 and the epoch is the next launch's (it wraps
// after 2**42 launches)
constexpr int TICKET_BITS = 22;
constexpr unsigned long long TICKETS = (1ull << TICKET_BITS) - 1;
constexpr int THREADS = 256;
constexpr unsigned FULL = 0xffffffffu;

struct SegMax {
  int f;        // a segment start lies in the span
  long long a;  // max of the span since its last start (all of it if none)
};

__device__ __forceinline__ SegMax combine(SegMax x, SegMax y) {
  return {x.f | y.f, y.f ? y.a : max(x.a, y.a)};
}

__device__ __forceinline__ SegMax shfl_up(SegMax x, int off) {
  return {__shfl_up_sync(FULL, x.f, off), __shfl_up_sync(FULL, x.a, off)};
}

// A tile word, (value, tag), read and written whole: one 16-byte access,
// past L1, so a waiting tile sees its predecessor's latest word
__device__ __forceinline__ longlong2 load_word(const longlong2* p) {
  longlong2 w;
  asm volatile("ld.volatile.global.v2.s64 {%0, %1}, [%2];"
               : "=l"(w.x), "=l"(w.y)
               : "l"(p)
               : "memory");
  return w;
}

__device__ __forceinline__ void store_word(longlong2* p, long long value,
                                           long long tag) {
  asm volatile("st.volatile.global.v2.s64 [%0], {%1, %2};" ::"l"(p),
               "l"(value), "l"(tag)
               : "memory");
}

// One tile of 1024 positions a block, four a thread.  words[t] is tile
// t's word in this launch (its tag's epoch is the launch's; a word of
// an earlier launch is never read as this one's); the tile comes from
// the ticket, so every predecessor has started and will publish: the
// look-back cannot wait on a tile that is not running.  Every block has
// claimed its ticket, and read the epoch with it, before the last claim
// resets the count.
template <bool MASKED>
__global__ void __launch_bounds__(CM_THREADS, CM_BLOCKS_PER_SM)
    seg_cummax_kernel(const int* __restrict__ order,
                      const long long* __restrict__ seg,
                      const long long* __restrict__ values,
                      const unsigned char* __restrict__ mask, long long n,
                      int exclusive, long long* __restrict__ out,
                      unsigned long long* head, longlong2* words) {
  __shared__ SegMax s_pre[CM_WARPS];  // warp totals, then their prefixes
  __shared__ long long s_first[CM_WARPS], s_last[CM_WARPS];
  __shared__ int s_start[CM_WARPS];   // a start at the warp's first position
  __shared__ long long s_carry, s_epoch;
  __shared__ unsigned s_tile;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) {
    const unsigned long long h = atomicAdd(head, 1ull);
    s_tile = (unsigned)(h & TICKETS);
    s_epoch = (long long)(h >> TICKET_BITS);
    if (s_tile == gridDim.x - 1)  // the last claim: the next launch's head
      atomicAdd(head, (1ull << TICKET_BITS) - gridDim.x);
  }
  __syncthreads();
  const long long tile = s_tile, epoch = s_epoch;
  const long long t0 = tile * CM_TILE;
  const long long p0 = t0 + threadIdx.x * CM_ITEMS;
  // 1. the order 16 bytes a thread, then every gather at a clamped index
  //    (the values, under a mask, only where it keeps them)
  int o[CM_ITEMS];
  if (p0 + CM_ITEMS <= n) {
    const int4 q = *reinterpret_cast<const int4*>(order + p0);
    o[0] = q.x, o[1] = q.y, o[2] = q.z, o[3] = q.w;
  } else {
#pragma unroll
    for (int k = 0; k < CM_ITEMS; ++k) o[k] = p0 + k < n ? order[p0 + k] : 0;
  }
  long long s_pred = 0;  // seg at the tile's predecessor position
  if (threadIdx.x == 0 && t0 > 0) s_pred = seg[order[t0 - 1]];
  long long s[CM_ITEMS], v[CM_ITEMS];
  bool keep[CM_ITEMS];
#pragma unroll
  for (int k = 0; k < CM_ITEMS; ++k) {
    s[k] = seg[o[k]];
    keep[k] = !MASKED || mask[o[k]];
    if (!MASKED) v[k] = values[o[k]];
  }
  if (MASKED) {
#pragma unroll
    for (int k = 0; k < CM_ITEMS; ++k)
      v[k] = keep[k] ? values[o[k]] : NEG_KEY;
  }
  // 2. start flags from the previous position's seg (a warp's first
  //    position's after the barrier), the thread's run, the warp's scan
  const long long up = __shfl_up_sync(FULL, s[CM_ITEMS - 1], 1);
  int flag[CM_ITEMS];
  SegMax run = {0, NEG_KEY};
#pragma unroll
  for (int k = 0; k < CM_ITEMS; ++k) {
    const bool live = p0 + k < n;
    flag[k] = live && (k || lane) && s[k] != (k ? s[k - 1] : up);
    if (!live || !keep[k]) v[k] = NEG_KEY;
    run = combine(run, SegMax{flag[k], v[k]});
  }
  // a span's max never reads its own first flag, so the scans' values
  // are right without the warp's first flag; its f is or-ed in after
  SegMax incl = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const SegMax x = shfl_up(incl, off);
    if (lane >= off) incl = combine(x, incl);
  }
  SegMax lane_ex = shfl_up(incl, 1);
  if (lane == 31) {
    s_pre[warp] = incl;
    s_last[warp] = s[CM_ITEMS - 1];
  }
  if (lane == 0) s_first[warp] = s[0];
  if (threadIdx.x == 0) s_start[0] = t0 == 0 || s[0] != s_pred;
  __syncthreads();
  // 3. warp 0: the warps' first flags and prefixes, the tile's word,
  //    the look-back, the inclusive word
  if (warp == 0) {
    SegMax w = {0, NEG_KEY};
    int start = 0;
    if (lane < CM_WARPS) {
      w = s_pre[lane];
      start = lane ? t0 + lane * 32 * CM_ITEMS < n &&
                         s_first[lane] != s_last[lane - 1]
                   : s_start[0];
      w.f |= start;
    }
    SegMax inc = w;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const SegMax x = shfl_up(inc, off);
      if (lane >= off) inc = combine(x, inc);
    }
    SegMax ex = shfl_up(inc, 1);
    if (lane == 0) ex = SegMax{0, NEG_KEY};
    const int agg_f = __shfl_sync(FULL, inc.f, CM_WARPS - 1);
    const long long agg_a = __shfl_sync(FULL, inc.a, CM_WARPS - 1);
    const int tile_start = __shfl_sync(FULL, start, 0);
    if (lane < CM_WARPS) {
      s_pre[lane] = ex;
      s_start[lane] = start;
    }
    if (lane == 0)
      store_word(&words[tile], agg_a,
                 epoch << 2 | (agg_f ? TILE_DONE : TILE_PARTIAL));
    long long carry = NEG_KEY;
    if (!tile_start) {  // tile 0 always starts a segment: the walk ends
      for (long long hi = tile - 1;; hi -= LOOK_BACK) {
        const long long pt = hi - lane;
        long long val = NEG_KEY;
        int st = (int)TILE_DONE;
        if (pt >= 0) {
          do {
            const longlong2 wd = load_word(&words[pt]);
            st = (wd.y >> 2) == epoch ? (int)(wd.y & 3) : 0;
            val = wd.x;
          } while (st == 0);
        }
        // fold back to the nearest complete word (lane order is tile
        // order, nearest first)
        const unsigned done = __ballot_sync(FULL, st == (int)TILE_DONE);
        const int stop = done ? __ffs(done) - 1 : 31;
        long long mx = lane <= stop ? val : NEG_KEY;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          mx = max(mx, __shfl_xor_sync(FULL, mx, off));
        carry = max(carry, mx);
        if (done) break;
      }
      if (lane == 0 && !agg_f)
        store_word(&words[tile], max(carry, agg_a), epoch << 2 | TILE_DONE);
    }
    if (lane == 0) s_carry = carry;
  }
  __syncthreads();
  // 4. each position once: the carry where no start precedes it in the
  //    tile, then two 16-byte stores a thread
  const int wstart = s_start[warp];
  SegMax pre = s_pre[warp];
  if (lane) {
    lane_ex.f |= wstart;
    pre = combine(pre, lane_ex);
  } else {
    flag[0] = wstart;
  }
  long long cur = pre.f ? pre.a : max(s_carry, pre.a);
  long long r[CM_ITEMS];
#pragma unroll
  for (int k = 0; k < CM_ITEMS; ++k) {
    const long long before = flag[k] ? NEG_KEY : cur;
    cur = flag[k] ? v[k] : max(cur, v[k]);
    r[k] = exclusive ? before : cur;
  }
  if (p0 + CM_ITEMS <= n) {
    reinterpret_cast<longlong2*>(out + p0)[0] = make_longlong2(r[0], r[1]);
    reinterpret_cast<longlong2*>(out + p0)[1] = make_longlong2(r[2], r[3]);
  } else {
#pragma unroll
    for (int k = 0; k < CM_ITEMS; ++k)
      if (p0 + k < n) out[p0 + k] = r[k];
  }
}

// -- winners_a and winners_b -------------------------------------------
//
// A thread takes ITEMS consecutive positions, a warp 32 * ITEMS: one
// 16-byte load of the order and two of prev (and in B two of pk_pos),
// then every gather of the tile, at clamped indices and
// unconditionally, before any result is used.  A row's (or a cell's)
// positions are adjacent in its order, so each output is a segmented
// reduction over a run of positions: a warp scans its tile with the
// segmented operator (thread runs, then warp shuffles) and the last
// position of each piece of a run writes the piece's value.  A piece
// that is a whole run writes with a plain store; only a piece at the
// tile's edge, whose run may go on in the next or the previous warp,
// takes an atomic: at most two a warp and an output.

constexpr int ITEMS = 4;  // 2 and 1 measured no faster on the H100
constexpr long long NO_ROW = -1;  // pk of a position past n (pk >= 0)

__device__ __forceinline__ void load4(const long long* __restrict__ src,
                                      long long (&v)[ITEMS]) {
  const longlong2 a = __ldcs(reinterpret_cast<const longlong2*>(src));
  const longlong2 b = __ldcs(reinterpret_cast<const longlong2*>(src + 2));
  v[0] = a.x, v[1] = a.y, v[2] = b.x, v[3] = b.y;
}

// positions i0 .. i0 + ITEMS - 1 of an order and of prev; o = -1 past n
__device__ __forceinline__ void load_tile(const int* __restrict__ order,
                                          const long long* __restrict__ prev,
                                          long long i0, long long n,
                                          int (&o)[ITEMS],
                                          long long (&pv)[ITEMS]) {
  if (i0 + ITEMS <= n) {
    const int4 v = __ldcs(reinterpret_cast<const int4*>(order + i0));
    o[0] = v.x, o[1] = v.y, o[2] = v.z, o[3] = v.w;
    load4(prev + i0, pv);
    return;
  }
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    o[k] = i0 + k < n ? order[i0 + k] : -1;
    pv[k] = i0 + k < n ? prev[i0 + k] : NEG_KEY;
  }
}

// the block's sum of v into *dst: one atomic a block
__device__ __forceinline__ void add_block_sum(unsigned long long* dst,
                                              long long v, long long* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(FULL, v, off);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    long long t = 0;
    for (int w = 0; w < THREADS / 32; ++w) t += red[w];
    if (t) atomicAdd(dst, (unsigned long long)t);
  }
}

// domain A's segmented OR: f, a run start in the span; a, the OR of the
// flags (bit 0 a sentinel raise, bit 1 an equal-generation live cell
// change) since the span's last start
struct RowOr {
  int f, a;
};

__device__ __forceinline__ RowOr combine(RowOr x, RowOr y) {
  return {x.f | y.f, y.f ? y.a : x.a | y.a};
}

__device__ __forceinline__ RowOr shfl_up(RowOr x, int off) {
  return {__shfl_up_sync(FULL, x.f, off), __shfl_up_sync(FULL, x.a, off)};
}

// domain B's two segmented reductions: f bit 0, a row start in the span,
// bit 1 a cell start (a row start is one too); mn, the least stream
// index at the row's final causal length since the last row start
// (INT_MAX: none); mx, the greatest accept at it since the last cell
// start (-1: none)
struct CellMinMax {
  int f, mn, mx;
};

__device__ __forceinline__ CellMinMax combine(CellMinMax x, CellMinMax y) {
  return {x.f | y.f, (y.f & 1) ? y.mn : min(x.mn, y.mn),
          (y.f & 2) ? y.mx : max(x.mx, y.mx)};
}

__device__ __forceinline__ CellMinMax shfl_up(CellMinMax x, int off) {
  return {__shfl_up_sync(FULL, x.f, off), __shfl_up_sync(FULL, x.mn, off),
          __shfl_up_sync(FULL, x.mx, off)};
}

// the warp's exclusive scan of the threads' aggregates (lane 0: id)
template <class S>
__device__ __forceinline__ S warp_exclusive(S agg, S id) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const S o = shfl_up(agg, off);
    if (lane >= off) agg = combine(o, agg);
  }
  const S ex = shfl_up(agg, 1);
  return lane ? ex : id;
}

__global__ void __launch_bounds__(THREADS)
    winners_a_kernel(const int* __restrict__ oA,
                     const long long* __restrict__ prev,
                     const long long* __restrict__ pk,
                     const long long* __restrict__ cl,
                     const unsigned char* __restrict__ sent,
                     const long long* __restrict__ seed_cl, long long n,
                     long long* __restrict__ final_cl,
                     long long* __restrict__ sent_flag,
                     long long* __restrict__ ensure,
                     unsigned char* __restrict__ part,
                     long long* __restrict__ pk_pos,
                     unsigned long long* __restrict__ counts) {
  __shared__ long long red[2][THREADS / 32];
  const int lane = threadIdx.x & 31;
  const long long i0 =
      ((long long)blockIdx.x * THREADS + threadIdx.x) * ITEMS;
  int o[ITEMS];
  long long pv[ITEMS], p[ITEMS], c[ITEMS], before[ITEMS];
  bool s[ITEMS];
  load_tile(oA, prev, i0, n, o, pv);
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    const int oc = max(o[k], 0);
    p[k] = pk[oc], c[k] = cl[oc], s[k] = sent[oc] != 0;
  }
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    before[k] = max(seed_cl[p[k]], pv[k]);
    if (o[k] < 0) p[k] = NO_ROW;
  }
  // pk by position, for winners_b: both orders sort by pk first
  if (i0 + ITEMS <= n) {
    reinterpret_cast<longlong2*>(pk_pos + i0)[0] = {p[0], p[1]};
    reinterpret_cast<longlong2*>(pk_pos + i0)[1] = {p[2], p[3]};
  } else {
#pragma unroll
    for (int k = 0; k < ITEMS; ++k)
      if (o[k] >= 0) pk_pos[i0 + k] = p[k];
  }
  const long long p_up = __shfl_up_sync(FULL, p[ITEMS - 1], 1);
  const long long p_down = __shfl_down_sync(FULL, p[0], 1);
  long long sent_raise = 0, even_raise = 0;
  RowOr e[ITEMS], agg = {0, 0};
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    const bool live = o[k] >= 0, odd = (c[k] & 1) != 0;
    const bool raise = live && c[k] > before[k];
    const bool cell = live && !s[k];
    e[k].f = k ? p[k] != p[k - 1] : lane && p[0] != p_up;
    e[k].a = (raise && s[k]) | (cell && odd && c[k] == before[k]) << 1;
    sent_raise += raise && s[k];
    even_raise += raise && cell && !odd;
    if (live) part[o[k]] = cell && odd && c[k] >= before[k];
    agg = combine(agg, e[k]);
  }
  RowOr cur = warp_exclusive(agg, RowOr{0, 0});
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    cur = combine(cur, e[k]);
    const bool edge = k == ITEMS - 1 && lane == 31;
    const long long next = k + 1 < ITEMS ? p[k + 1] : p_down;
    if (o[k] < 0 || (!edge && next == p[k])) continue;
    // the last position of a piece: prev carries the run's earlier
    // positions from any warp, so max(before, c) is the row's final
    // causal length where the run ends here, and no more than it
    // where it goes on past the tile's edge
    const long long fin = max(before[k], c[k]);
    if (edge)
      atomicMax(&final_cl[p[k]], fin);
    else
      final_cl[p[k]] = fin;
    // flags are 0 / 1: pieces of one run store the same 1
    if (cur.a & 1) sent_flag[p[k]] = 1;
    if (cur.a & 2) ensure[p[k]] = 1;
  }
  add_block_sum(&counts[0], sent_raise, red[0]);
  add_block_sum(&counts[1], even_raise, red[1]);
}

__global__ void __launch_bounds__(THREADS)
    winners_b_kernel(const int* __restrict__ oB,
                     const long long* __restrict__ prev,
                     const long long* __restrict__ pk_pos,
                     const long long* __restrict__ cid,
                     const long long* __restrict__ cl,
                     const long long* __restrict__ key,
                     const unsigned char* __restrict__ part,
                     const long long* __restrict__ seed_key,
                     const long long* __restrict__ final_cl, long long n,
                     long long n_cid, long long* __restrict__ winner,
                     long long* __restrict__ clrow,
                     unsigned long long* __restrict__ counts) {
  __shared__ long long red[THREADS / 32];
  const int lane = threadIdx.x & 31;
  const long long i0 =
      ((long long)blockIdx.x * THREADS + threadIdx.x) * ITEMS;
  int o[ITEMS], ci[ITEMS];
  long long pv[ITEMS], p[ITEMS], c[ITEMS], fcl[ITEMS], ky[ITEMS], sk[ITEMS];
  bool pt[ITEMS];
  load_tile(oB, prev, i0, n, o, pv);
  if (i0 + ITEMS <= n) {
    load4(pk_pos + i0, p);
  } else {
#pragma unroll
    for (int k = 0; k < ITEMS; ++k)
      p[k] = o[k] >= 0 ? pk_pos[i0 + k] : NO_ROW;
  }
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    const int oc = max(o[k], 0);
    ci[k] = (int)cid[oc], c[k] = cl[oc], pt[k] = o[k] >= 0 && part[oc];
    fcl[k] = final_cl[max(p[k], 0LL)];
    if (o[k] < 0) ci[k] = -2;
  }
  // keyB is NEG_KEY where a change takes no part: never an accept
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    ky[k] = pt[k] ? key[max(o[k], 0)] : NEG_KEY;
    sk[k] = pt[k] && ci[k] >= 0 ? seed_key[p[k] * n_cid + ci[k]] : NEG_KEY;
  }
  const long long p_up = __shfl_up_sync(FULL, p[ITEMS - 1], 1);
  const long long p_down = __shfl_down_sync(FULL, p[0], 1);
  const int ci_up = __shfl_up_sync(FULL, ci[ITEMS - 1], 1);
  const int ci_down = __shfl_down_sync(FULL, ci[0], 1);
  long long accepts = 0;
  CellMinMax e[ITEMS], agg = {0, INT_MAX, -1};
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    const bool at_final = o[k] >= 0 && c[k] == fcl[k];
    const bool accept = pt[k] && ky[k] > max(sk[k], pv[k]);
    const long long pp = k ? p[k - 1] : p_up;
    const int cp = k ? ci[k - 1] : ci_up;
    const bool first = k || lane;  // lane 0's first: the tile's edge
    e[k].f = first && p[k] != pp ? 3 : first && ci[k] != cp ? 2 : 0;
    e[k].mn = at_final ? o[k] : INT_MAX;
    e[k].mx = accept && at_final ? o[k] : -1;
    accepts += accept;
    agg = combine(agg, e[k]);
  }
  CellMinMax cur = warp_exclusive(agg, CellMinMax{0, INT_MAX, -1});
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    cur = combine(cur, e[k]);
    if (o[k] < 0) continue;
    const bool edge = k == ITEMS - 1 && lane == 31;
    const long long pn = k + 1 < ITEMS ? p[k + 1] : p_down;
    const int cn = k + 1 < ITEMS ? ci[k + 1] : ci_down;
    const bool row_end = edge || pn != p[k];
    // a piece is a whole run when a start lies in the tile at or
    // before it and it ends its run; else its run may cross the edge
    if (row_end && cur.mn != INT_MAX) {
      if (!edge && (cur.f & 1))
        clrow[p[k]] = cur.mn;
      else
        atomicMin(&clrow[p[k]], (long long)cur.mn);
    }
    if ((row_end || cn != ci[k]) && cur.mx >= 0) {
      long long* w = &winner[p[k] * n_cid + max(ci[k], 0)];
      if (!edge && (cur.f & 2))
        *w = cur.mx;
      else
        atomicMax(w, (long long)cur.mx);
    }
  }
  add_block_sum(&counts[2], accepts, red);
}

unsigned blocks_for(long long n) {
  return (unsigned)((n + THREADS * ITEMS - 1) / (THREADS * ITEMS));
}

}  // namespace

// order and words 16-byte aligned; words: 16 bytes per tile,
// ceil(n / 1024) < 2**22, and 16 more ahead of them, zero when first
// used and kept for the launches that follow on one stream (never two
// at once)
extern "C" int seg_cummax_launch(const int* order, const long long* seg,
                                 const long long* values,
                                 const unsigned char* mask, long long n,
                                 int exclusive, long long* out, void* words,
                                 void* stream) {
  if (n <= 0) return 0;
  const long long blocks = (n + CM_TILE - 1) / CM_TILE;
  if (blocks > (long long)TICKETS) return (int)cudaErrorInvalidValue;
  unsigned long long* head = static_cast<unsigned long long*>(words);
  longlong2* w = static_cast<longlong2*>(words) + 1;
  if (mask)
    seg_cummax_kernel<true>
        <<<(unsigned)blocks, CM_THREADS, 0, (cudaStream_t)stream>>>(
            order, seg, values, mask, n, exclusive, out, head, w);
  else
    seg_cummax_kernel<false>
        <<<(unsigned)blocks, CM_THREADS, 0, (cudaStream_t)stream>>>(
            order, seg, values, mask, n, exclusive, out, head, w);
  return (int)cudaGetLastError();
}

// oA, prev and pk_pos 16-byte aligned; n < 2**31
extern "C" int winners_a_launch(const int* oA, const long long* prev,
                                const long long* pk, const long long* cl,
                                const unsigned char* sent,
                                const long long* seed_cl, long long n,
                                long long* final_cl, long long* sent_flag,
                                long long* ensure, unsigned char* part,
                                long long* pk_pos,
                                unsigned long long* counts, void* stream) {
  if (n <= 0) return 0;
  winners_a_kernel<<<blocks_for(n), THREADS, 0, (cudaStream_t)stream>>>(
      oA, prev, pk, cl, sent, seed_cl, n, final_cl, sent_flag, ensure, part,
      pk_pos, counts);
  return (int)cudaGetLastError();
}

// oB, prev and pk_pos 16-byte aligned; n < 2**31
extern "C" int winners_b_launch(const int* oB, const long long* prev,
                                const long long* pk_pos, const long long* cid,
                                const long long* cl, const long long* key,
                                const unsigned char* part,
                                const long long* seed_key,
                                const long long* final_cl, long long n,
                                long long n_cid, long long* winner,
                                long long* clrow, unsigned long long* counts,
                                void* stream) {
  if (n <= 0) return 0;
  winners_b_kernel<<<blocks_for(n), THREADS, 0, (cudaStream_t)stream>>>(
      oB, prev, pk_pos, cid, cl, key, part, seed_key, final_cl, n, n_cid,
      winner, clrow, counts);
  return (int)cudaGetLastError();
}
