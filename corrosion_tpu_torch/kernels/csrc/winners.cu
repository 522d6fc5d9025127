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
//              seg[order[i]] changes.  Two launches: each block of 2048
//              scans its own positions with the segmented-max operator
//              on (start flag, value) pairs (thread runs, warp shuffles,
//              a scan of warp totals) and records its aggregate and its
//              first start; then each block folds the aggregates of the
//              blocks back to the last one holding a start into its
//              carry and applies it to its positions before its own
//              first start, so a segment may straddle any number of
//              block boundaries.
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
// against some 40 bytes moved), most of them the gathers of per-change
// fields through the permutation, which no design avoids.  The design
// writes each output once a run of positions and not once a change:
// a row's (a cell's) changes are adjacent in its order, so every output
// is a segmented reduction over a run, scanned in registers and warp
// shuffles, four positions a thread with all their loads in flight
// together; an atomic only where a run crosses a warp's 128 positions,
// and one count atomic a block.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr long long NEG_KEY = -(1LL << 62);
constexpr int CM_THREADS = 512;
constexpr int CM_ITEMS = 4;
constexpr int CM_TILE = CM_THREADS * CM_ITEMS;  // 2048
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

__device__ __forceinline__ long long block_max(long long v, long long* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = max(v, __shfl_down_sync(FULL, v, off));
  __syncthreads();  // red is free again
  if (lane == 0) red[warp] = v;
  __syncthreads();
  v = red[0];
  for (int w = 1; w < (int)(blockDim.x >> 5); ++w) v = max(v, red[w]);
  return v;
}

__global__ void seg_cummax_local(const int* __restrict__ order,
                                 const long long* __restrict__ seg,
                                 const long long* __restrict__ values,
                                 const unsigned char* __restrict__ mask,
                                 long long n, int exclusive,
                                 long long* __restrict__ out,
                                 long long* __restrict__ agg,
                                 int* __restrict__ first) {
  __shared__ SegMax warp_tot[CM_THREADS / 32];
  __shared__ int s_first;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long p0 = (long long)blockIdx.x * CM_TILE + threadIdx.x * CM_ITEMS;
  if (threadIdx.x == 0) s_first = CM_TILE;
  long long v[CM_ITEMS];
  int flag[CM_ITEMS];
  SegMax run = {0, NEG_KEY};
#pragma unroll
  for (int k = 0; k < CM_ITEMS; ++k) {
    const long long p = p0 + k;
    flag[k] = 0;
    v[k] = NEG_KEY;
    if (p < n) {
      const int o = order[p];
      flag[k] = p == 0 || seg[o] != seg[order[p - 1]];
      if (mask == nullptr || mask[o]) v[k] = values[o];
    }
    run = combine(run, SegMax{flag[k], v[k]});
  }
  // exclusive prefix of this thread within the block
  SegMax incl = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const SegMax o = shfl_up(incl, off);
    if (lane >= off) incl = combine(o, incl);
  }
  if (lane == 31) warp_tot[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    SegMax w = lane < CM_THREADS / 32 ? warp_tot[lane] : SegMax{0, NEG_KEY};
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const SegMax o = shfl_up(w, off);
      if (lane >= off) w = combine(o, w);
    }
    if (lane < CM_THREADS / 32) warp_tot[lane] = w;
  }
  SegMax lane_excl = shfl_up(incl, 1);
  if (lane == 0) lane_excl = SegMax{0, NEG_KEY};
  __syncthreads();
  SegMax pre = warp ? combine(warp_tot[warp - 1], lane_excl) : lane_excl;
  // pre.a: the max since the last start before this thread's first
  // position (NEG_KEY at the block's first position: phase 2's carry)
  long long cur = pre.a;
  int first_local = CM_TILE;
#pragma unroll
  for (int k = 0; k < CM_ITEMS; ++k) {
    const long long p = p0 + k;
    if (p >= n) break;
    long long before = flag[k] ? NEG_KEY : cur;
    cur = flag[k] ? v[k] : max(cur, v[k]);
    out[p] = exclusive ? before : cur;
    if (flag[k] && first_local == CM_TILE)
      first_local = threadIdx.x * CM_ITEMS + k;
  }
  if (first_local < CM_TILE) atomicMin(&s_first, first_local);
  __syncthreads();
  if (threadIdx.x == CM_THREADS - 1) {
    const SegMax tot = combine(pre, run);
    agg[blockIdx.x] = tot.a;
    first[blockIdx.x] = s_first;
  }
}

// block b >= 1: carry = max of agg over the blocks from the last one
// holding a start (block 0 always does) to b - 1, applied to b's
// positions before its first start
__global__ void seg_cummax_carry(const long long* __restrict__ agg,
                                 const int* __restrict__ first, long long n,
                                 long long* __restrict__ out) {
  __shared__ long long red[32];
  const int b = blockIdx.x + 1;
  const int upto = first[b];
  if (upto == 0) return;
  long long last = -1;
  for (int hi = b - 1; hi >= 0 && last < 0; hi -= blockDim.x) {
    const int k = hi - (int)threadIdx.x;
    last = block_max(k >= 0 && first[k] < CM_TILE ? k : -1, red);
  }
  long long c = NEG_KEY;
  for (long long k = last + threadIdx.x; k < b; k += blockDim.x)
    c = max(c, agg[k]);
  c = block_max(c, red);
  const long long base = (long long)b * CM_TILE;
  for (int i = threadIdx.x; i < upto && base + i < n; i += blockDim.x)
    out[base + i] = max(out[base + i], c);
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

// scratch: agg [ceil(n / 2048)] int64, first [ceil(n / 2048)] int32
extern "C" int seg_cummax_launch(const int* order, const long long* seg,
                                 const long long* values,
                                 const unsigned char* mask, long long n,
                                 int exclusive, long long* out,
                                 long long* agg, int* first, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  const long long blocks = (n + CM_TILE - 1) / CM_TILE;
  seg_cummax_local<<<(unsigned)blocks, CM_THREADS, 0, st>>>(
      order, seg, values, mask, n, exclusive, out, agg, first);
  if (blocks > 1)
    seg_cummax_carry<<<(unsigned)(blocks - 1), THREADS, 0, st>>>(agg, first,
                                                                  n, out);
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
