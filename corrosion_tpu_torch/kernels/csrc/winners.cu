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
//  winners_a   domain A, a thread per position: the row-generation
//              classification against seed_cl and the prefix, the
//              scatter-max of final_cl, the scatter-or (racing stores
//              of 1) of sent_flag and ensure, the LWW participation
//              mask part[oA[i]], and the raise counts (integer
//              atomicAdds of warp sums).
//  winners_b   domain B: the LWW accept against seed_key and the
//              prefix, the accept count, the scatter-max of the winner
//              index, and the scatter-min of the row-CL stamp clrow.
//              final_cl is complete at its launch, so the reference's
//              epilogue mask (merge.py:679-683, a winner survives only
//              at the row's final causal length) folds into the
//              accept: within a cell the accepted keys strictly rise in
//              stream order and cl is their top bits, so the last
//              accept (the winner) has the largest cl of the cell's
//              accepts, and max over {accepts with cl == final_cl}
//              equals the masked max.
//
// Bound on the H100: bytes (a few integer operations per change
// against some 40 bytes moved).  The design reads every per-change
// field once through the permutation, keeps the classification in
// registers and writes only the decision; the scatters are 64-bit
// atomicMax / atomicMin, exact in any order.

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

__device__ __forceinline__ void add_warp_sum(unsigned long long* dst,
                                             long long v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(FULL, v, off);
  if ((threadIdx.x & 31) == 0 && v) atomicAdd(dst, (unsigned long long)v);
}

__global__ void winners_a_kernel(const int* __restrict__ oA,
                                 const long long* __restrict__ prev,
                                 const long long* __restrict__ pk,
                                 const long long* __restrict__ cl,
                                 const unsigned char* __restrict__ sent,
                                 const long long* __restrict__ seed_cl,
                                 long long n, long long* __restrict__ final_cl,
                                 long long* __restrict__ sent_flag,
                                 long long* __restrict__ ensure,
                                 unsigned char* __restrict__ part,
                                 unsigned long long* __restrict__ counts) {
  long long sent_raise = 0, even_raise = 0;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const int o = oA[i];
    const long long p = pk[o], c = cl[o];
    const bool s = sent[o] != 0, odd = (c & 1) != 0;
    const long long before = max(seed_cl[p], prev[i]);
    const bool raise = c > before;
    atomicMax(&final_cl[p], c);
    if (raise && s) {
      sent_flag[p] = 1;
      ++sent_raise;
    }
    if (raise && !s && !odd) ++even_raise;
    if (!s && odd && c == before) ensure[p] = 1;
    part[o] = !s && odd && c >= before;
  }
  add_warp_sum(&counts[0], sent_raise);
  add_warp_sum(&counts[1], even_raise);
}

__global__ void winners_b_kernel(const int* __restrict__ oB,
                                 const long long* __restrict__ prev,
                                 const long long* __restrict__ pk,
                                 const long long* __restrict__ cid,
                                 const long long* __restrict__ cl,
                                 const long long* __restrict__ key,
                                 const unsigned char* __restrict__ part,
                                 const long long* __restrict__ seed_key,
                                 const long long* __restrict__ final_cl,
                                 long long n, long long n_cid,
                                 long long* __restrict__ winner,
                                 long long* __restrict__ clrow,
                                 unsigned long long* __restrict__ counts) {
  long long accepts = 0;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const int o = oB[i];
    const long long p = pk[o], c = cl[o];
    const bool at_final = c == final_cl[p];
    if (at_final) atomicMin(&clrow[p], (long long)o);
    if (!part[o]) continue;  // keyB = NEG_KEY: never an accept
    const long long ci = cid[o];
    const long long cell = p * n_cid + max(ci, 0LL);
    const long long seed = ci >= 0 ? seed_key[cell] : NEG_KEY;
    if (key[o] > max(seed, prev[i])) {
      ++accepts;
      if (at_final) atomicMax(&winner[cell], (long long)o);
    }
  }
  add_warp_sum(&counts[2], accepts);
}

int blocks_for(long long n) {
  long long b = (n + THREADS - 1) / THREADS;
  return (int)(b > (1 << 20) ? (1 << 20) : b);
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

extern "C" int winners_a_launch(const int* oA, const long long* prev,
                                const long long* pk, const long long* cl,
                                const unsigned char* sent,
                                const long long* seed_cl, long long n,
                                long long* final_cl, long long* sent_flag,
                                long long* ensure, unsigned char* part,
                                unsigned long long* counts, void* stream) {
  if (n <= 0) return 0;
  winners_a_kernel<<<blocks_for(n), THREADS, 0, (cudaStream_t)stream>>>(
      oA, prev, pk, cl, sent, seed_cl, n, final_cl, sent_flag, ensure, part,
      counts);
  return (int)cudaGetLastError();
}

extern "C" int winners_b_launch(const int* oB, const long long* prev,
                                const long long* pk, const long long* cid,
                                const long long* cl, const long long* key,
                                const unsigned char* part,
                                const long long* seed_key,
                                const long long* final_cl, long long n,
                                long long n_cid, long long* winner,
                                long long* clrow, unsigned long long* counts,
                                void* stream) {
  if (n <= 0) return 0;
  winners_b_kernel<<<blocks_for(n), THREADS, 0, (cudaStream_t)stream>>>(
      oB, prev, pk, cid, cl, key, part, seed_key, final_cl, n, n_cid, winner,
      clrow, counts);
  return (int)cudaGetLastError();
}
