// tick_stats: per-universe convergence statistics of one tick.
//
// Replaces the per-tick reductions of corrosion_tpu/sim/epidemic.py
// _scan_chunk (:272-309) and _scan_chunk_coverage (:351-359), and the
// exact runners' chunk statistics (corrosion_tpu/sim/calibrate.py:744,
// :1301): the all-rows-equal-target flag, the coverage fraction, the
// msgs mean and 99th percentile, the 50th / 99th nan-percentiles of the
// hop depths (depth >= HOP_UNSET - 1 counts as NaN) and the hop
// coverage.  The reference sorts every [S, n] series per tick to read
// percentiles.
//
// Rows come in two forms: R int32 cells a node held against an R-cell
// target (the headline), or one byte a node, held where it is nonzero
// (R = 0 here: the exact runners' bool `infected`, read as it is).
//
// Each universe is split over `blocks` blocks of `chunk` rows
// (kernels/tick_stats.py stats_plan: a few blocks an SM at every
// shape).  A block streams its rows, msgs and hops once: the holds
// count, the msgs sum (int64) and min / max, the measured depths' count
// and min / max, reduced over the block and added to the universe's
// partials with atomics (min / max as atomicMax of order-preserving
// unsigned keys, so all-zero partials are the identity).  Order
// statistics are exact: msgs and hop depths are small integers, counted
// in a shared-memory histogram of NBINS bins indexed by value mod NBINS
// (a warp whose values share one bin adds them with one atomic), whose
// nonzero bins the block adds to the universe's global histogram.  The
// bins need no minimum: where a series spans fewer than NBINS values,
// wherever its minimum lies, value mod NBINS is one to one on it, so
// one pass over the data serves both the range and the counts.  Where
// it spans NBINS values or more, the kernel writes +inf in place of its
// percentiles, never a clipped rank, and the host raises on it at the
// chunk's fetch.
//
// One block a universe then finishes: reads the partials and the
// histogram rotated to start at the minimum, one block-wide prefix scan
// gives every needed rank, and the percentiles follow jnp.percentile's
// linear rule in float32, with the ranks floor / ceil(q * (count - 1))
// and the products and sum rounded one by one (__fmul_rn / __fadd_rn,
// never contracted into an FMA), the same operations as the plain
// version.  The mean is the exact sum rounded to float32, divided by n.
// That block zeroes the partials and histograms it read, so the scratch
// is all zero between launches and no tick pays a memset.  Two ways to
// reach it, chosen by `design` (both timed in chip_smoke.py phase 2;
// the wrapper takes 1 where a universe has more than 32 blocks, where
// it was the faster):
//   0  one launch: each block takes a ticket after its atomics
//      (__threadfence first); the universe's last block finishes;
//   1  two launches: a grid of one block a universe finishes, under
//      programmatic dependent launch (griddepcontrol.wait).
//
// Bound on the H100: bytes — the rows and the two series read once, 40
// bytes a node at R = 8 with hops (0.128 GB, 0.038 ms, at S = 32,
// n = 100k) and 5 bytes a node in the byte form (0.006 ms at 4 x 1M,
// 0.030 ms at 2 x 10M, 0.0024 ms at 16 x 100k, where the launch and the
// finishing block weigh more than the bytes).

#include <cstdint>
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

using common::HOP_UNSET;
constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int NBINS = 4096;
constexpr int BIN_MASK = NBINS - 1;
constexpr int BINS_PER_THREAD = NBINS / THREADS;
constexpr int NSTATS = 7;
constexpr unsigned FULL = 0xffffffffu;

// A universe's partials over its blocks; all zero between launches.
struct Partial {
  unsigned long long msum;
  unsigned holds, hcnt;
  unsigned mmax, mmin, hmax, hmin;  // order keys, see hi_key / lo_key
  unsigned ticket;
  unsigned pad;
};

struct StatsArgs {
  const void* rows;  // [S*n, R] int32, or [S*n] bytes (R = 0)
  const int* target;  // [R] or null (R = 0)
  const int* msgs;
  const int* hops;  // or null
  float* out;  // [S, NSTATS]
  Partial* part;  // [S]
  int* hist;  // [S, 2, NBINS]: msgs, hops
  int n;
  int blocks;  // per universe
  int chunk;   // rows a block
  float q99;
  float q50;
};

// max by atomicMax of hi_key(v), min by atomicMax of lo_key(v); 0 is
// the identity of both
__device__ __forceinline__ unsigned hi_key(int v) {
  return (unsigned)v ^ 0x80000000u;
}
__device__ __forceinline__ unsigned lo_key(int v) { return ~hi_key(v); }
__device__ __forceinline__ int of_hi(unsigned k) {
  return (int)(k ^ 0x80000000u);
}
__device__ __forceinline__ int of_lo(unsigned k) { return of_hi(~k); }

__device__ int block_exclusive_scan(int v, int* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(FULL, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) scratch[warp] = x;
  __syncthreads();
  int pre = 0;
  for (int w = 0; w < warp; ++w) pre += scratch[w];
  __syncthreads();
  return pre + x - v;
}

__device__ __forceinline__ bool counted(int v) { return v < HOP_UNSET - 1; }

// One count of bin v mod NBINS where ok; the whole warp calls it.  A
// warp whose counted values share one bin adds them with one atomic.
__device__ __forceinline__ void count(int* hist, int v, bool ok) {
  const int bin = v & BIN_MASK;
  const unsigned oks = __ballot_sync(FULL, ok);
  const int b0 = __shfl_sync(FULL, bin, __ffs(oks | 1u) - 1);
  if (__all_sync(FULL, !ok || bin == b0)) {
    if ((threadIdx.x & 31) == 0 && oks) atomicAdd(hist + b0, __popc(oks));
  } else if (ok) {
    atomicAdd(hist + bin, 1);
  }
}

template <int R>
__device__ __forceinline__ bool holds_at(const StatsArgs& a,
                                         const int (&tgt)[R > 0 ? R : 1],
                                         size_t i) {
  if constexpr (R == 0) {
    return static_cast<const unsigned char*>(a.rows)[i] != 0;
  } else {
    int v[R];
    common::load_row<R>(static_cast<const int*>(a.rows) + i * R, v);
    bool eq = true;
#pragma unroll
    for (int c = 0; c < R; ++c) eq &= v[c] == tgt[c];
    return eq;
  }
}

__device__ __forceinline__ bool fits(int vmin, int vmax) {
  return (long long)vmax - vmin < NBINS;
}

// +inf, written in place of a percentile whose series does not fit the
// bins; the host raises on it (kernels/tick_stats.py raise_on_overflow)
__device__ __forceinline__ float too_wide() {
  return __int_as_float(0x7f800000);
}

// floor / ceil ranks of quantile q over count values (jnp.percentile)
__device__ __forceinline__ void quantile_ranks(float q, int count, int* lo,
                                               int* hi, float* hw) {
  const float last = __fsub_rn(__int2float_rn(count), 1.0f);
  const float pos = __fmul_rn(q, last);
  const float fl = floorf(pos), ce = ceilf(pos);
  *hw = __fsub_rn(pos, fl);
  *lo = (int)fmaxf(0.0f, fminf(fl, last));
  *hi = (int)fmaxf(0.0f, fminf(ce, last));
}

__device__ __forceinline__ float interpolate(int vlo, int vhi, float hw) {
  const float lw = __fsub_rn(1.0f, hw);
  return __fadd_rn(__fmul_rn(__int2float_rn(vlo), lw),
                   __fmul_rn(__int2float_rn(vhi), hw));
}

// ranks[q] (0-based, < count) of a series whose values lie in
// [vmin, vmin + NBINS) -> values[q] (shared), from its global histogram
// of value mod NBINS (read through L2); all threads call it.
__device__ void order_stats(const int* hist, int vmin, const int* ranks,
                            int nq, int* values, int* iscratch) {
  const int first = threadIdx.x * BINS_PER_THREAD;
  int c[BINS_PER_THREAD], total = 0;
#pragma unroll
  for (int b = 0; b < BINS_PER_THREAD; ++b) {
    c[b] = __ldcg(hist + ((vmin + first + b) & BIN_MASK));
    total += c[b];
  }
  const int pre = block_exclusive_scan(total, iscratch);
  for (int q = 0; q < nq; ++q) {
    const int k = ranks[q];
    if (pre <= k && k < pre + total) {
      int acc = pre;
      for (int b = 0; b < BINS_PER_THREAD; ++b) {
        acc += c[b];
        if (k < acc) {
          values[q] = vmin + first + b;
          break;
        }
      }
    }
  }
  __syncthreads();
}

// Universe s's statistics from its partials and histograms, which it
// then zeroes; one block, all threads.
__device__ void finish(const StatsArgs& a, int s) {
  __shared__ int iscratch[32];
  __shared__ int values[4];
  Partial* p = a.part + s;
  int* hm = a.hist + (size_t)s * 2 * NBINS;
  int* hh = hm + NBINS;
  const int holds = (int)__ldcg(&p->holds);
  const long long msum = (long long)__ldcg(&p->msum);
  const int mmin = of_lo(__ldcg(&p->mmin)), mmax = of_hi(__ldcg(&p->mmax));
  const int hcnt = (int)__ldcg(&p->hcnt);
  const int hmin = of_lo(__ldcg(&p->hmin)), hmax = of_hi(__ldcg(&p->hmax));
  __syncthreads();  // every thread has read the partials
  if (threadIdx.x == 0) *p = Partial{};

  float* o = a.out + (size_t)s * NSTATS;
  const float nf = __int2float_rn(a.n);
  int ranks[4];
  float hw99, hw50;
  quantile_ranks(a.q99, a.n, &ranks[0], &ranks[1], &hw99);
  const bool m_fits = fits(mmin, mmax);
  if (m_fits) order_stats(hm, mmin, ranks, 2, values, iscratch);
  if (threadIdx.x == 0) {
    o[0] = holds == a.n ? 1.0f : 0.0f;
    o[1] = __fdiv_rn(__int2float_rn(holds), nf);
    o[2] = __fdiv_rn(__ll2float_rn(msum), nf);
    o[3] = m_fits ? interpolate(values[0], values[1], hw99) : too_wide();
    o[4] = o[5] = __int_as_float(0x7fc00000);  // NaN: no measured depth
    o[6] = __fdiv_rn(__int2float_rn(hcnt), nf);
  }
  __syncthreads();
  if (a.hops && hcnt > 0) {
    quantile_ranks(a.q50, hcnt, &ranks[0], &ranks[1], &hw50);
    quantile_ranks(a.q99, hcnt, &ranks[2], &ranks[3], &hw99);
    if (fits(hmin, hmax)) {
      order_stats(hh, hmin, ranks, 4, values, iscratch);
      if (threadIdx.x == 0) {
        o[4] = interpolate(values[0], values[1], hw50);
        o[5] = interpolate(values[2], values[3], hw99);
      }
    } else if (threadIdx.x == 0) {
      o[4] = o[5] = too_wide();
    }
  }
  // order_stats ended in a barrier: every bin is read
  for (int b = threadIdx.x; b < NBINS; b += THREADS) hm[b] = 0;
  if (a.hops)
    for (int b = threadIdx.x; b < NBINS; b += THREADS) hh[b] = 0;
}

// Block b of universe s: its rows' partials and histogram counts,
// added to the universe's.  Returns true in the universe's last block
// to finish when `ticket` (every thread gets the answer).
template <int R, bool TICKET>
__device__ bool accumulate(const StatsArgs& a, int s, int b) {
  __shared__ int sh_m[NBINS], sh_h[NBINS];
  __shared__ unsigned s_u[6][WARPS];
  __shared__ unsigned long long s_sum[WARPS];
  __shared__ bool s_last;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const bool hops = a.hops != nullptr;
  for (int i = threadIdx.x; i < NBINS; i += THREADS) sh_m[i] = 0;
  if (hops)
    for (int i = threadIdx.x; i < NBINS; i += THREADS) sh_h[i] = 0;
  int tgt[R > 0 ? R : 1];
#pragma unroll
  for (int c = 0; c < R; ++c) tgt[c] = a.target[c];
  __syncthreads();

  // rows a thread has in flight: 4 of 40 bytes at R = 8 with hops,
  // 8 of 5 bytes in the byte form
  constexpr int UNROLL = R == 0 ? 8 : 4;
  const int lo = b * a.chunk, hi = min(a.n, lo + a.chunk);
  const size_t u0 = (size_t)s * a.n;
  unsigned holds = 0, hcnt = 0, mmax = 0, mmin = 0, hmax = 0, hmin = 0;
  long long msum = 0;
  // warp-uniform trips (count's votes take the whole warp)
  for (int base = lo + warp * 32; base < hi; base += THREADS * UNROLL) {
    int v[UNROLL], hv[UNROLL];
    bool ok[UNROLL], eq[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int i = base + u * THREADS + lane;
      ok[u] = i < hi;
      v[u] = 0;
      hv[u] = HOP_UNSET;
      eq[u] = false;
      if (ok[u]) {
        eq[u] = holds_at<R>(a, tgt, u0 + i);
        v[u] = a.msgs[u0 + i];
        if (hops) hv[u] = a.hops[u0 + i];
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (ok[u]) {
        holds += eq[u];
        msum += v[u];
        mmax = max(mmax, hi_key(v[u]));
        mmin = max(mmin, lo_key(v[u]));
      }
      count(sh_m, v[u], ok[u]);
      if (hops) {
        const bool c = ok[u] && counted(hv[u]);
        if (c) {
          ++hcnt;
          hmax = max(hmax, hi_key(hv[u]));
          hmin = max(hmin, lo_key(hv[u]));
        }
        count(sh_h, hv[u], c);
      }
    }
  }
  holds = __reduce_add_sync(FULL, holds);
  hcnt = __reduce_add_sync(FULL, hcnt);
  mmax = __reduce_max_sync(FULL, mmax);
  mmin = __reduce_max_sync(FULL, mmin);
  hmax = __reduce_max_sync(FULL, hmax);
  hmin = __reduce_max_sync(FULL, hmin);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    msum += __shfl_down_sync(FULL, msum, o);
  if (lane == 0) {
    s_u[0][warp] = holds;
    s_u[1][warp] = hcnt;
    s_u[2][warp] = mmax;
    s_u[3][warp] = mmin;
    s_u[4][warp] = hmax;
    s_u[5][warp] = hmin;
    s_sum[warp] = (unsigned long long)msum;
  }
  __syncthreads();
  Partial* p = a.part + s;
  if (warp == 0) {
    unsigned x[6];
#pragma unroll
    for (int f = 0; f < 6; ++f) x[f] = lane < WARPS ? s_u[f][lane] : 0u;
    unsigned long long sum = lane < WARPS ? s_sum[lane] : 0ull;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      sum += __shfl_down_sync(FULL, sum, o);
    x[0] = __reduce_add_sync(FULL, x[0]);
    x[1] = __reduce_add_sync(FULL, x[1]);
#pragma unroll
    for (int f = 2; f < 6; ++f) x[f] = __reduce_max_sync(FULL, x[f]);
    if (lane == 0) {
      atomicAdd(&p->msum, sum);
      atomicAdd(&p->holds, x[0]);
      atomicMax(&p->mmax, x[2]);
      atomicMax(&p->mmin, x[3]);
      if (x[1]) {
        atomicAdd(&p->hcnt, x[1]);
        atomicMax(&p->hmax, x[4]);
        atomicMax(&p->hmin, x[5]);
      }
    }
  }
  int* hm = a.hist + (size_t)s * 2 * NBINS;
  for (int i = threadIdx.x; i < NBINS; i += THREADS) {
    const int c = sh_m[i];
    if (c) atomicAdd(hm + i, c);
  }
  if (hops)
    for (int i = threadIdx.x; i < NBINS; i += THREADS) {
      const int c = sh_h[i];
      if (c) atomicAdd(hm + NBINS + i, c);
    }
  if (!TICKET) return false;
  __threadfence();  // this thread's atomics before the block's ticket
  __syncthreads();
  if (threadIdx.x == 0)
    s_last = atomicAdd(&p->ticket, 1u) == (unsigned)a.blocks - 1u;
  __syncthreads();
  if (s_last) __threadfence();  // the other blocks' atomics before reads
  return s_last;
}

template <int R, bool TICKET>
__global__ void __launch_bounds__(THREADS, 2)
    tick_stats_blocks(const StatsArgs a) {
  if (!TICKET) asm volatile("griddepcontrol.launch_dependents;");
  const int s = blockIdx.x / a.blocks, b = blockIdx.x - s * a.blocks;
  if (accumulate<R, TICKET>(a, s, b)) finish(a, s);
}

__global__ void __launch_bounds__(THREADS) tick_stats_finish(
    const StatsArgs a) {
  asm volatile("griddepcontrol.wait;" ::: "memory");
  finish(a, blockIdx.x);
}

template <int R>
cudaError_t launch(const StatsArgs& a, int s, int design, cudaStream_t st) {
  const unsigned grid = (unsigned)s * (unsigned)a.blocks;
  if (design == 0) {
    tick_stats_blocks<R, true><<<grid, THREADS, 0, st>>>(a);
    return cudaGetLastError();
  }
  tick_stats_blocks<R, false><<<grid, THREADS, 0, st>>>(a);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)s);
  cfg.blockDim = dim3(THREADS);
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, tick_stats_finish, a);
}

}  // namespace

extern "C" int tick_stats_scratch_words() {
  return (int)(sizeof(Partial) / 4 + 2 * NBINS);
}

// rows: [S*n, r] int32 with target [r], or [S*n] bytes with r = 0 and
// no target; scratch: S * tick_stats_scratch_words() int32, all zero on
// entry (and so on return); blocks * chunk >= n > (blocks - 1) * chunk.
extern "C" int tick_stats_launch(const void* rows, const void* target,
                                 const void* msgs, const void* hops,
                                 void* out, void* scratch, int s, int n,
                                 int r, int blocks, int chunk, float q99,
                                 float q50, int design, void* stream) {
  if (s <= 0) return 0;
  if (n <= 0 || blocks <= 0 || chunk <= 0 ||
      (long long)blocks * chunk < n || (long long)(blocks - 1) * chunk >= n ||
      (r > 0) != (target != nullptr) || design < 0 || design > 1 ||
      (long long)s * blocks > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  StatsArgs a;
  a.rows = rows;
  a.target = static_cast<const int*>(target);
  a.msgs = static_cast<const int*>(msgs);
  a.hops = static_cast<const int*>(hops);
  a.out = static_cast<float*>(out);
  a.part = static_cast<Partial*>(scratch);
  a.hist = reinterpret_cast<int*>(a.part + s);
  a.n = n;
  a.blocks = blocks;
  a.chunk = chunk;
  a.q99 = q99;
  a.q50 = q50;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (r) {
#define STATS_CASE(RR)                      \
  case RR:                                  \
    err = launch<RR>(a, s, design, st);     \
    break;
    STATS_CASE(0) STATS_CASE(1) STATS_CASE(2) STATS_CASE(3) STATS_CASE(4)
    STATS_CASE(5) STATS_CASE(6) STATS_CASE(7) STATS_CASE(8)
    STATS_CASE(9) STATS_CASE(10) STATS_CASE(11) STATS_CASE(12)
    STATS_CASE(13) STATS_CASE(14) STATS_CASE(15) STATS_CASE(16)
#undef STATS_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)err;
}
