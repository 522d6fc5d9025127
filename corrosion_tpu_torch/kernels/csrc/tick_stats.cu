// tick_stats: per-universe convergence statistics of one tick.
//
// Replaces the per-tick reductions of corrosion_tpu/sim/epidemic.py
// _scan_chunk (:272-309) and _scan_chunk_coverage (:351-359): the
// all-rows-equal-target flag, the coverage fraction, the msgs mean and
// 99th percentile, the 50th / 99th nan-percentiles of the hop depths
// (depth >= HOP_UNSET - 1 counts as NaN) and the hop coverage.  The
// reference sorts every [S, n] series per tick to read percentiles.
//
// One block of 1024 threads per universe.  Pass 1 streams the
// universe's rows, msgs and hops once: the holds count, the exact msgs
// sum (int64), and min / max / count of both series, reduced over the
// block.  Order statistics are exact: msgs and hop depths are small
// integers, so a shared-memory histogram of value - min over 4096 bins
// and one block-wide prefix scan give every needed rank.  Where a
// series spans 4096 values or more, the kernel writes +inf in place of
// its percentiles, never a clipped rank, and the host raises on it at
// the chunk's fetch.  Percentiles then follow
// jnp.percentile's linear rule in float32, with the ranks
// floor / ceil(q * (count - 1)) and the products and sum rounded one
// by one (__fmul_rn / __fadd_rn, never contracted into an FMA), the
// same operations as the plain version.  The mean is the exact sum
// rounded to float32, divided by n.
//
// Bound on the H100: bytes — the [S*n, R] rows and the two [S*n]
// series read once (about 0.13 GB per tick at S = 32, n = 100k,
// R = 8).  The histogram pass re-reads msgs and hops, mostly from L2.
// One block per universe leaves most SMs idle at S = 32; splitting a
// universe over several blocks is later work.

#include <cstdint>
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

using common::HOP_UNSET;
constexpr int THREADS = 1024;
constexpr int NBINS = 4096;
constexpr int BINS_PER_THREAD = NBINS / THREADS;
constexpr int NSTATS = 7;

struct Sum {
  template <class T>
  __device__ T operator()(T a, T b) const { return a + b; }
};
struct Min {
  template <class T>
  __device__ T operator()(T a, T b) const { return a < b ? a : b; }
};
struct Max {
  template <class T>
  __device__ T operator()(T a, T b) const { return a > b ? a : b; }
};

// Every thread of the block calls it; every thread gets the result.
template <class T, class Op>
__device__ T block_reduce(T v, Op op, T* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = op(v, __shfl_down_sync(0xffffffffu, v, o));
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  T r = scratch[0];
  for (int w = 1; w < THREADS / 32; ++w) r = op(r, scratch[w]);
  __syncthreads();
  return r;
}

__device__ int block_exclusive_scan(int v, int* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) scratch[warp] = x;
  __syncthreads();
  int pre = 0;
  for (int w = 0; w < warp; ++w) pre += scratch[w];
  __syncthreads();
  return pre + x - v;
}

__device__ __forceinline__ bool counted(int v, bool hop) {
  return !hop || v < HOP_UNSET - 1;
}

// ranks[q] (0-based, < count) of the counted values -> values[q]
// (shared); all threads call it, only while vmax - vmin < NBINS.
__device__ void order_stats(const int* __restrict__ vals, int n, bool hop,
                            int vmin, const int* ranks, int nq, int* values,
                            int* hist, int* iscratch) {
  for (int b = threadIdx.x; b < NBINS; b += THREADS) hist[b] = 0;
  __syncthreads();
  for (int i = threadIdx.x; i < n; i += THREADS) {
    const int v = vals[i];
    if (counted(v, hop)) atomicAdd(hist + (v - vmin), 1);
  }
  __syncthreads();
  int c[BINS_PER_THREAD], total = 0;
#pragma unroll
  for (int b = 0; b < BINS_PER_THREAD; ++b) {
    c[b] = hist[threadIdx.x * BINS_PER_THREAD + b];
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
          values[q] = vmin + threadIdx.x * BINS_PER_THREAD + b;
          break;
        }
      }
    }
  }
  __syncthreads();
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

template <int R>
__global__ void __launch_bounds__(THREADS)
tick_stats_kernel(const int* __restrict__ rows, const int* __restrict__ target,
                  const int* __restrict__ msgs, const int* __restrict__ hops,
                  float* __restrict__ out, int n, float q99, float q50) {
  __shared__ int hist[NBINS];
  __shared__ int iscratch[32];
  __shared__ long long lscratch[32];
  __shared__ int values[4];
  const int s = blockIdx.x;
  const int* rws = rows + (size_t)s * n * R;
  const int* m = msgs + (size_t)s * n;
  const int* h = hops ? hops + (size_t)s * n : nullptr;

  int tgt[R];
#pragma unroll
  for (int c = 0; c < R; ++c) tgt[c] = target[c];

  int holds = 0, mmin = INT32_MAX, mmax = INT32_MIN;
  int hcnt = 0, hmin = INT32_MAX, hmax = INT32_MIN;
  long long msum = 0;
  for (int i = threadIdx.x; i < n; i += THREADS) {
    bool eq = true;
#pragma unroll
    for (int c = 0; c < R; ++c) eq &= rws[(size_t)i * R + c] == tgt[c];
    holds += eq;
    const int v = m[i];
    msum += v;
    mmin = min(mmin, v);
    mmax = max(mmax, v);
    if (h) {
      const int hv = h[i];
      if (hv < HOP_UNSET - 1) {
        ++hcnt;
        hmin = min(hmin, hv);
        hmax = max(hmax, hv);
      }
    }
  }
  holds = block_reduce(holds, Sum(), iscratch);
  msum = block_reduce(msum, Sum(), lscratch);
  mmin = block_reduce(mmin, Min(), iscratch);
  mmax = block_reduce(mmax, Max(), iscratch);
  hcnt = block_reduce(hcnt, Sum(), iscratch);
  hmin = block_reduce(hmin, Min(), iscratch);
  hmax = block_reduce(hmax, Max(), iscratch);

  float* o = out + (size_t)s * NSTATS;
  const float nf = __int2float_rn(n);

  int ranks[4];
  float hw99, hw50;
  quantile_ranks(q99, n, &ranks[0], &ranks[1], &hw99);
  const bool m_fits = fits(mmin, mmax);
  if (m_fits)
    order_stats(m, n, false, mmin, ranks, 2, values, hist, iscratch);
  if (threadIdx.x == 0) {
    o[0] = holds == n ? 1.0f : 0.0f;
    o[1] = __fdiv_rn(__int2float_rn(holds), nf);
    o[2] = __fdiv_rn(__ll2float_rn(msum), nf);
    o[3] = m_fits ? interpolate(values[0], values[1], hw99) : too_wide();
    o[4] = o[5] = __int_as_float(0x7fc00000);  // NaN: no measured depth
    o[6] = __fdiv_rn(__int2float_rn(hcnt), nf);
  }
  __syncthreads();
  if (h && hcnt > 0) {
    quantile_ranks(q50, hcnt, &ranks[0], &ranks[1], &hw50);
    quantile_ranks(q99, hcnt, &ranks[2], &ranks[3], &hw99);
    if (!fits(hmin, hmax)) {
      if (threadIdx.x == 0) o[4] = o[5] = too_wide();
      return;
    }
    order_stats(h, n, true, hmin, ranks, 4, values, hist, iscratch);
    if (threadIdx.x == 0) {
      o[4] = interpolate(values[0], values[1], hw50);
      o[5] = interpolate(values[2], values[3], hw99);
    }
  }
}

}  // namespace

extern "C" int tick_stats_launch(const void* rows, const void* target,
                                 const void* msgs, const void* hops,
                                 void* out, int s, int n, int r, float q99,
                                 float q50, void* stream) {
  if (s <= 0) return 0;
  if (n <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* rw = static_cast<const int*>(rows);
  const int* tg = static_cast<const int*>(target);
  const int* ms = static_cast<const int*>(msgs);
  const int* hp = static_cast<const int*>(hops);
  float* ou = static_cast<float*>(out);
  switch (r) {
#define STATS_CASE(RR)                                                 \
  case RR:                                                             \
    tick_stats_kernel<RR><<<s, THREADS, 0, st>>>(rw, tg, ms, hp, ou, n, \
                                                 q99, q50);            \
    break;
    STATS_CASE(1) STATS_CASE(2) STATS_CASE(3) STATS_CASE(4)
    STATS_CASE(5) STATS_CASE(6) STATS_CASE(7) STATS_CASE(8)
    STATS_CASE(9) STATS_CASE(10) STATS_CASE(11) STATS_CASE(12)
    STATS_CASE(13) STATS_CASE(14) STATS_CASE(15) STATS_CASE(16)
#undef STATS_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
