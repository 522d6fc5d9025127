// seg_argsort: the stable argsort of non-negative integer keys within
// S equal segments of length L, as int32 flat indices into the
// row-major [S, L] input (seg * L + local; S * L < 2**31).
//
// Replaces jnp.argsort in corrosion_tpu/models/broadcast.py
// _perm_senders (:321; the uniform scores are (bits >> 9) * 2**-23, a
// one-to-one monotone map, so the stable argsort of bits >> 9 is the
// reference's order bitwise) and the two stable lexsorts of
// corrosion_tpu/ops/merge.py _winners_jax_core (:618 on pk, :657 on
// (pk, cid); int64 keys, one segment, index order breaking ties).  The
// flat index is the sender map _perm_senders needs, so it takes the
// sort's output as it is; for one segment it is the local index.
//
// Three regimes, picked by the wrapper (kernels/seg_sort.py) by shape:
//
//  warp    L <= 256 and key_bits + lbits <= 64, lbits = ceil(log2 L):
//          a warp a segment, several segments a block.  Each element
//          becomes the composite (key << lbits) | index, which is
//          unique, so any correct sort of it is the stable argsort.  A
//          lane holds E = P / 32 composites in registers (P >= 32 the
//          power of two >= L, all-ones pads sorting last), loaded
//          striped (coalesced; a composite carries its index, so where
//          it starts does not matter).  The bitonic network runs over
//          positions lane * E + e: a stage of distance j < E swaps
//          registers inside the lane, a wider one exchanges through
//          __shfl_xor_sync.  No shared memory and no block barrier.
//          32-bit composites when key_bits + lbits <= 32 (the
//          headline's ring0 column, 23 + 8).
//  shared  257 <= L <= 4096 (same composites): one block a segment, the
//          bitonic network in shared memory.
//  radix   otherwise: a stable LSD radix sort with RADIX_BITS-bit
//          digits in one sweep (Merrill & Garland 2016, "Single-pass
//          Parallel Prefix Scan with Decoupled Look-back"; Adinets &
//          Merrill 2022, "Onesweep").  One launch reads each
//          segment's keys once and adds every pass's digit counts for
//          the segment into a global histogram.  Each pass is then one
//          launch: a block claims the next tile (4096 positions) in
//          claim order, ranks it stably by digit (a match of the warp's
//          digits by one ballot a digit bit a round, per-warp digit
//          counters), publishes its digit counts,
//          and takes the counts of the segment's earlier tiles by
//          decoupled look-back (a 2-bit flag and a 30-bit count in
//          one word per (tile, digit), so a tile's exclusive prefix
//          never waits on a scan launch); it stages the tile in digit
//          order in shared memory and writes each digit's run to
//          consecutive addresses.  Pass 0 reads the input keys
//          (shifted right by `shift`) and takes the flat index as the
//          value; the last pass writes the values only.
//
// Bound on the H100: bytes, 4 + 4 bytes an element for the headline's
// uint32 keys and int32 indices.  The warp and shared regimes move just
// those.  The radix regime at 23 bits moves 4 (histogram) + 12 + 16 +
// 12 = 44 bytes an element over three passes, where a pass of three
// launches (histogram, scan, scatter) moves about 60 in nine.

#include <cstdint>
#include <cuda_runtime.h>
#include <type_traits>

namespace {

constexpr unsigned FULL = 0xffffffffu;

// -- warp regime -----------------------------------------------------------

constexpr int WARP_BLOCK = 256;  // 8 segments a block

template <typename C>
__device__ __forceinline__ C cmin(C a, C b) { return a < b ? a : b; }
template <typename C>
__device__ __forceinline__ C cmax(C a, C b) { return a < b ? b : a; }

// E composites a lane: the network's positions lane * E + e, LOGP =
// log2(32 * E)
template <typename Raw, typename C, int E, int LOGP>
__global__ void __launch_bounds__(WARP_BLOCK)
    seg_sort_warp(const Raw* __restrict__ keys, int* __restrict__ out,
                  int S, int L, int lbits, int shift) {
  const int lane = threadIdx.x & 31;
  const int seg = blockIdx.x * (WARP_BLOCK / 32) + (threadIdx.x >> 5);
  if (seg >= S) return;  // the whole warp leaves together
  const unsigned base = (unsigned)seg * (unsigned)L;
  C v[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int i = e * 32 + lane;
    v[e] = i < L ? ((C)(keys[base + i] >> shift) << lbits) | (C)i : ~(C)0;
  }
  // Both loops have constant trips, so both unroll fully and every
  // register index below is a constant.  A stage's direction bit
  // (p & k) and, across lanes, the partner's side (p & j) are bits of
  // the lane when they are at or above log2(E) and bits of e (a
  // constant) below, so they are computed once a stage, not once an
  // element.
  const int lp = lane * E;  // this lane's first position
#pragma unroll
  for (int kb = 1; kb <= LOGP; ++kb) {
#pragma unroll
    for (int jb = LOGP - 1; jb >= 0; --jb) {
      if (jb >= kb) continue;
      const int j = 1 << jb;
      const bool lane_up = ((lp >> kb) & 1) == 0;  // for k >= E
      if (j >= E) {
        // the partner is position p ^ j, in lane ^ (j / E), register e
        const bool keep_min = ((lp & j) == 0) == lane_up;
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const C o = __shfl_xor_sync(FULL, v[e], j / E);
          v[e] = keep_min ? cmin(v[e], o) : cmax(v[e], o);
        }
      } else {
#pragma unroll
        for (int e = 0; e < E; ++e) {
          if ((e & j) == 0) {
            const bool up = (1 << kb) >= E ? lane_up : ((e >> kb) & 1) == 0;
            const C a = v[e], b = v[e + j];
            const C lo = cmin(a, b), hi = cmax(a, b);
            v[e] = up ? lo : hi;
            v[e + j] = up ? hi : lo;
          }
        }
      }
    }
  }
  const C mask = ((C)1 << lbits) - 1;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int p = lane * E + e;
    if (p < L) out[base + p] = (int)(base + (unsigned)(v[e] & mask));
  }
}

template <typename Raw, typename C>
int warp_launch(const void* keys, int* out, int S, int L, int lbits,
                int shift, cudaStream_t st) {
  const unsigned blocks = (unsigned)((S + WARP_BLOCK / 32 - 1) /
                                     (WARP_BLOCK / 32));
  const Raw* k = static_cast<const Raw*>(keys);
  if (L <= 32)
    seg_sort_warp<Raw, C, 1, 5><<<blocks, WARP_BLOCK, 0, st>>>(
        k, out, S, L, lbits, shift);
  else if (L <= 64)
    seg_sort_warp<Raw, C, 2, 6><<<blocks, WARP_BLOCK, 0, st>>>(
        k, out, S, L, lbits, shift);
  else if (L <= 128)
    seg_sort_warp<Raw, C, 4, 7><<<blocks, WARP_BLOCK, 0, st>>>(
        k, out, S, L, lbits, shift);
  else
    seg_sort_warp<Raw, C, 8, 8><<<blocks, WARP_BLOCK, 0, st>>>(
        k, out, S, L, lbits, shift);
  return (int)cudaGetLastError();
}

// -- shared regime ---------------------------------------------------------

template <typename Raw, typename C>
__global__ void seg_sort_shared(const Raw* __restrict__ keys,
                                int* __restrict__ out, int L, int P,
                                int lbits, int shift) {
  extern __shared__ __align__(8) unsigned char smem[];
  C* s = reinterpret_cast<C*>(smem);
  const unsigned base = blockIdx.x * (unsigned)L;
  for (int i = threadIdx.x; i < P; i += blockDim.x) {
    s[i] = i < L ? ((C)(keys[base + i] >> shift) << lbits) | (C)i : ~(C)0;
  }
  __syncthreads();
  for (int k = 2; k <= P; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int t = threadIdx.x; t < P / 2; t += blockDim.x) {
        const int i = 2 * t - (t & (j - 1));  // (t / j) * 2j + t % j
        const C a = s[i], b = s[i + j];
        if ((a > b) == ((i & k) == 0)) {
          s[i] = b;
          s[i + j] = a;
        }
      }
      __syncthreads();
    }
  }
  const C mask = ((C)1 << lbits) - 1;
  for (int i = threadIdx.x; i < L; i += blockDim.x) {
    out[base + i] = (int)(base + (unsigned)(s[i] & mask));
  }
}

template <typename Raw, typename C>
int shared_launch(const void* keys, int* out, int S, int L, int P, int lbits,
                  int shift, cudaStream_t stream) {
  const int threads = P / 2 > 512 ? 512 : P / 2;
  seg_sort_shared<Raw, C><<<(unsigned)S, threads, P * sizeof(C), stream>>>(
      static_cast<const Raw*>(keys), out, L, P, lbits, shift);
  return (int)cudaGetLastError();
}

// -- radix regime ----------------------------------------------------------

constexpr int RADIX_BITS = 8;
constexpr int BINS = 1 << RADIX_BITS;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int ITEMS = 16;  // positions a thread ranks
constexpr int TILE = THREADS * ITEMS;
constexpr int WARP_SPAN = 32 * ITEMS;
constexpr int DPT = BINS > THREADS ? BINS / THREADS : 1;  // digits a thread
constexpr unsigned FLAG_AGG = 1u << 30;     // the tile's own counts
constexpr unsigned FLAG_PREFIX = 2u << 30;  // counts of tiles 0 .. this
constexpr unsigned COUNT = FLAG_AGG - 1;
constexpr int LOOK_BACK = 16;  // predecessors' words a look-back step loads
using Digit = std::conditional<(BINS <= 256), uint8_t, uint16_t>::type;

template <typename K>
__device__ __forceinline__ unsigned digit_of(K k, int digit_shift) {
  return (unsigned)(k >> digit_shift) & (BINS - 1);
}

__device__ __forceinline__ unsigned warp_incl_sum(unsigned v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const unsigned o = __shfl_up_sync(FULL, v, off);
    if (lane >= off) v += o;
  }
  return v;
}

// exclusive scan of one value a thread over the block
__device__ __forceinline__ unsigned block_excl_sum(unsigned x,
                                                   unsigned* warp_sums) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned incl = warp_incl_sum(x);
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const unsigned y = warp_incl_sum(lane < WARPS ? warp_sums[lane] : 0u);
    if (lane < WARPS) warp_sums[lane] = y;
  }
  __syncthreads();
  const unsigned out = (warp ? warp_sums[warp - 1] : 0u) + incl - x;
  __syncthreads();  // warp_sums free for the next scan
  return out;
}

// The lanes of the warp whose digit equals mine, among `valid`: one
// ballot a digit bit (a __match_any_sync costs several times as much).
__device__ __forceinline__ unsigned match_digit(unsigned d, unsigned valid) {
  unsigned peers = valid;
#pragma unroll
  for (int b = 0; b < RADIX_BITS; ++b) {
    const bool bit = (d >> b) & 1u;
    const unsigned m = __ballot_sync(FULL, bit);
    peers &= bit ? m : ~m;
  }
  return peers;
}

// histogram copies in a hist block: a warp each, one for wide digits
constexpr int HIST_COPIES = BINS <= 256 ? WARPS : 1;

// Every pass's digit counts of one (segment, tile), added into
// hist[(seg * passes + pass) * BINS + digit].
template <typename K>
__global__ void __launch_bounds__(THREADS)
    seg_sort_hist(const K* __restrict__ keys, unsigned* __restrict__ hist,
                  int L, int tiles, int passes, int shift) {
  extern __shared__ unsigned h[];  // [HIST_COPIES][passes][BINS]
  const int seg = blockIdx.x / tiles, tile = blockIdx.x - seg * tiles;
  const int words = passes * BINS;
  for (int x = threadIdx.x; x < HIST_COPIES * words; x += THREADS) h[x] = 0;
  __syncthreads();
  unsigned* mine = h + (threadIdx.x >> 5) % HIST_COPIES * words;
  const unsigned base = (unsigned)seg * (unsigned)L;
  const int start = tile * TILE, end = min(L, start + TILE);
  // the tile's keys into registers first, every load in flight at once
  K k[ITEMS];
#pragma unroll
  for (int r = 0; r < ITEMS; ++r) {
    const int i = start + r * THREADS + threadIdx.x;
    k[r] = i < end ? keys[base + i] >> shift : (K)0;
  }
#pragma unroll
  for (int r = 0; r < ITEMS; ++r) {
    if (start + r * THREADS + (int)threadIdx.x < end)
      for (int p = 0; p < passes; ++p)
        atomicAdd(&mine[p * BINS + digit_of<K>(k[r], p * RADIX_BITS)], 1u);
  }
  __syncthreads();
  unsigned* g = hist + (size_t)seg * words;
  for (int x = threadIdx.x; x < words; x += THREADS) {
    unsigned c = 0;
#pragma unroll
    for (int w = 0; w < HIST_COPIES; ++w) c += h[w * words + x];
    if (c) atomicAdd(&g[x], c);
  }
}

// The shared memory of a pass block (dynamic: above 48 KB with wide
// digits or keys).
template <typename K>
struct PassSmem {
  K stage_k[TILE];
  int stage_v[TILE];
  unsigned warp_count[WARPS][BINS];
  unsigned tile_start[BINS];
  int dst_off[BINS];
  Digit stage_d[TILE];
  unsigned warp_sums[WARPS];
  int tile_id;
};

// One pass: the stable scatter of one claimed tile by the digit at
// pass * RADIX_BITS.  FIRST: keys from the input, shifted, and the
// flat index as the value; LAST: values only.
template <typename K, bool FIRST, bool LAST>
__global__ void __launch_bounds__(THREADS)
    seg_sort_pass(const K* __restrict__ keys_in,
                  const int* __restrict__ vals_in, K* __restrict__ keys_out,
                  int* __restrict__ vals_out,
                  const unsigned* __restrict__ hist, unsigned* status,
                  unsigned* claim, int L, int tiles, int passes, int pass,
                  int shift) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  PassSmem<K>& sm = *reinterpret_cast<PassSmem<K>*>(smem_raw);
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const unsigned lanes_below = (1u << lane) - 1u;
  const int digit_shift = pass * RADIX_BITS;
  if (t == 0) sm.tile_id = (int)atomicAdd(claim, 1u);
  for (int x = t; x < WARPS * BINS; x += THREADS)
    (&sm.warp_count[0][0])[x] = 0;
  __syncthreads();
  const int seg = sm.tile_id / tiles, tile = sm.tile_id - seg * tiles;
  const unsigned base = (unsigned)seg * (unsigned)L;
  const int start = tile * TILE;
  const int count = min(L - start, TILE);

  // 1. each warp loads its span (every load issued before the first
  //    is waited on), then ranks it in position order: an element's
  //    rank among the equal digits before it in the span
  K k[ITEMS];
  int v[ITEMS];
  unsigned slot[ITEMS];
#pragma unroll
  for (int r = 0; r < ITEMS; ++r) {
    const int j = warp * WARP_SPAN + r * 32 + lane;
    k[r] = 0;
    v[r] = 0;
    if (j < count) {
      if (FIRST) {
        k[r] = keys_in[base + start + j] >> shift;
        v[r] = (int)(base + start + j);
      } else {
        k[r] = keys_in[base + start + j];
        v[r] = vals_in[base + start + j];
      }
    }
  }
#pragma unroll
  for (int r = 0; r < ITEMS; ++r) {
    const bool valid = warp * WARP_SPAN + r * 32 + lane < count;
    const unsigned d = digit_of<K>(k[r], digit_shift);
    const unsigned peers = match_digit(d, __ballot_sync(FULL, valid));
    const int leader = __ffs(peers) - 1;  // -1 for an invalid lane
    unsigned old = 0;
    if (valid && lane == leader) {
      old = sm.warp_count[warp][d];
      sm.warp_count[warp][d] = old + __popc(peers);
    }
    slot[r] = __shfl_sync(FULL, old, leader & 31) +
              __popc(peers & lanes_below);
    __syncwarp();
  }
  __syncthreads();

  // 2. thread t owns digits t * DPT ..: the warps' offsets within each
  //    digit, the tile's count, published at once
  unsigned total[DPT], excl[DPT];
  unsigned* my_status = status + ((size_t)seg * tiles + tile) * BINS;
#pragma unroll
  for (int q = 0; q < DPT; ++q) {
    const int d = t * DPT + q;
    total[q] = 0;
    if (d < BINS) {
#pragma unroll
      for (int w = 0; w < WARPS; ++w) {
        const unsigned c = sm.warp_count[w][d];
        sm.warp_count[w][d] = total[q];
        total[q] += c;
      }
      *(volatile unsigned*)&my_status[d] =
          (tile == 0 ? FLAG_PREFIX : FLAG_AGG) | total[q];
    }
  }
  // 3. decoupled look-back over the segment's earlier tiles, LOOK_BACK
  //    of them a step (their words loaded at once: when every tile
  //    starts together, a walk of one tile a load would cost a memory
  //    round trip per tile), then the inclusive prefix published for
  //    the tiles after
  const volatile unsigned* seg_status =
      status + (size_t)seg * tiles * BINS;
#pragma unroll
  for (int q = 0; q < DPT; ++q) {
    const int d = t * DPT + q;
    excl[q] = 0;
    if (d < BINS && tile > 0) {
      bool done = false;
      for (int pt = tile - 1; !done; pt -= LOOK_BACK) {
        unsigned word[LOOK_BACK];
#pragma unroll
        for (int x = 0; x < LOOK_BACK; ++x)
          word[x] = pt - x >= 0 ? seg_status[(size_t)(pt - x) * BINS + d]
                                : FLAG_PREFIX;
#pragma unroll
        for (int x = 0; x < LOOK_BACK; ++x) {
          if (done) break;
          while ((word[x] & (FLAG_AGG | FLAG_PREFIX)) == 0)
            word[x] = seg_status[(size_t)(pt - x) * BINS + d];
          excl[q] += word[x] & COUNT;
          done = (word[x] & FLAG_PREFIX) != 0;
        }
      }
      *(volatile unsigned*)&my_status[d] = FLAG_PREFIX | (excl[q] + total[q]);
    }
  }
  // 4. the digits' starts in the tile and in the segment (exclusive
  //    scans over the digits of the tile's and the segment's counts)
  const unsigned* seg_hist = hist + ((size_t)seg * passes + pass) * BINS;
  unsigned tsum = 0, ssum = 0, hcount[DPT];
#pragma unroll
  for (int q = 0; q < DPT; ++q) {
    const int d = t * DPT + q;
    hcount[q] = d < BINS ? seg_hist[d] : 0u;
    tsum += total[q];
    ssum += hcount[q];
  }
  unsigned trun = block_excl_sum(tsum, sm.warp_sums);
  unsigned srun = block_excl_sum(ssum, sm.warp_sums);
#pragma unroll
  for (int q = 0; q < DPT; ++q) {
    const int d = t * DPT + q;
    if (d < BINS) {
      sm.tile_start[d] = trun;
      sm.dst_off[d] = (int)(srun + excl[q]) - (int)trun;
    }
    trun += total[q];
    srun += hcount[q];
  }
  __syncthreads();
  // 5. stage the tile in digit order, then write each digit's run
#pragma unroll
  for (int r = 0; r < ITEMS; ++r) {
    const int j = warp * WARP_SPAN + r * 32 + lane;
    if (j < count) {
      const unsigned d = digit_of<K>(k[r], digit_shift);
      const unsigned pos = sm.tile_start[d] + sm.warp_count[warp][d] + slot[r];
      if (!LAST) sm.stage_k[pos] = k[r];
      sm.stage_v[pos] = v[r];
      sm.stage_d[pos] = (Digit)d;
    }
  }
  __syncthreads();
  for (int j = t; j < count; j += THREADS) {
    const unsigned dst = base + (unsigned)(sm.dst_off[sm.stage_d[j]] + j);
    if (!LAST) keys_out[dst] = sm.stage_k[j];
    vals_out[dst] = sm.stage_v[j];
  }
}

template <typename K, bool FIRST, bool LAST>
cudaError_t pass_launch(unsigned blocks, cudaStream_t st, const K* kin,
                        const int* vin, K* kout, int* vout,
                        const unsigned* hist, unsigned* status,
                        unsigned* claim, int L, int tiles, int passes,
                        int pass, int shift) {
  const int bytes = (int)sizeof(PassSmem<K>);
  auto kernel = seg_sort_pass<K, FIRST, LAST>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return e;
  kernel<<<blocks, THREADS, bytes, st>>>(kin, vin, kout, vout, hist, status,
                                         claim, L, tiles, passes, pass,
                                         shift);
  return cudaGetLastError();
}

template <typename K>
int radix_launch(const void* keys, int* out, int S, int L, int key_bits,
                 int shift, unsigned* zero, void* keys_a, void* keys_b,
                 int* vals_a, int* vals_b, cudaStream_t st) {
  const int tiles = (L + TILE - 1) / TILE;
  const int passes = key_bits <= RADIX_BITS
                         ? 1
                         : (key_bits + RADIX_BITS - 1) / RADIX_BITS;
  const unsigned blocks = (unsigned)S * (unsigned)tiles;
  unsigned* hist = zero;
  unsigned* status = hist + (size_t)S * passes * BINS;
  const size_t status_pass = (size_t)S * tiles * BINS;
  unsigned* claim = status + status_pass * passes;
  cudaError_t e = cudaMemsetAsync(
      zero, 0, ((size_t)(claim - zero) + passes) * sizeof(unsigned), st);
  if (e != cudaSuccess) return (int)e;
  const K* kin = static_cast<const K*>(keys);
  const int hist_bytes = HIST_COPIES * passes * BINS * (int)sizeof(unsigned);
  e = cudaFuncSetAttribute(seg_sort_hist<K>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           hist_bytes);
  if (e != cudaSuccess) return (int)e;
  seg_sort_hist<K><<<blocks, THREADS, hist_bytes, st>>>(kin, hist, L, tiles,
                                                        passes, shift);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  if (passes == 1)
    return (int)pass_launch<K, true, true>(blocks, st, kin, nullptr, nullptr,
                                           out, hist, status, claim, L,
                                           tiles, 1, 0, shift);
  K* kbuf[2] = {static_cast<K*>(keys_a), static_cast<K*>(keys_b)};
  int* vbuf[2] = {vals_a, vals_b};
  e = pass_launch<K, true, false>(blocks, st, kin, nullptr, kbuf[0], vbuf[0],
                                  hist, status, claim, L, tiles, passes, 0,
                                  shift);
  for (int p = 1; p < passes && e == cudaSuccess; ++p) {
    const K* ki = kbuf[(p - 1) & 1];
    const int* vi = vbuf[(p - 1) & 1];
    unsigned* sp = status + status_pass * p;
    if (p == passes - 1)
      e = pass_launch<K, false, true>(blocks, st, ki, vi, nullptr, out, hist,
                                      sp, claim + p, L, tiles, passes, p, 0);
    else
      e = pass_launch<K, false, false>(blocks, st, ki, vi, kbuf[p & 1],
                                       vbuf[p & 1], hist, sp, claim + p, L,
                                       tiles, passes, p, 0);
  }
  return (int)e;
}

}  // namespace

// wide: 0 = uint32 keys, 1 = int64 keys (non-negative, read as uint64);
// lbits = ceil(log2 L); L <= 256 takes the warp regime, up to 4096 the
// shared one (P the power of two >= L there)
extern "C" int seg_sort_small_launch(const void* keys, int wide, int* out,
                                     int S, int L, int lbits, int shift,
                                     int composite64, void* stream) {
  if (S <= 0 || L <= 0) return 0;
  if (L > 4096 || lbits < 0 || lbits > 12 || (1 << lbits) < L)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  using u64 = unsigned long long;
  if (L <= 256) {
    if (wide)
      return composite64 ? warp_launch<u64, u64>(keys, out, S, L, lbits,
                                                 shift, st)
                         : warp_launch<u64, uint32_t>(keys, out, S, L, lbits,
                                                      shift, st);
    return composite64 ? warp_launch<uint32_t, u64>(keys, out, S, L, lbits,
                                                    shift, st)
                       : warp_launch<uint32_t, uint32_t>(keys, out, S, L,
                                                         lbits, shift, st);
  }
  const int P = 1 << lbits;
  if (wide)
    return composite64 ? shared_launch<u64, u64>(keys, out, S, L, P, lbits,
                                                 shift, st)
                       : shared_launch<u64, uint32_t>(keys, out, S, L, P,
                                                      lbits, shift, st);
  return composite64 ? shared_launch<uint32_t, u64>(keys, out, S, L, P, lbits,
                                                    shift, st)
                     : shared_launch<uint32_t, uint32_t>(keys, out, S, L, P,
                                                         lbits, shift, st);
}

// zero: the words the launch clears before its histogram pass,
// S * passes * BINS + passes * S * tiles * BINS + passes (BINS = 2 **
// RADIX_BITS, tiles = ceil(L / 4096)); keys_a / keys_b S * L keys of
// the input's width and vals_a / vals_b S * L ints, unused (null) for
// one pass
extern "C" int seg_sort_radix_launch(const void* keys, int wide, int* out,
                                     int S, int L, int key_bits, int shift,
                                     void* zero, void* keys_a, void* keys_b,
                                     int* vals_a, int* vals_b, void* stream) {
  if (S <= 0 || L <= 0) return 0;
  if ((long long)S * L > 0x7fffffffLL || (unsigned)L > COUNT)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  unsigned* z = static_cast<unsigned*>(zero);
  return wide ? radix_launch<unsigned long long>(keys, out, S, L, key_bits,
                                                 shift, z, keys_a, keys_b,
                                                 vals_a, vals_b, st)
              : radix_launch<uint32_t>(keys, out, S, L, key_bits, shift, z,
                                       keys_a, keys_b, vals_a, vals_b, st);
}
