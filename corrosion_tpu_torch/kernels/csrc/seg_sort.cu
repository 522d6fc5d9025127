// seg_argsort: the stable argsort of non-negative integer keys within
// S equal segments of length L, as int32 local indices.
//
// Replaces jnp.argsort in corrosion_tpu/models/broadcast.py
// _perm_senders (:321; the uniform scores are (bits >> 9) * 2**-23, a
// one-to-one monotone map, so the stable argsort of bits >> 9 is the
// reference's order bitwise) and the two stable lexsorts of
// corrosion_tpu/ops/merge.py _winners_jax_core (:618 on pk, :657 on
// (pk, cid); int64 keys, one segment, index order breaking ties).
//
// Two regimes, picked by the wrapper (kernels/seg_sort.py):
//
//  small  L <= 4096 and key_bits + lbits <= 64, lbits = ceil(log2 L):
//         one block per segment.  Each element becomes the composite
//         (key << lbits) | index, which is unique, so any correct sort
//         of it is the stable argsort.  A bitonic network sorts the
//         composites in shared memory, padded to a power of two P with
//         all-ones pads that sort last; 32-bit composites when
//         key_bits + lbits <= 32 (the headline's 23 + 8).
//  radix  otherwise: a stable LSD radix sort with 8-bit digits,
//         ceil(key_bits / 8) passes (3 for 23-bit keys), each three
//         launches: per-(segment, tile) digit histograms, one block per
//         (segment, digit) scanning its tiles' counts, and a stable
//         scatter.  The scatter gives each warp a contiguous
//         span of the tile: the warp walks it 32 positions at a time,
//         and a warp match plus the warp's running digit counts give
//         each element its rank among the equal digits before it.  An
//         exclusive scan of the warps' counts per digit and of the
//         digits' totals turns ranks into the tile's stable digit
//         order, which is staged in shared memory so that every digit's
//         run is written to consecutive addresses.  Pass 0 reads the
//         input keys (shifted right by `shift`) and takes the index as
//         the value; the last pass writes only the values.
//
// Bound on the H100: bytes, 4 + 4 bytes an element for the headline's
// uint32 keys and int32 indices.  The small regime moves just those;
// the radix regime moves about 3 x 20 bytes an element (each pass reads
// the keys twice, the values once, and writes both), some eight times
// its bound before latency.  Speed is later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int RADIX_THREADS = 256;
constexpr int RADIX_WARPS = RADIX_THREADS / 32;
constexpr int SCAN_THREADS = 256;
constexpr int SCAN_ITEMS = 4;
constexpr unsigned FULL = 0xffffffffu;

// -- small regime ----------------------------------------------------------

template <typename Raw, typename C>
__global__ void seg_sort_small(const Raw* __restrict__ keys,
                               int* __restrict__ out, int L, int P,
                               int lbits, int shift) {
  extern __shared__ __align__(8) unsigned char smem[];
  C* s = reinterpret_cast<C*>(smem);
  const long long base = (long long)blockIdx.x * L;
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
    out[base + i] = (int)(s[i] & mask);
  }
}

template <typename Raw, typename C>
int small_launch(const void* keys, int* out, long long S, int L, int P,
                 int lbits, int shift, cudaStream_t stream) {
  const int threads = P / 2 < 32 ? 32 : (P / 2 > 512 ? 512 : P / 2);
  seg_sort_small<Raw, C><<<(unsigned)S, threads, P * sizeof(C), stream>>>(
      static_cast<const Raw*>(keys), out, L, P, lbits, shift);
  return (int)cudaGetLastError();
}

// -- radix regime ----------------------------------------------------------

// a radix block's tile: 256 threads x ROUNDS positions, each warp ranking
// one contiguous span of 32 x ROUNDS (4096 positions for uint32 keys,
// 2048 for uint64, so the staging buffers fit 48 KB of shared memory)
template <typename K>
struct Tile {
  static constexpr int ROUNDS = sizeof(K) == 4 ? 16 : 8;
  static constexpr int SIZE = RADIX_THREADS * ROUNDS;
  static constexpr int WARP_SPAN = 32 * ROUNDS;
};

template <typename K>
__device__ __forceinline__ unsigned digit_of(K k, int digit_shift) {
  return (unsigned)((k >> digit_shift) & 0xFF);
}

// digit histogram of one (segment, tile), written digit-major:
// hist[(seg * 256 + digit) * tiles + tile]
template <typename K>
__global__ void seg_sort_hist(const K* __restrict__ keys,
                              int* __restrict__ hist, int L, int tiles,
                              int shift, int digit_shift) {
  __shared__ int h[RADIX_WARPS][256];
  const int seg = blockIdx.x / tiles, tile = blockIdx.x % tiles;
  const long long base = (long long)seg * L;
  const int start = tile * Tile<K>::SIZE;
  const int end = min(L, start + Tile<K>::SIZE);
  const int t = threadIdx.x, warp = t >> 5;
#pragma unroll
  for (int w = 0; w < RADIX_WARPS; ++w) h[w][t] = 0;
  __syncthreads();
  for (int i = start + t; i < end; i += RADIX_THREADS)
    atomicAdd(&h[warp][digit_of<K>(keys[base + i] >> shift, digit_shift)], 1);
  __syncthreads();
  int c = 0;
#pragma unroll
  for (int w = 0; w < RADIX_WARPS; ++w) c += h[w][t];
  hist[((long long)seg * 256 + t) * tiles + tile] = c;
}

__device__ __forceinline__ int warp_incl_sum(int v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int o = __shfl_up_sync(FULL, v, off);
    if (lane >= off) v += o;
  }
  return v;
}

// exclusive scan, in place, of one (segment, digit) row of tile counts
// (block seg * 256 + digit): the digit's scatter base in each tile
// relative to the digit's start; the row's total into tot
__global__ void seg_sort_scan(int* __restrict__ hist, int* __restrict__ tot,
                              int tiles) {
  __shared__ int warp_sums[SCAN_THREADS / 32];
  __shared__ int carry;
  const long long base = (long long)blockIdx.x * tiles;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) carry = 0;
  __syncthreads();
  for (int c0 = 0; c0 < tiles; c0 += SCAN_THREADS * SCAN_ITEMS) {
    const int i0 = c0 + threadIdx.x * SCAN_ITEMS;
    int v[SCAN_ITEMS];
    int sum = 0;
#pragma unroll
    for (int k = 0; k < SCAN_ITEMS; ++k) {
      v[k] = i0 + k < tiles ? hist[base + i0 + k] : 0;
      sum += v[k];
    }
    const int incl = warp_incl_sum(sum);
    if (lane == 31) warp_sums[warp] = incl;
    __syncthreads();
    if (warp == 0) {
      const int x = warp_incl_sum(lane < SCAN_THREADS / 32 ? warp_sums[lane]
                                                           : 0);
      if (lane < SCAN_THREADS / 32) warp_sums[lane] = x;
    }
    __syncthreads();
    int run = carry + (warp ? warp_sums[warp - 1] : 0) + incl - sum;
#pragma unroll
    for (int k = 0; k < SCAN_ITEMS; ++k) {
      if (i0 + k < tiles) hist[base + i0 + k] = run;
      run += v[k];
    }
    __syncthreads();
    if (threadIdx.x == SCAN_THREADS - 1) carry = run;
    __syncthreads();
  }
  if (threadIdx.x == 0) tot[blockIdx.x] = carry;
}

// exclusive scan of one value per thread over a 256-thread block
__device__ __forceinline__ int block_excl_sum(int x, int* warp_sums) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int incl = warp_incl_sum(x);
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int y = warp_incl_sum(lane < RADIX_WARPS ? warp_sums[lane] : 0);
    if (lane < RADIX_WARPS) warp_sums[lane] = y;
  }
  __syncthreads();
  const int out = (warp ? warp_sums[warp - 1] : 0) + incl - x;
  __syncthreads();  // warp_sums free for the next scan
  return out;
}

// the stable scatter of one (segment, tile) by the digit at digit_shift;
// vals_in null = the local index, keys_out null = keys not written.
// Ranks the tile into digit order in shared memory, then writes each
// digit's run to consecutive addresses.
template <typename K>
__global__ void seg_sort_scatter(const K* __restrict__ keys_in,
                                 const int* __restrict__ vals_in,
                                 K* __restrict__ keys_out,
                                 int* __restrict__ vals_out,
                                 const int* __restrict__ bases,
                                 const int* __restrict__ tot, int L,
                                 int tiles, int shift, int digit_shift) {
  constexpr int ROUNDS = Tile<K>::ROUNDS, SIZE = Tile<K>::SIZE;
  __shared__ int warp_count[RADIX_WARPS][256];
  __shared__ int tile_start[256];
  __shared__ int dst_off[256];
  __shared__ int warp_sums[RADIX_WARPS];
  __shared__ K stage_k[SIZE];
  __shared__ int stage_v[SIZE];
  __shared__ unsigned char slot_digit[SIZE];
  const int seg = blockIdx.x / tiles, tile = blockIdx.x % tiles;
  const long long base = (long long)seg * L;
  const int start = tile * SIZE;
  const int count = min(L, start + SIZE) - start;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const unsigned lanes_below = (1u << lane) - 1u;
#pragma unroll
  for (int w = 0; w < RADIX_WARPS; ++w) warp_count[w][t] = 0;
  __syncthreads();
  // 1. each warp ranks its span in position order: the rank of an
  //    element among the equal digits before it in the span
  K k[ROUNDS];
  int v[ROUNDS], slot[ROUNDS];
#pragma unroll
  for (int r = 0; r < ROUNDS; ++r) {
    const int j = warp * Tile<K>::WARP_SPAN + r * 32 + lane;
    const bool valid = j < count;
    unsigned d = 256u;
    k[r] = 0;
    v[r] = 0;
    if (valid) {
      k[r] = keys_in[base + start + j] >> shift;
      v[r] = vals_in != nullptr ? vals_in[base + start + j] : start + j;
      d = digit_of<K>(k[r], digit_shift);
    }
    const unsigned peers = __match_any_sync(FULL, d);
    slot[r] = valid ? warp_count[warp][d] + __popc(peers & lanes_below) : -1;
    __syncwarp();
    if (valid && lane == __ffs(peers) - 1) warp_count[warp][d] += __popc(peers);
    __syncwarp();
  }
  __syncthreads();
  // 2. thread t = digit t: the warps' offsets within the digit, the
  //    digit's start in the tile and in the segment (exclusive scans
  //    over the digits of the tile's and the segment's totals)
  int total = 0;
#pragma unroll
  for (int w = 0; w < RADIX_WARPS; ++w) {
    const int c = warp_count[w][t];
    warp_count[w][t] = total;
    total += c;
  }
  tile_start[t] = block_excl_sum(total, warp_sums);
  const int seg_start = block_excl_sum(tot[seg * 256 + t], warp_sums);
  dst_off[t] = seg_start + bases[((long long)seg * 256 + t) * tiles + tile] -
               tile_start[t];
  __syncthreads();
  // 3. stage the tile in digit order, then write each digit's run
#pragma unroll
  for (int r = 0; r < ROUNDS; ++r) {
    if (slot[r] < 0) continue;
    const unsigned d = digit_of<K>(k[r], digit_shift);
    const int j = slot[r] + tile_start[d] + warp_count[warp][d];
    if (keys_out != nullptr) stage_k[j] = k[r];
    stage_v[j] = v[r];
    slot_digit[j] = (unsigned char)d;
  }
  __syncthreads();
  for (int j = t; j < count; j += RADIX_THREADS) {
    const long long dst = base + dst_off[slot_digit[j]] + j;
    if (keys_out != nullptr) keys_out[dst] = stage_k[j];
    vals_out[dst] = stage_v[j];
  }
}

template <typename K>
int radix_launch(const void* keys, int* out, long long S, int L,
                 int key_bits, int shift, void* keys_a, void* keys_b,
                 int* vals_a, int* vals_b, int* hist, cudaStream_t stream) {
  const int tiles = (L + Tile<K>::SIZE - 1) / Tile<K>::SIZE;
  const long long blocks = S * tiles;
  const int passes = key_bits <= 8 ? 1 : (key_bits + 7) / 8;
  const K* kin = static_cast<const K*>(keys);
  const int* vin = nullptr;
  K* kbuf[2] = {static_cast<K*>(keys_a), static_cast<K*>(keys_b)};
  int* vbuf[2] = {vals_a, vals_b};
  int* tot = hist + S * 256 * tiles;
  int sh = shift;
  for (int p = 0; p < passes; ++p) {
    const bool last = p == passes - 1;
    K* kout = last ? nullptr : kbuf[p & 1];
    int* vout = last ? out : vbuf[p & 1];
    seg_sort_hist<K><<<(unsigned)blocks, RADIX_THREADS, 0, stream>>>(
        kin, hist, L, tiles, sh, 8 * p);
    seg_sort_scan<<<(unsigned)(S * 256), SCAN_THREADS, 0, stream>>>(
        hist, tot, tiles);
    seg_sort_scatter<K><<<(unsigned)blocks, RADIX_THREADS, 0, stream>>>(
        kin, vin, kout, vout, hist, tot, L, tiles, sh, 8 * p);
    const int code = (int)cudaGetLastError();
    if (code) return code;
    kin = kout;
    vin = vout;
    sh = 0;
  }
  return 0;
}

}  // namespace

// wide: 0 = uint32 keys, 1 = int64 keys (non-negative, read as uint64);
// P the power of two >= L, lbits = log2 P
extern "C" int seg_sort_small_launch(const void* keys, int wide, int* out,
                                     long long S, int L, int P, int lbits,
                                     int shift, int composite64,
                                     void* stream) {
  if (S <= 0 || L <= 0) return 0;
  if (P < L || P > 4096 || (1 << lbits) != P) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (wide) {
    return composite64
               ? small_launch<unsigned long long, unsigned long long>(
                     keys, out, S, L, P, lbits, shift, st)
               : small_launch<unsigned long long, uint32_t>(
                     keys, out, S, L, P, lbits, shift, st);
  }
  return composite64 ? small_launch<uint32_t, unsigned long long>(
                           keys, out, S, L, P, lbits, shift, st)
                     : small_launch<uint32_t, uint32_t>(keys, out, S, L, P,
                                                        lbits, shift, st);
}

// scratch: keys_a / keys_b S * L keys of the input's width, vals_a /
// vals_b S * L ints (all four unused when key_bits <= 8), hist
// S * 256 * (ceil(L / tile) + 1) ints, the tile 4096 for uint32 keys
// and 2048 for int64
extern "C" int seg_sort_radix_launch(const void* keys, int wide, int* out,
                                     long long S, int L, int key_bits,
                                     int shift, void* keys_a, void* keys_b,
                                     int* vals_a, int* vals_b, int* hist,
                                     void* stream) {
  if (S <= 0 || L <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  return wide ? radix_launch<unsigned long long>(keys, out, S, L, key_bits,
                                                 shift, keys_a, keys_b, vals_a,
                                                 vals_b, hist, st)
              : radix_launch<uint32_t>(keys, out, S, L, key_bits, shift,
                                       keys_a, keys_b, vals_a, vals_b, hist,
                                       st);
}
