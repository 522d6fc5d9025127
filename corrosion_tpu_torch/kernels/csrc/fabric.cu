// fabric: the compute steps around the shard fabric's collectives.
//
// The validity wire replaces corrosion_tpu/models/sharded.py _pack_bits
// (:57) and _unpack_bits (:68): a [..., M] mask (M % 8 == 0) as
// [..., M/8] uint8, LSB first within each byte, the encoding the
// multi-host frontier layout puts on the wire, one bit a row.  Rows
// hold M % 8 == 0 positions, so a mask is read flat: wire byte b holds
// positions 8b .. 8b + 7, bit q position 8b + q.  Five entry points:
//   bits_pack          bool source: a lane packs 32 positions from two
//                      16-byte loads, each 8 bool bytes to a wire byte by
//                      one multiply, and stores the 4 bytes at once;
//   bits_pack_above    the wire of x > t on int32 x: lane l of a warp
//                      compares position 32 i + l, and the ballot is the
//                      4 wire bytes of those 32 (a warp's 32 ballots
//                      stored by its lanes, one coalesced 128-byte store);
//   bits_pack_active   the host layout's active predicate, infected (a
//                      window of the replicated mask, read by its row
//                      stride) & tx > 0 & next_send <= tick, as bool and
//                      as wire in one pass, the wire by ballots;
//   bits_unpack        wire to bool: a lane spreads a wire word into 32
//                      bool bytes by one multiply a byte, a warp's 1024
//                      positions stored in coalesced 16-byte chunks (the
//                      bits shuffled to the storing lane);
//   bits_unpack_add    accepted += unpack(wire) on int32, without the bool
//                      mask: with `first` it writes accepted whole as
//                      0 / 1 (the warp's chunks as above), else it reads
//                      the wire 16 bytes a lane and rewrites only the
//                      32-byte sectors that hold a set bit (a position
//                      has one owner: no atomics).
// Heads and tails that the vectors' alignment does not reach take a
// scalar path, a thread a wire byte.  The unpacks also write the set
// bits' count, the host's test of the exchange: each block adds its
// sum and a ticket to a per-stream 8-byte scratch word in one atomic,
// and the last block moves the sum out and zeroes the word, so nothing
// is filled between calls and a replayed CUDA graph counts right.  Grids
// are grid-stride, at most BITS_BLOCKS_PER_SM blocks an SM, but for the
// first round's unpack into accepted (a warp a tile).  Bound on the
// H100: bytes (the
// sources read once, the outputs written once; a later round of
// bits_unpack_add the wire and 64 bytes a sector holding a set bit).
//
// route_pack replaces the demand and packing steps of
// sharded_broadcast_step_ring (sharded.py:216-248), the
// destination-sorted fabric (its receive side is ring_receive, in
// deliver_perm.cu).  route_pack runs on one source shard
// ("me", rows [lo, lo + n_local)) for every destination shard d, in
// three launches chained by programmatic dependent launch, each grid
// spread over the whole card:
//   1. mark: a thread a receiver t reads its K senders (coalesced, K
//      loads in flight); where sender s is one of my active rows it sets
//      bit s - lo of destination t / n_local's mark words (atomicOr into
//      a scratch that is zero on entry);
//   2. count: each destination's marks cut into tiles of TILE local
//      indices (TILE_WORDS words); a tile's count is its words'
//      popcounts, TILE_WORDS lanes a tile;
//   3. write: a block a tile, a warp a word.  The tile's exclusive
//      offset within its destination and the destination's total come
//      from the counts; a needed row's slot is that offset plus its rank
//      in the tile (popcounts of the earlier words and lanes), so slots
//      run in ascending local index: the reference's sort of (index or
//      n_local) scores.  The ids go a lane a slot, the rows R / 4 lanes a
//      row in 16-byte loads and stores (a lane an int where R % 4 or an
//      alignment forbids); a row whose slot is at or past cap is counted
//      and not written.  The pad slots [min(total, cap), cap) are spread
//      over the destination's tiles by position (tile t pads those in
//      [t * TILE, (t + 1) * TILE)), -1 ids and zero rows in 16-byte
//      stores.  Each block clears the mark words it read, so the scratch
//      is zero again for the next call; the first block writes the
//      overflow (sum over d of max(0, total - cap)), so nothing is filled
//      beforehand.
// Bound on the H100: bytes — the K x N sender maps read once, my active
// flags and rows read once, the D x cap slots with their R keys written.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int PACK_THREADS = 256;
constexpr int TILE_WORDS = PACK_THREADS / 32;  // a warp a mark word
constexpr int TILE = TILE_WORDS * 32;          // local indices a tile
constexpr int MARK_LOADS = 4;  // sender loads a mark thread has in flight

// -- the validity wire -------------------------------------------------

constexpr int BITS_THREADS = 256;
constexpr int BITS_BLOCKS_PER_SM = 8;
constexpr unsigned FULL = 0xffffffffu;

// 8 bool bytes (each 0 or 1) to one wire byte: byte q to bit q
__device__ __forceinline__ unsigned pack8(uint64_t w) {
  return (unsigned)(((w & 0x0101010101010101ull) * 0x0102040810204080ull) >>
                    56);
}

// one wire byte to 8 bool bytes: bit q to byte q
__device__ __forceinline__ uint64_t spread8(unsigned v) {
  return (((((uint64_t)v * 0x0101010101010101ull) & 0x8040201008040201ull) +
           0x7F7F7F7F7F7F7F7Full) >>
          7) &
         0x0101010101010101ull;
}

// A flat wire of `bytes` bytes cut for the vector path: `head` bytes
// before the body, `units` body units of UNIT bytes, the rest (head and
// tail, `scalar` bytes) a thread a byte.
struct Split {
  int head, units, scalar;
};

template <int UNIT>
__device__ __forceinline__ int scalar_byte(const Split& s, int i) {
  return i < s.head ? i : i + s.units * UNIT;
}

// a 16-byte chunk of CHUNK positions from their CHUNK wire bits: 16
// bool bytes or 4 int32
template <int CHUNK>
__device__ __forceinline__ uint4 chunk_of(unsigned bits) {
  if constexpr (CHUNK == 16) {
    const uint64_t lo = spread8(bits & 0xffu), hi = spread8(bits >> 8);
    return make_uint4((unsigned)lo, (unsigned)(lo >> 32), (unsigned)hi,
                      (unsigned)(hi >> 32));
  } else {
    return make_uint4(bits & 1u, (bits >> 1) & 1u, (bits >> 2) & 1u,
                      bits >> 3);
  }
}

// wire word k (positions 32k .. 32k + 31) of a wire of `bytes` bytes:
// one 4-byte store, or its bytes where the wire ends inside it
__device__ __forceinline__ void store_word(unsigned char* wire, int bytes,
                                           int k, unsigned word) {
  const int b = 4 * k;
  if (b + 4 <= bytes) {
    *reinterpret_cast<unsigned*>(wire + b) = word;
  } else {
    for (int e = 0; b + e < bytes; ++e)
      wire[b + e] = (unsigned char)(word >> (8 * e));
  }
}

// the block's set bits and its ticket in one 64-bit atomic on the
// scratch word (the sum in the low half, the blocks done in the high);
// the last block writes the call's sum to *out and zeroes the word
__device__ __forceinline__ void finish_count(unsigned cnt,
                                             unsigned long long* scratch,
                                             int* out) {
  __shared__ unsigned block_sum;
  if (threadIdx.x == 0) block_sum = 0;
  __syncthreads();
  cnt = __reduce_add_sync(FULL, cnt);
  if ((threadIdx.x & 31) == 0 && cnt) atomicAdd(&block_sum, cnt);
  __syncthreads();
  if (threadIdx.x != 0) return;
  const unsigned long long old =
      atomicAdd(scratch, (1ull << 32) | block_sum);
  if ((old >> 32) == gridDim.x - 1) {
    *out = (int)((unsigned)old + block_sum);
    atomicExch(scratch, 0ull);
  }
}

// bool mask -> wire: a unit is 4 wire bytes, 32 positions from two
// 16-byte loads
__global__ void __launch_bounds__(BITS_THREADS)
    bits_pack_kernel(const unsigned char* __restrict__ mask,
                     unsigned char* __restrict__ wire, const Split s) {
  const int stride = gridDim.x * BITS_THREADS;
  for (int i = blockIdx.x * BITS_THREADS + threadIdx.x;
       i < s.units + s.scalar; i += stride) {
    if (i < s.units) {
      const int b = s.head + 4 * i;
      const uint4* src = reinterpret_cast<const uint4*>(mask + 8LL * b);
      const uint4 u = src[0], v = src[1];
      *reinterpret_cast<unsigned*>(wire + b) =
          pack8(((uint64_t)u.y << 32) | u.x) |
          pack8(((uint64_t)u.w << 32) | u.z) << 8 |
          pack8(((uint64_t)v.y << 32) | v.x) << 16 |
          pack8(((uint64_t)v.w << 32) | v.z) << 24;
    } else {
      const int b = scalar_byte<4>(s, i - s.units);
      uint64_t w = 0;
#pragma unroll
      for (int q = 0; q < 8; ++q) w |= (uint64_t)mask[8LL * b + q] << (8 * q);
      wire[b] = (unsigned char)pack8(w);
    }
  }
}

// wire -> bool (CHUNK 16, one byte a position) or -> int32 0 / 1 (CHUNK
// 4, bits_unpack_add's first round).  A warp's tile is 32 body words
// (1024 positions): lane l loads word l, and store j of lane l is the
// tile's 16-byte chunk 32 j + l, its bits shuffled from the word's lane.
template <int CHUNK, typename T>
__global__ void __launch_bounds__(BITS_THREADS)
    bits_unpack_kernel(const unsigned char* __restrict__ wire,
                       T* __restrict__ out, const Split s,
                       unsigned long long* __restrict__ scratch,
                       int* __restrict__ count) {
  constexpr int PER = 1024 / CHUNK / 32;  // a lane's chunks a tile
  const int tid = blockIdx.x * BITS_THREADS + threadIdx.x;
  const int stride = gridDim.x * BITS_THREADS;
  const int lane = threadIdx.x & 31;
  unsigned cnt = 0;
  for (int w0 = tid - lane; w0 < s.units; w0 += stride) {  // warp-uniform
    const int k = w0 + lane;
    const unsigned word =
        k < s.units
            ? *reinterpret_cast<const unsigned*>(wire + s.head + 4 * k)
            : 0u;
    cnt += __popc(word);
    uint4* dst = reinterpret_cast<uint4*>(out + 8LL * s.head + 32LL * w0);
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int c = 32 * j + lane;
      const int src = c * CHUNK / 32;
      const unsigned v = __shfl_sync(FULL, word, src);
      if (w0 + src < s.units)
        dst[c] = chunk_of<CHUNK>((v >> (c * CHUNK % 32)) &
                                 ((1u << CHUNK) - 1u));
    }
  }
  for (int i = tid; i < s.scalar; i += stride) {
    const int b = scalar_byte<4>(s, i);
    const unsigned v = wire[b];
    cnt += __popc(v);
#pragma unroll
    for (int q = 0; q < 8; ++q) out[8LL * b + q] = (T)((v >> q) & 1u);
  }
  if (count) finish_count(cnt, scratch, count);
}

// accepted += unpack(wire) after the first round: a unit is 16 wire
// bytes; a zero byte is skipped, a set one rewrites its 32-byte sector
__global__ void __launch_bounds__(BITS_THREADS)
    bits_unpack_add_kernel(const unsigned char* __restrict__ wire,
                           int* __restrict__ acc, const Split s,
                           unsigned long long* __restrict__ scratch,
                           int* __restrict__ count) {
  const int stride = gridDim.x * BITS_THREADS;
  unsigned cnt = 0;
  for (int i = blockIdx.x * BITS_THREADS + threadIdx.x;
       i < s.units + s.scalar; i += stride) {
    if (i < s.units) {
      const int b = s.head + 16 * i;
      const uint4 u = *reinterpret_cast<const uint4*>(wire + b);
      const unsigned words[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (!words[k]) continue;
        cnt += __popc(words[k]);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const unsigned v = (words[k] >> (8 * e)) & 0xffu;
          if (!v) continue;
          int4* p = reinterpret_cast<int4*>(acc + 8LL * (b + 4 * k + e));
          int4 x = p[0], y = p[1];
          x.x += v & 1u, x.y += (v >> 1) & 1u, x.z += (v >> 2) & 1u,
              x.w += (v >> 3) & 1u;
          y.x += (v >> 4) & 1u, y.y += (v >> 5) & 1u, y.z += (v >> 6) & 1u,
              y.w += v >> 7;
          p[0] = x, p[1] = y;
        }
      }
    } else {
      const int b = scalar_byte<16>(s, i - s.units);
      const unsigned v = wire[b];
      cnt += __popc(v);
      for (int q = 0; q < 8; ++q)
        if ((v >> q) & 1u) acc[8LL * b + q] += 1;
    }
  }
  if (count) finish_count(cnt, scratch, count);
}

// the wire of x > t over `n` positions of int32 x: a warp's tile is
// 1024 positions, lane l loads position 32 j + l of it and the warp's
// ballot of j is wire word j of the tile, which lane j stores
__global__ void __launch_bounds__(BITS_THREADS)
    bits_pack_above_kernel(const int* __restrict__ x, int t,
                           unsigned char* __restrict__ wire, int n) {
  const int lane = threadIdx.x & 31;
  const int stride = gridDim.x * BITS_THREADS;
  const int bytes = n / 8;
  for (int p0 = (blockIdx.x * BITS_THREADS + threadIdx.x - lane) * 32;
       p0 < n; p0 += stride * 32) {  // warp-uniform
    unsigned mine = 0;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      int v[16];
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int p = p0 + 32 * (16 * half + j) + lane;
        v[j] = p < n ? x[p] : t;
      }
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const unsigned bal = __ballot_sync(FULL, v[j] > t);
        if (lane == 16 * half + j) mine = bal;
      }
    }
    if (p0 + 32 * lane < n) store_word(wire, bytes, p0 / 32 + lane, mine);
  }
}

// the host layout's active rows: infected [s, m] by row stride ld,
// tx and next_send [s, m] contiguous; active [s, m] bool and the wire,
// flat, in the tiles of bits_pack_above_kernel, ACTIVE_BATCH positions
// a lane loaded at a time
constexpr int ACTIVE_BATCH = 8;

__global__ void __launch_bounds__(BITS_THREADS)
    bits_pack_active_kernel(const unsigned char* __restrict__ infected,
                            long long ld, const int* __restrict__ tx,
                            const int* __restrict__ next_send, int tick,
                            bool* __restrict__ active,
                            unsigned char* __restrict__ wire, int n, int m) {
  const int lane = threadIdx.x & 31;
  const int stride = gridDim.x * BITS_THREADS;
  const int bytes = n / 8;
  for (int p0 = (blockIdx.x * BITS_THREADS + threadIdx.x - lane) * 32;
       p0 < n; p0 += stride * 32) {  // warp-uniform
    // my first position's row and column, then 32 further each step
    int row = (p0 + lane) / m, col = (p0 + lane) - row * m;
    unsigned mine = 0;
#pragma unroll
    for (int j0 = 0; j0 < 32; j0 += ACTIVE_BATCH) {
      unsigned char inf[ACTIVE_BATCH];
      int txv[ACTIVE_BATCH], nsv[ACTIVE_BATCH];
#pragma unroll
      for (int j = 0; j < ACTIVE_BATCH; ++j) {
        const int p = p0 + 32 * (j0 + j) + lane;
        const bool in = p < n;
        inf[j] = in ? infected[row * ld + col] : 0;
        txv[j] = in ? tx[p] : 0;
        nsv[j] = in ? next_send[p] : 0;
        for (col += 32; col >= m; col -= m) ++row;
      }
#pragma unroll
      for (int j = 0; j < ACTIVE_BATCH; ++j) {
        const int p = p0 + 32 * (j0 + j) + lane;
        const bool a = inf[j] && txv[j] > 0 && nsv[j] <= tick;
        if (p < n) active[p] = a;
        const unsigned bal = __ballot_sync(FULL, a);
        if (lane == j0 + j) mine = bal;
      }
    }
    if (p0 + 32 * lane < n) store_word(wire, bytes, p0 / 32 + lane, mine);
  }
}

// -- route_pack: three launches, each after the one before under
// programmatic dependent launch (griddepcontrol), over a scratch of
// mark words [d][words] (zero on entry, left zero) and tile counts
// [d][tiles] (written whole).  A tile is TILE_WORDS mark words, TILE
// local indices of one destination.

struct Pack {
  const int* senders;           // [k, n]
  const unsigned char* active;  // [n_local]
  const int* rows;              // [n_local, r]
  unsigned* marks;              // [d, words]
  int* counts;                  // [d, tiles]
  int* send_ids;                // [d, cap]
  int* send_rows;               // [d, cap, r]
  int* overflow;                // [1]
  int k, n, lo, n_local, d, cap, r, words, tiles;
  int vec;                      // rows and send_rows in int4 (r % 4 == 0)
};

// 1. mark: a thread a receiver t; for each of its k senders that is one
//    of my active rows, set bit il of destination t / n_local's words
//    (the reference's scatter-max of `mine` into needed, then & active)
__device__ __forceinline__ void mark_receiver(const Pack& a, int t) {
  unsigned* marks = a.marks + (size_t)(t / a.n_local) * a.words;
  for (int j0 = 0; j0 < a.k; j0 += MARK_LOADS) {
    unsigned il[MARK_LOADS];
#pragma unroll
    for (int q = 0; q < MARK_LOADS; ++q)
      il[q] = j0 + q < a.k
                  ? (unsigned)__ldg(a.senders + (size_t)(j0 + q) * a.n + t) -
                        (unsigned)a.lo
                  : 0xffffffffu;
    bool act[MARK_LOADS];  // the flags loaded together, then the marks
#pragma unroll
    for (int q = 0; q < MARK_LOADS; ++q)
      act[q] = il[q] < (unsigned)a.n_local && __ldg(a.active + il[q]);
#pragma unroll
    for (int q = 0; q < MARK_LOADS; ++q)
      if (act[q]) atomicOr(marks + (il[q] >> 5), 1u << (il[q] & 31));
  }
}

__global__ void __launch_bounds__(PACK_THREADS)
    route_mark_kernel(const Pack a) {
  asm volatile("griddepcontrol.launch_dependents;");
  const int t = blockIdx.x * PACK_THREADS + threadIdx.x;
  if (t < a.n) mark_receiver(a, t);
}

// 2. count: TILE_WORDS lanes a tile, each the popcount of its word,
//    summed over the lanes of the tile into counts[d][tile]
//    (g: the thread's index over all tiles' lanes; every lane of a warp
//    takes part)
__device__ __forceinline__ void count_tile(const Pack& a, int g) {
  const int x = g / TILE_WORDS;  // the tile, d * tiles + its index
  const int dest = x / a.tiles, w = (x - dest * a.tiles) * TILE_WORDS +
                                     g % TILE_WORDS;
  int c = x < a.d * a.tiles && w < a.words
              ? __popc(__ldcg(a.marks + (size_t)dest * a.words + w))
              : 0;
#pragma unroll
  for (int o = TILE_WORDS / 2; o > 0; o /= 2)
    c += __shfl_xor_sync(0xffffffffu, c, o);
  if (g % TILE_WORDS == 0 && x < a.d * a.tiles) a.counts[x] = c;
}

__global__ void __launch_bounds__(PACK_THREADS)
    route_count_kernel(const Pack a) {
  asm volatile("griddepcontrol.launch_dependents;");
  asm volatile("griddepcontrol.wait;" ::: "memory");
  count_tile(a, blockIdx.x * PACK_THREADS + threadIdx.x);
}

// ints [from, to) of p set to zero, 16-byte stores where p's alignment
// allows (mis: p's address / 4 mod 4), by the block's threads
__device__ __forceinline__ void zero_ints(int* p, int mis, long long from,
                                          long long to) {
  long long body = ((from + mis + 3) & ~3LL) - mis;  // first aligned int
  if (body > to) body = to;
  long long tail = ((to + mis) & ~3LL) - mis;        // end of the int4s
  if (tail < body) tail = body;
  for (long long e = from + threadIdx.x; e < body; e += PACK_THREADS)
    p[e] = 0;
  const int4 zero = make_int4(0, 0, 0, 0);
  int4* p4 = reinterpret_cast<int4*>(p + body);
  for (long long e = threadIdx.x; e < (tail - body) / 4; e += PACK_THREADS)
    p4[e] = zero;
  for (long long e = tail + threadIdx.x; e < to; e += PACK_THREADS)
    p[e] = 0;
}

// 3. write: a block a tile (warp w its word w).  The tile's offset in
//    its destination and the destination's total from the counts; each
//    needed row's slot = offset + its rank in the tile (ascending local
//    index, the reference's sort of (index or n_local) scores); the ids
//    a lane a slot, the rows R / 4 lanes a row in int4 (a lane an int
//    where r % 4 or an alignment forbids); slots at or past cap counted
//    and not written.  The tile's marks are cleared as read.  The pad
//    slots [min(total, cap), cap) of the destination that fall in
//    [tile * TILE, (tile + 1) * TILE) are this tile's to write: -1 ids,
//    zero rows in int4.  Tile 0 of destination 0 writes the overflow.
__device__ __forceinline__ void write_tile(const Pack& a, int x) {
  __shared__ int list[TILE];
  __shared__ int word_count[TILE_WORDS];
  __shared__ int sums[3][PACK_THREADS / 32];
  const int dest = x / a.tiles, t = x - dest * a.tiles;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  // the tiles before mine and all of my destination's (and, for block
  // 0, the overflow of every destination)
  const int* counts = a.counts + (size_t)dest * a.tiles;
  int before = 0, total = 0;
  for (int u = threadIdx.x; u < a.tiles; u += PACK_THREADS) {
    const int c = __ldcg(counts + u);
    total += c;
    before += u < t ? c : 0;
  }
  int over = 0;
  if (x == 0)
    for (int e = threadIdx.x; e < a.d; e += PACK_THREADS) {
      int sum = 0;
      for (int u = 0; u < a.tiles; ++u)
        sum += __ldcg(a.counts + (size_t)e * a.tiles + u);
      over += max(0, sum - a.cap);
    }
#pragma unroll
  for (int o = 16; o > 0; o /= 2) {
    before += __shfl_xor_sync(0xffffffffu, before, o);
    total += __shfl_xor_sync(0xffffffffu, total, o);
    over += __shfl_xor_sync(0xffffffffu, over, o);
  }
  // my word: its bits, cleared for the next call
  const int w = t * TILE_WORDS + warp;
  unsigned word = 0;
  if (w < a.words) {
    unsigned* mp = a.marks + (size_t)dest * a.words + w;
    word = __ldcg(mp);
    if (lane == 0 && word) *mp = 0u;
  }
  if (lane == 0) {
    sums[0][warp] = before;
    sums[1][warp] = total;
    sums[2][warp] = over;
    word_count[warp] = __popc(word);
  }
  __syncthreads();
  before = total = over = 0;
  int rank = 0, count = 0;
#pragma unroll
  for (int v = 0; v < PACK_THREADS / 32; ++v) {
    before += sums[0][v];
    total += sums[1][v];
    over += sums[2][v];
    rank += v < warp ? word_count[v] : 0;
    count += word_count[v];
  }
  if (x == 0 && threadIdx.x == 0) *a.overflow = over;
  if ((word >> lane) & 1u)
    list[rank + __popc(word & ((1u << lane) - 1u))] =
        t * TILE + warp * 32 + lane;
  __syncthreads();
  const int fit = max(0, min(count, a.cap - before));
  const size_t slot0 = (size_t)dest * a.cap + before;
  for (int q = threadIdx.x; q < fit; q += PACK_THREADS)
    a.send_ids[slot0 + q] = a.lo + list[q];
  if (a.vec) {
    const int r4 = a.r / 4;
    const int4* in = reinterpret_cast<const int4*>(a.rows);
    int4* out = reinterpret_cast<int4*>(a.send_rows) + slot0 * r4;
    for (int e = threadIdx.x; e < fit * r4; e += PACK_THREADS) {
      const int q = e / r4;
      out[e] = __ldg(in + (size_t)list[q] * r4 + (e - q * r4));
    }
  } else {
    int* out = a.send_rows + slot0 * a.r;
    for (int e = threadIdx.x; e < fit * a.r; e += PACK_THREADS) {
      const int q = e / a.r;
      out[e] = __ldg(a.rows + (size_t)list[q] * a.r + (e - q * a.r));
    }
  }
  const int pad_from = max(t * TILE, min(total, a.cap));
  const int pad_to = min((t + 1) * TILE, a.cap);
  if (pad_from >= pad_to) return;
  const size_t pad0 = (size_t)dest * a.cap;
  for (int p = pad_from + threadIdx.x; p < pad_to; p += PACK_THREADS)
    a.send_ids[pad0 + p] = -1;
  const int mis =
      (int)((reinterpret_cast<uintptr_t>(a.send_rows) >> 2) & 3);
  zero_ints(a.send_rows, mis, (long long)(pad0 + pad_from) * a.r,
            (long long)(pad0 + pad_to) * a.r);
}

__global__ void __launch_bounds__(PACK_THREADS)
    route_write_kernel(const Pack a) {
  asm volatile("griddepcontrol.wait;" ::: "memory");
  write_tile(a, blockIdx.x);
}

cudaError_t launch_after(void (*kernel)(const Pack), unsigned blocks,
                         const Pack& a, cudaStream_t st) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(PACK_THREADS);
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, a);
}

Pack pack_args(const void* senders, const void* active, const void* rows,
               void* scratch, void* send_ids, void* send_rows,
               void* overflow, int k, int n, int lo, int n_local, int d,
               int cap, int r) {
  Pack a;
  a.senders = static_cast<const int*>(senders);
  a.active = static_cast<const unsigned char*>(active);
  a.rows = static_cast<const int*>(rows);
  a.words = (n_local + 31) / 32;
  a.tiles = (n_local + TILE - 1) / TILE;
  a.marks = static_cast<unsigned*>(scratch);
  a.counts = static_cast<int*>(scratch) + (size_t)d * a.words;
  a.send_ids = static_cast<int*>(send_ids);
  a.send_rows = static_cast<int*>(send_rows);
  a.overflow = static_cast<int*>(overflow);
  a.k = k, a.n = n, a.lo = lo, a.n_local = n_local, a.d = d, a.cap = cap,
  a.r = r;
  a.vec = r % 4 == 0 && (reinterpret_cast<uintptr_t>(rows) & 15) == 0 &&
          (reinterpret_cast<uintptr_t>(send_rows) & 15) == 0;
  return a;
}

}  // namespace

namespace {

int sm_count() {
  static int counts[64];
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 64) dev = 0;
  if (!counts[dev])
    cudaDeviceGetAttribute(&counts[dev], cudaDevAttrMultiProcessorCount, dev);
  return counts[dev] > 0 ? counts[dev] : 132;
}

// blocks for `threads` threads of work, at least one; at most
// BITS_BLOCKS_PER_SM an SM where `capped` (the first round's unpack into
// accepted takes a warp a tile: its blocks retire and start one by one,
// where a warp's loop over tiles leaves an uneven tail)
unsigned bits_grid(long long threads, bool capped = true) {
  const long long cap = (long long)sm_count() * BITS_BLOCKS_PER_SM;
  const long long want = (threads + BITS_THREADS - 1) / BITS_THREADS;
  return (unsigned)(want < 1 ? 1 : !capped || want < cap ? want : cap);
}

// `bytes` wire bytes cut for units of `unit` wire bytes: the body starts
// at the first byte where the wire is `align`-byte aligned and the other
// side (`per` bytes a wire byte) 16-byte aligned; where no byte is both,
// every byte takes the scalar path
Split split(const void* wire, int align, int unit, const void* side, int per,
            int bytes) {
  const uintptr_t w = reinterpret_cast<uintptr_t>(wire),
                  o = reinterpret_cast<uintptr_t>(side);
  Split s{bytes, 0, bytes};
  for (int h = 0; h < 16 && h <= bytes; ++h)
    if ((w + h) % align == 0 && (o + (uintptr_t)h * per) % 16 == 0) {
      s.head = h;
      s.units = (bytes - h) / unit;
      s.scalar = bytes - s.units * unit;
      break;
    }
  return s;
}

// positions (8 a wire byte) stay below 2**30, so a grid-stride step
// never overflows an int
bool too_big(long long bytes) { return bytes < 0 || bytes >= (1LL << 27); }

}  // namespace

// mask [n_bytes * 8] bool -> wire [n_bytes]
extern "C" int bits_pack_launch(const void* mask, void* wire,
                                long long n_bytes, void* stream) {
  if (too_big(n_bytes)) return (int)cudaErrorInvalidValue;
  if (n_bytes == 0) return 0;
  const Split s = split(wire, 4, 4, mask, 8, (int)n_bytes);
  bits_pack_kernel<<<bits_grid(s.units + s.scalar), BITS_THREADS, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned char*>(mask),
      static_cast<unsigned char*>(wire), s);
  return (int)cudaGetLastError();
}

// wire [n_bytes] -> mask [n_bytes * 8] bool; with `count` (and its
// scratch, one 8-byte zero word) the set bits' count into count[0]
extern "C" int bits_unpack_launch(const void* wire, void* mask,
                                  long long n_bytes, void* scratch,
                                  void* count, void* stream) {
  if (too_big(n_bytes) || !scratch != !count)
    return (int)cudaErrorInvalidValue;
  if (n_bytes == 0 && !count) return 0;
  const Split s = split(wire, 4, 4, mask, 8, (int)n_bytes);
  bits_unpack_kernel<16, bool>
      <<<bits_grid(s.units > s.scalar ? s.units : s.scalar), BITS_THREADS, 0,
         static_cast<cudaStream_t>(stream)>>>(
          static_cast<const unsigned char*>(wire), static_cast<bool*>(mask),
          s, static_cast<unsigned long long*>(scratch),
          static_cast<int*>(count));
  return (int)cudaGetLastError();
}

// accepted [n_bytes * 8] int32 += unpack(wire) (= it, with `first`);
// with `count` (and its scratch, one 8-byte zero word) the set bits'
// count into count[0]
extern "C" int bits_unpack_add_launch(const void* wire, void* accepted,
                                      long long n_bytes, int first,
                                      void* scratch, void* count,
                                      void* stream) {
  if (too_big(n_bytes) || !scratch != !count)
    return (int)cudaErrorInvalidValue;
  if (n_bytes == 0 && !count) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned char* w = static_cast<const unsigned char*>(wire);
  int* acc = static_cast<int*>(accepted);
  unsigned long long* sc = static_cast<unsigned long long*>(scratch);
  int* out = static_cast<int*>(count);
  if (first) {
    const Split s = split(wire, 4, 4, accepted, 32, (int)n_bytes);
    bits_unpack_kernel<4, int>
        <<<bits_grid(s.units > s.scalar ? s.units : s.scalar, false),
           BITS_THREADS, 0, st>>>(w, acc, s, sc, out);
  } else {
    const Split s = split(wire, 16, 16, accepted, 32, (int)n_bytes);
    bits_unpack_add_kernel<<<bits_grid(s.units + s.scalar), BITS_THREADS, 0,
                             st>>>(w, acc, s, sc, out);
  }
  return (int)cudaGetLastError();
}

// x [n] int32 (n % 8 == 0) -> the wire of x > t, [n / 8], 4-byte aligned
extern "C" int bits_pack_above_launch(const void* x, int t, void* wire,
                                      long long n, void* stream) {
  if (n < 0 || n % 8 || too_big(n / 8) ||
      reinterpret_cast<uintptr_t>(wire) % 4)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  bits_pack_above_kernel<<<bits_grid((n + 31) / 32), BITS_THREADS, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(x), t, static_cast<unsigned char*>(wire),
      (int)n);
  return (int)cudaGetLastError();
}

// infected [s, m] bool by row stride ld (>= m), tx / next_send [s, m]
// int32 -> active [s, m] bool and its wire [s, m / 8], 4-byte aligned
extern "C" int bits_pack_active_launch(const void* infected, long long ld,
                                       const void* tx, const void* next_send,
                                       int tick, void* active, void* wire,
                                       int s, int m, void* stream) {
  const long long n = (long long)s * m;
  if (s < 0 || m < 0 || m % 8 || (s > 1 && ld < m) ||
      too_big(n / 8) || reinterpret_cast<uintptr_t>(wire) % 4)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  bits_pack_active_kernel<<<bits_grid((n + 31) / 32), BITS_THREADS, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned char*>(infected), ld,
      static_cast<const int*>(tx), static_cast<const int*>(next_send), tick,
      static_cast<bool*>(active), static_cast<unsigned char*>(wire), (int)n,
      m);
  return (int)cudaGetLastError();
}

// the scratch route_pack needs, in int32 words: d * words marks, then
// d * tiles counts
extern "C" int route_pack_scratch_words(int n_local, int d) {
  return d * ((n_local + 31) / 32 + (n_local + TILE - 1) / TILE);
}

// needed: route_pack_scratch_words(n_local, d) int32 words, zero on the
// first call; the kernels leave the marks zero and write the rest
extern "C" int route_pack_launch(const void* senders, const void* active,
                                 const void* rows, void* needed,
                                 void* send_ids, void* send_rows,
                                 void* overflow, int k, int n, int lo,
                                 int n_local, int d, int cap, int r,
                                 void* stream) {
  if (k < 1 || n < 1 || n_local < 1 || d < 1 || cap < 1 || r < 1 ||
      cap > n_local || (long long)n_local * d != n)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Pack a = pack_args(senders, active, rows, needed, send_ids,
                           send_rows, overflow, k, n, lo, n_local, d, cap,
                           r);
  const unsigned tiles = (unsigned)d * (unsigned)a.tiles;
  route_mark_kernel<<<(n + PACK_THREADS - 1) / PACK_THREADS, PACK_THREADS,
                      0, st>>>(a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  e = launch_after(route_count_kernel,
                   (tiles * TILE_WORDS + PACK_THREADS - 1) / PACK_THREADS, a,
                   st);
  if (e != cudaSuccess) return (int)e;
  return (int)launch_after(route_write_kernel, tiles, a, st);
}
