// fabric: the compute steps around the shard fabric's collectives.
//
// bits_pack / bits_unpack replace corrosion_tpu/models/sharded.py
// _pack_bits (:57) and _unpack_bits (:68): a [..., M] bool mask (M % 8
// == 0) as [..., M/8] uint8, LSB first within each byte — the encoding
// the multi-host frontier layout puts on the wire, one bit a row.  One
// thread per packed byte: it reads (or writes) its eight bool bytes as
// one 8-byte word.  Bound on the H100: bytes (M + M/8 a row, each once).
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

constexpr int THREADS = 256;
constexpr int PACK_THREADS = 256;
constexpr int TILE_WORDS = PACK_THREADS / 32;  // a warp a mark word
constexpr int TILE = TILE_WORDS * 32;          // local indices a tile
constexpr int MARK_LOADS = 4;  // sender loads a mark thread has in flight

__global__ void bits_pack_kernel(const uint64_t* __restrict__ mask,
                                 unsigned char* __restrict__ wire,
                                 long long n_bytes) {
  const long long b = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (b >= n_bytes) return;
  const uint64_t w = mask[b];
  unsigned v = 0;
#pragma unroll
  for (int q = 0; q < 8; ++q) v |= (unsigned)((w >> (8 * q)) & 1u) << q;
  wire[b] = (unsigned char)v;
}

__global__ void bits_unpack_kernel(const unsigned char* __restrict__ wire,
                                   uint64_t* __restrict__ mask,
                                   long long n_bytes) {
  const long long b = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (b >= n_bytes) return;
  const unsigned v = wire[b];
  uint64_t w = 0;
#pragma unroll
  for (int q = 0; q < 8; ++q) w |= (uint64_t)((v >> q) & 1u) << (8 * q);
  mask[b] = w;
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

unsigned grid(long long total) {
  return (unsigned)((total + THREADS - 1) / THREADS);
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

extern "C" int bits_pack_launch(const void* mask, void* wire,
                                long long n_bytes, void* stream) {
  if (n_bytes <= 0) return 0;
  bits_pack_kernel<<<grid(n_bytes), THREADS, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint64_t*>(mask), static_cast<unsigned char*>(wire),
      n_bytes);
  return (int)cudaGetLastError();
}

extern "C" int bits_unpack_launch(const void* wire, void* mask,
                                  long long n_bytes, void* stream) {
  if (n_bytes <= 0) return 0;
  bits_unpack_kernel<<<grid(n_bytes), THREADS, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned char*>(wire), static_cast<uint64_t*>(mask),
      n_bytes);
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
