// fabric: the compute steps around the shard fabric's collectives.
//
// bits_pack / bits_unpack replace corrosion_tpu/models/sharded.py
// _pack_bits (:57) and _unpack_bits (:68): a [..., M] bool mask (M % 8
// == 0) as [..., M/8] uint8, LSB first within each byte — the encoding
// the multi-host frontier layout puts on the wire, one bit a row.  One
// thread per packed byte: it reads (or writes) its eight bool bytes as
// one 8-byte word.  Bound on the H100: bytes (M + M/8 a row, each once).
//
// route_pack / route_slots replace the demand, packing and slot-map
// steps of sharded_broadcast_step_ring (sharded.py:216-259), the
// destination-sorted fabric.  route_pack runs on one source shard
// ("me", rows [lo, lo + n_local)) for every destination shard d:
//   1. mark: one thread per (column j, receiver t) reads sender
//      s = senders[j][t]; if s is one of my rows and that row is active,
//      needed[t / n_local][s - lo] = 1 (idempotent byte stores into a
//      zeroed [D, n_local] scratch);
//   2. compact: one block per destination walks its needed row in
//      ascending local index with a block-wide prefix count, writes the
//      first cap needed rows' global ids and their R keys into slots
//      0..cap-1 of send_ids [D, cap] / send_rows [D, cap, R] (a stable
//      compaction, not a sort: the reference's sort of (index or
//      n_local) scores keeps exactly this order), pads the rest with -1
//      and zero keys, and adds what did not fit to the overflow count.
// route_slots inverts the received ids: slot_of[id] = position of id in
// recv_ids, -1 for an id not received (ids are unique: the shards own
// disjoint rows), a fill pass then a scatter pass.
// Bound on the H100: bytes — the K x N sender maps read once (mark),
// the [D, n_local] marks written and read, and the D x cap slots with
// their R keys written (compact); N + D x cap words (slots).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int COMPACT_THREADS = 1024;

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

__global__ void route_mark_kernel(const int* __restrict__ senders,
                                  const unsigned char* __restrict__ active,
                                  unsigned char* __restrict__ needed,
                                  long long total, int n, int lo,
                                  int n_local) {
  const long long q = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (q >= total) return;
  const int t = (int)(q % n);  // the receiver of column q / n
  const int s = senders[q];
  const int il = s - lo;
  if (il < 0 || il >= n_local || !active[il]) return;
  needed[(size_t)(t / n_local) * n_local + il] = 1;
}

__global__ void __launch_bounds__(COMPACT_THREADS)
    route_compact_kernel(const unsigned char* __restrict__ needed,
                         const int* __restrict__ rows, int* send_ids,
                         int* send_rows, int* overflow, int lo, int n_local,
                         int cap, int r) {
  const int d = blockIdx.x;
  const unsigned char* need = needed + (size_t)d * n_local;
  int* ids = send_ids + (size_t)d * cap;
  int* out = send_rows + (size_t)d * cap * r;
  __shared__ int warp_count[COMPACT_THREADS / 32];
  __shared__ int base;
  if (threadIdx.x == 0) base = 0;
  __syncthreads();
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  for (int start = 0; start < n_local; start += COMPACT_THREADS) {
    const int i = start + threadIdx.x;
    const bool hit = i < n_local && need[i];
    const unsigned ballot = __ballot_sync(0xffffffffu, hit);
    if (lane == 0) warp_count[warp] = __popc(ballot);
    __syncthreads();
    int before = base;
    for (int w = 0; w < warp; ++w) before += warp_count[w];
    before += __popc(ballot & ((1u << lane) - 1u));
    if (hit && before < cap) {
      ids[before] = lo + i;
      const int* src = rows + (size_t)i * r;
      int* dst = out + (size_t)before * r;
      for (int c = 0; c < r; ++c) dst[c] = src[c];
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      int sum = 0;
      for (int w = 0; w < COMPACT_THREADS / 32; ++w) sum += warp_count[w];
      base += sum;
    }
    __syncthreads();
  }
  const int total = base;
  for (int p = min(total, cap) + threadIdx.x; p < cap;
       p += COMPACT_THREADS) {
    ids[p] = -1;
    for (int c = 0; c < r; ++c) out[(size_t)p * r + c] = 0;
  }
  if (threadIdx.x == 0 && total > cap) atomicAdd(overflow, total - cap);
}

__global__ void fill_kernel(int* __restrict__ slot_of, int n) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i < n) slot_of[i] = -1;
}

__global__ void route_slots_kernel(const int* __restrict__ recv_ids,
                                   int* __restrict__ slot_of, int q_total,
                                   int n) {
  const int q = blockIdx.x * THREADS + threadIdx.x;
  if (q >= q_total) return;
  const int id = recv_ids[q];
  if (id >= 0 && id < n) slot_of[id] = q;
}

unsigned grid(long long total) {
  return (unsigned)((total + THREADS - 1) / THREADS);
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

extern "C" int route_pack_launch(const void* senders, const void* active,
                                 const void* rows, void* needed,
                                 void* send_ids, void* send_rows,
                                 void* overflow, int k, int n, int lo,
                                 int n_local, int d, int cap, int r,
                                 void* stream) {
  if (k < 1 || n < 1 || n_local < 1 || d < 1 || cap < 1 || r < 1 ||
      (long long)n_local * d != n)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long total = (long long)k * n;
  route_mark_kernel<<<grid(total), THREADS, 0, st>>>(
      static_cast<const int*>(senders),
      static_cast<const unsigned char*>(active),
      static_cast<unsigned char*>(needed), total, n, lo, n_local);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  route_compact_kernel<<<d, COMPACT_THREADS, 0, st>>>(
      static_cast<const unsigned char*>(needed),
      static_cast<const int*>(rows), static_cast<int*>(send_ids),
      static_cast<int*>(send_rows), static_cast<int*>(overflow), lo,
      n_local, cap, r);
  return (int)cudaGetLastError();
}

extern "C" int route_slots_launch(const void* recv_ids, void* slot_of,
                                  int q_total, int n, void* stream) {
  if (n < 1 || q_total < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  fill_kernel<<<grid(n), THREADS, 0, st>>>(static_cast<int*>(slot_of), n);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || q_total == 0) return (int)e;
  route_slots_kernel<<<grid(q_total), THREADS, 0, st>>>(
      static_cast<const int*>(recv_ids), static_cast<int*>(slot_of),
      q_total, n);
  return (int)cudaGetLastError();
}
