// sync_pull: one anti-entropy round, every node pulling from its peers.
//
// Replaces corrosion_tpu/models/sync.py sync_step (:90) with
// session_msgs (:66) and the peer draw / bidirectional partition test
// of models/common.py (rand_peers :35, partition_ok :65).  The
// reference gathers [N, P, R] peer rows, counts the cells each peer is
// ahead on, max-merges, and charges the sessions with a scatter-add.
//
// One thread per client i.  For each of its P draws it forms the peer
// base + (local + offset) % u inside its own universe, tests that both
// directions between the two blocks are up while the partition is in
// force, loads the peer's row, counts the cells where the peer is
// strictly ahead of the client's own row and max-merges them in
// registers.  The server half of the handshake plus ceil(ahead / cells
// per chunk) chunk messages go to the peer's counter with an integer
// atomicAdd, the client half to its own — integer sums, so the result
// is the same in any order.  The merged row goes to a fresh buffer
// (peers read the old rows); msgs_out arrives holding a copy of msgs.
//
// Bound on the H100: bytes — the client row, one random peer row per
// draw, the offsets and the [N] counters, each moved once (about 0.25
// GB per sync tick at N = 3.2M, R = 8, P = 1).  The atomics land on
// random counters and rarely collide.

#include <cstdint>
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

using common::load_row;
using common::store_row;

struct SyncArgs {
  const int* rows;
  const int* offs;  // [N, P] offsets in 1..u-1
  const int* part;  // [N] or null (no partition)
  const unsigned char* sev;  // [B, B] or null (symmetric)
  int sev_b;
  int part_active;
  int* rows_out;
  int* msgs_out;
  int n;
  int p;
  int u;
  int cells_per_chunk;
  int handshake;
};

template <int R>
__global__ void sync_pull_kernel(const SyncArgs a) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.n) return;
  int own[R], acc[R];
  load_row<R>(a.rows + (size_t)i * R, own);
#pragma unroll
  for (int c = 0; c < R; ++c) acc[c] = own[c];
  const int local = i % a.u;
  const int base = i - local;
  const int server_half = a.handshake - a.handshake / 2;
  int sessions = 0;
  for (int q = 0; q < a.p; ++q) {
    const int off = a.offs[(size_t)i * a.p + q];
    const int peer = base + (local + off) % a.u;
    // a session needs both directions up; none: nothing served or paid
    if (a.part && a.part_active &&
        common::blocks_cross(a.part[i], a.part[peer], a.sev, a.sev_b, true))
      continue;
    int g[R];
    load_row<R>(a.rows + (size_t)peer * R, g);
    int ahead = 0;
#pragma unroll
    for (int c = 0; c < R; ++c) {
      ahead += g[c] > own[c];
      acc[c] = max(acc[c], g[c]);
    }
    ++sessions;
    const int chunks = (ahead + a.cells_per_chunk - 1) / a.cells_per_chunk;
    atomicAdd(a.msgs_out + peer, server_half + chunks);
  }
  store_row<R>(a.rows_out + (size_t)i * R, acc);
  if (sessions) atomicAdd(a.msgs_out + i, sessions * (a.handshake / 2));
}

}  // namespace

extern "C" int sync_pull_launch(const void* rows, const void* offs,
                                const void* part, const void* sev, int sev_b,
                                int part_active, void* rows_out,
                                void* msgs_out, int n, int r, int p, int u,
                                int cells_per_chunk, int handshake,
                                void* stream) {
  if (n <= 0) return 0;
  if (u < 1 || cells_per_chunk < 1) return (int)cudaErrorInvalidValue;
  SyncArgs a;
  a.rows = static_cast<const int*>(rows);
  a.offs = static_cast<const int*>(offs);
  a.part = static_cast<const int*>(part);
  a.sev = static_cast<const unsigned char*>(sev);
  a.sev_b = sev_b;
  a.part_active = part_active;
  a.rows_out = static_cast<int*>(rows_out);
  a.msgs_out = static_cast<int*>(msgs_out);
  a.n = n;
  a.p = p;
  a.u = u;
  a.cells_per_chunk = cells_per_chunk;
  a.handshake = handshake;
  const int threads = 256;
  const int blocks = (n + threads - 1) / threads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (r) {
#define SYNC_CASE(RR) \
  case RR:            \
    sync_pull_kernel<RR><<<blocks, threads, 0, s>>>(a); \
    break;
    SYNC_CASE(1) SYNC_CASE(2) SYNC_CASE(3) SYNC_CASE(4)
    SYNC_CASE(5) SYNC_CASE(6) SYNC_CASE(7) SYNC_CASE(8)
    SYNC_CASE(9) SYNC_CASE(10) SYNC_CASE(11) SYNC_CASE(12)
    SYNC_CASE(13) SYNC_CASE(14) SYNC_CASE(15) SYNC_CASE(16)
#undef SYNC_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
