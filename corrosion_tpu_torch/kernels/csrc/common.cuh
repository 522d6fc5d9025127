// Device helpers shared by the simulator's kernels.
#pragma once

#include <cuda_runtime.h>

namespace common {

// "not infected yet" hop depth (models/broadcast.py HOP_UNSET)
constexpr int HOP_UNSET = 1 << 30;

// A node's R packed keys to or from registers (R a template
// parameter): 16-byte vector accesses when R % 4 == 0 (the wrappers
// check 16-byte alignment).

template <int R>
__device__ __forceinline__ void load_row(const int* __restrict__ p,
                                         int (&v)[R]) {
  if constexpr (R % 4 == 0) {
    const int4* q = reinterpret_cast<const int4*>(p);
#pragma unroll
    for (int c = 0; c < R / 4; ++c) {
      const int4 w = q[c];
      v[4 * c] = w.x;
      v[4 * c + 1] = w.y;
      v[4 * c + 2] = w.z;
      v[4 * c + 3] = w.w;
    }
  } else {
#pragma unroll
    for (int c = 0; c < R; ++c) v[c] = p[c];
  }
}

template <int R>
__device__ __forceinline__ void store_row(int* __restrict__ p,
                                          const int (&v)[R]) {
  if constexpr (R % 4 == 0) {
    int4* q = reinterpret_cast<int4*>(p);
#pragma unroll
    for (int c = 0; c < R / 4; ++c)
      q[c] = make_int4(v[4 * c], v[4 * c + 1], v[4 * c + 2], v[4 * c + 3]);
  } else {
#pragma unroll
    for (int c = 0; c < R; ++c) p[c] = v[c];
  }
}

// True where traffic from block src to block dst is cut while the
// partition is in force: any two different blocks when sev is null
// (symmetric), else the listed directions of the b x b severance
// matrix (ids clamped to its all-false pad row); bidirectional cuts a
// link when either direction is listed.
__device__ __forceinline__ bool blocks_cross(int src, int dst,
                                             const unsigned char* sev, int b,
                                             bool bidirectional) {
  if (sev == nullptr) return src != dst;
  const int s = min(src, b - 1), d = min(dst, b - 1);
  return sev[s * b + d] != 0 || (bidirectional && sev[d * b + s] != 0);
}

}  // namespace common
