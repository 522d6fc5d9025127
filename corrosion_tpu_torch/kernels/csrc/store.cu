// The device clock cache's array store: store_gather and store_set.
//
// Replace corrosion_tpu/ops/devcache.py JaxStore.gather (:155), a
// jitted take a[i] over a pow2-padded index vector, and JaxStore.set
// (:143), a jitted a.at[i].set(v) on a donated int64 buffer.  The
// arrays are the cache's row causal lengths (row_cl, up to 65,536 at
// the default 262,144 slots) and packed cell versions (cell_ver, up to
// 524,288); n runs from 1 to 262,144 on the apply path, 10,000 in its
// steady waves.  Both launch at n: no padding.
//
//  store_gather  out[i] = arr[idx[i]], a thread per index.
//  store_set     arr[idx[i]] = vals[i] with NumPy's answer on a repeated
//                index: the pair that comes last wins.  Two kernels, a
//                thread per pair, over a persistent int32 owner buffer
//                that holds -1 everywhere between calls: the claim
//                takes atomicMax(owner[idx[i]], i), so each target
//                holds its last writer; the write writes where
//                owner[idx[i]] == i (one writer a target, no race) and
//                that writer puts the owner back to -1.  A loser never
//                reads -1 as its own index, so the reset needs no third
//                pass.  The write is launched under Hopper's
//                programmatic dependent launch: the claim lets it be
//                scheduled at once, and it loads its pair before it
//                waits (griddepcontrol.wait) for the claims to finish.
//
// The wrapper (kernels/store.py) checks every index against the array
// on the host and wraps negative ones as NumPy does, so the kernels
// take 0 <= idx < cap.
//
// Bound on the H100: bytes, and random ones: each index, value and
// output is one streamed 8-byte word, each arr / owner access one
// 32-byte sector.  At the apply path's sizes everything sits in the
// 50 MB L2, so the launches' ramps and tails weigh more than the
// bytes.  Measured on the H100 (PERF.md row 15a), the dependent launch
// beats two plain launches and one cooperative launch with a grid
// barrier at the steady wave's 10,000 pairs and at 262,144; last pair
// wins needs every claim before any write, so it stays two passes.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

unsigned blocks_for(long long n) {
  return (unsigned)((n + THREADS - 1) / THREADS);
}

__global__ void store_gather_kernel(const long long* __restrict__ arr,
                                    const long long* __restrict__ idx,
                                    long long n, long long* __restrict__ out) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i < n) out[i] = arr[idx[i]];
}

// the claim lets the write grid be scheduled at once
// (griddepcontrol.launch_dependents)
__global__ void __launch_bounds__(THREADS)
    store_claim_kernel(const long long* __restrict__ idx, long long n,
                       int* owner) {
  asm volatile("griddepcontrol.launch_dependents;");
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i < n) atomicMax(owner + idx[i], (int)i);
}

// the write grid loads its pair, then waits until the claim grid has
// finished and its atomics are visible (griddepcontrol.wait)
__global__ void __launch_bounds__(THREADS)
    store_write_kernel(long long* __restrict__ arr,
                       const long long* __restrict__ idx,
                       const long long* __restrict__ vals, long long n,
                       int* owner) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  const long long t = i < n ? idx[i] : -1;
  const long long v = i < n ? vals[i] : 0;
  asm volatile("griddepcontrol.wait;" ::: "memory");
  if (t >= 0 && __ldcg(owner + t) == (int)i) {  // L2: the claims
    arr[t] = v;
    owner[t] = -1;
  }
}

}  // namespace

extern "C" int store_gather_launch(const long long* arr, const long long* idx,
                                   long long n, long long* out,
                                   void* stream) {
  if (n <= 0) return 0;
  store_gather_kernel<<<blocks_for(n), THREADS, 0, (cudaStream_t)stream>>>(
      arr, idx, n, out);
  return (int)cudaGetLastError();
}

// owner: int32 [>= cap], -1 everywhere on entry and on return; n < 2^31
extern "C" int store_set_launch(long long* arr, const long long* idx,
                                const long long* vals, long long n,
                                int* owner, void* stream) {
  if (n <= 0) return 0;
  if (n > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  store_claim_kernel<<<blocks_for(n), THREADS, 0, st>>>(idx, n, owner);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks_for(n));
  cfg.blockDim = dim3(THREADS);
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, store_write_kernel, arr, idx, vals, n,
                                 owner);
}
