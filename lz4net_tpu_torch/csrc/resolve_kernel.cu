// resolve_wavefront: per-byte state words -> output bytes.
//
// Replaces the TPU kernel lz4net_tpu/ops/resolve_kernel.py:
// resolve_wavefront (_resolve_kernel).  State words: t0[o] = VFLAG|byte
// for a terminal (literal or dictionary byte), else the match source
// position, which always precedes o.  The output is resolved in 8 KB
// chunks, in order, as on the TPU; what differs is only how a gather is
// done:
//   * inside a chunk, match nesting collapses by synchronous pointer
//     doubling over the chunk-local ordinals held in shared memory (the
//     TPU used one-hot matmuls and lane-shuffle select loops); 13
//     doublings reach 2^13 = 8192 and always converge, a 14th sees no
//     change, and the loop leaves early once a round changes nothing;
//   * a pointer into an earlier chunk reads the byte already resolved
//     there straight from the output row (the TPU packed 4 bytes a word
//     and ran a staircase of select loops);
//   * chunks below start_chunk hold a pre-resolved prefix and pass through.
//
// What bounds it on the H100: bytes - one int32 read of t0 and one int32
// write per output byte, plus the terminal and cross-chunk reads.  A
// 64 KB block's 73,728 states (288 KB) exceed the 227 KB of shared memory
// of a CTA, so only the current chunk's ordinals (32 KB) live there; the
// resolved prefix stays in global memory, where it is L2-resident.
#include "common.cuh"

namespace lz4t {
namespace {

constexpr int THREADS = 1024;
constexpr int CH = 8192;               // chunk, as decode_vector.CH
constexpr int PER = CH / THREADS;      // ordinals per thread
constexpr int MAX_ROUNDS = 14;

__global__ void __launch_bounds__(THREADS)
resolve_kernel(const int* __restrict__ t0_all, int* __restrict__ out_all,
               uint8_t* __restrict__ ok, int Dt, int start_chunk) {
  __shared__ int n[CH];
  const int b = blockIdx.x;
  const int* t0 = t0_all + (size_t)b * Dt;
  int* out = out_all + (size_t)b * Dt;
  bool converged = true;

  for (int j = 0; j < Dt / CH; ++j) {
    const int lo = j * CH;
    if (j < start_chunk) {               // dictionary prefix: terminals
      for (int k = threadIdx.x; k < CH; k += THREADS)
        out[lo + k] = t0[lo + k] & 0xFF;
      __syncthreads();
      continue;
    }
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int k = threadIdx.x + i * THREADS;
      const int t = t0[lo + k];
      n[k] = (t < VFLAG && t >= lo) ? (t - lo < CH - 1 ? t - lo : CH - 1)
                                    : k;
    }
    __syncthreads();

    int changed = 1;
    for (int r = 0; r < MAX_ROUNDS && changed; ++r) {
      int nn[PER];
#pragma unroll
      for (int i = 0; i < PER; ++i) nn[i] = n[n[threadIdx.x + i * THREADS]];
      __syncthreads();                   // all reads of this round done
      int mine = 0;
#pragma unroll
      for (int i = 0; i < PER; ++i) {
        const int k = threadIdx.x + i * THREADS;
        mine |= nn[i] != n[k];
        n[k] = nn[i];
      }
      changed = __syncthreads_or(mine);
    }
    converged = converged && !changed;

#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int k = threadIdx.x + i * THREADS;
      const int t = t0[lo + n[k]];
      int res;
      if (t >= VFLAG) res = t - VFLAG;
      else res = lo == 0 ? 0 : out[clampi(t, 0, lo - 1)];
      out[lo + k] = res & 0xFF;
    }
    __syncthreads();                     // chunk j visible to chunk j+1
  }
  if (threadIdx.x == 0) ok[b] = converged;
}

}  // namespace
}  // namespace lz4t

extern "C" int lz4t_resolve_wavefront(const void* t0, void* out, void* ok,
                                      int B, int Dt, int start_chunk,
                                      void* stream) {
  if (B <= 0) return 0;
  lz4t::resolve_kernel<<<B, lz4t::THREADS, 0, (cudaStream_t)stream>>>(
      (const int*)t0, (int*)out, (uint8_t*)ok, Dt, start_chunk);
  return (int)cudaGetLastError();
}
