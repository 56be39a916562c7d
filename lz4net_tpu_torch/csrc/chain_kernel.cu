// mark_chain: mark[b, i] = 1 iff i lies in the orbit of 0 under g[b].
//
// Replaces the TPU kernel lz4net_tpu/ops/chain_kernel.py: mark_chain
// (_chain_kernel).  The TPU version finds segment exits by pointer
// doubling over 128-position segments, threads a carry across the
// segments and marks inside each segment in parallel, stopping after
// ceil(128/3) + 1 = 44 rounds, which covers the encoder's graphs (hops of
// at least 4 after the first) but not an arbitrary g.  Here one CTA owns
// one block and marks the exact orbit:
//
//   1. all threads zero the block's mark row and stage each position's
//      step g[i] - i in 16 bits of shared memory (0 where g[i] <= i, which
//      ends the walk; 0xFFFF where the step is too long for 16 bits, and
//      the walk reads g[i] from device memory there);
//   2. one thread walks pos = 0, g[pos], g[g[pos]], ... while pos < D,
//      storing 1 at each position it visits.
//
// What bounds it on the H100: the walk, a serial chain of dependent
// shared-memory reads, one per chain position (at most about one per
// four bytes of the block on the encoder's graphs: its tokens).  The
// stores do not wait.  Phase 1 reads g and writes the mark row once,
// coalesced.  All blocks walk at once, one CTA each (2 x D bytes of
// shared memory); the walk, not the bytes, sets the time.
#include "common.cuh"

namespace lz4t {
namespace {

constexpr int THREADS = 1024;
constexpr unsigned STOP = 0;        // g[i] <= i: the walk ends at i
constexpr unsigned FAR = 0xFFFF;    // step of 0xFFFF or more: read g[i]

__global__ void __launch_bounds__(THREADS)
chain_kernel(const int* __restrict__ g_all, int* __restrict__ mark_all,
             int D) {
  extern __shared__ uint16_t step[];    // [D]
  const int* g = g_all + (size_t)blockIdx.x * D;
  int* mark = mark_all + (size_t)blockIdx.x * D;

  for (int i = threadIdx.x; i < D; i += THREADS) {
    const long long s = (long long)g[i] - i;
    step[i] = s <= 0 ? STOP : (s < FAR ? (uint16_t)s : FAR);
    mark[i] = 0;
  }
  __syncthreads();   // the zeros land before the walk's ones

  if (threadIdx.x == 0) {
    int pos = 0;
    while (pos < D) {
      mark[pos] = 1;
      const unsigned s = step[pos];
      if (s == STOP) break;
      pos = s == FAR ? g[pos] : pos + (int)s;   // g[pos] > pos here
    }
  }
}

}  // namespace
}  // namespace lz4t

extern "C" int lz4t_mark_chain(const void* g, void* mark, int B, int D,
                               void* stream) {
  if (B <= 0 || D <= 0) return 0;
  const int smem = 2 * D;
  cudaError_t err = cudaFuncSetAttribute(
      lz4t::chain_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  lz4t::chain_kernel<<<B, lz4t::THREADS, smem, (cudaStream_t)stream>>>(
      (const int*)g, (int*)mark, D);
  return (int)cudaGetLastError();
}
