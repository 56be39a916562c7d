// rowbase_gather: vals[b, k] = table[b, idx[b, k]].
//
// Replaces the TPU kernel lz4net_tpu/ops/fused_gather.py: rowbase_gather
// (_rowbase_kernel).  The TPU has no hardware gather, so that kernel
// fetches a window of w_rows table rows per index row with a one-hot bf16
// matmul per 8-bit plane and selects lanes; indices outside the window
// come back with in_band = 0.  Hopper gathers natively: one thread per
// index reads the table entry, and in_band only says whether the index
// lies in [0, N) (an out-of-range index reads the clamped entry).
//
// What bounds it on the H100: bytes.  Each index and value is one int32
// read and one int32 write, plus one byte of in_band; the table reads are
// near-monotone (the decode path's literal sources), so they coalesce and
// the table is read about once.
#include "common.cuh"

namespace lz4t {
namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
rowbase_gather_kernel(const int* __restrict__ table,
                      const int* __restrict__ idx, int* __restrict__ vals,
                      uint8_t* __restrict__ in_band, int N, int K) {
  const int b = blockIdx.y;
  const int k = blockIdx.x * THREADS + threadIdx.x;
  if (k >= K) return;
  const size_t at = (size_t)b * K + k;
  const int i = idx[at];
  vals[at] = table[(size_t)b * N + clampi(i, 0, N - 1)];
  in_band[at] = i >= 0 && i < N;
}

}  // namespace
}  // namespace lz4t

extern "C" int lz4t_rowbase_gather(const void* table, const void* idx,
                                   void* vals, void* in_band, int B, int N,
                                   int K, void* stream) {
  if (B <= 0 || K <= 0) return 0;
  dim3 grid((K + lz4t::THREADS - 1) / lz4t::THREADS, B);
  lz4t::rowbase_gather_kernel<<<grid, lz4t::THREADS, 0,
                                (cudaStream_t)stream>>>(
      (const int*)table, (const int*)idx, (int*)vals, (uint8_t*)in_band, N,
      K);
  return (int)cudaGetLastError();
}
