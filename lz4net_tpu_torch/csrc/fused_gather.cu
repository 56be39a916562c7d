// The four gathers of the TPU's fused gather module, one thread an
// element each:
//
//   rowbase_gather  vals[b, k] = table[b, idx[b, k]];
//   table_gather    out[t][b, k] = tables[t][b, j] & mask[t] for 1-4
//                   tables at one index stream;
//   lane_lookup     out[r, l] = table[r, idx[r, l] & 127];
//   diag_gather     table[b, idx[b, q]] where idx's row lies in a band of
//                   rows around q's own, and the band flag.
//
// They replace the TPU kernels of lz4net_tpu/ops/fused_gather.py
// (_rowbase_kernel, _table_kernel, _lane_lookup_kernel, _diag_kernel).
// The TPU has no hardware gather, so those fetch table rows with one-hot
// bf16 matmuls per 8-bit plane, shuffle lanes within 128-lane rows and
// select over shifted row windows.  Hopper gathers natively, so each
// kernel here reads its entries directly and reproduces the TPU kernel's
// value on every index:
//
//   rowbase_gather  in_band says only whether the index lies in [0, N)
//                   (an index outside reads the clamped entry); the TPU's
//                   window parameters are gone;
//   table_gather    an index reads row clamp(idx >> 7, 0, N / 128 - 1) at
//                   lane idx & 127, and each value keeps the low
//                   ceil(bits / 8) bytes that the TPU's planes carry;
//   diag_gather     0 out of the band and where idx is outside [0, N),
//                   which the TPU kernel's zero accumulator and zero-filled
//                   row shifts give.
//
// What bounds them on the H100: bytes.  Each element reads its index and
// one table entry per table and writes its outputs.  rowbase_gather's
// indices are near-monotone, so its table reads coalesce; table_gather's
// follow the token positions (increasing within a block); lane_lookup
// reads within the element's own 512-byte row, and diag_gather within a
// band of rows near the element's own: all of them stay in the lines
// that their warp's neighbours fetch, or close to them.
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

struct Tables {
  const int* t[4];
  int* out[4];
  int mask[4];
};

__global__ void __launch_bounds__(THREADS)
table_gather_kernel(Tables tabs, int n_tables, const int* __restrict__ idx,
                    int N, int K) {
  const int b = blockIdx.y;
  const int k = blockIdx.x * THREADS + threadIdx.x;
  if (k >= K) return;
  const size_t at = (size_t)b * K + k;
  const int i = idx[at];
  const size_t src =
      (size_t)b * N + (size_t)clampi(i >> 7, 0, N / 128 - 1) * 128 + (i & 127);
#pragma unroll
  for (int t = 0; t < 4; ++t)
    if (t < n_tables) tabs.out[t][at] = tabs.t[t][src] & tabs.mask[t];
}

__global__ void __launch_bounds__(THREADS)
lane_lookup_kernel(const int* __restrict__ table,
                   const int* __restrict__ idx, int* __restrict__ out,
                   size_t M) {
  const size_t e = (size_t)blockIdx.x * THREADS + threadIdx.x;
  if (e >= M) return;
  out[e] = table[(e & ~(size_t)127) + (idx[e] & 127)];
}

__global__ void __launch_bounds__(THREADS)
diag_gather_kernel(const int* __restrict__ table,
                   const int* __restrict__ idx, int* __restrict__ vals,
                   uint8_t* __restrict__ in_band, int N, int back_rows,
                   int w_rows) {
  const int b = blockIdx.y;
  const int q = blockIdx.x * THREADS + threadIdx.x;
  if (q >= N) return;
  const size_t at = (size_t)b * N + q;
  const int i = idx[at];
  const int delta = (i >> 7) - (q >> 7) + back_rows;   // arithmetic shift
  const bool band = delta >= 0 && delta < w_rows;
  vals[at] = band && i >= 0 && i < N ? table[(size_t)b * N + i] : 0;
  in_band[at] = band;
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

extern "C" int lz4t_table_gather(const void* t0, const void* t1,
                                 const void* t2, const void* t3,
                                 const void* idx, void* o0, void* o1,
                                 void* o2, void* o3, int m0, int m1, int m2,
                                 int m3, int n_tables, int B, int N, int K,
                                 void* stream) {
  if (n_tables < 1 || n_tables > 4 || N <= 0 || N % 128)
    return (int)cudaErrorInvalidValue;
  if (B <= 0 || K <= 0) return 0;
  lz4t::Tables tabs = {{(const int*)t0, (const int*)t1, (const int*)t2,
                        (const int*)t3},
                       {(int*)o0, (int*)o1, (int*)o2, (int*)o3},
                       {m0, m1, m2, m3}};
  dim3 grid((K + lz4t::THREADS - 1) / lz4t::THREADS, B);
  lz4t::table_gather_kernel<<<grid, lz4t::THREADS, 0,
                              (cudaStream_t)stream>>>(tabs, n_tables,
                                                      (const int*)idx, N, K);
  return (int)cudaGetLastError();
}

extern "C" int lz4t_lane_lookup(const void* table, const void* idx,
                                void* out, int rows, void* stream) {
  if (rows <= 0) return 0;
  const size_t M = (size_t)rows * 128;
  const unsigned grid = (unsigned)((M + lz4t::THREADS - 1) / lz4t::THREADS);
  lz4t::lane_lookup_kernel<<<grid, lz4t::THREADS, 0,
                             (cudaStream_t)stream>>>(
      (const int*)table, (const int*)idx, (int*)out, M);
  return (int)cudaGetLastError();
}

extern "C" int lz4t_diag_gather(const void* table, const void* idx,
                                void* vals, void* in_band, int B, int N,
                                int back_rows, int w_rows, void* stream) {
  if (B <= 0 || N <= 0) return 0;
  dim3 grid((N + lz4t::THREADS - 1) / lz4t::THREADS, B);
  lz4t::diag_gather_kernel<<<grid, lz4t::THREADS, 0,
                             (cudaStream_t)stream>>>(
      (const int*)table, (const int*)idx, (int*)vals, (uint8_t*)in_band, N,
      back_rows, w_rows);
  return (int)cudaGetLastError();
}
