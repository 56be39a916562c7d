// The four gathers of the TPU's fused gather module:
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
// indices are near-monotone, so its table reads coalesce; lane_lookup
// reads within the element's own 512-byte row, and diag_gather within a
// band of rows near the element's own.  Those three take one thread an
// element.
//
// table_gather's indices follow the token positions (increasing within a
// block, about one in ten positions on the chain path), so most of its
// table entries sit in 32-byte sectors of their own: the sectors its
// indices touch, not the 4 bytes a slot that its bound counts, set the
// floor of the bytes it moves (PERF.md section 6 gives both).  Its first
// form took one thread an element, an index load and then one dependent
// load a table in flight per thread, and lost most on the small tables of
// the chain path (mcum at last, the merged fields at kidx).  Here a grid
// that the card holds at once strides over the flattened [B, K] stream,
// a warp taking 32 * ELEMS consecutive elements a step, lane l the
// elements l, l + 32, ...: every index load is issued, then every table
// load, then the stores, so each thread has ELEMS loads of each table in
// flight; each index load and output store is 128 contiguous bytes, and
// the lanes of each table load read consecutive elements' entries, which
// keeps a warp's gathers on the fewest lines.  The index and the outputs
// take streaming cache hints, so the tables' lines stay in L2.  (16-byte
// index loads, four consecutive elements a lane, spread each gather over
// four times the lines and lost up to 19% on the two large tables.)
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

constexpr int ELEMS = 4;   // table_gather's elements a thread a step

// The element e of the flat [B, K] index stream reads table row b = e / K
// at the TPU kernel's entry for its index.
__device__ __forceinline__ size_t table_src(int i, int b, int N) {
  return (size_t)b * N + (size_t)clampi(i >> 7, 0, N / 128 - 1) * 128 +
         (i & 127);
}

template <int NT>
__global__ void __launch_bounds__(THREADS)
table_gather_kernel(Tables tabs, const int* __restrict__ idx, int N, int K,
                    int M) {
  // a warp takes 32 * ELEMS consecutive elements a step, lane l the
  // elements l, l + 32, ...: each load and store of the index stream and
  // the outputs is 128 contiguous bytes, and the lanes of each gather
  // read consecutive elements' entries
  const int lane = threadIdx.x & 31;
  const long long warps = (long long)gridDim.x * (THREADS / 32);
  for (long long c = blockIdx.x * (THREADS / 32) + (threadIdx.x >> 5);
       c * 32 * ELEMS < M; c += warps) {
    const int base = (int)(c * 32 * ELEMS);
    int i[ELEMS];
#pragma unroll
    for (int j = 0; j < ELEMS; ++j) {
      const int e = base + j * 32 + lane;
      i[j] = e < M ? __ldcs(idx + e) : 0;
    }
    const int b0 = base / K, r0 = base - b0 * K;
    size_t src[ELEMS];
#pragma unroll
    for (int j = 0; j < ELEMS; ++j) {
      int b = b0, r = r0 + j * 32 + lane;
      if (r >= K) {                      // a later row of the stream
        b += r / K;
        r %= K;
      }
      src[j] = table_src(i[j], b, N);
    }
    int val[NT][ELEMS];                  // every load before any store
#pragma unroll
    for (int t = 0; t < NT; ++t)
#pragma unroll
      for (int j = 0; j < ELEMS; ++j)
        val[t][j] = base + j * 32 + lane < M ? __ldg(tabs.t[t] + src[j]) : 0;
#pragma unroll
    for (int t = 0; t < NT; ++t)
#pragma unroll
      for (int j = 0; j < ELEMS; ++j) {
        const int e = base + j * 32 + lane;
        if (e < M) __stcs(tabs.out[t] + e, val[t][j] & tabs.mask[t]);
      }
  }
}

template <int NT>
int launch_table_gather(const Tables& tabs, const int* idx, int N, int K,
                        int M, cudaStream_t stream) {
  // a grid the card holds at once, each warp striding over the elements
  static int grid = 0;
  if (grid == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, table_gather_kernel<NT>, THREADS, 0);
    if (err != cudaSuccess) return (int)err;
    grid = sms * per_sm;
  }
  const int per = THREADS * ELEMS;       // elements a CTA a step
  const int want = (int)(((long long)M + per - 1) / per);
  table_gather_kernel<NT><<<want < 1 ? 1 : (want < grid ? want : grid),
                            THREADS, 0, stream>>>(tabs, idx, N, K, M);
  return (int)cudaGetLastError();
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
  // element numbers, and a warp's last one a step, stay below 2^31
  if ((long long)B * K > 0x7fffffff - 32 * lz4t::ELEMS)
    return (int)cudaErrorInvalidValue;
  const lz4t::Tables tabs = {{(const int*)t0, (const int*)t1, (const int*)t2,
                              (const int*)t3},
                             {(int*)o0, (int*)o1, (int*)o2, (int*)o3},
                             {m0, m1, m2, m3}};
  const int* ix = (const int*)idx;
  const int M = B * K;
  cudaStream_t st = (cudaStream_t)stream;
  switch (n_tables) {
    case 1: return lz4t::launch_table_gather<1>(tabs, ix, N, K, M, st);
    case 2: return lz4t::launch_table_gather<2>(tabs, ix, N, K, M, st);
    case 3: return lz4t::launch_table_gather<3>(tabs, ix, N, K, M, st);
    default: return lz4t::launch_table_gather<4>(tabs, ix, N, K, M, st);
  }
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
