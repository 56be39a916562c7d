// bucket_prev: per-position match candidate from a near window and two
// count-guarded 8192-bucket hash tables.
//
// Replaces the TPU kernel lz4net_tpu/ops/hash_kernel.py:
// _bucket_prev_pallas (_hash_kernel).  The TPU version walks the chunks
// as its grid, batches every block into each step, compares the near
// window as [128, 128] tiles, probes the tables with a select loop over
// table rows and updates them with one-hot bf16 matmuls per 8-bit plane
// (count, position and word planes), because the TPU has neither a
// gather nor a scatter.  Here two kernels, launched together:
//
//   1. near_window_kernel, one CTA per 512-position chunk of every
//      block, all in parallel: the chunk's u32 words go to shared
//      memory, and each thread scans its near window (its 128-row and
//      the row before it, within the chunk) backwards for the nearest
//      8-byte and 4-byte equal position.  The window needs no table
//      state, so this part runs at full occupancy;
//   2. bucket_tables_kernel, one CTA per block, walks the block's chunks
//      in order, one thread per chunk position: it probes both tables
//      (state as of the chunk start) and writes prev; then the
//      count-guarded update: shared-memory atomics count the chunk's
//      hits per bucket, a bucket hit exactly once takes (position + 1,
//      u32) of its one hitter, a bucket hit more than once keeps its
//      entry, and the hitters reset their counts.  The tables (4 x 8192
//      words) and the counts (2 x 8192) live in shared memory, 192 KB,
//      so one CTA fits an SM.
//
// What bounds it on the H100: the near-window scans, up to 255
// shared-memory compares per position (they stop at the first 8-byte
// match), then the chunk walk's barriers; device-memory traffic is the
// four input words and prev per position, plus the window results
// (written and read once, 8 bytes a position).
#include "common.cuh"

namespace lz4t {
namespace {

constexpr int LANE = 128;
constexpr int CHUNK = 4 * LANE;   // threads per CTA; D is a multiple
constexpr int NB = 8192;          // buckets per table
constexpr int TABLE_SMEM = 6 * NB * 4;

// near[i] = (m4 + 1) | (m8 + 1) << 16, chunk-local positions, 0 = none
__global__ void __launch_bounds__(CHUNK)
near_window_kernel(const int* __restrict__ wa_all,
                   const int* __restrict__ wb_all, int* __restrict__ near,
                   int D) {
  __shared__ int swa[CHUNK], swb[CHUNK];
  const int li = threadIdx.x;
  const size_t at = (size_t)blockIdx.y * D + (size_t)blockIdx.x * CHUNK + li;
  const int a = wa_all[at], bw = wb_all[at];
  swa[li] = a;
  swb[li] = bw;
  __syncthreads();
  // the window: [lo, li) of the chunk (the row before li's, and li's)
  const int lo = li < LANE ? 0 : (li / LANE - 1) * LANE;
  int m4 = -1, m8 = -1;
  for (int j = li - 1; j >= lo; j -= 4) {
    int w[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) w[u] = j - u >= lo ? swa[j - u] : ~a;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (w[u] != a) continue;
      if (m4 < 0) m4 = j - u;
      if (swb[j - u] == bw) {
        m8 = j - u;
        goto found;
      }
    }
  }
found:
  near[at] = (m4 + 1) | ((m8 + 1) << 16);
}

__global__ void __launch_bounds__(CHUNK)
bucket_tables_kernel(const int* __restrict__ wa_all,
                     const int* __restrict__ h4_all,
                     const int* __restrict__ h8_all,
                     const int* __restrict__ near, int* __restrict__ prev_all,
                     int D) {
  extern __shared__ unsigned smem[];
  unsigned* t4p = smem;           // position + 1, 0 = empty
  unsigned* t4w = t4p + NB;       // u32 word of that position
  unsigned* t8p = t4w + NB;
  unsigned* t8w = t8p + NB;
  unsigned* c4 = t8w + NB;        // hits in the current chunk
  unsigned* c8 = c4 + NB;

  const size_t row = (size_t)blockIdx.x * D;
  for (int k = threadIdx.x; k < 6 * NB; k += CHUNK) smem[k] = 0;
  __syncthreads();

  for (int c0 = 0; c0 < D; c0 += CHUNK) {
    const int i = c0 + threadIdx.x;
    const int a = wa_all[row + i];
    const int k4 = h4_all[row + i] & (NB - 1);   // in range by contract;
    const int k8 = h8_all[row + i] & (NB - 1);   // masked for safety
    const int nw = near[row + i];
    const int m4 = (nw & 0xFFFF) - 1, m8 = (nw >> 16) - 1;
    const unsigned p8 = t8p[k8], p4 = t4p[k4];
    const bool ok8 = p8 > 0 && (int)t8w[k8] == a;
    const bool ok4 = p4 > 0 && (int)t4w[k4] == a;
    prev_all[row + i] = m8 >= 0 ? c0 + m8
                        : ok8   ? (int)p8 - 1
                        : m4 >= 0 ? c0 + m4
                        : ok4   ? (int)p4 - 1
                                : -1;
    atomicAdd(&c4[k4], 1u);
    atomicAdd(&c8[k8], 1u);
    __syncthreads();   // every probe done, every hit counted

    if (c4[k4] == 1u) {
      t4p[k4] = (unsigned)i + 1u;
      t4w[k4] = (unsigned)a;
    }
    if (c8[k8] == 1u) {
      t8p[k8] = (unsigned)i + 1u;
      t8w[k8] = (unsigned)a;
    }
    __syncthreads();   // every count read before any reset
    c4[k4] = 0u;
    c8[k8] = 0u;
    __syncthreads();   // counts reset before the next chunk's hits
  }
}

}  // namespace
}  // namespace lz4t

extern "C" int lz4t_bucket_prev(const void* wa, const void* wb,
                                const void* h4, const void* h8, void* prev,
                                void* near_scratch, int B, int D,
                                void* stream) {
  if (B <= 0) return 0;
  if (D % lz4t::CHUNK) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  dim3 grid(D / lz4t::CHUNK, B);
  lz4t::near_window_kernel<<<grid, lz4t::CHUNK, 0, s>>>(
      (const int*)wa, (const int*)wb, (int*)near_scratch, D);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(lz4t::bucket_tables_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             lz4t::TABLE_SMEM);
  if (err != cudaSuccess) return (int)err;
  lz4t::bucket_tables_kernel<<<B, lz4t::CHUNK, lz4t::TABLE_SMEM, s>>>(
      (const int*)wa, (const int*)h4, (const int*)h8,
      (const int*)near_scratch, (int*)prev, D);
  return (int)cudaGetLastError();
}
