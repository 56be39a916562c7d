// hc_tables: the fast-HC encoder's candidate streams from count-guarded
// bucket tables, one stream per table.
//
// Replaces the TPU kernel lz4net_tpu/ops/hash_kernel.py:_hc_tables_pallas
// (_hc_kernel).  The TPU version walks the chunks as its grid with every
// block of the batch (at most 32) and every table in each step; it probes
// with a select loop over table rows and updates with one-hot bf16
// matmuls per 8-bit plane of the count, the position and the word,
// because the TPU has neither a gather nor a scatter.  Here the tables are
// independent, so one CTA serves one (block, table) pair and walks that
// block's 512-position chunks in order, one thread per chunk position:
//
//   1. probe: read the bucket as of the chunk start; the candidate is the
//      stored position when the entry is set and its u32 equals wa[i];
//   2. count: a shared-memory atomicAdd per position on its bucket;
//   3. update: a bucket hit exactly once in the chunk takes (i + 1,
//      wa[i]) of its one hitter, unless the table is sticky and the
//      bucket already holds an entry; then the hitters reset the counts.
//
// This is bucket_prev's count-then-write rule (csrc/hash_kernel.cu).  A
// table's positions, words and counts live in shared memory: 96 KB for
// an 8192-bucket table (two CTAs an SM), 12 KB for a 1024-bucket run
// table.  The run tables' last bucket (the catch-all of non-run
// positions) is an ordinary bucket here, as in the TPU kernel.
//
// What bounds it on the H100: each position of each table is read once
// (its bucket id, and wa once a table) and its candidate written once,
// (1 + 2 nt) int32 words a position for nt tables; the chunk walk's three
// barriers a chunk and the dependent shared-memory reads set the time.
#include "common.cuh"

namespace lz4t {
namespace {

constexpr int CHUNK = 512;        // threads per CTA; D is a multiple
constexpr int MAX_TABLES = 8;

// per table: buckets and the sticky flag, passed by value
struct Tables {
  int nb[MAX_TABLES];
  int sticky[MAX_TABLES];
};

__global__ void __launch_bounds__(CHUNK)
hc_tables_kernel(const int* __restrict__ wa_all, const int* __restrict__ h_all,
                 const Tables tables, int* __restrict__ cand_all, int B,
                 int D, int max_nb) {
  extern __shared__ unsigned smem[];
  const int b = blockIdx.x, t = blockIdx.y;
  const int nb = tables.nb[t];          // buckets of this table
  const bool sticky = tables.sticky[t] != 0;
  unsigned* tp = smem;                  // position + 1, 0 = empty
  unsigned* tw = tp + max_nb;           // u32 word of that position
  unsigned* cnt = tw + max_nb;          // hits in the current chunk
  for (int k = threadIdx.x; k < 3 * max_nb; k += CHUNK) smem[k] = 0;
  __syncthreads();

  const size_t row = (size_t)b * D;
  const size_t hrow = ((size_t)t * B + b) * D;
  for (int c0 = 0; c0 < D; c0 += CHUNK) {
    const int i = c0 + threadIdx.x;
    const int a = wa_all[row + i];
    const int k = clampi(h_all[hrow + i], 0, nb - 1);
    const unsigned p = tp[k];
    cand_all[hrow + i] = p > 0 && (int)tw[k] == a ? (int)p - 1 : -1;
    atomicAdd(&cnt[k], 1u);
    __syncthreads();   // every probe done, every hit counted

    // a bucket hit once has one hitter: no other thread touches it
    if (cnt[k] == 1u && (!sticky || p == 0u)) {
      tp[k] = (unsigned)i + 1u;
      tw[k] = (unsigned)a;
    }
    __syncthreads();   // every count read before any reset
    cnt[k] = 0u;
    __syncthreads();   // counts reset before the next chunk's hits
  }
}

}  // namespace
}  // namespace lz4t

// wa [B, D], h [nt, B, D] and cand [nt, B, D] on the device; meta
// [nt, 2] = (buckets, sticky) in host memory, copied into the launch's
// arguments (no copy to the device, so no wait on the stream).
extern "C" int lz4t_hc_tables(const void* wa, const void* h, const void* meta,
                              void* cand, int B, int D, int nt,
                              void* stream) {
  if (B <= 0 || nt <= 0) return 0;
  if (D % lz4t::CHUNK || nt > lz4t::MAX_TABLES)
    return (int)cudaErrorInvalidValue;
  lz4t::Tables tables = {};
  int max_nb = 0;
  for (int t = 0; t < nt; ++t) {
    tables.nb[t] = ((const int*)meta)[2 * t];
    tables.sticky[t] = ((const int*)meta)[2 * t + 1];
    if (tables.nb[t] <= 0 || tables.nb[t] > 8192)
      return (int)cudaErrorInvalidValue;
    max_nb = tables.nb[t] > max_nb ? tables.nb[t] : max_nb;
  }
  const int smem = 3 * max_nb * (int)sizeof(unsigned);
  cudaError_t err = cudaFuncSetAttribute(
      lz4t::hc_tables_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(B, nt);
  lz4t::hc_tables_kernel<<<grid, lz4t::CHUNK, smem, (cudaStream_t)stream>>>(
      (const int*)wa, (const int*)h, tables, (int*)cand, B, D, max_nb);
  return (int)cudaGetLastError();
}
