// hc_tables: the fast-HC encoder's candidate streams from count-guarded
// bucket tables, one stream per table.
//
// Replaces the TPU kernel lz4net_tpu/ops/hash_kernel.py:_hc_tables_pallas
// (_hc_kernel).  The TPU version walks the chunks as its grid with every
// block of the batch (at most 32) and every table in each step; it probes
// with a select loop over table rows and updates with one-hot bf16
// matmuls per 8-bit plane of the count, the position and the word,
// because the TPU has neither a gather nor a scatter.  Here one CTA
// serves one block and one group of its tables - consecutive tables of
// at most 8192 buckets together, so the three 1024-bucket run tables
// share a CTA and read wa once, and an 8192-bucket table has a CTA of its
// own - and walks that block's 512-position chunks in order, one thread
// per chunk position.  Each thread keeps the next PF chunks' wa and
// bucket ids in flight in registers while it works on the current one:
//
//   1. probe and count: a shared-memory atomicAdd of the position's hit
//      returns its bucket as of the chunk start (a table word holds
//      position + 1 in its low 21 bits and the chunk's hits above them);
//      a warp whose lanes all hit one bucket (the run tables' catch-all,
//      a run's hash) adds its 32 hits from lane 0.  The candidate is the
//      stored position when it is set and the stored u32 equals wa[i];
//   2. update: a bucket hit exactly once in the chunk takes (i + 1,
//      wa[i]) of its one hitter, unless the table is sticky and the
//      bucket already held an entry; the other hitters clear the hits
//      (they all write the same word).
//
// This is bucket_prev's count-then-write rule (csrc/hash_kernel.cu), with
// two barriers a chunk; a group's tables go through each step side by
// side, so their latencies overlap.  A table's words live in shared
// memory: 64 KB for an 8192-bucket table, 8 KB for a 1024-bucket run
// table.  The run tables' last bucket (the catch-all of non-run
// positions) is an ordinary bucket here, as in the TPU kernel.  The
// streams come as separate arrays: nothing copies them into one tensor
// before the launch.  One-table groups and the others are two grids of
// one call (their kernels differ in registers).
//
// What bounds it on the H100: bytes.  Each position of each table is read
// once (its bucket id, and wa once a block) and its candidate written
// once, (1 + 2 nt) int32 words a position for nt tables; the CTAs of one
// block's groups run side by side, so the groups' repeated reads of wa
// mostly hit L2.  The first form (one CTA a table, loads waited for at
// every chunk, three barriers a chunk) spent 0.53 of its cycles waiting
// on its loads, and its wrapper stacked the streams first, 0.16 ms of a
// 0.39 ms call on the run tables (tools/chunk_clocks.py).
#include "common.cuh"

namespace lz4t {
namespace {

constexpr int CHUNK = 512;        // threads per CTA; D is a multiple
constexpr int MAX_TABLES = 8;
constexpr int GROUP_NB = 8192;    // buckets of one CTA's tables together
constexpr int POS_BITS = 21;      // a table word: position + 1, hits above
constexpr unsigned POS_MASK = (1u << POS_BITS) - 1u;
constexpr unsigned HIT = 1u << POS_BITS;
constexpr unsigned FULL = 0xFFFFFFFFu;

// per table: its bucket ids, buckets and sticky flag; per group of
// tables, its first table and its size (passed by value)
struct Tables {
  const int* h[MAX_TABLES];
  int nb[MAX_TABLES];
  int sticky[MAX_TABLES];
  int first[MAX_TABLES];          // group g: tables first[g] ..
  int size[MAX_TABLES];           //          .. first[g] + size[g] - 1
};

// G: most tables of a group; PF: chunks in flight ahead of the current.
// CTA (x, b) serves group g0 + x of block b.
template <int G, int PF>
__global__ void __launch_bounds__(CHUNK, 2)
hc_tables_kernel(const int* __restrict__ wa_all, const Tables tables,
                 int g0, int* __restrict__ cand_all, int B, int D) {
  extern __shared__ unsigned smem[];
  const int g = g0 + blockIdx.x, b = blockIdx.y;
  const int tab0 = tables.first[g], ntab = tables.size[g];
  const unsigned lane = threadIdx.x & 31u;
  const size_t row = (size_t)b * D;
  const size_t plane = (size_t)B * D;   // one table's candidates
  int nb[G], base[G];                   // buckets, first word in smem
  int words = 0;
#pragma unroll
  for (int q = 0; q < G; ++q) {
    nb[q] = tables.nb[q < ntab ? tab0 + q : tab0];
    base[q] = words;
    if (q < ntab) words += 2 * nb[q];
  }
  for (int k = threadIdx.x; k < words; k += CHUNK) smem[k] = 0u;
  const int* wa = wa_all + row;
  int* cand = cand_all + (size_t)tab0 * plane + row;
  const int nchunks = D / CHUNK;

  int a_buf[PF], h_buf[PF][G];          // chunks c .. c + PF - 1
#pragma unroll
  for (int s = 0; s < PF; ++s) {
    if (s < nchunks) {
      a_buf[s] = __ldg(wa + s * CHUNK + threadIdx.x);
#pragma unroll
      for (int q = 0; q < G; ++q)
        if (q < ntab)
          h_buf[s][q] = __ldg(tables.h[tab0 + q] + row + s * CHUNK +
                              threadIdx.x);
    }
  }
  __syncthreads();                      // tables zeroed

  for (int c0 = 0; c0 < nchunks; c0 += PF) {
#pragma unroll
    for (int s = 0; s < PF; ++s) {
      const int c = c0 + s;
      if (c >= nchunks) break;
      const int i = c * CHUNK + threadIdx.x;
      const int a = a_buf[s];
      int k[G];
#pragma unroll
      for (int q = 0; q < G; ++q) k[q] = clampi(h_buf[s][q], 0, nb[q] - 1);
      if (c + PF < nchunks) {           // refill this slot, PF chunks on
        a_buf[s] = __ldg(wa + i + PF * CHUNK);
#pragma unroll
        for (int q = 0; q < G; ++q)
          if (q < ntab)
            h_buf[s][q] = __ldg(tables.h[tab0 + q] + row + i + PF * CHUNK);
      }

      // ---- 1. probe and count ------------------------------------------
      // A warp whose lanes share one bucket (the run tables' catch-all,
      // a run's hash) adds its 32 hits in one atomic from lane 0.  The
      // tables' steps are interleaved, so their latencies overlap.
      unsigned same = 0u, p[G];
#pragma unroll
      for (int q = 0; q < G; ++q)
        if (q < ntab && __all_sync(FULL, k[q] == __shfl_sync(FULL, k[q], 0)))
          same |= 1u << q;
#pragma unroll
      for (int q = 0; q < G; ++q) {
        p[q] = 0u;
        if (q < ntab && (!(same >> q & 1u) || lane == 0))
          p[q] = atomicAdd(smem + base[q] + k[q],
                           same >> q & 1u ? 32u * HIT : HIT);
      }
#pragma unroll
      for (int q = 0; q < G; ++q) {
        if (q < ntab) {
          if (same >> q & 1u) p[q] = __shfl_sync(FULL, p[q], 0);
          p[q] &= POS_MASK;             // the bucket as of the chunk start
          cand[q * plane + i] =
              p[q] > 0u && (int)smem[base[q] + nb[q] + k[q]] == a
                  ? (int)p[q] - 1 : -1;
        }
      }
      __syncthreads();                  // every probe done, every hit counted

      // ---- 2. update ---------------------------------------------------
      unsigned w[G];
#pragma unroll
      for (int q = 0; q < G; ++q)
        if (q < ntab) w[q] = smem[base[q] + k[q]];
#pragma unroll
      for (int q = 0; q < G; ++q) {
        if (q < ntab) {
          unsigned* tp = smem + base[q];
          if (same >> q & 1u) {         // 32 hits or more: lane 0 clears
            if (lane == 0) tp[k[q]] = p[q];
          } else if (w[q] >> POS_BITS == 1u &&
                     (!tables.sticky[tab0 + q] || p[q] == 0u)) {
            tp[k[q]] = (unsigned)i + 1u;   // its one hitter
            tp[nb[q] + k[q]] = (unsigned)a;
          } else {
            tp[k[q]] = p[q];               // the hits cleared
          }
        }
      }
      __syncthreads();                  // updates seen by the next probes
    }
  }
}

template <int G, int PF>
cudaError_t launch(const int* wa, const Tables& tables, int g0, int ng,
                   int* cand, int B, int D, int smem, cudaStream_t s) {
  if (ng == 0) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      hc_tables_kernel<G, PF>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  hc_tables_kernel<G, PF><<<dim3(ng, B), CHUNK, smem, s>>>(
      wa, tables, g0, cand, B, D);
  return cudaGetLastError();
}

}  // namespace
}  // namespace lz4t

// wa [B, D] and cand [nt, B, D] on the device; hs: a host array of nt
// device pointers, the tables' bucket-id streams [B, D]; meta [nt, 2] =
// (buckets, sticky) in host memory.  Both host arrays are copied into the
// launch's arguments (no copy to the device, so no wait on the stream).
extern "C" int lz4t_hc_tables(const void* wa, const void* hs,
                              const void* meta, void* cand, int B, int D,
                              int nt, void* stream) {
  using namespace lz4t;
  if (B <= 0 || nt <= 0 || D == 0) return 0;
  if (D < 0 || D % CHUNK || D >= (int)POS_MASK || nt > MAX_TABLES)
    return (int)cudaErrorInvalidValue;
  Tables tables = {};
  // groups: consecutive tables of at most GROUP_NB buckets together;
  // one-table groups first, then the others
  int gfirst[MAX_TABLES], gsize[MAX_TABLES], gnb[MAX_TABLES], ngroups = 0;
  for (int t = 0; t < nt; ++t) {
    const int nb = ((const int*)meta)[2 * t];
    if (nb <= 0 || nb > GROUP_NB) return (int)cudaErrorInvalidValue;
    tables.h[t] = ((const int* const*)hs)[t];
    tables.nb[t] = nb;
    tables.sticky[t] = ((const int*)meta)[2 * t + 1];
    if (t == 0 || gnb[ngroups - 1] + nb > GROUP_NB) {
      gfirst[ngroups] = t;
      gsize[ngroups] = gnb[ngroups] = 0;
      ++ngroups;
    }
    ++gsize[ngroups - 1];
    gnb[ngroups - 1] += nb;
  }
  // [0, n1): the one-table groups, their kernel's smem; then the others
  int n1 = 0, ng = 0, most = 0, smem1 = 0, smem2 = 0;
  for (int pass = 0; pass < 2; ++pass) {
    for (int g = 0; g < ngroups; ++g) {
      if ((gsize[g] == 1) != (pass == 0)) continue;
      tables.first[ng] = gfirst[g];
      tables.size[ng++] = gsize[g];
      int& bytes = pass == 0 ? smem1 : smem2;
      if (2 * gnb[g] * (int)sizeof(unsigned) > bytes)
        bytes = 2 * gnb[g] * (int)sizeof(unsigned);
      if (gsize[g] > most) most = gsize[g];
    }
    if (pass == 0) n1 = ng;
  }
  cudaStream_t s = (cudaStream_t)stream;
  const int* w = (const int*)wa;
  int* c = (int*)cand;
  cudaError_t err = launch<1, 4>(w, tables, 0, n1, c, B, D, smem1, s);
  if (err == cudaSuccess)
    err = most <= 4 ? launch<4, 4>(w, tables, n1, ng - n1, c, B, D, smem2, s)
                    : launch<8, 2>(w, tables, n1, ng - n1, c, B, D, smem2,
                                   s);
  return (int)err;
}
