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
//   1. near_window_kernel: a CTA takes 8 chunks of 512 positions of one
//      block in turn, all CTAs in parallel.  Per chunk, each position's
//      u32 word goes to shared memory and its bit into a bit mask of its
//      hash group (a hash of its word, g4, and one of its 8 bytes, g8,
//      both computed here, whatever h4 and h8 hold: 256 groups each, a
//      32-bit word a group for each 32 positions).  A position then
//      scans its group's positions in its near window (its 128-row and
//      the row before it, within the chunk) nearest first, a mask word
//      at a time: m8 is the first of its g8 group whose two words equal
//      its own, m4 (needed only without m8) the first of its g4 group
//      whose word does.  So a position pays for the window's mask words
//      (at most 8 a group) and for the other words that share its group,
//      not for a compare per window position;
//   2. bucket_tables_kernel, one CTA per block, walks the block's chunks
//      in order, one thread per chunk position.  A table word holds
//      position + 1, the chunk's hits and a 4-bit fingerprint of the
//      position's word: a plain read gives the entry as of the chunk
//      start, one shared-memory atomicAdd counts the hit.  The entry's
//      word is read from wa in device memory only where it could decide
//      prev (no window result before it, the fingerprint agrees), a chunk
//      ahead of its use.  After one barrier, a bucket hit exactly once
//      takes its hitter's entry, a bucket hit more than once keeps its
//      own, and either clears its count; a second barrier ends the chunk.
//      The tables take 2 x 8192 words, 64 KB, so every block of a
//      256-block batch is resident at once.
//
// What bounds it on the H100: the bytes, the four input words read and
// prev written once a position (0.1127 ms for the encode cell, PERF.md
// section 6).  The kernels also pass the window results through device
// memory (8 bytes a position).  The near window's mask words and the
// tables are read at random banks of shared memory (a few-way bank
// conflicts a warp access), which with the table walk's two barriers a
// chunk, 144 chunks a block in sequence, is what the time is spent on.
// Wide rows take the table walk's chunks in series: 1.04 ms on 256 rows
// of 139,264 (272 chunks a block), 0.58 ms on 64 rows of 172,032.
// The first form compared every word of the window, up to 255 a
// position, and kept 192 KB of tables and counts, one CTA an SM.
#include "common.cuh"

namespace lz4t {
namespace {

constexpr int LANE = 128;
constexpr int CHUNK = 4 * LANE;   // threads per CTA; D is a multiple
constexpr int NB = 8192;          // buckets per table
constexpr int TABLE_SMEM = 2 * NB * 4;
// A table word: position + 1 (0 = empty) in bits 0-17, the chunk's hits
// in bits 18-27 (at most 512), a 4-bit fingerprint of the position's word
// in bits 28-31 (it only spares reads of words that cannot agree, so prev
// does not depend on its width); D < 2^18
constexpr int POS_BITS = 18;
constexpr unsigned POS_MASK = (1u << POS_BITS) - 1;
constexpr unsigned HIT = 1u << POS_BITS;   // one hit of the chunk
constexpr int FP_SHIFT = 28;
constexpr unsigned ENTRY = POS_MASK | (~0u << FP_SHIFT);  // all but hits

__device__ __forceinline__ unsigned fingerprint(int a) {
  return ((unsigned)a * 2654435761u) >> FP_SHIFT << FP_SHIFT;
}
constexpr int GROUP_BITS = 8;     // hash bits of the near window's groups
constexpr int GROUPS = 1 << GROUP_BITS;
constexpr int WORDS = CHUNK / 32; // bit-mask words a group
constexpr int NEAR_CHUNKS = 8;    // chunks of a near-window CTA

// The nearest position of li's hash group in the window [32 w_lo, li)
// whose words equal li's (swb only where wb is set); -1 if none.  The
// group's positions are scanned nearest first, a bit-mask word at a time.
__device__ __forceinline__ int nearest(const unsigned* group_s, int grp,
                                       const int* swa, const int* swb,
                                       int li, int w_lo, int a, int b,
                                       bool wb) {
  int w = li >> 5;
  unsigned bits = group_s[w * GROUPS + grp] & ((1u << (li & 31)) - 1);
  for (;;) {
    while (bits) {
      const int top = 31 - __clz(bits);
      bits ^= 1u << top;
      const int j = 32 * w + top;
      if (swa[j] == a && (!wb || swb[j] == b)) return j;
    }
    if (--w < w_lo) return -1;
    bits = group_s[w * GROUPS + grp];
  }
}

// near[i] = (m4 + 1) | (m8 + 1) << 16, chunk-local positions, 0 = none;
// a CTA takes NEAR_CHUNKS chunks of one block in turn
__global__ void __launch_bounds__(CHUNK)
near_window_kernel(const int* __restrict__ wa_all,
                   const int* __restrict__ wb_all, int* __restrict__ near,
                   int D) {
  __shared__ int swa[CHUNK], swb[CHUNK];
  // the chunk's positions by hash group, of the 4-byte words (g4) and of
  // the 8-byte prefixes (g8): bit b of word w of group g is position
  // 32 w + b; word w of every group lies together, and only warp w
  // writes it
  __shared__ unsigned g4_s[WORDS * GROUPS], g8_s[WORDS * GROUPS];
  const int li = threadIdx.x;
  const int c_end = min((int)(blockIdx.x + 1) * NEAR_CHUNKS * CHUNK, D);
  const size_t row = (size_t)blockIdx.y * D;
  int c0 = blockIdx.x * NEAR_CHUNKS * CHUNK;
  int a = __ldg(wa_all + row + c0 + li), bw = __ldg(wb_all + row + c0 + li);
  for (int k = li; k < WORDS * GROUPS; k += CHUNK) g4_s[k] = g8_s[k] = 0;
  int mine4 = (li >> 5) * GROUPS, mine8 = mine4;   // this thread's words
  // the window: [lo, li) of the chunk (the row before li's, and li's)
  const int w_lo = li < LANE ? 0 : (li / LANE - 1) * (LANE / 32);
  __syncthreads();
  for (; c0 < c_end; c0 += CHUNK) {
    swa[li] = a;
    swb[li] = bw;
    g4_s[mine4] = g8_s[mine8] = 0;     // the chunk before's bits
    __syncwarp();
    const unsigned h4 = (unsigned)a * 2654435761u;
    const int grp4 = h4 >> (32 - GROUP_BITS);
    const int grp8 = ((h4 ^ (unsigned)bw) * 2246822519u) >> (32 - GROUP_BITS);
    mine4 = (li >> 5) * GROUPS + grp4;
    mine8 = (li >> 5) * GROUPS + grp8;
    atomicOr(&g4_s[mine4], 1u << (li & 31));
    atomicOr(&g8_s[mine8], 1u << (li & 31));
    int na = 0, nb = 0;                // the next chunk's words
    if (c0 + CHUNK < c_end) {
      na = __ldg(wa_all + row + c0 + CHUNK + li);
      nb = __ldg(wb_all + row + c0 + CHUNK + li);
    }
    __syncthreads();   // the chunk's words and groups stored
    const int m8 = nearest(g8_s, grp8, swa, swb, li, w_lo, a, bw, true);
    // m4 is read only where there is no m8
    const int m4 = m8 >= 0 ? m8 : nearest(g4_s, grp4, swa, swb, li, w_lo,
                                          a, bw, false);
    near[row + c0 + li] = (m4 + 1) | ((m8 + 1) << 16);
    a = na;
    bw = nb;
    __syncthreads();   // every scan of the chunk done
  }
}

// One position's part of a chunk of the table walk: its inputs, then its
// probe (the entries as of the chunk start, and their words where they
// decide prev: read, else ~a)
struct Probe {
  int a, k4, k8, nw;
  unsigned e8, e4;
  int w8, w4;

  // prev from the window results, then the tables
  __device__ __forceinline__ int pick(int c0) const {
    const int m4 = (nw & 0xFFFF) - 1, m8 = (nw >> 16) - 1;
    return m8 >= 0    ? c0 + m8
           : w8 == a  ? (int)(e8 & POS_MASK) - 1
           : m4 >= 0  ? c0 + m4
           : w4 == a  ? (int)(e4 & POS_MASK) - 1
                      : -1;
  }
};

struct Tables {
  const int *wa, *h4, *h8, *near;
  int* prev;
  unsigned *t4, *t8;
  int D;

  __device__ __forceinline__ void load(Probe& p, int i) const {
    p.a = __ldg(wa + i);
    p.k4 = __ldg(h4 + i);   // masked at use (in range by contract)
    p.k8 = __ldg(h8 + i);
    p.nw = __ldg(near + i);
  }

  // Chunk c0 (inputs in cur): probe it, write prev of the chunk before
  // (held in last, which then takes the next chunk's inputs), update the
  // tables.  The entries' words are read a chunk before they are needed,
  // so their latency overlaps the barriers.  False past the last chunk.
  __device__ __forceinline__ bool step(Probe& cur, Probe& last,
                                       int c0) const {
    const int i = c0 + threadIdx.x;
    if (c0 < D) {
      cur.k4 &= NB - 1;
      cur.k8 &= NB - 1;
      cur.e8 = t8[cur.k8] & ENTRY;     // the entries as of the chunk start
      cur.e4 = t4[cur.k4] & ENTRY;
      atomicAdd(&t8[cur.k8], HIT);     // count the hits
      atomicAdd(&t4[cur.k4], HIT);
      // an entry's word is read where it could decide prev: no window
      // result comes first, the entry is set and its fingerprint agrees
      const unsigned fp = fingerprint(cur.a);
      const bool no8 = cur.nw >> 16 == 0, no4 = (cur.nw & 0xFFFF) == 0;
      cur.w8 = no8 && cur.e8 & POS_MASK && (cur.e8 & ~POS_MASK) == fp
                   ? __ldg(wa + (cur.e8 & POS_MASK) - 1) : ~cur.a;
      cur.w4 = no8 && no4 && cur.e4 & POS_MASK
                       && (cur.e4 & ~POS_MASK) == fp
                   ? __ldg(wa + (cur.e4 & POS_MASK) - 1) : ~cur.a;
    }
    if (c0 > 0) prev[i - CHUNK] = last.pick(c0 - CHUNK);
    if (c0 >= D) return false;
    if (i + CHUNK < D) load(last, i + CHUNK);
    __syncthreads();   // every probe done, every hit counted

    // a bucket hit once takes its hitter; one hit more than once keeps its
    // entry (every hitter writes the entry back, clearing the count)
    const unsigned mine = ((unsigned)i + 1) | fingerprint(cur.a);
    const unsigned h8 = (t8[cur.k8] & ~ENTRY) >> POS_BITS;
    const unsigned h4 = (t4[cur.k4] & ~ENTRY) >> POS_BITS;
    t8[cur.k8] = h8 == 1 ? mine : cur.e8;
    t4[cur.k4] = h4 == 1 ? mine : cur.e4;
    __syncthreads();   // the tables as of the next chunk's start
    return true;
  }
};

__global__ void __launch_bounds__(CHUNK, 2)
bucket_tables_kernel(const int* __restrict__ wa_all,
                     const int* __restrict__ h4_all,
                     const int* __restrict__ h8_all,
                     const int* __restrict__ near, int* __restrict__ prev_all,
                     int D) {
  extern __shared__ unsigned smem[];
  const size_t row = (size_t)blockIdx.x * D;
  const Tables tb{wa_all + row, h4_all + row, h8_all + row, near + row,
                  prev_all + row, smem, smem + NB, D};
  for (int k = threadIdx.x; k < 2 * NB; k += CHUNK) smem[k] = 0;
  Probe x, y;                          // chunks in turn, no copies
  tb.load(x, threadIdx.x);
  __syncthreads();
  for (int c0 = 0;; c0 += 2 * CHUNK)
    if (!tb.step(x, y, c0) || !tb.step(y, x, c0 + CHUNK)) break;
}

}  // namespace
}  // namespace lz4t

extern "C" int lz4t_bucket_prev(const void* wa, const void* wb,
                                const void* h4, const void* h8, void* prev,
                                void* near_scratch, int B, int D,
                                void* stream) {
  if (B <= 0) return 0;
  if (D % lz4t::CHUNK || D >= (1 << lz4t::POS_BITS))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int per = lz4t::NEAR_CHUNKS * lz4t::CHUNK;
  dim3 grid((D + per - 1) / per, B);
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
