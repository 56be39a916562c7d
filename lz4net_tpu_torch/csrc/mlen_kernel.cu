// match_lengths: (matched, off, mlen) per position from its candidate.
//
// Replaces the TPU kernel lz4net_tpu/ops/mlen_kernel.py:
// match_lengths_fused (_mlen_kernel).  The TPU version gathers u32[prev+4]
// with a staircase select loop, compacts the still-growing survivors
// with windowed binary searches over a rank transpose and 8-bit-plane
// matmuls, gathers their extension words the same way, and shifts the
// input through a staged scratch for each dominant offset.  Hopper
// gathers natively, so one CTA per block computes the same function in
// three phases:
//
//   1. forward over the block in tiles: off, matched, the far round at
//      prev+4 (a direct read), and a block-wide exclusive scan of the
//      survivors (nb1 == 4) carried across tiles, so a survivor knows
//      its rank; the first rcap survivors run their ext_rounds
//      extension rounds right there (two direct u32 reads a round).
//      Each position records which exact-run offset, if any, sets its
//      length: 1-4 where matched, or a dominant offset where far;
//   2. for each such offset d that occurs in the block, a block-wide
//      reverse min-scan of the next byte with x[j] != x[j - d] gives the
//      exact equal-run length at every position of that class;
//   3. the format's end rules, and the outputs.
//
// The block's bytes (one per position) and the class of each position
// stay in shared memory (2 x D bytes).
//
// What bounds it on the H100: the up-to-28 run scans (4 + K, K = 8 on
// the fast path and 24 on the HC tiers), each a pass of
// shared-memory reads and a CUB block scan over the block; device-memory
// traffic is about 7 int32 words per position (x, u32, prev, m8 read;
// matched, off, mlen written, off and mlen read back once).
#include <cub/block/block_scan.cuh>

#include "common.cuh"

namespace lz4t {
namespace {

constexpr int THREADS = 1024;
constexpr int ITEMS = 4;
constexpr int TILE = THREADS * ITEMS;   // D is a multiple of this
constexpr int MAX_TOP = 24;             // dominant offsets at most (HC: 24)
constexpr int NCLS = 4 + MAX_TOP;       // exact-run offset classes, < 32
                                        // so s_used's bits hold them
constexpr int NO_CLS = 0x7F;            // "no class" in cls's 7 low bits
constexpr int MAX_DISTANCE = 65535;
constexpr int MINMATCH = 4;
constexpr int LASTLITERALS = 5;
constexpr int MFLIMIT = 12;
constexpr int MINLENGTH = 13;

// equal low-order bytes of two u32 words (0..4)
__device__ __forceinline__ int xor_nb(int wa, int wb) {
  const unsigned d = (unsigned)wa ^ (unsigned)wb;
  return (d & 0xFFu) ? 0 : (d & 0xFF00u) ? 1 : (d & 0xFF0000u) ? 2
                                          : d ? 3 : 4;
}

__global__ void __launch_bounds__(THREADS)
mlen_kernel(const int* __restrict__ x_all, const int* __restrict__ u32_all,
            const int* __restrict__ prev_all, const int* __restrict__ m8_all,
            const int* __restrict__ dks_all,
            const int* __restrict__ end_abs_all,
            const int* __restrict__ blk_len_all, int* __restrict__ matched_all,
            int* __restrict__ off_all, int* __restrict__ mlen_all, int D,
            int K, int rcap, int ext_rounds) {
  using Scan = cub::BlockScan<int, THREADS>;
  __shared__ typename Scan::TempStorage scan_tmp;
  __shared__ int s_d[NCLS];          // offset of each class (0 = unused)
  __shared__ unsigned s_used;        // classes that occur in the block
  extern __shared__ uint8_t smem[];
  uint8_t* sx = smem;                // the block's bytes
  uint8_t* cls = smem + D;           // class | matched << 7

  const int b = blockIdx.x;
  const size_t row = (size_t)b * D;
  const int* u32 = u32_all + row;
  for (int q = threadIdx.x; q < D; q += THREADS)
    sx[q] = (uint8_t)x_all[row + q];
  if (threadIdx.x < NCLS) {
    const int c = threadIdx.x;
    s_d[c] = c < 4 ? c + 1 : (c - 4 < K ? dks_all[b * K + c - 4] : 0);
  }
  if (threadIdx.x == 0) s_used = 0;
  __syncthreads();

  // ---- 1. far round, survivor ranks, extension, classes ---------------
  unsigned used = 0;
  TileCarry<SumOp> rank_carry(0);
  for (int t0 = 0; t0 < D; t0 += TILE) {
    const int qb = t0 + threadIdx.x * ITEMS;
    int off[ITEMS], nb1[ITEMS], alive[ITEMS];
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) {
      const int q = qb + k;
      const int p = prev_all[row + q];
      off[k] = q - p;
      const bool far = p >= 0 && off[k] <= MAX_DISTANCE && off[k] > 4;
      nb1[k] = -1;                   // -1: not far
      if (far) {
        const int w_i4 = q + 4 < D ? u32[q + 4] : 0;
        const int w_p4 = u32[clampi(p + 4, 0, D - 1)];
        nb1[k] = m8_all[row + q] != 0 ? 4 : xor_nb(w_i4, w_p4);
      }
      alive[k] = nb1[k] == 4;
    }
    int rank[ITEMS];
    Scan(scan_tmp).ExclusiveScan(alive, rank, SumOp(), rank_carry);
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) {
      const int q = qb + k;
      const int p = q - off[k];
      const bool matched = p >= 0 && off[k] <= MAX_DISTANCE;
      int len = 0;
      if (nb1[k] >= 0) len = MINMATCH + nb1[k];
      if (alive[k] && rank[k] < rcap) {
        for (int r = 0; r < ext_rounds; ++r) {
          const int nb = xor_nb(u32[clampi(q + len, 0, D - 1)],
                                u32[clampi(p + len, 0, D - 1)]);
          len += nb;
          if (nb != 4) break;
        }
      }
      int c = NO_CLS;
      if (matched && off[k] >= 1 && off[k] <= 4) {
        c = off[k] - 1;
      } else if (nb1[k] >= 0) {
        for (int t = 4; t < NCLS; ++t)
          if (s_d[t] > 0 && s_d[t] == off[k]) { c = t; break; }
      }
      if (c != NO_CLS) used |= 1u << c;
      cls[q] = (uint8_t)(c | (matched ? 0x80 : 0));
      off_all[row + q] = off[k];
      mlen_all[row + q] = len;
    }
    __syncthreads();   // scan_tmp is reused by the next tile
  }
  atomicOr(&s_used, used);
  __syncthreads();     // classes, lengths and s_used complete

  // ---- 2. exact equal-run lengths, one reverse scan per class ---------
  for (int c = 0; c < NCLS; ++c) {
    if (!((s_used >> c) & 1u)) continue;      // uniform across the CTA
    const int d = s_d[c];
    TileCarry<MinOp> carry(BIG);
    for (int t0 = 0; t0 < D; t0 += TILE) {
      int v[ITEMS];
#pragma unroll
      for (int k = 0; k < ITEMS; ++k) {
        const int q = D - 1 - (t0 + threadIdx.x * ITEMS + k);
        v[k] = q >= d && sx[q] == sx[q - d] ? BIG : q;
      }
      Scan(scan_tmp).InclusiveScan(v, v, MinOp(), carry);
#pragma unroll
      for (int k = 0; k < ITEMS; ++k) {
        const int q = D - 1 - (t0 + threadIdx.x * ITEMS + k);
        // v[k]: the first j >= q where the run breaks (BIG: none)
        if ((cls[q] & 0x7F) == c)
          mlen_all[row + q] = (v[k] == BIG ? D : v[k]) - q;
      }
      __syncthreads();
    }
  }

  // ---- 3. the format's end rules --------------------------------------
  const int end_abs = end_abs_all[b];
  const bool blk_ok = blk_len_all[b] >= MINLENGTH;
  for (int q = threadIdx.x; q < D; q += THREADS) {
    const int limit = end_abs - LASTLITERALS - q;
    const int cap = limit > 0 ? limit : 0;
    const int len = mlen_all[row + q] < cap ? mlen_all[row + q] : cap;
    const bool m = (cls[q] & 0x80) && len >= MINMATCH &&
                   q <= end_abs - MFLIMIT && blk_ok;
    matched_all[row + q] = m;
    off_all[row + q] = m ? off_all[row + q] : 0;
    mlen_all[row + q] = m ? len : 0;
  }
}

}  // namespace
}  // namespace lz4t

extern "C" int lz4t_match_lengths(const void* x, const void* u32,
                                  const void* prev, const void* m8,
                                  const void* dks, const void* end_abs,
                                  const void* blk_len, void* matched,
                                  void* off, void* mlen, int B, int D, int K,
                                  int rcap, int ext_rounds, void* stream) {
  if (B <= 0) return 0;
  if (K > lz4t::MAX_TOP || D % lz4t::TILE) return (int)cudaErrorInvalidValue;
  const int smem = 2 * D;
  cudaError_t err = cudaFuncSetAttribute(
      lz4t::mlen_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  lz4t::mlen_kernel<<<B, lz4t::THREADS, smem, (cudaStream_t)stream>>>(
      (const int*)x, (const int*)u32, (const int*)prev, (const int*)m8,
      (const int*)dks, (const int*)end_abs, (const int*)blk_len,
      (int*)matched, (int*)off, (int*)mlen, D, K, rcap, ext_rounds);
  return (int)cudaGetLastError();
}
