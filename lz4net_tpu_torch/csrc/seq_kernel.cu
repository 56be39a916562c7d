// sequence_records: per-position matches -> the greedy parse's sequence
// records, ready for emit_bytes.
//
// Replaces the TPU kernel lz4net_tpu/ops/seq_kernel.py: sequence_records
// (_seq_kernel).  The TPU version threads the parse chain with
// segment-exit pointer doubling and a two-level supersegment walk,
// compacts tokens and records with in-row lane searches over rank
// transposes, and fetches every field with staircase select loops,
// because it has no gather.  Here one CTA owns one block:
//
//   1. nm[i], the first match at or after i: a block-wide reverse
//      min-scan carried across tiles;
//   2. the chain g[i] (the first match at or after the end of i's match,
//      or nm[i] where i is not matched), stored with i's matched flag;
//   3. one thread walks the chain from position 0 and writes each
//      matched position it visits into the next token slot (the first
//      S_cap tokens).  It reads each step from shared memory, where
//      phase 2 left g - i and the matched flag in 16 bits a position
//      (steps too long for 15 bits read g from device memory);
//   4. per slot, in parallel: the literal run from the previous token's
//      match end, the catch-up rounds (two direct u32 reads a round), and
//      whether the slot starts a record (a literal run, a new offset);
//   5. one reverse block-wide scan over the slots computes, together,
//      each record's merged match length (a segmented sum of the match
//      lengths up to the next record start) and its record index (the
//      count of kept slots after it); kept slots write their record;
//   6. the tail record at n_m, per-record sizes, and the output starts
//      s0 by a forward exclusive scan.
//
// What bounds it on the H100: phase 3, a serial chain of dependent
// shared-memory reads, one per token (up to about 16,000 for a 64 KB
// block); every other phase moves a few int32 words per position or
// slot.  All blocks walk at once, one CTA each (2 x D bytes of shared
// memory); the TPU kernel's chain doubling is the known way to cut the
// walk, for a later version.
#include <cub/block/block_scan.cuh>

#include "common.cuh"

namespace lz4t {
namespace {

constexpr int THREADS = 1024;
constexpr int ITEMS = 4;
constexpr int TILE = THREADS * ITEMS;   // D and SR are multiples of this
constexpr int BIGKEY = 1 << 23;         // s0 of a dead record
constexpr int GFLAG = 1 << 30;          // "matched" flag beside g
constexpr unsigned SFLAG = 0x8000;      // "matched" flag of a step
constexpr unsigned SFAR = 0x7FFF;       // step too long: g is in gm
constexpr int MINMATCH = 4;
constexpr int ML_MASK = 15;
constexpr int RUN_MASK = 15;

// equal high-order bytes of two u32 words (0..4)
__device__ __forceinline__ int xor_nb_rev(int wa, int wb) {
  const unsigned d = (unsigned)wa ^ (unsigned)wb;
  return (d & 0xFF000000u) ? 0 : (d & 0xFF0000u) ? 1 : (d & 0xFF00u) ? 2
                                                      : d ? 3 : 4;
}

// Reverse scan element of phase 5: f = a record starts right after this
// slot, s = segmented sum of match lengths, c = kept slots.
struct Seg {
  int f, s, c;
};

struct SegOp {
  __device__ __forceinline__ Seg operator()(const Seg& a,
                                            const Seg& b) const {
    return Seg{a.f | b.f, b.f ? b.s : a.s + b.s, a.c + b.c};
  }
};

__global__ void __launch_bounds__(THREADS)
seq_kernel(const int* __restrict__ u32_all,
           const int* __restrict__ matched_all,
           const int* __restrict__ off_all, const int* __restrict__ mlen_all,
           const int* __restrict__ end_abs_all,
           const int* __restrict__ pre_len_all, int* __restrict__ s0k_all,
           int* __restrict__ litsrc_all, int* __restrict__ ll_all,
           int* __restrict__ offk_all, int* __restrict__ mlk_all,
           int* __restrict__ stats_all, int* __restrict__ chain_all,
           int* __restrict__ slots_all, int D, int S_cap, int SR, int P,
           int cu_rounds) {
  using ScanI = cub::BlockScan<int, THREADS>;
  using ScanS = cub::BlockScan<Seg, THREADS>;
  __shared__ union {
    typename ScanI::TempStorage i;
    typename ScanS::TempStorage s;
  } tmp;
  __shared__ int s_nseqs, s_nm, s_tail;
  extern __shared__ uint16_t step[];     // [D] g - i | matched flag

  const int b = blockIdx.x;
  const size_t rowD = (size_t)b * D;
  const size_t rowS = (size_t)b * SR;
  const int* u32 = u32_all + rowD;
  const int* matched = matched_all + rowD;
  const int* off = off_all + rowD;
  const int* mlen = mlen_all + rowD;
  int* nm = chain_all + 2 * rowD;        // [D] first match at or after i
  int* gm = nm + D;                      // [D] g | matched flag
  int* tok = slots_all + (size_t)b * 4 * S_cap;
  int* ll2 = tok + S_cap;                // literal length after catch-up
  int* ml2 = ll2 + S_cap;                // match length after catch-up
  int* st = ml2 + S_cap;                 // the slot starts a record
  int* litsrc = litsrc_all + rowS;
  int* ll = ll_all + rowS;
  int* offk = offk_all + rowS;
  int* mlk = mlk_all + rowS;
  const int end_abs = end_abs_all[b];
  const int floor_abs = P - pre_len_all[b];  // lowest legal match source
  if (threadIdx.x == 0) {
    s_nm = 0;
    s_tail = 0;
  }

  // ---- 1. nm: reverse min-scan of the matched positions ---------------
  TileCarry<MinOp> nm_carry(BIG);
  for (int t0 = 0; t0 < D; t0 += TILE) {
    int v[ITEMS];
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) {
      const int q = D - 1 - (t0 + threadIdx.x * ITEMS + k);
      v[k] = matched[q] == 1 ? q : BIG;
    }
    ScanI(tmp.i).InclusiveScan(v, v, MinOp(), nm_carry);
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) {
      const int q = D - 1 - (t0 + threadIdx.x * ITEMS + k);
      nm[q] = v[k] == BIG ? D : v[k];
    }
    __syncthreads();   // tmp is reused by the next tile
  }

  // ---- 2. the parse chain --------------------------------------------
  for (int q = threadIdx.x; q < D; q += THREADS) {
    const bool m = matched[q] == 1;
    const int tgt = q + (m ? clampi(mlen[q], 0, D) : 1);
    int g = m ? (tgt >= D ? D : nm[tgt]) : nm[q];
    g = g > q + 1 ? g : q + 1;           // strictly forward
    gm[q] = g | (m ? GFLAG : 0);
    step[q] = (uint16_t)(((unsigned)(g - q) < SFAR ? (unsigned)(g - q)
                                                   : SFAR)
                         | (m ? SFLAG : 0u));
  }
  __syncthreads();

  // ---- 3. walk the chain from position 0 ------------------------------
  if (threadIdx.x == 0) {
    int n = 0;
    for (int pos = 0; pos < D;) {
      const unsigned v = step[pos];
      if (v & SFLAG) {
        if (n < S_cap) tok[n] = pos;
        ++n;
      }
      pos = (v & SFAR) == SFAR ? gm[pos] & (GFLAG - 1) : pos + (v & SFAR);
    }
    s_nseqs = n;
  }
  __syncthreads();
  const int n_seqs = s_nseqs;
  const int nv = n_seqs < S_cap ? n_seqs : S_cap;   // filled token slots

  // ---- 4. literal runs, catch-up, record starts -----------------------
  int keeps = 0;
  for (int k = threadIdx.x; k < S_cap; k += THREADS) {
    int l2 = 0, m2 = 0, start = 1;
    if (k < nv) {
      const int q = tok[k];
      const int qp = k > 0 ? tok[k - 1] : 0;
      const int off_s = off[q];
      const int ml_s = mlen[q];
      const int lit_start = k > 0 ? qp + mlen[qp] : P;
      const int lit_len = q - lit_start;
      int cb = 0;
      bool can = ml_s > 0;
      for (int r = 0; r < cu_rounds; ++r) {
        const int cb_max = min(lit_len, q - off_s - floor_abs);
        const int pa = q - cb - 4;
        const int pb = q - off_s - cb - 4;
        const int nb = can && pa >= 0 && pb >= 0
                           ? xor_nb_rev(u32[clampi(pa, 0, D - 1)],
                                        u32[clampi(pb, 0, D - 1)])
                           : 0;
        cb = min(cb + nb, max(cb_max, 0));
        can = can && nb == 4;
      }
      l2 = lit_len - cb;
      m2 = ml_s + cb;
      const int prev_off = k > 0 ? off[qp] : 0;
      start = k == 0 || l2 != 0 || off_s != prev_off;
      keeps += start;
    }
    ll2[k] = l2;
    ml2[k] = m2;
    st[k] = start;
  }
  atomicAdd(&s_nm, keeps);
  __syncthreads();
  const int n_m = s_nm;

  // ---- 5. merge and compact the records (reverse scan) ----------------
  int tail = 0;
  TileCarry<SegOp, Seg> seg_carry(Seg{0, 0, 0});
  for (int t0 = 0; t0 < SR; t0 += TILE) {
    Seg e[ITEMS];
#pragma unroll
    for (int kk = 0; kk < ITEMS; ++kk) {
      const int k = SR - 1 - (t0 + threadIdx.x * ITEMS + kk);
      if (k < S_cap)
        e[kk] = Seg{k + 1 >= S_cap || st[k + 1], ml2[k], k < nv && st[k]};
      else
        e[kk] = Seg{1, 0, 0};
    }
    ScanS(tmp.s).InclusiveScan(e, e, SegOp(), seg_carry);
#pragma unroll
    for (int kk = 0; kk < ITEMS; ++kk) {
      const int k = SR - 1 - (t0 + threadIdx.x * ITEMS + kk);
      if (k >= nv || !st[k]) continue;
      const int r = n_m - e[kk].c;       // kept slots before this one
      const int q = tok[k];
      const int lit_start = k > 0 ? tok[k - 1] + mlen[tok[k - 1]] : P;
      litsrc[r] = lit_start;
      ll[r] = ll2[k];
      offk[r] = off[q];
      mlk[r] = e[kk].s;                  // merged match length
      const int end = lit_start + ll2[k] + e[kk].s;
      tail = end > tail ? end : tail;
    }
    __syncthreads();   // tmp is reused by the next tile
  }
  atomicMax(&s_tail, tail);
  __syncthreads();
  const int tail_start = s_tail > P ? s_tail : P;
  const int tail_len = end_abs - tail_start;

  // ---- 6. tail record, sizes, output starts ---------------------------
  int first_lit = 0;
  TileCarry<SumOp> s0_carry(0);
  for (int t0 = 0; t0 < SR; t0 += TILE) {
    int ls[ITEMS], ln[ITEMS], of[ITEMS], ml[ITEMS], size[ITEMS];
    bool live[ITEMS];
#pragma unroll
    for (int kk = 0; kk < ITEMS; ++kk) {
      const int r = t0 + threadIdx.x * ITEMS + kk;
      live[kk] = r <= n_m && r < S_cap;
      ls[kk] = ln[kk] = of[kk] = ml[kk] = 0;
      if (r < n_m) {
        ls[kk] = litsrc[r];
        ln[kk] = ll[r];
        of[kk] = offk[r];
        ml[kk] = mlk[r];
      } else if (live[kk]) {            // the final literal-only record
        ls[kk] = tail_start;
        ln[kk] = tail_len;
      }
      const bool has_m = live[kk] && ml[kk] > 0;
      const int e_lit = ln[kk] - RUN_MASK > 0 ? ln[kk] - RUN_MASK : 0;
      const int lit_ext =
          live[kk] && ln[kk] >= RUN_MASK ? 1 + e_lit / 255 : 0;
      const int e_m = ml[kk] - MINMATCH - ML_MASK > 0
                          ? ml[kk] - MINMATCH - ML_MASK : 0;
      const int m_ext =
          has_m && ml[kk] - MINMATCH >= ML_MASK ? 1 + e_m / 255 : 0;
      size[kk] = live[kk] ? 1 + lit_ext + ln[kk] + (has_m ? 2 + m_ext : 0)
                          : 0;
      if (!has_m) ml[kk] = 0;
    }
    int s0[ITEMS];
    ScanI(tmp.i).ExclusiveScan(size, s0, SumOp(), s0_carry);
#pragma unroll
    for (int kk = 0; kk < ITEMS; ++kk) {
      const int r = t0 + threadIdx.x * ITEMS + kk;
      s0k_all[rowS + r] = live[kk] ? s0[kk] : BIGKEY;
      litsrc[r] = live[kk] ? ls[kk] : 0;
      ll[r] = live[kk] ? ln[kk] : 0;
      offk[r] = live[kk] ? of[kk] : 0;
      mlk[r] = ml[kk];
      if (r == 0) first_lit = ln[kk];
    }
    __syncthreads();   // tmp is reused by the next tile
  }
  if (threadIdx.x == 0) {
    // thread 0 runs the prefix callback, so its carry holds the total
    int* stats = stats_all + (size_t)b * 8;
    stats[0] = n_seqs;
    stats[1] = n_m;
    stats[2] = s0_carry.carry;
    stats[3] = first_lit;
    stats[4] = tail_len;
    stats[5] = tail_start;
    stats[6] = 0;
    stats[7] = 0;
  }
}

}  // namespace
}  // namespace lz4t

extern "C" int lz4t_sequence_records(
    const void* u32, const void* matched, const void* off, const void* mlen,
    const void* end_abs, const void* pre_len, void* s0k, void* litsrc,
    void* ll, void* offk, void* mlk, void* stats, void* chain_scratch,
    void* slot_scratch, int B, int D, int S_cap, int SR, int P,
    int cu_rounds, void* stream) {
  if (B <= 0) return 0;
  if (D % lz4t::TILE || SR % lz4t::TILE || S_cap > SR)
    return (int)cudaErrorInvalidValue;
  const int smem = 2 * D;
  cudaError_t err = cudaFuncSetAttribute(
      lz4t::seq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  lz4t::seq_kernel<<<B, lz4t::THREADS, smem, (cudaStream_t)stream>>>(
      (const int*)u32, (const int*)matched, (const int*)off,
      (const int*)mlen, (const int*)end_abs, (const int*)pre_len,
      (int*)s0k, (int*)litsrc, (int*)ll, (int*)offk, (int*)mlk,
      (int*)stats, (int*)chain_scratch, (int*)slot_scratch, D, S_cap, SR,
      P, cu_rounds);
  return (int)cudaGetLastError();
}
