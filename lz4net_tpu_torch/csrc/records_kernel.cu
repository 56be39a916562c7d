// records_to_state: token marks -> per-output-byte state and certificate.
//
// Replaces the TPU kernel lz4net_tpu/ops/records_kernel.py:
// records_to_state (_records_kernel).  The TPU version finds each output
// byte's governing sequence with W-row windows fetched by one-hot bf16
// matmuls and lane-shuffle binary searches, because the TPU has no
// gather.  Here the same function is computed with exact reads:
//
//   1. block-wide inclusive scans of adv = mark*(ll+ml) and of mark
//      (records_kernel.py:178-182) give every token its output start
//      estart and its rank; each token's fields (estart, ll, comp
//      position, 16-bit offset read at mpos, lok/mok) are written into a
//      dense per-token table at rank-1, and the certificate's reductions
//      (records_kernel.py:209-221) accumulate in shared memory;
//   2. one thread per output byte o binary-searches the token table for
//      the last token with estart <= o (the key search of :8-14 and
//      :228-351) and writes the state word t0m (match source with the RLE
//      overlap collapsed, or VFLAG) and the literal source index cidx.
//
// What bounds it on the H100: bytes.  It reads comp/mark/ll/ml once
// (4 int32 per comp position), writes t0m and cidx (2 int32 per output
// byte) and a token table of 4 int32 per token; the binary searches read
// the token table (tens of KB per block) from L1/L2, not device memory.
// One CTA per block keeps the scans' carries and the reductions on chip.
#include <cub/block/block_scan.cuh>

#include "common.cuh"

namespace lz4t {
namespace {

constexpr int THREADS = 1024;
constexpr int ITEMS = 4;
constexpr int TILE = THREADS * ITEMS;   // C is a multiple of this

__global__ void __launch_bounds__(THREADS)
records_kernel(const int* __restrict__ comp_all,
               const int* __restrict__ mark_all,
               const int* __restrict__ ll_in, const int* __restrict__ ml_in,
               const int* __restrict__ comp_len_all,
               const int* __restrict__ out_len_all,
               const int* __restrict__ pre_len_all, int* __restrict__ t0m,
               int* __restrict__ cidx, int* __restrict__ stats,
               int* __restrict__ tok_all, int C, int Dt, int P) {
  using Scan = cub::BlockScan<int, THREADS>;
  __shared__ typename Scan::TempStorage scan_tmp;
  __shared__ int s_nseqs, s_consumed, s_lit_bad, s_m_bad;
  __shared__ unsigned s_total, s_needed;

  const int b = blockIdx.x;
  const size_t row = (size_t)b * C;
  const int* comp = comp_all + row;
  const int comp_len = comp_len_all[b];
  const int out_lim = P + out_len_all[b];
  const int ref_floor = P - pre_len_all[b];
  // token table: [4, C] per block (a block has at most C tokens)
  int* tok_est = tok_all + (size_t)b * 4 * C;
  int* tok_ll = tok_est + C;
  int* tok_q = tok_ll + C;
  int* tok_om = tok_q + C;      // off | lok << 16 | mok << 17 | mbad << 18

  if (threadIdx.x == 0) {
    s_nseqs = 0;
    s_consumed = 0;
    s_lit_bad = 0;
    s_m_bad = 0;
    s_total = 0;
    s_needed = 0;
  }
  __syncthreads();

  // ---- 1. scans, token table, certificate partials ---------------------
  int consumed = 0, lit_bad = 0, m_bad = 0;
  unsigned total = 0, needed = 0;
  TileCarry<SumOp> adv_carry(0), rank_carry(0);
  for (int t0 = 0; t0 < C; t0 += TILE) {
    const int qb = t0 + threadIdx.x * ITEMS;
    int m[ITEMS], ll[ITEMS], ml[ITEMS], S[ITEMS], rank[ITEMS];
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) {
      m[k] = mark_all[row + qb + k];
      ll[k] = clampi(ll_in[row + qb + k], 0, Dt);
      ml[k] = clampi(ml_in[row + qb + k], 0, Dt);
      S[k] = m[k] * (ll[k] + ml[k]);
      rank[k] = m[k];
    }
    Scan(scan_tmp).InclusiveScan(S, S, SumOp(), adv_carry);
    __syncthreads();
    Scan(scan_tmp).InclusiveScan(rank, rank, SumOp(), rank_carry);
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) {
      if (m[k] != 1) continue;
      const int q = qb + k;
      const int c = comp[q];
      // ext >= 0, so the truncating division is the floor division
      const int ext = ll[k] - 15 > 0 ? ll[k] - 15 : 0;
      const int hdr = 1 + ((c >> 4) == 15 ? 1 + ext / 255 : 0);
      const int estart = P + S[k] - m[k] * (ll[k] + ml[k]);
      const int mpos = clampi(q + hdr + ll[k], 0, C - 2);
      const int off = comp[mpos] | (comp[mpos + 1] << 8);
      const int match_dst = estart + ll[k];
      const int lok = ll[k] > 0 && estart < out_lim;
      const int mok = match_dst < out_lim && off > 0 &&
                      match_dst - off >= ref_floor;
      const int mbad = !(off > 0 && match_dst - off >= ref_floor);
      const int end = q + hdr + ll[k];
      consumed = end > consumed ? end : consumed;
      lit_bad |= end > comp_len;
      m_bad += mbad;
      needed += (unsigned)ll[k] + (unsigned)ml[k];
      total += (estart < out_lim ? (unsigned)ll[k] : 0u) +
               (mok ? (unsigned)ml[k] : 0u);
      const int t = rank[k] - 1;
      if (t < 0 || t >= C) continue;   // only for marks outside {0, 1}
      tok_est[t] = estart;
      tok_ll[t] = ll[k];
      tok_q[t] = q;
      tok_om[t] = off | (lok << 16) | (mok << 17) | (mbad << 18);
    }
    if (threadIdx.x == THREADS - 1) s_nseqs = rank[ITEMS - 1];
    __syncthreads();   // scan_tmp is reused by the next tile
  }
  atomicMax(&s_consumed, consumed);
  atomicOr(&s_lit_bad, lit_bad);
  atomicAdd(&s_m_bad, m_bad);
  atomicAdd(&s_total, total);
  atomicAdd(&s_needed, needed);
  __syncthreads();     // token table and reductions complete
  const int n_seqs = s_nseqs;
  // table entries to read; n_seqs itself whenever mark holds 0/1 (other
  // marks give unspecified outputs, but no access outside the table)
  const int n_tok = n_seqs < 0 ? 0 : (n_seqs > C ? C : n_seqs);

  if (threadIdx.x == 0) {
    // the last sequence carries no match (has_match = rank < n_seqs):
    // take its match length and its offset check back out
    unsigned need = s_needed;
    int mb = s_m_bad;
    if (n_tok > 0) {
      const int ql = clampi(tok_q[n_tok - 1], 0, C - 1);
      need -= (unsigned)clampi(ml_in[row + ql], 0, Dt);
      mb -= (tok_om[n_tok - 1] >> 18) & 1;
    }
    int* st = stats + b * 8;
    st[0] = n_seqs;
    st[1] = (int)s_total;
    st[2] = s_lit_bad == 0 && mb == 0 && s_consumed == comp_len && n_seqs > 0;
    st[3] = s_consumed;
    st[4] = (int)need;
    st[5] = 0;   // window misses cannot happen with exact reads
    st[6] = 0;
    st[7] = 0;
  }

  // ---- 2. per output byte: governing token, state word, literal index --
  for (int o = threadIdx.x; o < Dt; o += THREADS) {
    int lo = 0, hi = n_tok;           // count of tokens with estart <= o
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (tok_est[mid] <= o) lo = mid + 1; else hi = mid;
    }
    const int t = lo - 1;
    int state = VFLAG, src = -1;
    if (t >= 0) {
      const int est = tok_est[t];
      const int llq = tok_ll[t] < M17 ? tok_ll[t] : M17;
      const int om = tok_om[t];
      const int offq = om & 0xFFFF;
      const int mdst = est + llq;
      const bool in_lit = ((om >> 16) & 1) && o < mdst;
      const bool in_match = !in_lit && ((om >> 17) & 1) && o >= mdst;
      if (in_lit) {
        const int hdrq = 1 + (llq >= 15 ? 1 + (llq - 15) / 255 : 0);
        src = tok_q[t] + hdrq + (o - est);
      }
      if (in_match) {
        // phase >= 0 and offq > 0 here, so % is the remainder of lax.rem
        const int phase = o - mdst;
        const int msrc = phase >= offq ? mdst - offq + phase % offq
                                       : o - offq;
        state = clampi(msrc, 0, Dt - 1);
      }
    }
    t0m[(size_t)b * Dt + o] = state;
    cidx[(size_t)b * Dt + o] = src;
  }
}

}  // namespace
}  // namespace lz4t

extern "C" int lz4t_records_to_state(const void* comp, const void* mark,
                                     const void* ll, const void* ml,
                                     const void* comp_len,
                                     const void* out_len,
                                     const void* pre_len, void* t0m,
                                     void* cidx, void* stats,
                                     void* tok_scratch, int B, int C,
                                     int Dt, int P, void* stream) {
  if (B <= 0) return 0;
  lz4t::records_kernel<<<B, lz4t::THREADS, 0, (cudaStream_t)stream>>>(
      (const int*)comp, (const int*)mark, (const int*)ll, (const int*)ml,
      (const int*)comp_len, (const int*)out_len, (const int*)pre_len,
      (int*)t0m, (int*)cidx, (int*)stats, (int*)tok_scratch, C, Dt, P);
  return (int)cudaGetLastError();
}
