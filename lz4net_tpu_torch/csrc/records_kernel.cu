// records_to_state: token marks -> per-output-byte state and certificate.
//
// Replaces the TPU kernel lz4net_tpu/ops/records_kernel.py:
// records_to_state (_records_kernel).  The TPU version finds each output
// byte's governing sequence with W-row windows fetched by one-hot bf16
// matmuls and lane-shuffle binary searches, because the TPU has no
// gather.  Here the same function is computed with exact reads, in two
// kernels launched by one call:
//
//   scan_kernel, one CTA per segment of 4096 compressed positions of one
//     block (C/4096 x B CTAs, taken in order from a counter): the
//     inclusive scans of adv = mark*(ll+ml) and of mark, as one scan of
//     pairs (records_kernel.py:178-182), run as a single-pass scan with
//     decoupled look-back: each CTA publishes its segment's sums, a warp
//     adds its predecessors' (up to 32 at a step) until it meets an
//     inclusive prefix, and publishes its own.  That gives every token
//     its output start estart and its rank; each token's per-byte fields
//     are computed once and written into a dense token table at rank-1
//     (estart, the match destination mdst, the literal base
//     cbase = q + hdr - estart, and the 16-bit offset read at mpos with
//     the lok/mok/mbad bits).  Every token also writes its rank-1 into
//     the tile index at each output tile k whose start k*T lies in
//     [estart, next estart), so tile k's entry is the token that governs
//     its first byte (-1 before the first token; the block's last segment
//     gives the last token the tiles past its bytes).  The certificate's
//     reductions (records_kernel.py:209-221) go to per-block counters.
//   expand_kernel, one CTA per tile of T = 4096 output bytes of one
//     block (a (Dt/T, B) grid): a tile expansion.  The tokens that
//     govern the tile are [t_lo, t_hi], the tile index's entries of this
//     tile and the next (the last token for the last tile).  Each token
//     in (t_lo, t_hi] whose estart lies in the tile marks
//     owner[estart - tile start] with its index (atomicMax: of tokens
//     with equal estart the last wins, as the search of :8-14 and
//     :228-351 takes the last token with estart <= o); a block-wide
//     inclusive max-scan over owner, seeded with t_lo, gives every byte
//     its governing token with no search (common.cuh's expand_tile,
//     which emit_kernel.cu shares).
//     Each thread derives its 8 bytes' state word t0m (the match source
//     with the RLE overlap collapsed, or VFLAG) and literal source cidx
//     from the token's fields, loaded once per token it meets, and
//     writes them with int4 stores.  The block's first tile also writes
//     the certificate and, where the caller asks for them, the positions
//     the reference decoders' block-end rules bind on, read from the
//     token table at the block's last two tokens (ops/records_kernel.py's
//     ``ends``).
//
// Domain: estart never decreases, which holds for parse_tokens' output
// (each token's ll + ml is at most 274 times the compressed bytes it
// spans, so the row's sum stays far below 2^31 - P).  Marks outside
// {0, 1} give unspecified outputs but no access outside the buffers.
//
// What bounds it on the H100: bytes.  It reads mark once (int4), and ll
// and ml (int4) only in the 4-position groups that hold a mark, where it
// also prefetches comp into L1 for the tokens' own reads and most
// offsets; it writes t0m and cidx (2 int32 per output byte) and a token
// table of 4 int32 per token, which the expansion reads back from L2.
// Both kernels spread a batch over thousands of CTAs, so the loads of
// many segments and tiles are in flight at once.
#include <cub/block/block_scan.cuh>

#include "common.cuh"

namespace lz4t {
namespace {

constexpr int THREADS = 512;
constexpr int ITEMS = 8;
constexpr int SEG = THREADS * ITEMS;     // C is a multiple of this
constexpr int EXPAND = THREADS * ITEMS;  // output bytes of a tile
constexpr int NO_END = -(1 << 30);       // ends of a block without a match

// look-back words: flag << 62 | rank sum << 32 | adv sum (mod 2^32)
constexpr unsigned long long NOT_READY = 0, AGGREGATE = 1, INCLUSIVE = 2;

struct PairSumOp {
  __device__ __forceinline__ int2 operator()(int2 a, int2 b) const {
    // int32 wraparound, as XLA's int32 cumsum
    return make_int2((int)((unsigned)a.x + (unsigned)b.x),
                     (int)((unsigned)a.y + (unsigned)b.y));
  }
};

// The scratch after the blocks' token tables (set by the C entry):
// look-back words and certificate partials zeroed, the tile index -1.
struct Ctrl {
  unsigned long long* status;   // [B, nseg] look-back words
  int* acc;                     // [B, 8] certificate partials
  int* next;                    // the next segment to take
  int* tile_lo;                 // [B, nt] tile index
};

enum { ACC_CONSUMED, ACC_LIT_BAD, ACC_M_BAD, ACC_TOTAL, ACC_NEEDED,
       ACC_LASTQ };

__device__ __forceinline__ unsigned long long pack(unsigned long long flag,
                                                   int2 v) {
  return flag << 62 |
         (unsigned long long)((unsigned)v.y & 0x3FFFFFFFu) << 32 |
         (unsigned)v.x;
}

__device__ __forceinline__ int ceil_tiles(int x, int nt) {
  // first tile whose start is >= x, for x clamped to [0, nt * EXPAND]
  const long long c = x < 0 ? 0 : x;
  const long long k = (c + EXPAND - 1) / EXPAND;
  return k > nt ? nt : (int)k;
}

__global__ void __launch_bounds__(THREADS, 2)
scan_kernel(const int* __restrict__ comp_all, const int* __restrict__ mark_all,
            const int* __restrict__ ll_in, const int* __restrict__ ml_in,
            const int* __restrict__ comp_len_all,
            const int* __restrict__ out_len_all,
            const int* __restrict__ pre_len_all, int* __restrict__ tok_all,
            Ctrl ctrl, int C, int Dt, int P, int nt, int nseg) {
  using Scan = cub::BlockScan<int2, THREADS, cub::BLOCK_SCAN_WARP_SCANS>;
  __shared__ typename Scan::TempStorage scan_tmp;
  __shared__ int s_v, s_red[6];
  __shared__ int2 s_excl;

  if (threadIdx.x == 0) {
    s_v = atomicAdd(ctrl.next, 1);   // segments start in order
    s_red[ACC_CONSUMED] = s_red[ACC_LIT_BAD] = s_red[ACC_M_BAD] = 0;
    s_red[ACC_TOTAL] = s_red[ACC_NEEDED] = 0;
    s_red[ACC_LASTQ] = -1;
  }
  __syncthreads();
  const int b = s_v / nseg;
  const int seg = s_v % nseg;
  const int lane = threadIdx.x & 31;
  const size_t row = (size_t)b * C;
  const int* comp = comp_all + row;
  // token table [4, C] per block (a block has at most C tokens)
  int* tok_est = tok_all + (size_t)b * 4 * C;
  int* tok_mdst = tok_est + C;
  int* tok_cbase = tok_mdst + C;
  int* tok_om = tok_cbase + C;  // off | lok << 16 | mok << 17 | mbad << 18
  int* tile_lo = ctrl.tile_lo + (size_t)b * nt;
  unsigned long long* status = ctrl.status + (size_t)b * nseg;

  // ---- 1. loads and the segment's scan ---------------------------------
  const int qb = seg * SEG + threadIdx.x * ITEMS;
  int2 S[ITEMS];       // (adv, mark), then their inclusive sums
  unsigned ones = 0;   // items whose mark is 1
#pragma unroll
  for (int h = 0; h < ITEMS; h += 4) {
    const int4 mv = *reinterpret_cast<const int4*>(mark_all + row + qb + h);
    int4 lv = make_int4(0, 0, 0, 0), nv = lv;
    if (mv.x | mv.y | mv.z | mv.w) {   // ll and ml only where marked
      lv = *reinterpret_cast<const int4*>(ll_in + row + qb + h);
      nv = *reinterpret_cast<const int4*>(ml_in + row + qb + h);
      // into L1 for the tokens' own reads below
      asm volatile("prefetch.global.L1 [%0];" :: "l"(comp + qb + h));
    }
    const int m[4] = {mv.x, mv.y, mv.z, mv.w};
    const int l[4] = {lv.x, lv.y, lv.z, lv.w};
    const int n[4] = {nv.x, nv.y, nv.z, nv.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      S[h + i] = make_int2(m[i] * (clampi(l[i], 0, Dt) +
                                   clampi(n[i], 0, Dt)), m[i]);
      ones |= (unsigned)(m[i] == 1) << (h + i);
    }
  }
  int2 agg;
  Scan(scan_tmp).InclusiveScan(S, S, PairSumOp(), agg);

  // ---- 2. look-back: the sums of the block's earlier segments -----------
  if (threadIdx.x < 32) {
    int2 excl = make_int2(0, 0);
    if (lane == 0)
      atomicExch(status + seg, pack(seg == 0 ? INCLUSIVE : AGGREGATE, agg));
    for (int j = seg - 1; j >= 0; j -= 32) {
      const int idx = j - lane;
      unsigned long long w = INCLUSIVE << 62;   // before segment 0: zeros
      do {
        if (idx >= 0) w = *(volatile unsigned long long*)(status + idx);
      } while (__any_sync(0xFFFFFFFFu, (w >> 62) == NOT_READY));
      const unsigned incl = __ballot_sync(0xFFFFFFFFu,
                                          (w >> 62) == INCLUSIVE);
      const int lim = incl ? __ffs(incl) - 1 : 31;   // nearest first
      excl = PairSumOp()(excl, make_int2(
          (int)__reduce_add_sync(0xFFFFFFFFu,
                                 lane <= lim ? (unsigned)w : 0u),
          (int)__reduce_add_sync(0xFFFFFFFFu,
                                 lane <= lim ? (unsigned)(w >> 32) &
                                                   0x3FFFFFFFu : 0u)));
      if (incl) break;
    }
    if (lane == 0) {
      if (seg > 0)
        atomicExch(status + seg, pack(INCLUSIVE, PairSumOp()(excl, agg)));
      s_excl = excl;
    }
  }
  __syncthreads();

  // ---- 3. tokens: table, tile index, certificate partials ---------------
  const int2 excl = s_excl;
  if (seg == nseg - 1) {
    // the block's last segment knows its totals: the last token governs
    // every tile past the end of its bytes
    const int n_all = excl.y + agg.y;
    const int n_tok = n_all < 0 ? 0 : (n_all > C ? C : n_all);
    const int end = (int)((unsigned)P + (unsigned)excl.x + (unsigned)agg.x);
    if (n_tok > 0)
      for (int j = ceil_tiles(end, nt) + threadIdx.x; j < nt; j += THREADS)
        tile_lo[j] = n_tok - 1;
  }
  const int comp_len = comp_len_all[b];
  const int out_lim = P + out_len_all[b];
  const int ref_floor = P - pre_len_all[b];
  int consumed = 0, lit_bad = 0, m_bad = 0, lastq = -1;
  unsigned total = 0, needed = 0;
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    if (!((ones >> k) & 1)) continue;
    const int q = qb + k;
    // a token's lengths again, from L1 (only the scan needed them all)
    const int llk = clampi(ll_in[row + q], 0, Dt);
    const int mlk = clampi(ml_in[row + q], 0, Dt);
    const int c = comp[q];
    // ext >= 0, so the truncating division is the floor division
    const int ext = llk - 15 > 0 ? llk - 15 : 0;
    const int hdr = 1 + ((c >> 4) == 15 ? 1 + ext / 255 : 0);
    // the next token's estart
    const int next =
        (int)((unsigned)P + (unsigned)excl.x + (unsigned)S[k].x);
    const int estart = next - (llk + mlk);
    const int mpos = clampi(q + hdr + llk, 0, C - 2);
    const int off = comp[mpos] | (comp[mpos + 1] << 8);
    const int match_dst = estart + llk;
    const int lok = llk > 0 && estart < out_lim;
    const int mok = match_dst < out_lim && off > 0 &&
                    match_dst - off >= ref_floor;
    const int mbad = !(off > 0 && match_dst - off >= ref_floor);
    const int end = q + hdr + llk;
    consumed = end > consumed ? end : consumed;
    lit_bad |= end > comp_len;
    m_bad += mbad;
    lastq = q;
    needed += (unsigned)llk + (unsigned)mlk;
    total += (estart < out_lim ? (unsigned)llk : 0u) +
             (mok ? (unsigned)mlk : 0u);
    const int t = excl.y + S[k].y - 1;
    if (t < 0 || t >= C) continue;   // only for marks outside {0, 1}
    // the per-byte fields: llq clamps to M17, the header from llq
    const int llq = llk < M17 ? llk : M17;
    const int hdrq = 1 + (llq >= 15 ? 1 + (llq - 15) / 255 : 0);
    tok_est[t] = estart;
    tok_mdst[t] = (int)((unsigned)estart + (unsigned)llq);
    tok_cbase[t] = (int)((unsigned)q + (unsigned)hdrq - (unsigned)estart);
    tok_om[t] = off | (lok << 16) | (mok << 17) | (mbad << 18);
    // tiles whose first byte this token governs
    for (int j = ceil_tiles(estart, nt), je = ceil_tiles(next, nt); j < je;
         ++j)
      tile_lo[j] = t;
  }
  atomicMax(&s_red[ACC_CONSUMED], consumed);
  atomicOr(&s_red[ACC_LIT_BAD], lit_bad);
  atomicAdd(&s_red[ACC_M_BAD], m_bad);
  atomicMax(&s_red[ACC_LASTQ], lastq);
  atomicAdd((unsigned*)&s_red[ACC_TOTAL], total);
  atomicAdd((unsigned*)&s_red[ACC_NEEDED], needed);
  __syncthreads();
  if (threadIdx.x == 0) {
    int* acc = ctrl.acc + b * 8;
    atomicMax(acc + ACC_CONSUMED, s_red[ACC_CONSUMED]);
    atomicOr(acc + ACC_LIT_BAD, s_red[ACC_LIT_BAD]);
    atomicAdd(acc + ACC_M_BAD, s_red[ACC_M_BAD]);
    atomicMax(acc + ACC_LASTQ, s_red[ACC_LASTQ]);
    atomicAdd((unsigned*)acc + ACC_TOTAL, (unsigned)s_red[ACC_TOTAL]);
    atomicAdd((unsigned*)acc + ACC_NEEDED, (unsigned)s_red[ACC_NEEDED]);
  }
}

// The block's certificate: stats[b] = (n_seqs, total_out, strict,
// consumed, needed, 0, 0, 0) from the scan's partials; and, if ends is
// not null, ends[b] = the last match's (literal end in comp, literal end
// and match end in the output from P, the final token's offset where the
// match length has extension bytes) from the token table.
__device__ void certificate(const int* __restrict__ comp_all,
                            const int* __restrict__ ml_in,
                            const int* __restrict__ comp_len_all,
                            const int* __restrict__ tok_est, Ctrl ctrl,
                            int* __restrict__ stats, int* __restrict__ ends,
                            int b, int n_seqs, int C, int Dt, int P) {
  const int* tok_mdst = tok_est + C;
  const int* tok_cbase = tok_mdst + C;
  const int* tok_om = tok_cbase + C;
  const int* acc = ctrl.acc + b * 8;
  const int n_tok = n_seqs > C ? C : n_seqs;
  // the last sequence carries no match (has_match = rank < n_seqs): take
  // its match length and its offset check back out
  unsigned need = (unsigned)acc[ACC_NEEDED];
  int mb = acc[ACC_M_BAD];
  if (n_tok > 0) {
    const int ql = clampi(acc[ACC_LASTQ], 0, C - 1);
    need -= (unsigned)clampi(ml_in[(size_t)b * C + ql], 0, Dt);
    mb -= (tok_om[n_tok - 1] >> 18) & 1;
  }
  int* st = stats + b * 8;
  st[0] = n_seqs;
  st[1] = acc[ACC_TOTAL];
  st[2] = acc[ACC_LIT_BAD] == 0 && mb == 0 &&
          acc[ACC_CONSUMED] == comp_len_all[b] && n_seqs > 0;
  st[3] = acc[ACC_CONSUMED];
  st[4] = (int)need;
  st[5] = 0;   // window misses cannot happen with exact reads
  st[6] = 0;
  st[7] = 0;
  if (ends == nullptr) return;
  int e[4] = {NO_END, NO_END, NO_END, NO_END};
  if (n_tok >= 2) {
    const int t = n_tok - 2;   // the last sequence with a match
    const int est = tok_est[t], mdst = tok_mdst[t];
    const int llq = (int)((unsigned)mdst - (unsigned)est);
    const int hdrq = 1 + (llq >= 15 ? 1 + (llq - 15) / 255 : 0);
    const int q = (int)((unsigned)tok_cbase[t] + (unsigned)est -
                        (unsigned)hdrq);
    e[0] = (int)((unsigned)tok_cbase[t] + (unsigned)mdst);  // q + hdr + ll
    e[1] = (int)((unsigned)mdst - (unsigned)P);
    e[2] = (int)((unsigned)tok_est[t + 1] - (unsigned)P);
    if ((comp_all[(size_t)b * C + clampi(q, 0, C - 1)] & 15) == 15)
      e[3] = acc[ACC_LASTQ];
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) ends[b * 4 + i] = e[i];
}

__global__ void __launch_bounds__(THREADS)
expand_kernel(const int* __restrict__ comp_all,
              const int* __restrict__ ml_in,
              const int* __restrict__ comp_len_all,
              const int* __restrict__ tok_all, Ctrl ctrl,
              int* __restrict__ t0m, int* __restrict__ cidx,
              int* __restrict__ stats, int* __restrict__ ends, int C,
              int Dt, int P, int nt, int nseg) {
  using Scan = cub::BlockScan<int, THREADS, cub::BLOCK_SCAN_WARP_SCANS>;
  __shared__ typename Scan::TempStorage scan_tmp;
  __shared__ __align__(16) int owner[EXPAND];

  const int b = blockIdx.y;
  const int k = blockIdx.x;
  const int o0 = k * EXPAND;
  const int* tok_est = tok_all + (size_t)b * 4 * C;
  const int* tok_mdst = tok_est + C;
  const int* tok_cbase = tok_mdst + C;
  const int* tok_om = tok_cbase + C;
  const int* tile_lo = ctrl.tile_lo + (size_t)b * nt;
  // the block's token count: the rank sum of its last segment
  const int n_seqs = (int)((ctrl.status[(size_t)b * nseg + nseg - 1] >> 32) &
                           0x3FFFFFFFu);
  // table entries to read; n_seqs itself whenever mark holds 0/1
  const int n_tok = n_seqs > C ? C : n_seqs;

  if (k >= nt) {        // Dt == 0: the certificate only
    if (threadIdx.x == 0)
      certificate(comp_all, ml_in, comp_len_all, tok_est, ctrl, stats, ends,
                  b, n_seqs, C, Dt, P);
    return;
  }

  // ---- 4. tile bounds ---------------------------------------------------
  const int t_lo = clampi(tile_lo[k], -1, n_tok - 1);
  const int t_hi = clampi(k + 1 < nt ? tile_lo[k + 1] : n_tok - 1, t_lo,
                          n_tok - 1);
  for (int i = threadIdx.x; i < EXPAND; i += THREADS) owner[i] = -1;
  __syncthreads();

  // ---- 5. owner marks and max-scan: every byte's governing token --------
  int gov[ITEMS];
  expand_tile<THREADS, ITEMS, Scan>(tok_est, t_lo, t_hi, o0, owner,
                                    scan_tmp, gov);

  // ---- 6. per byte: state word and literal index, int4 stores -----------
  int state[ITEMS], src[ITEMS];
  int tc = -1, mdst = 0, cbase = 0, om = 0;
  const int ob = o0 + threadIdx.x * ITEMS;
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    const int t = gov[j];
    const int o = ob + j;
    state[j] = VFLAG;
    src[j] = -1;
    if (t < 0) continue;
    if (t != tc) {
      tc = t;
      mdst = __ldg(tok_mdst + t);
      cbase = __ldg(tok_cbase + t);
      om = __ldg(tok_om + t);
    }
    const int offq = om & 0xFFFF;
    const bool in_lit = ((om >> 16) & 1) && o < mdst;
    const bool in_match = !in_lit && ((om >> 17) & 1) && o >= mdst;
    if (in_lit) src[j] = (int)((unsigned)cbase + (unsigned)o);
    if (in_match) {
      // phase >= 0 and offq > 0 here, so % is the remainder of lax.rem
      const int phase = o - mdst;
      const int msrc = phase >= offq ? mdst - offq + phase % offq
                                     : o - offq;
      state[j] = clampi(msrc, 0, Dt - 1);
    }
  }
  const size_t at = (size_t)b * Dt + ob;
  if ((Dt & 3) == 0) {
#pragma unroll
    for (int h = 0; h < ITEMS; h += 4) {
      if (ob + h >= Dt) break;
      *reinterpret_cast<int4*>(t0m + at + h) =
          make_int4(state[h], state[h + 1], state[h + 2], state[h + 3]);
      *reinterpret_cast<int4*>(cidx + at + h) =
          make_int4(src[h], src[h + 1], src[h + 2], src[h + 3]);
    }
  } else {
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {
      if (ob + j >= Dt) break;
      t0m[at + j] = state[j];
      cidx[at + j] = src[j];
    }
  }
  // the certificate, once a block, after the tile's stores are issued
  if (k == 0 && threadIdx.x == 0)
    certificate(comp_all, ml_in, comp_len_all, tok_est, ctrl, stats, ends, b,
                n_seqs, C, Dt, P);
}

}  // namespace
}  // namespace lz4t

extern "C" int lz4t_records_to_state(const void* comp, const void* mark,
                                     const void* ll, const void* ml,
                                     const void* comp_len,
                                     const void* out_len,
                                     const void* pre_len, void* t0m,
                                     void* cidx, void* stats, void* ends,
                                     void* tok_scratch, int B, int C,
                                     int Dt, int P, void* stream) {
  if (B <= 0) return 0;
  // scratch (ops/records_kernel.py sizes it): the token tables [B, 4, C];
  // the look-back words [B, nseg] (64-bit), the certificate partials
  // [B, 8] and the segment counter, zeroed; the tile index [B, nt], -1
  const int nt = (Dt + lz4t::EXPAND - 1) / lz4t::EXPAND;
  const int nseg = C / lz4t::SEG;
  int* words = (int*)tok_scratch + (size_t)B * 4 * C;
  lz4t::Ctrl ctrl;
  ctrl.status = (unsigned long long*)words;
  ctrl.acc = words + 2 * (size_t)B * nseg;
  ctrl.next = ctrl.acc + 8 * (size_t)B;
  ctrl.tile_lo = ctrl.next + 1;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(
      words, 0, (2 * (size_t)B * nseg + 8 * (size_t)B + 1) * 4, s);
  if (err == cudaSuccess)
    err = cudaMemsetAsync(ctrl.tile_lo, 0xFF, (size_t)B * nt * 4, s);
  if (err != cudaSuccess) return (int)err;
  lz4t::scan_kernel<<<nseg * B, lz4t::THREADS, 0, s>>>(
      (const int*)comp, (const int*)mark, (const int*)ll, (const int*)ml,
      (const int*)comp_len, (const int*)out_len, (const int*)pre_len,
      (int*)tok_scratch, ctrl, C, Dt, P, nt, nseg);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  lz4t::expand_kernel<<<dim3(nt > 0 ? nt : 1, B), lz4t::THREADS, 0, s>>>(
      (const int*)comp, (const int*)ml, (const int*)comp_len,
      (const int*)tok_scratch, ctrl, (int*)t0m, (int*)cidx, (int*)stats,
      (int*)ends, C, Dt, P, nt, nseg);
  return (int)cudaGetLastError();
}
