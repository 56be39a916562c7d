// sequence_records: per-position matches -> the greedy parse's sequence
// records, ready for emit_bytes.
//
// Replaces the TPU kernel lz4net_tpu/ops/seq_kernel.py: sequence_records
// (_seq_kernel).  The TPU version threads the parse chain with
// segment-exit pointer doubling and a two-level supersegment walk,
// compacts tokens and records with in-row lane searches over rank
// transposes, and fetches every field with staircase select loops,
// because it has no gather.  Here one CTA of 512 threads owns one block.
//
// The parse follows the local step g(q) = min(q + max(matched[q] ?
// clamp(mlen[q], 0, D) : 1, 1), D): a matched position steps past its
// match, any other to the next position.  The matched positions on the
// orbit of 0 under g are the greedy parse's tokens, the same as under
// the step "to the first match at or after" (ops/seq_kernel.py:
// chain_graph; a CPU test holds the two orbits equal), and g needs
// nothing but position q's own fields: no next-match table, no gather.
//
//   1. the parse, by segment exits (csrc/parse_kernel.cu's steps 2-4),
//      in tiles of 1024 positions with the orbit's next position carried
//      from tile to tile (matched and mlen loaded a tile ahead):
//      - each position's g, and its exit from its 32-position segment
//        (the first orbit position at or past the segment's end) by
//        pointer doubling with __shfl_sync: g >= q + 1, so at most 32
//        steps, 5 rounds; the rounds' jumps g^(2^r) stay in registers;
//      - each position's exit from its 128-position group, at most three
//        segment exits on; one thread hops from the carried position over
//        the group exits in shared memory, one dependent read a group the
//        orbit enters (8 a tile at most), recording each group's entry;
//      - each warp finds its segment's entry from its group's (at most
//        three exits), then the segment's orbit at once: lane i reaches
//        the i-th orbit position by the binary digits of i over the
//        jumps, and the orbit's matched positions are the tokens;
//      - in the next tile's pass, a warp scan of the 32 segments' token
//        counts gives each token its slot: the first S_cap are written,
//        and all are counted into n_seqs;
//   2. per filled slot, in parallel: the literal run from the previous
//      token's match end, the catch-up rounds (two direct u32 reads a
//      round), and whether the slot starts a record (a literal run, a
//      new offset);
//   3. one reverse block-wide scan over the filled slots computes,
//      together, each record's merged match length (a segmented sum of
//      the match lengths up to the next record start) and its record
//      index (the count of kept slots after it); kept slots write their
//      record;
//   4. the tail record at n_m, per-record sizes and the output starts s0
//      by a forward exclusive scan over the live records; the dead slots
//      are filled.
//
// What bounds it on the H100: the bytes are matched read once, off,
// mlen and two u32 words a catch-up round at each token, and the five
// slot rows written once (0.0739 ms for the encode cell, PERF.md section
// 6).  The parse's serial part is one shared-memory hop a 128-position
// group the orbit enters (at most D / 128 = 576 a block at D = 73,728),
// not a step a token; the rest is warp-wide work, a few dozen shuffles
// a position, which with two CTAs an SM is what the time is spent on.
// The CTA needs about 19 KB of shared memory, nothing in proportion to
// D, so every block of a 256-block batch is resident at once.  Rows of
// up to 172,032 positions (a 96 KB block behind a 64 KB window; S_cap
// 43,264, SR 49,152) keep every position, slot, group count and output
// start far below BIGKEY and int range.  The first
// form of this kernel built a next-match table and the chain in
// device memory and walked it on one thread, 2 bytes of shared memory a
// position.
#include <cub/block/block_scan.cuh>

#include "common.cuh"

namespace lz4t {
namespace {

constexpr int THREADS = 512;
constexpr int ITEMS = 2;
constexpr int TILE = THREADS * ITEMS;   // SR is a multiple of this
constexpr int PTILE = 2 * THREADS;      // parse tile; D is a multiple
constexpr int SEGS = PTILE / 32;        // 32-position segments a tile
constexpr int GROUP = 128;              // positions a hop of the parse
constexpr int GROUPS = PTILE / GROUP;
constexpr unsigned FULL = 0xffffffffu;
constexpr int BIGKEY = 1 << 23;         // s0 of a dead record
constexpr int MINMATCH = 4;
constexpr int ML_MASK = 15;
constexpr int RUN_MASK = 15;

// equal high-order bytes of two u32 words (0..4)
__device__ __forceinline__ int xor_nb_rev(int wa, int wb) {
  const unsigned d = (unsigned)wa ^ (unsigned)wb;
  return (d & 0xFF000000u) ? 0 : (d & 0xFF0000u) ? 1 : (d & 0xFF00u) ? 2
                                                      : d ? 3 : 4;
}

// Reverse scan element of phase 3: f = a record starts right after this
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

__global__ void __launch_bounds__(THREADS, 2)
seq_kernel(const int* __restrict__ u32_all,
           const int* __restrict__ matched_all,
           const int* __restrict__ off_all, const int* __restrict__ mlen_all,
           const int* __restrict__ end_abs_all,
           const int* __restrict__ pre_len_all, int* __restrict__ s0k_all,
           int* __restrict__ litsrc_all, int* __restrict__ ll_all,
           int* __restrict__ offk_all, int* __restrict__ mlk_all,
           int* __restrict__ stats_all, int* __restrict__ slots_all, int D,
           int S_cap, int SR, int P, int cu_rounds) {
  using ScanI = cub::BlockScan<int, THREADS>;
  using ScanS = cub::BlockScan<Seg, THREADS>;
  __shared__ union {
    typename ScanI::TempStorage i;
    typename ScanS::TempStorage s;
  } tmp;
  // segment exit of each position, by tile parity (a warp may still read
  // a tile's exits while a faster one writes the next tile's)
  __shared__ int exit_s[2][PTILE];
  __shared__ int gexit_s[PTILE];         // group exit of each position
  // the orbit's entry into each group, or -1; by tile parity, so a tile
  // clears its entries while slower warps still mark the tile before
  __shared__ int gentry_s[2][GROUPS];
  __shared__ int count_s[SEGS];          // tokens in each segment
  __shared__ int s_carry, s_nm, s_tail;

  const int b = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const size_t rowD = (size_t)b * D;
  const size_t rowS = (size_t)b * SR;
  const int* u32 = u32_all + rowD;
  const int* matched = matched_all + rowD;
  const int* off = off_all + rowD;
  const int* mlen = mlen_all + rowD;
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
    s_carry = 0;
    s_nm = 0;
    s_tail = 0;
  }

  // ---- 1. the parse: token slots by segment exits ---------------------
  // Tile t's token slots are written in the next pass of the loop, in
  // the same stretch as tile t + 1's group exits; so the loop runs one
  // pass past the last tile.  matched and mlen are loaded a tile ahead.
  int n_seqs = 0;                        // tokens of the tiles before
  int pm[2], pl[2];                      // the tile's matched and mlen
  unsigned pbits[2];                     // the tokens of the tile before
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int q = k * THREADS + warp * 32 + lane;
    pm[k] = __ldg(matched + q);
    pl[k] = __ldg(mlen + q);
  }
  for (int t0 = 0;; t0 += PTILE) {
    const bool live = t0 < D;            // uniform
    int* exits = exit_s[(t0 / PTILE) & 1];
    int* gentry = gentry_s[(t0 / PTILE) & 1];
    int jump[2][5];                      // g^(2^r), stopped past the segment
    unsigned mbits[2];
    if (live) {
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int s0 = t0 + k * THREADS + warp * 32;   // the warp's segment
        const int q = s0 + lane;
        const bool m = pm[k] == 1;
        const int step = m ? max(clampi(pl[k], 0, D), 1) : 1;
        int h = min(q + step, D);
        mbits[k] = __ballot_sync(FULL, m);
#pragma unroll
        for (int r = 0; r < 5; ++r) {    // g >= q + 1: 32 steps at most
          jump[k][r] = h;
          const bool in = h < s0 + 32;
          const int nx = __shfl_sync(FULL, h, in ? h - s0 : lane);
          h = in ? nx : h;
        }
        exits[q - t0] = h;               // >= s0 + 32: g <= D
        if (q + PTILE < D) {
          pm[k] = __ldg(matched + q + PTILE);
          pl[k] = __ldg(mlen + q + PTILE);
        }
      }
      if (threadIdx.x < GROUPS) gentry[threadIdx.x] = -1;
    }
    __syncthreads();

    // the tile before: each token's slot, by a warp scan of the counts
    if (t0 > 0) {
      int cnt = count_s[lane];           // SEGS == 32
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int v = __shfl_up_sync(FULL, cnt, d);
        if (lane >= d) cnt += v;
      }
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int seg = k * (THREADS / 32) + warp;
        const int slot = n_seqs + __shfl_sync(FULL, cnt, seg) - count_s[seg]
                         + __popc(pbits[k] & ((1u << lane) - 1));
        if ((pbits[k] >> lane) & 1u && slot < S_cap)
          tok[slot] = t0 - PTILE + seg * 32 + lane;
      }
      n_seqs += __shfl_sync(FULL, cnt, 31);
    }
    if (!live) break;

    // each position's group exit: the first orbit position at or past the
    // end of its 128-position group, at most 3 segment exits on
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int q = k * THREADS + warp * 32 + lane;   // in the tile
      const int gend = t0 + (q / GROUP + 1) * GROUP;
      int e = exits[q];
      while (e < gend) e = exits[e - t0];
      gexit_s[q] = e;
    }
    __syncthreads();

    // the orbit's entries into this tile's groups
    if (threadIdx.x == 0) {
      int pos = s_carry;
      while (pos < t0 + PTILE) {
        gentry[(pos - t0) / GROUP] = pos;
        pos = gexit_s[pos - t0];
      }
      s_carry = pos;
    }
    __syncthreads();

    // each segment's orbit from its entry: lane i finds the i-th orbit
    // position by the binary digits of i over the jumps
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int s0 = t0 + k * THREADS + warp * 32;
      // the segment's entry, from its group's (uniform across the warp)
      int e = gentry[(s0 - t0) / GROUP];
      if (e >= 0) {
        while (e < s0) e = exits[e - t0];
        if (e >= s0 + 32) e = -1;
      }
      unsigned on = 0;
      if (e >= 0) {
        int x = e;
#pragma unroll
        for (int r = 0; r < 5; ++r) {
          const bool in = x < s0 + 32;
          const int y = __shfl_sync(FULL, jump[k][r], in ? x - s0 : lane);
          if (in && (lane >> r) & 1) x = y;
        }
        on = __reduce_or_sync(FULL, x < s0 + 32 ? 1u << (x - s0) : 0u);
      }
      pbits[k] = on & mbits[k];
      if (lane == 0) count_s[(s0 - t0) >> 5] = __popc(pbits[k]);
    }
  }
  __syncthreads();   // every token slot written
  const int nv = n_seqs < S_cap ? n_seqs : S_cap;   // filled token slots

  // ---- 2. literal runs, catch-up, record starts -----------------------
  int keeps = 0;
  for (int k = threadIdx.x; k < nv; k += THREADS) {
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
    const int l2 = lit_len - cb;
    const int prev_off = k > 0 ? off[qp] : 0;
    const int start = k == 0 || l2 != 0 || off_s != prev_off;
    keeps += start;
    ll2[k] = l2;
    ml2[k] = ml_s + cb;
    st[k] = start;
  }
  atomicAdd(&s_nm, keeps);
  __syncthreads();
  const int n_m = s_nm;

  // ---- 3. merge and compact the records (reverse scan) ----------------
  // over the filled slots only: a record ends at slot nv - 1 at the latest
  int tail = 0;
  const int nvt = (nv + TILE - 1) / TILE * TILE;
  TileCarry<SegOp, Seg> seg_carry(Seg{0, 0, 0});
  for (int t0 = 0; t0 < nvt; t0 += TILE) {
    Seg e[ITEMS];
#pragma unroll
    for (int kk = 0; kk < ITEMS; ++kk) {
      const int k = nvt - 1 - (t0 + threadIdx.x * ITEMS + kk);
      e[kk] = k < nv ? Seg{k + 1 >= nv || st[k + 1], ml2[k], st[k]}
                     : Seg{1, 0, 0};
    }
    ScanS(tmp.s).InclusiveScan(e, e, SegOp(), seg_carry);
#pragma unroll
    for (int kk = 0; kk < ITEMS; ++kk) {
      const int k = nvt - 1 - (t0 + threadIdx.x * ITEMS + kk);
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

  // ---- 4. tail record, sizes, output starts ---------------------------
  // the scan covers the live records (slots up to n_m), then the dead
  // slots are filled
  int first_lit = 0;
  const int nrt = min(n_m + TILE, SR) / TILE * TILE;
  TileCarry<SumOp> s0_carry(0);
  for (int t0 = 0; t0 < nrt; t0 += TILE) {
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
  for (int r = nrt + threadIdx.x; r < SR; r += THREADS) {
    s0k_all[rowS + r] = BIGKEY;
    litsrc[r] = ll[r] = offk[r] = mlk[r] = 0;
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
    void* ll, void* offk, void* mlk, void* stats, void* slot_scratch, int B,
    int D, int S_cap, int SR, int P, int cu_rounds, void* stream) {
  if (B <= 0) return 0;
  if (D % lz4t::PTILE || SR % lz4t::TILE || S_cap > SR)
    return (int)cudaErrorInvalidValue;
  lz4t::seq_kernel<<<B, lz4t::THREADS, 0, (cudaStream_t)stream>>>(
      (const int*)u32, (const int*)matched, (const int*)off,
      (const int*)mlen, (const int*)end_abs, (const int*)pre_len,
      (int*)s0k, (int*)litsrc, (int*)ll, (int*)offk, (int*)mlk,
      (int*)stats, (int*)slot_scratch, D, S_cap, SR, P, cu_rounds);
  return (int)cudaGetLastError();
}
