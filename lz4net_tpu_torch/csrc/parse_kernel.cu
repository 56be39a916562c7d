// parse_tokens: compressed LZ4 bytes -> token marks and lengths.
//
// Replaces the TPU kernel lz4net_tpu/ops/parse_kernel.py: parse_tokens
// (_parse_kernel).  Same function, none of the TPU's workarounds: the
// extension lookups are exact reads instead of diagonal row windows, so a
// window miss cannot happen and `miss` is always 0.
//
// Per position q the speculative token fields of parse_kernel.py:86-119:
// lit_len, mlen and the chain pointer g = clip(mpos + 2 + mext, q + 3,
// C - 1); mark is the orbit of position 0 under g, below comp_len.  The
// orbit is a serial chain, one step per token (11,221 on the slowest
// block of the decode cell); the first form of this kernel walked it on
// one thread through device memory, one dependent load a token.  This
// form restores the TPU kernel's segment exits (P2-P4) for a warp, so the
// serial part is one step per 32 positions, not one per token:
//
//   0. One CTA of 512 threads a block.  The block's 0xFF bit mask (one
//      ballot a warp per 32 positions) goes to shared memory, C / 8
//      bytes; with it ext[p] (the 255-extension value starting at p) is
//      read anywhere in the row: comp[p] where it is not 0xFF, otherwise
//      the run to the next clear bit (at most 17 words: a run of 515
//      saturates at M17) and the byte that ends it.  So g is exact
//      anywhere in the row, and neither ext nor g goes to device memory.
//   Then tiles of 1024 positions in order, with the orbit's next position
//   carried from tile to tile:
//   1. each thread computes two positions' fields (ll and ml are stored
//      here, coalesced) and keeps g in a register;
//   2. warp exits: for each position of a 32-position segment, the first
//      chain position at or past the segment's end, by pointer doubling
//      with __shfl_sync (g >= q + 3, so at most 11 steps: 4 rounds).  In
//      the last segment every chain ends at g's fixed point C - 1; its
//      exit is C, which ends the walk;
//   3. one thread hops from the carried position over the exits, which
//      are in shared memory: one dependent read per segment the orbit
//      enters (at most 32 a tile), recording each segment's entry, and
//      carries the first position past the tile (or past comp_len) on.
//      A skipped segment or tile (a long literal run, a junk jump) keeps
//      entry -1 and is never marked;
//   4. each warp marks its segments from their entries with shuffles of
//      the registers' g (at most 11 steps), all warps at once, stopping
//      below comp_len and at the fixed point, and stores the marks.
// The serial depth is C / 32 shared-memory hops (2,176 for C = 69,632)
// and 11 shuffle steps a segment, instead of a device-memory load a token.
//
// What bounds it on the H100: the bytes, comp read once (below comp_len)
// and mark, ll and ml written once, [B, C] int32 each (0.0755 ms for the
// decode cell, PERF.md section 6).  The kernel reads comp twice (the mask
// pass and the tiles), and the hops stall the CTA's other warps; the
// block's CTA needs C / 8 + 4.2 KB of shared memory, so every block of a
// 256-block batch is resident at once and one CTA's hops overlap
// another's tiles.
#include "common.cuh"

namespace lz4t {
namespace {

constexpr int THREADS = 512;
constexpr int ITEMS = 2;
constexpr int TILE = THREADS * ITEMS;   // C is a multiple of 4096
constexpr int SEGS = TILE / 32;
constexpr unsigned FULL = 0xffffffffu;
constexpr int SAT_RUN = 515;            // 255 * 515 > M17: ext saturates

// ext[p] of parse_kernel.py: clip(255 * run255[p] + comp[p + run255[p]],
// 0, M17), run255 from the row's 0xFF bit mask
__device__ __forceinline__ int ext_at(const int* __restrict__ comp,
                                      const uint32_t* ffm, int p, int C) {
  const int c = __ldg(comp + p);
  if (c != 255) return clampi(c, 0, M17);
  int w = p >> 5;
  uint32_t open = ~ffm[w] & (FULL << (p & 31));
  while (open == 0) {
    // no clear bit to the end (run C) or a run of 515 or more: M17
    if (++w == (C >> 5) || (w << 5) - p >= SAT_RUN) return M17;
    open = ~ffm[w];
  }
  const int nn = (w << 5) + __ffs(open) - 1;
  return clampi((int)(255u * (unsigned)(nn - p) + (unsigned)__ldg(comp + nn)),
                0, M17);
}

__global__ void __launch_bounds__(THREADS, 2)
parse_tokens_kernel(const int* __restrict__ comp_all,
                    const int* __restrict__ comp_len_all,
                    int* __restrict__ mark_all, int* __restrict__ ll_all,
                    int* __restrict__ ml_all, uint8_t* __restrict__ miss,
                    int C) {
  extern __shared__ uint32_t ffm[];    // [C / 32] bit q: comp[q] == 255
  __shared__ int exit_s[TILE];         // segment exit of each tile position
  // the orbit's entry into each segment, or -1; by tile parity, so a tile
  // clears its entries while slower warps still mark the tile before
  __shared__ int entry_s[2][SEGS];
  __shared__ int carry_s;              // next orbit position

  const int b = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const size_t row = (size_t)b * C;
  const int* comp = comp_all + row;
  const int lim = comp_len_all[b] < C ? comp_len_all[b] : C;

  // ---- 0. the 0xFF bit mask ----------------------------------------------
  for (int q = threadIdx.x; q < C; q += THREADS) {
    const unsigned m = __ballot_sync(FULL, __ldg(comp + q) == 255);
    if (lane == 0) ffm[q >> 5] = m;
  }
  if (threadIdx.x == 0) {
    carry_s = 0;
    miss[b] = 0;
  }
  __syncthreads();

  for (int t0 = 0; t0 < C; t0 += TILE) {
    int* entry = entry_s[(t0 / TILE) & 1];
    // ---- 1-2. fields, g and the warp exits ---------------------------------
    int g[ITEMS];
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) {
      const int s0 = t0 + k * THREADS + warp * 32;   // the warp's segment
      const int q = s0 + lane;
      const int c = __ldg(comp + q);
      const int lit_nib = c >> 4, ml_nib = c & 15;
      int lit_len = lit_nib, hdr = 1;
      if (lit_nib == 15) {                 // literal ext starts at q + 1
        const int el = q + 1 < C ? ext_at(comp, ffm, q + 1, C) : 0;
        lit_len = 15 + el;
        hdr = 2 + el / 255;
      }
      lit_len = clampi(lit_len, 0, M17);
      const int mpos = clampi(q + hdr + lit_len, 0, C - 1);
      int mlen = 4 + ml_nib, nxt = mpos + 2;
      if (ml_nib == 15) {
        const int em = ext_at(comp, ffm, mpos + 2 < C ? mpos + 2 : C - 1, C);
        mlen = 19 + em;
        nxt += 1 + em / 255;
      }
      nxt = nxt < q + 3 ? q + 3 : nxt;     // junk-safe: forward,
      g[k] = nxt > C - 1 ? C - 1 : nxt;    // and in range
      ll_all[row + q] = lit_len;
      ml_all[row + q] = clampi(mlen, 0, M17);

      int h = g[k];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const bool in = h < s0 + 32;
        const int nx = __shfl_sync(FULL, h, in ? h - s0 : lane);
        h = in ? nx : h;
      }
      exit_s[q - t0] = h >= s0 + 32 ? h : C;   // C: the fixed point
    }
    if (threadIdx.x < SEGS) entry[threadIdx.x] = -1;
    __syncthreads();

    // ---- 3. the orbit's entries into this tile's segments ------------------
    if (threadIdx.x == 0) {
      const int end = t0 + TILE < lim ? t0 + TILE : lim;
      int pos = carry_s;
      while (pos < end) {
        entry[(pos - t0) >> 5] = pos;
        pos = exit_s[pos - t0];
      }
      carry_s = pos;
    }
    __syncthreads();

    // ---- 4. marks inside each segment --------------------------------------
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) {
      const int s0 = t0 + k * THREADS + warp * 32;
      int p = entry[(s0 - t0) >> 5];       // uniform across the warp
      unsigned bits = 0;
      if (p >= 0) {
        for (;;) {
          bits |= 1u << (p - s0);
          const int nx = __shfl_sync(FULL, g[k], p - s0);
          if (nx == p || nx >= s0 + 32 || nx >= lim) break;
          p = nx;
        }
      }
      mark_all[row + s0 + lane] = (bits >> lane) & 1;
    }
  }
}

}  // namespace
}  // namespace lz4t

extern "C" int lz4t_parse_tokens(const void* comp, const void* comp_len,
                                 void* mark, void* lit_len, void* mlen,
                                 void* miss, int B, int C, void* stream) {
  if (B <= 0) return 0;
  const int smem = C / 8;
  cudaError_t err = cudaFuncSetAttribute(
      lz4t::parse_tokens_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  lz4t::parse_tokens_kernel<<<B, lz4t::THREADS, smem,
                              (cudaStream_t)stream>>>(
      (const int*)comp, (const int*)comp_len, (int*)mark, (int*)lit_len,
      (int*)mlen, (uint8_t*)miss, C);
  return (int)cudaGetLastError();
}
