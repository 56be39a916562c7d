// parse_tokens: compressed LZ4 bytes -> token marks and lengths.
//
// Replaces the TPU kernel lz4net_tpu/ops/parse_kernel.py: parse_tokens
// (_parse_kernel).  Same function, none of the TPU's workarounds: the
// extension lookups are exact global-memory reads instead of diagonal
// row windows, so a window miss cannot happen and `miss` is always 0.
//
// One CTA per block, three phases:
//   1. run255[q] (length of the 0xFF run starting at q) by a block-wide
//      suffix-min scan of the next non-255 index, then the 255-extension
//      value ext[q] = clip(255*run255 + comp[q+run255], 0, M17).
//   2. per position q, the speculative token fields: lit_len, mlen and the
//      chain pointer g = clip(mpos + 2 + mext, q + 3, C - 1), exactly the
//      formulas of parse_kernel.py:86-119.
//   3. one thread walks the chain from position 0 and marks every
//      position it visits below comp_len.
//
// What bounds it on the H100: phases 1-2 move ~7 int32 words per position
// (comp read twice plus scattered ext reads, ll/ml/mark/ext/g writes), a
// few microseconds at 3.35 TB/s for a 256 x 64 KB batch.  Phase 3 is a
// serial chain of dependent L2 loads, one per token (~thousands per 64 KB
// block), and dominates.  This first version accepts that: all blocks walk
// concurrently (one CTA each), and a later version can restore the
// segment-exit doubling of parse_kernel.py:121-145 to cut the chain.
#include <cub/block/block_scan.cuh>

#include "common.cuh"

namespace lz4t {
namespace {

constexpr int THREADS = 1024;
constexpr int ITEMS = 4;
constexpr int TILE = THREADS * ITEMS;   // C is a multiple of this

__global__ void __launch_bounds__(THREADS)
parse_tokens_kernel(const int* __restrict__ comp_all,
                    const int* __restrict__ comp_len_all,
                    int* __restrict__ mark_all, int* __restrict__ ll_all,
                    int* __restrict__ ml_all, uint8_t* __restrict__ miss,
                    int* __restrict__ ext_all, int* __restrict__ g_all,
                    int C) {
  using Scan = cub::BlockScan<int, THREADS>;
  __shared__ typename Scan::TempStorage scan_tmp;

  const int b = blockIdx.x;
  const size_t row = (size_t)b * C;
  const int* comp = comp_all + row;
  int* ext = ext_all + row;
  int* g = g_all + row;
  int* mark = mark_all + row;

  // ---- 1. suffix-min scan, walked as a prefix scan over r = C-1-q ------
  TileCarry<MinOp> carry(BIG);
  for (int t0 = 0; t0 < C; t0 += TILE) {
    int v[ITEMS];
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) {
      int q = C - 1 - (t0 + threadIdx.x * ITEMS + k);
      v[k] = comp[q] != 255 ? q : BIG;
    }
    Scan(scan_tmp).InclusiveScan(v, v, MinOp(), carry);
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) {
      int q = C - 1 - (t0 + threadIdx.x * ITEMS + k);
      // v[k] is the first non-255 index >= q (BIG if none)
      int run = v[k] == BIG ? C : clampi(v[k] - q, 0, C);
      int term = comp[clampi(q + run, 0, C - 1)];
      ext[q] = clampi(255 * run + term, 0, M17);
    }
    __syncthreads();   // scan_tmp is reused by the next tile
  }
  __syncthreads();     // ext[] complete before any thread reads it

  // ---- 2. per-position token fields -----------------------------------
  for (int q = threadIdx.x; q < C; q += THREADS) {
    int c = comp[q];
    int lit_nib = c >> 4, ml_nib = c & 15;
    int ext_lit = q + 1 < C ? ext[q + 1] : 0;   // literal ext starts at q+1
    int lit_len = clampi(lit_nib == 15 ? 15 + ext_lit : lit_nib, 0, M17);
    // ext_lit >= 0, so C's truncating division is the floor division
    int hdr = 1 + (lit_nib == 15 ? 1 + ext_lit / 255 : 0);
    int mpos = clampi(q + hdr + lit_len, 0, C - 1);
    int mp2 = clampi(mpos + 2, 0, C - 1);
    int ext_m = clampi(ext[mp2], 0, M17);
    int mlen = clampi(4 + (ml_nib == 15 ? 15 + ext_m : ml_nib), 0, M17);
    int mext = ml_nib == 15 ? 1 + ext_m / 255 : 0;
    int nxt = mpos + 2 + mext;
    nxt = nxt < q + 3 ? q + 3 : nxt;            // junk-safe: forward,
    g[q] = nxt > C - 1 ? C - 1 : nxt;           // and in range
    ll_all[row + q] = lit_len;
    ml_all[row + q] = mlen;
    mark[q] = 0;
  }
  __syncthreads();     // g[] and the zeroed marks visible to the walker

  // ---- 3. mark the orbit of position 0 below comp_len -----------------
  if (threadIdx.x == 0) {
    int lim = comp_len_all[b] < C ? comp_len_all[b] : C;
    for (int pos = 0; pos < lim; pos = g[pos]) {
      mark[pos] = 1;
      if (pos == C - 1) break;   // g's fixed point
    }
    miss[b] = 0;
  }
}

}  // namespace
}  // namespace lz4t

extern "C" int lz4t_parse_tokens(const void* comp, const void* comp_len,
                                 void* mark, void* lit_len, void* mlen,
                                 void* miss, void* ext_scratch,
                                 void* g_scratch, int B, int C,
                                 void* stream) {
  if (B <= 0) return 0;
  lz4t::parse_tokens_kernel<<<B, lz4t::THREADS, 0, (cudaStream_t)stream>>>(
      (const int*)comp, (const int*)comp_len, (int*)mark, (int*)lit_len,
      (int*)mlen, (uint8_t*)miss, (int*)ext_scratch, (int*)g_scratch, C);
  return (int)cudaGetLastError();
}
