// emit_bytes: sequence records -> compressed bytes.
//
// Replaces the TPU kernel lz4net_tpu/ops/emit_kernel.py: emit_bytes
// (_emit_kernel).  The TPU version finds each output byte's record with a
// W-row window of records fetched by one-hot bf16 matmuls per 8-bit plane
// and a lane-shuffle binary search, and counts the bytes whose record
// fell outside the window.  Here one thread per output byte o
// binary-searches the record starts s0 (monotone over the live records,
// BIGKEY beyond) for the last record with s0 <= o and derives the byte
// from that record's fields: the token, a 255-run or remainder of a
// length extension, a byte of the 16-bit offset, or, for a literal, its
// input index (cidx; direct is 0 there).  The mirror of
// records_kernel.cu; the search is exact, so no byte goes ungoverned.
//
// What bounds it on the H100: bytes.  Each output byte is two int32
// writes; the searches read the record table (a few hundred KB per
// block at most) through L1/L2, about 15 probes per byte.
#include "common.cuh"

namespace lz4t {
namespace {

constexpr int THREADS = 256;
constexpr int BIGKEY = 1 << 23;
constexpr int MINMATCH = 4;
constexpr int ML_MASK = 15;
constexpr int RUN_MASK = 15;

__global__ void __launch_bounds__(THREADS)
emit_kernel(const int* __restrict__ s0_all, const int* __restrict__ ls_all,
            const int* __restrict__ ll_all, const int* __restrict__ off_all,
            const int* __restrict__ ml_all,
            const int* __restrict__ out_len_all, int* __restrict__ direct,
            int* __restrict__ cidx, int S, int O) {
  const int b = blockIdx.y;
  const int o = blockIdx.x * THREADS + threadIdx.x;
  if (o >= O) return;
  const size_t row = (size_t)b * S;
  const int* s0 = s0_all + row;
  // upper bound: the count of records with s0 <= o (torch.searchsorted's
  // loop, so both agree on any input)
  int lo = 0, hi = S;
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);
    if (s0[mid] <= o) lo = mid + 1; else hi = mid;
  }
  const int t = lo - 1;
  const int tc = t > 0 ? t : 0;
  const int s0q = s0[tc];
  const bool found = t >= 0 && s0q >= 0 && s0q <= o && s0q < BIGKEY - 1;
  const int lsq = ls_all[row + tc];
  const int llq = ll_all[row + tc];
  const int offq = off_all[row + tc];
  const int mlq = ml_all[row + tc];

  const int e_lit = llq - RUN_MASK > 0 ? llq - RUN_MASK : 0;
  const int lit_ext = llq >= RUN_MASK ? 1 + e_lit / 255 : 0;
  const bool has_m = mlq > 0;
  const int mm = mlq - MINMATCH > 0 ? mlq - MINMATCH : 0;
  const int e_m = mm - ML_MASK > 0 ? mm - ML_MASK : 0;
  const int m_ext = has_m && mm >= ML_MASK ? 1 + e_m / 255 : 0;
  const int size = 1 + lit_ext + llq + (has_m ? 2 + m_ext : 0);

  const int r = o - s0q;                 // byte within the record
  const bool live = found && o < out_len_all[b] && r < size;
  const int lit_o = 1 + lit_ext;         // record-relative offsets
  const int off_o = lit_o + llq;
  const int mext_o = off_o + 2;
  int byte;
  if (r == 0) {
    byte = ((llq < RUN_MASK ? llq : RUN_MASK) << 4) |
           (has_m ? (mm < ML_MASK ? mm : ML_MASK) : 0);
  } else if (r < lit_o) {                // literal-length extension
    byte = r - 1 < lit_ext - 1 ? 255 : e_lit - 255 * (lit_ext - 1);
  } else if (r < off_o) {                // a literal: its index below
    byte = 0;
  } else if (r == off_o) {
    byte = offq & 0xFF;
  } else if (r == off_o + 1) {
    byte = offq >> 8;
  } else {                               // match-length extension
    byte = r - mext_o < m_ext - 1
               ? 255 : e_m - 255 * (m_ext - 1 > 0 ? m_ext - 1 : 0);
  }
  const size_t at = (size_t)b * O + o;
  direct[at] = live ? byte & 0xFF : 0;
  cidx[at] = live && r >= lit_o && r < off_o ? lsq + (r - lit_o) : -1;
}

}  // namespace
}  // namespace lz4t

extern "C" int lz4t_emit_bytes(const void* s0, const void* lit_start,
                               const void* lit_len, const void* off,
                               const void* mlen, const void* out_len,
                               void* direct, void* cidx, int B, int S,
                               int O, void* stream) {
  if (B <= 0 || O <= 0) return 0;
  dim3 grid((O + lz4t::THREADS - 1) / lz4t::THREADS, B);
  lz4t::emit_kernel<<<grid, lz4t::THREADS, 0, (cudaStream_t)stream>>>(
      (const int*)s0, (const int*)lit_start, (const int*)lit_len,
      (const int*)off, (const int*)mlen, (const int*)out_len, (int*)direct,
      (int*)cidx, S, O);
  return (int)cudaGetLastError();
}
