// emit_bytes: sequence records -> compressed bytes.
//
// Replaces the TPU kernel lz4net_tpu/ops/emit_kernel.py: emit_bytes
// (_emit_kernel).  The TPU version finds each output byte's record with a
// W-row window of records fetched by one-hot bf16 matmuls per 8-bit plane
// and a lane-shuffle binary search, and counts the bytes whose record
// fell outside the window.  Here a tile expansion finds every byte's
// record with no search per byte.  One CTA of 1024 threads takes a tile
// of T = 4096 output bytes of one block (a (O/T, B) grid):
//
//   1. two warps find the records that govern the tile's first and last
//      byte, [t_lo, t_hi] (the count of records with s0 <= o, by a
//      32-way search: 32 probes a step, one __ballot_sync);
//   2. each record in (t_lo, t_hi] whose start lies in the tile marks
//      owner[s0 - tile start] with its index (atomicMax: of equal starts
//      the last wins, as the last record with s0 <= o governs o);
//   3. a block-wide inclusive max-scan over owner, seeded with t_lo,
//      gives every byte its record in O(1) (a record longer than the
//      tile has no start in it and reaches it through the seed); steps
//      2 and 3 are common.cuh's expand_tile, which records_kernel.cu
//      shares;
//   4. each thread takes 4 consecutive bytes, loads a record's fields and
//      derives its sizes once per record it meets, and derives each byte
//      from them: the token, a 255-run or remainder of a length
//      extension, a byte of the 16-bit offset, or, for a literal, its
//      input index (cidx; direct is 0 there).  int4 stores.
// A tile that starts at or past out_len holds no live byte: it writes
// direct 0, cidx -1 and nothing else.
//
// Domain: s0 never decreases over a row.  Both producers give that:
// csrc/seq_kernel.cu phase 4 and seq_kernel.parse_records (the chain
// path) write s0 as the exclusive sum of the live records' sizes (each
// at least 1, the live records a prefix of the row) and BIGKEY for every
// dead record after them.  On such rows the byte's record is the one
// torch.searchsorted gives the plain version, so both agree.
//
// What bounds it on the H100: bytes.  Each output byte is two int32
// writes; the records are read once a tile (a few KB, from L2), and
// the searches cost two warps three rounds of 32 probes a tile at the
// encode path's S = 24,576.
#include <cub/block/block_scan.cuh>

#include "common.cuh"

namespace lz4t {
namespace {

constexpr int THREADS = 1024;
constexpr int ITEMS = 4;
constexpr int TILE = THREADS * ITEMS;   // output bytes of a tile
constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr int BIGKEY = 1 << 23;
constexpr int MINMATCH = 4;
constexpr int ML_MASK = 15;
constexpr int RUN_MASK = 15;

// The count of a[0..n) <= x for a non-decreasing a, by one warp: each
// step probes 32 evenly spaced entries of [lo, hi) and keeps the part
// between the last probe <= x and the first > x.
__device__ int warp_count_le(const int* __restrict__ a, int n, int x) {
  const int lane = threadIdx.x & 31;
  int lo = 0, hi = n;               // the count lies in [lo, hi]
  while (lo < hi) {
    const int step = (hi - lo + 31) >> 5;
    const int p = lo + (lane + 1) * step - 1;
    const unsigned le = __ballot_sync(FULL, p < hi && __ldg(a + p) <= x);
    const int n_le = __popc(le);
    const int nlo = lo + n_le * step;
    const int nhi = lo + (n_le + 1) * step - 1;
    lo = nlo < hi ? nlo : hi;
    hi = nhi < hi ? nhi : hi;
  }
  return lo;
}

__global__ void __launch_bounds__(THREADS, 2)
emit_kernel(const int* __restrict__ s0_all, const int* __restrict__ ls_all,
            const int* __restrict__ ll_all, const int* __restrict__ off_all,
            const int* __restrict__ ml_all,
            const int* __restrict__ out_len_all, int* __restrict__ direct,
            int* __restrict__ cidx, int S, int O) {
  using Scan = cub::BlockScan<int, THREADS, cub::BLOCK_SCAN_WARP_SCANS>;
  __shared__ typename Scan::TempStorage scan_tmp;
  __shared__ __align__(16) int owner[TILE];
  __shared__ int s_bound[2];

  const int b = blockIdx.y;
  const int o0 = blockIdx.x * TILE;
  const size_t row = (size_t)b * S;
  const int* s0 = s0_all + row;
  const int out_len = out_len_all[b];
  const int warp = threadIdx.x >> 5;
  const int ob = o0 + threadIdx.x * ITEMS;
  const size_t at = (size_t)b * O + ob;
  if (o0 >= out_len) {               // no byte of the tile is live
    if ((O & 3) == 0) {
      if (ob < O) {
        *reinterpret_cast<int4*>(direct + at) = make_int4(0, 0, 0, 0);
        *reinterpret_cast<int4*>(cidx + at) = make_int4(-1, -1, -1, -1);
      }
    } else {
      for (int j = 0; j < ITEMS && ob + j < O; ++j) {
        direct[at + j] = 0;
        cidx[at + j] = -1;
      }
    }
    return;
  }

  // ---- 1. tile bounds: the records of the tile's first and last byte ----
  if (warp < 2) {
    const int cnt = warp_count_le(s0, S, o0 + warp * (TILE - 1));
    if ((threadIdx.x & 31) == 0) s_bound[warp] = cnt - 1;
  }
  for (int i = threadIdx.x; i < TILE; i += THREADS) owner[i] = -1;
  __syncthreads();

  // ---- 2. owner marks and max-scan: every byte's record ----------------
  int gov[ITEMS];
  expand_tile<THREADS, ITEMS, Scan>(s0, s_bound[0], s_bound[1], o0, owner,
                                    scan_tmp, gov);

  // ---- 3. per byte: record fields, the byte or literal index, stores ---
  int dv[ITEMS], cv[ITEMS];
  int tc = -1, s0q = 0, lsq = 0, llq = 0, offq = 0;
  int e_lit = 0, lit_ext = 0, mm = 0, e_m = 0, m_ext = 0, size = 0;
  bool has_m = false;
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    const int t = gov[j];
    const int o = ob + j;
    dv[j] = 0;
    cv[j] = -1;
    if (t < 0) continue;
    if (t != tc) {
      tc = t;
      s0q = __ldg(s0 + t);
      lsq = __ldg(ls_all + row + t);
      llq = __ldg(ll_all + row + t);
      offq = __ldg(off_all + row + t);
      const int mlq = __ldg(ml_all + row + t);
      e_lit = llq - RUN_MASK > 0 ? llq - RUN_MASK : 0;
      lit_ext = llq >= RUN_MASK ? 1 + e_lit / 255 : 0;
      has_m = mlq > 0;
      mm = mlq - MINMATCH > 0 ? mlq - MINMATCH : 0;
      e_m = mm - ML_MASK > 0 ? mm - ML_MASK : 0;
      m_ext = has_m && mm >= ML_MASK ? 1 + e_m / 255 : 0;
      size = 1 + lit_ext + llq + (has_m ? 2 + m_ext : 0);
    }
    const bool found = s0q >= 0 && s0q <= o && s0q < BIGKEY - 1;
    const int r = o - s0q;                 // byte within the record
    const bool live = found && o < out_len && r < size;
    if (!live) continue;
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
      cv[j] = lsq + (r - lit_o);
    } else if (r == off_o) {
      byte = offq & 0xFF;
    } else if (r == off_o + 1) {
      byte = offq >> 8;
    } else {                               // match-length extension
      byte = r - mext_o < m_ext - 1
                 ? 255 : e_m - 255 * (m_ext - 1 > 0 ? m_ext - 1 : 0);
    }
    dv[j] = byte & 0xFF;
  }
  if ((O & 3) == 0) {
    if (ob < O) {
      *reinterpret_cast<int4*>(direct + at) =
          make_int4(dv[0], dv[1], dv[2], dv[3]);
      *reinterpret_cast<int4*>(cidx + at) =
          make_int4(cv[0], cv[1], cv[2], cv[3]);
    }
  } else {
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {
      if (ob + j >= O) break;
      direct[at + j] = dv[j];
      cidx[at + j] = cv[j];
    }
  }
}

}  // namespace
}  // namespace lz4t

extern "C" int lz4t_emit_bytes(const void* s0, const void* lit_start,
                               const void* lit_len, const void* off,
                               const void* mlen, const void* out_len,
                               void* direct, void* cidx, int B, int S,
                               int O, void* stream) {
  if (B <= 0 || O <= 0) return 0;
  dim3 grid((O + lz4t::TILE - 1) / lz4t::TILE, B);
  lz4t::emit_kernel<<<grid, lz4t::THREADS, 0, (cudaStream_t)stream>>>(
      (const int*)s0, (const int*)lit_start, (const int*)lit_len,
      (const int*)off, (const int*)mlen, (const int*)out_len, (int*)direct,
      (int*)cidx, S, O);
  return (int)cudaGetLastError();
}
