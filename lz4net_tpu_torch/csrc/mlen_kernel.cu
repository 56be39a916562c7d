// match_lengths: (matched, off, mlen) per position from its candidate.
//
// Replaces the TPU kernel lz4net_tpu/ops/mlen_kernel.py:
// match_lengths_fused (_mlen_kernel).  The TPU version gathers u32[prev+4]
// with a staircase select loop, compacts the still-growing survivors
// with windowed binary searches over a rank transpose and 8-bit-plane
// matmuls, gathers their extension words the same way, and shifts the
// input through a staged scratch for each dominant offset.  Hopper
// gathers natively, so one CTA per block computes the same function in
// two phases over the block's bytes, staged once in shared memory:
//
//   1. forward over the block in tiles of 4096: off, matched, the far
//      round at prev+4 and the first rcap survivors' extension rounds,
//      every word assembled from the staged bytes (two aligned 32-bit
//      shared loads and a funnel shift).  A survivor's rank (nb1 == 4,
//      in position order) comes from a warp scan of each thread's count
//      and one of the warps' counts, one barrier a tile, and only while
//      the survivors before the tile are fewer than rcap.  A position
//      whose length is final here gets the format's end rules and its
//      outputs; one whose length is an exact equal run (offsets 1-4, or
//      a far match at a dominant offset, found through a 16384-bit
//      filter of the dominant offsets) records its class instead;
//   2. the classes that occur, in groups of as many as shared memory
//      holds (8 at D = 73728): for each class offset d, one warp
//      ballot per 32 positions, four bytes compared per lane, writes
//      a break bitmask (bit j: j < d or x[j] != x[j - d]), and two more
//      ballot levels mark its nonzero words, so a position finds the
//      end of its run with at most three masked find-first-set steps
//      (__ffs) and no scan.  Then the end rules and the outputs of the
//      group's positions.
//
// Shared memory: the block's bytes (D), a class byte a position (D) where
// it fits, and G break bitmasks of D / 32 + D / 1024 + D / 32768 words
// (rounded up) each.  The launcher keeps the class bytes in shared memory
// where the bytes, the classes and one bitmask fit the card's opt-in
// (rows up to 106,496 positions on the H100, the main paths' 73,728
// among them); wider rows (a 64 KB segment or a 96 KB block behind a
// 64 KB window: 139,264 and 172,032 positions) keep them in a device
// scratch row instead, written once in phase 1 and read once a group in
// phase 2, and spend the room on bitmasks.
//
// What bounds it on the H100 (NVIDIA H100 80GB HBM3, 700 W; PERF.md
// section 6, kernel table): 0.45 ms at the fast path's shape and
// 0.58-0.70 ms at the HC tiers' (24 dominant offsets, rcap 9216-18432),
// 3.3-5.2x the 0.135 ms of its device-memory traffic (x, prev and m8
// read, matched, off and mlen written: 6 int32 words a position; u32 is
// not read, its words come from x's bytes).  One CTA of 1024 threads an
// SM (147 KB of bytes and classes) runs the batch in two waves; a
// block's time is phase 1's tiles (the extension rounds of up to rcap
// survivors, 10 dependent word compares each) and, with 24 offsets, four
// groups of bitmasks.  Wide rows hold 2-5 bitmasks a group (D = 172,032:
// 2), so 24 offsets take up to 14 groups: 0.89 ms (8 offsets) and 1.42
// ms (24, rcap 34,816) on 256 rows of 139,264, 0.54 and 1.02 ms on 64
// rows of 172,032, 3.5-13x their bytes.  A later design could drop the
// class bytes (recompute them from prev in phase 2) to fit two CTAs an
// SM, and build a group's bitmasks with fewer instructions (a lane a
// 32-bit word instead of three shuffles a word).
#include "common.cuh"

namespace lz4t {
namespace {

constexpr int THREADS = 1024;
constexpr int WARPS = THREADS / 32;
constexpr int ITEMS = 4;
constexpr int TILE = THREADS * ITEMS;   // D is a multiple of this
constexpr int MAX_TOP = 24;             // dominant offsets at most (HC: 24)
constexpr int NCLS = 4 + MAX_TOP;       // exact-run offset classes, < 32
                                        // so s_used's bits hold them
constexpr uint8_t NO_CLS = 0xFF;        // "no class"
constexpr int PAD = 16;                 // zero bytes staged past D
constexpr int DMAP = 1 << 14;           // bits of the dominant-offset
                                        // filter (offset & (DMAP - 1))
constexpr int MAX_DISTANCE = 65535;
constexpr int MINMATCH = 4;
constexpr int LASTLITERALS = 5;
constexpr int MFLIMIT = 12;
constexpr int MINLENGTH = 13;

// equal low-order bytes of two u32 words (0..4)
__device__ __forceinline__ int xor_nb(uint32_t wa, uint32_t wb) {
  const uint32_t d = wa ^ wb;
  return d ? (__ffs(d) - 1) >> 3 : 4;
}

// the little-endian word of the staged bytes at i (0 <= i <= D + 8):
// u32[i] of the zero-padded row
__device__ __forceinline__ uint32_t word_at(const uint32_t* sw, int i) {
  return __funnelshift_r(sw[i >> 2], sw[(i >> 2) + 1], (i & 3) * 8);
}

struct Masks {        // one class's break bitmask and its two levels
  const uint32_t* l0;
  const uint32_t* l1;
  const uint32_t* l2;
};

// the first j >= q whose break bit is set, or D when the run reaches the
// block's end
__device__ __forceinline__ int next_break(const Masks& m, int q, int n0,
                                          int n1, int n2, int D) {
  int w = q >> 5;
  uint32_t b = m.l0[w] & (0xFFFFFFFFu << (q & 31));
  if (b) return (w << 5) + __ffs(b) - 1;
  if (++w >= n0) return D;
  int v = w >> 5;
  uint32_t b1 = m.l1[v] & (0xFFFFFFFFu << (w & 31));
  if (!b1) {
    if (++v >= n1) return D;
    int u = v >> 5;
    uint32_t b2 = m.l2[u] & (0xFFFFFFFFu << (v & 31));
    while (!b2) {
      if (++u >= n2) return D;
      b2 = m.l2[u];
    }
    v = (u << 5) + __ffs(b2) - 1;
    b1 = m.l1[v];
  }
  w = (v << 5) + __ffs(b1) - 1;
  return (w << 5) + __ffs(m.l0[w]) - 1;
}

// the format's end rules on a length: (matched, off, mlen) as written
__device__ __forceinline__ int3 finish(bool matched, int off, int len,
                                       int q, int end_abs, bool blk_ok) {
  const int limit = end_abs - LASTLITERALS - q;
  const int cap = limit > 0 ? limit : 0;
  len = len < cap ? len : cap;
  const bool m = matched && len >= MINMATCH && q <= end_abs - MFLIMIT &&
                 blk_ok;
  return make_int3(m, m ? off : 0, m ? len : 0);
}

__global__ void __launch_bounds__(THREADS)
mlen_kernel(const int* __restrict__ x_all, const int* __restrict__ prev_all,
            const int* __restrict__ m8_all, const int* __restrict__ dks_all,
            const int* __restrict__ end_abs_all,
            const int* __restrict__ blk_len_all, int* __restrict__ matched_all,
            int* __restrict__ off_all, int* __restrict__ mlen_all,
            uint8_t* __restrict__ cls_all, int D, int K, int rcap,
            int ext_rounds, int G) {
  __shared__ int s_d[NCLS];          // offset of each class (0 = unused)
  __shared__ uint32_t s_dmap[DMAP / 32];   // may a far offset be dominant
  __shared__ int s_wcount[2][WARPS]; // survivors a warp, tiles by parity
  __shared__ int s_list[NCLS];       // the classes that occur, in order
  __shared__ int s_slot[NCLS];       // class -> mask slot in this group
  __shared__ unsigned s_used;        // classes that occur in the block
  extern __shared__ uint32_t smem[];
  const int n0 = D >> 5, n1 = D >> 10, n2 = (n1 + 31) >> 5;
  const int mask_words = n0 + n1 + n2;
  uint32_t* masks = smem;                      // G x mask_words
  uint32_t* sw = smem + G * mask_words;        // the bytes, as words

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.x;
  const size_t row = (size_t)b * D;
  // the class bytes: in shared memory after the bytes, or the block's
  // row of the device scratch
  uint8_t* cls = cls_all ? cls_all + row : (uint8_t*)(sw + (D + PAD) / 4);
  const int4* x4 = (const int4*)(x_all + row);
  const int4* prev4 = (const int4*)(prev_all + row);
  const int4* m84 = (const int4*)(m8_all + row);
  int4* matched4 = (int4*)(matched_all + row);
  int4* off4 = (int4*)(off_all + row);
  int4* mlen4 = (int4*)(mlen_all + row);

#pragma unroll 6
  for (int w = tid; w < D / 4; w += THREADS) {
    const int4 v = x4[w];
    sw[w] = (uint32_t)(v.x & 0xFF) | (uint32_t)(v.y & 0xFF) << 8 |
            (uint32_t)(v.z & 0xFF) << 16 | (uint32_t)(v.w & 0xFF) << 24;
  }
  if (tid < PAD / 4) sw[D / 4 + tid] = 0;
  for (int i = tid; i < DMAP / 32; i += THREADS) s_dmap[i] = 0;
  int dom = 0;
  if (tid < NCLS) {
    const int c = tid;
    s_d[c] = c < 4 ? c + 1 : (c - 4 < K ? dks_all[b * K + c - 4] : 0);
    if (c >= 4) dom = s_d[c];
  }
  if (tid == 0) s_used = 0;
  const int end_abs = end_abs_all[b];
  const bool blk_ok = blk_len_all[b] >= MINLENGTH;
  __syncthreads();
  if (dom > 0)
    atomicOr(&s_dmap[(dom & (DMAP - 1)) >> 5], 1u << (dom & 31));
  __syncthreads();

  // ---- 1. far round, survivor ranks, extension, classes ---------------
  unsigned used = 0;
  int carry = 0;                     // survivors before the tile
  int par = 0;
  int4 pv = prev4[tid], mv = m84[tid];
  for (int t0 = 0; t0 < D; t0 += TILE) {
    const int qb = t0 + tid * ITEMS;
    const int pk[ITEMS] = {pv.x, pv.y, pv.z, pv.w};
    const int mk[ITEMS] = {mv.x, mv.y, mv.z, mv.w};
    if (t0 + TILE < D) {             // the next tile's operands, early
      pv = prev4[(t0 + TILE) / 4 + tid];
      mv = m84[(t0 + TILE) / 4 + tid];
    }
    int nb1[ITEMS], alive[ITEMS];
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) {
      const int q = qb + k, p = pk[k], off = q - p;
      const bool far = p >= 0 && off <= MAX_DISTANCE && off > 4;
      nb1[k] = -1;                   // -1: not far
      if (far)
        nb1[k] = mk[k] != 0 ? 4
                            : xor_nb(word_at(sw, q + 4),
                                     word_at(sw, clampi(p + 4, 0, D - 1)));
      alive[k] = nb1[k] == 4;
    }
    // survivor ranks in position order, while they can be below rcap
    // (carry is the same in every thread): a warp scan of each thread's
    // count, then one of the warps' counts
    int rank[ITEMS] = {rcap, rcap, rcap, rcap};
    if (carry < rcap) {
      const int cnt = alive[0] + alive[1] + alive[2] + alive[3];
      int inc = cnt;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int v = __shfl_up_sync(0xFFFFFFFFu, inc, o);
        if (lane >= o) inc += v;
      }
      if (lane == 31) s_wcount[par][warp] = inc;
      __syncthreads();
      const int wc = s_wcount[par][lane];
      int winc = wc;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int v = __shfl_up_sync(0xFFFFFFFFu, winc, o);
        if (lane >= o) winc += v;
      }
      const int wpre = __shfl_sync(0xFFFFFFFFu, winc - wc, warp);
      int r = carry + wpre + inc - cnt;
#pragma unroll
      for (int k = 0; k < ITEMS; ++k) {
        rank[k] = r;
        r += alive[k];
      }
      carry += __shfl_sync(0xFFFFFFFFu, winc, 31);
      par ^= 1;
    }
    int res[3][ITEMS];
    uint32_t cword = 0;
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) {
      const int q = qb + k, p = pk[k], off = q - p;
      const bool matched = p >= 0 && off <= MAX_DISTANCE;
      int len = nb1[k] >= 0 ? MINMATCH + nb1[k] : 0;
      if (alive[k] && rank[k] < rcap) {
        for (int r = 0; r < ext_rounds; ++r) {
          const int nb = xor_nb(word_at(sw, clampi(q + len, 0, D - 1)),
                                word_at(sw, clampi(p + len, 0, D - 1)));
          len += nb;
          if (nb != 4) break;
        }
      }
      int c = NO_CLS;
      if (matched && off >= 1 && off <= 4) {
        c = off - 1;
      } else if (nb1[k] >= 0 &&
                 (s_dmap[(off & (DMAP - 1)) >> 5] >> (off & 31)) & 1u) {
        for (int t = 4; t < 4 + K; ++t)
          if (s_d[t] > 0 && s_d[t] == off) { c = t; break; }
      }
      if (c != NO_CLS) used |= 1u << c;
      cword |= (uint32_t)c << (8 * k);
      // final unless the class's run sets the length (phase 2 rewrites)
      const int3 o = finish(matched, off, len, q, end_abs, blk_ok);
      res[0][k] = o.x;
      res[1][k] = o.y;
      res[2][k] = o.z;
    }
    *(uint32_t*)(cls + qb) = cword;
    matched4[qb / 4] = make_int4(res[0][0], res[0][1], res[0][2], res[0][3]);
    off4[qb / 4] = make_int4(res[1][0], res[1][1], res[1][2], res[1][3]);
    mlen4[qb / 4] = make_int4(res[2][0], res[2][1], res[2][2], res[2][3]);
  }
  used = __reduce_or_sync(0xFFFFFFFFu, used);
  if (lane == 0) atomicOr(&s_used, used);
  __syncthreads();
  const unsigned all_used = s_used;
  const int n_used = __popc(all_used);
  if (tid == 0) {
    int n = 0;
    for (int c = 0; c < NCLS; ++c)
      if ((all_used >> c) & 1u) s_list[n++] = c;
  }

  // ---- 2. exact equal-run lengths, G classes at a time ----------------
  for (int g0 = 0; g0 < n_used; g0 += G) {
    const int ng = min(G, n_used - g0);
    __syncthreads();   // s_list written; the last group's masks read
    if (tid < NCLS) s_slot[tid] = -1;
    __syncthreads();
    if (tid < ng) s_slot[s_list[g0 + tid]] = tid;

    // break bitmasks: a warp takes 128 positions, 4 a lane
    for (int s = 0; s < ng; ++s) {
      const int d = s_d[s_list[g0 + s]];
#pragma unroll 2
      for (int ch = warp; ch < D / 128; ch += WARPS) {
        const int j = ch * 128 + lane * 4;
        const uint32_t a = sw[j >> 2];
        const int e = j - d;
        uint32_t nib = 0xFu;                     // all four j + k < d
        if (e > -4) {
          const uint32_t bw = e >= 0 ? word_at(sw, e) : sw[0] << (8 * -e);
          const uint32_t t = __vcmpne4(a, bw) & 0x01010101u;
          nib = ((t * 0x204081u) >> 21) & 0xFu;  // byte k -> bit k
          if (e < 0) nib |= (1u << -e) - 1;      // j + k < d breaks
        }
        uint32_t v = nib << ((lane & 7) * 4);
        v |= __shfl_xor_sync(0xFFFFFFFFu, v, 1);
        v |= __shfl_xor_sync(0xFFFFFFFFu, v, 2);
        v |= __shfl_xor_sync(0xFFFFFFFFu, v, 4);
        if ((lane & 7) == 0) masks[s * mask_words + (j >> 5)] = v;
      }
    }
    __syncthreads();
    // levels 1 and 2: a warp takes 32 level-1 words of one class
    for (int it = warp; it < ng * n2; it += WARPS) {
      const int s = it / n2, u = it % n2;
      uint32_t* l0 = masks + s * mask_words;
      uint32_t* l1 = l0 + n0;
      uint32_t mine = 0;
      for (int i = 0; i < 32; ++i) {
        const int v = u * 32 + i;
        if (v >= n1) break;                      // uniform in the warp
        const uint32_t bal =
            __ballot_sync(0xFFFFFFFFu, l0[v * 32 + lane] != 0);
        if (lane == i) mine = bal;
        if (lane == 0) l1[v] = bal;
      }
      const uint32_t b2 = __ballot_sync(0xFFFFFFFFu, mine != 0);
      if (lane == 0) l1[n1 + u] = b2;
    }
    __syncthreads();
    // the group's positions: run length, end rules, outputs
    for (int w = tid; w < D / 4; w += THREADS) {
      const uint32_t cw = ((const uint32_t*)cls)[w];
      if (cw == 0xFFFFFFFFu) continue;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int c = (cw >> (8 * k)) & 0xFF;
        if (c >= NCLS) continue;
        const int s = s_slot[c];
        if (s < 0) continue;
        const uint32_t* l0 = masks + s * mask_words;
        const Masks m{l0, l0 + n0, l0 + n0 + n1};
        const int q = w * 4 + k;
        const int len = next_break(m, q, n0, n1, n2, D) - q;
        const int3 o = finish(true, s_d[c], len, q, end_abs, blk_ok);
        matched_all[row + q] = o.x;
        off_all[row + q] = o.y;
        mlen_all[row + q] = o.z;
      }
    }
  }
}

}  // namespace
}  // namespace lz4t

// cls_scratch: B x D bytes of device memory for the class bytes of rows
// too wide to keep them in shared memory (unused otherwise)
extern "C" int lz4t_match_lengths(const void* x, const void* u32,
                                  const void* prev, const void* m8,
                                  const void* dks, const void* end_abs,
                                  const void* blk_len, void* matched,
                                  void* off, void* mlen, void* cls_scratch,
                                  int B, int D, int K, int rcap,
                                  int ext_rounds, void* stream) {
  (void)u32;   // the words are assembled from x's bytes
  if (B <= 0) return 0;
  if (K > lz4t::MAX_TOP || D % lz4t::TILE) return (int)cudaErrorInvalidValue;
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  cudaFuncAttributes attr;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, lz4t::mlen_kernel);
  if (err != cudaSuccess) return (int)err;
  const int n1 = D / 1024;
  const int mask_bytes = 4 * (D / 32 + n1 + (n1 + 31) / 32);
  // the class bytes stay in shared memory where they and one bitmask fit
  const bool cls_shared =
      (int)attr.sharedSizeBytes + 2 * D + lz4t::PAD + mask_bytes <= optin;
  const int fixed = (cls_shared ? 2 * D : D) + lz4t::PAD;
  const int room = optin - (int)attr.sharedSizeBytes - fixed;
  int G = room / mask_bytes;
  if (G > 4 + K) G = 4 + K;
  if (G < 1) return (int)cudaErrorInvalidValue;
  const int smem = fixed + G * mask_bytes;
  err = cudaFuncSetAttribute(
      lz4t::mlen_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  lz4t::mlen_kernel<<<B, lz4t::THREADS, smem, (cudaStream_t)stream>>>(
      (const int*)x, (const int*)prev, (const int*)m8, (const int*)dks,
      (const int*)end_abs, (const int*)blk_len, (int*)matched, (int*)off,
      (int*)mlen, cls_shared ? nullptr : (uint8_t*)cls_scratch, D, K, rcap,
      ext_rounds, G);
  return (int)cudaGetLastError();
}
