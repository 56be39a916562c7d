// mark_chain: mark[b, i] = 1 iff i lies in the orbit of 0 under g[b].
//
// Replaces the TPU kernel lz4net_tpu/ops/chain_kernel.py: mark_chain
// (_chain_kernel).  The TPU version finds segment exits by pointer
// doubling over 128-position segments, threads a carry across the
// segments and marks inside each segment in parallel, stopping after
// ceil(128/3) + 1 = 44 rounds, which covers the encoder's graphs (hops of
// at least 4 after the first) but not an arbitrary g.  Here one CTA owns
// one block and marks the exact orbit by segment exits, as the parse of
// csrc/seq_kernel.cu (its step 1) and csrc/parse_kernel.cu (steps 2-4)
// do, in tiles of 2048 positions: 16 worker warps, each owning one
// 128-position group of every tile (four 32-position segments, one
// position a lane in each), and one hop warp.
//
//   1. each position's step h = g[q] where q < g[q] < D, else a code that
//      ends the walk: STOP where g[q] <= q (the walk ends at q), ENDED
//      where g[q] >= D (it ends after q).  Both codes lie past every
//      position and boundary, so a walk leaves its segment, group and
//      tile at once, and a jump may land anywhere ahead: in its own
//      segment, in a later tile, on a boundary, at or past D.  By pointer
//      doubling with __shfl_sync (h >= q + 1, so at most 32 steps, 5
//      rounds) each position gets its exit from its segment (the first
//      orbit position at or past the segment's end, or a code) and its
//      path mask, the positions of the segment on its walk.  g is loaded
//      one tile ahead, coalesced;
//   2. each position's exit from its group, at most three segment exits
//      on, in shared memory;
//   3. the hop warp's lane 0 hops from the carried position over the group
//      exits, one dependent shared-memory read a group the orbit enters
//      (at most D / 128 = 576 a block at D = 73,728; 462 on average on
//      the encode cell), recording each group's entry;
//   4. each worker warp marks its group from the group's entry: a
//      segment's marks are the path mask of its entry, and its exit the
//      next segment's entry (two shuffles a segment), and stores them once,
//      coalesced.  There is no zeroing pass.
// The three run pipelined: in interval i the worker warps mark tile i - 2
// and find tile i's exits while the hop warp hops over tile i - 1, one
// barrier an interval.  Exits and path masks wait two intervals in
// registers, by tile parity.
//
// What bounds it on the H100: the bound counts the mark row written once
// and g read at the orbit's positions (0.0248 ms for the encode cell,
// PERF.md section 6).  The kernel reads all of g, twice the bytes that
// bound counts (0.045 ms at 3.35 TB/s): which positions the orbit visits
// is what it computes, and reading g at only those is the serial walk
// this design removes.  What sets its time is issue: the worker warps'
// shuffles, about 5 instructions a position a doubling round, and the
// hop warp's dependent reads, which other warps' issue slows.  The CTA
// needs about 24 KB of shared memory, nothing in proportion to D, so two
// CTAs fit on an SM and every block of a 256-block batch is resident at
// once.  The first form staged 2 bytes of step a position (147,456 bytes
// at D = 73,728: one CTA an SM, two waves) and walked the orbit on one
// thread, one dependent read a position (about 100 cycles a hop, 0.946 of
// its cycles).
#include <type_traits>

#include "common.cuh"

namespace lz4t {
namespace {

constexpr int WARPS = 16;               // worker warps; one more hops
constexpr int THREADS = (WARPS + 1) * 32;
constexpr int GROUP = 128;              // a worker warp's positions a tile
constexpr int SEGS = GROUP / 32;        // 32-position segments a group
constexpr int TILE = WARPS * GROUP;     // positions a tile
constexpr unsigned FULL = 0xffffffffu;
constexpr int STOP = 0x7fffffff;        // g[q] <= q: the walk ends at q
constexpr int ENDED = 0x7ffffffe;       // g[q] >= D: it ends after q

__global__ void __launch_bounds__(THREADS, 2)
chain_kernel(const int* __restrict__ g_all, int* __restrict__ mark_all,
             int D) {
  __shared__ int ex_s[TILE];             // segment exits, a group a warp
  __shared__ int gx_s[2][TILE];          // group exits, by tile parity
  // the orbit's entry into each group of a tile, or -1; by tile parity
  __shared__ int gentry_s[2][WARPS];

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int* g = g_all + (size_t)blockIdx.x * D;
  int* mark = mark_all + (size_t)blockIdx.x * D;
  const int ntiles = (D + TILE - 1) / TILE;

  int pg[SEGS];                          // g of the warp's next positions
  // each segment's exit and path mask (the positions of the segment on
  // the walk from each lane's position, bit i for position s0 + i) of
  // tiles i and i - 1, by tile parity
  int xr[2][SEGS];
  unsigned pr[2][SEGS];
  int carry = 0;                         // the hop warp's next position
  if (warp < WARPS) {
#pragma unroll
    for (int k = 0; k < SEGS; ++k) {
      const int q = warp * GROUP + k * 32 + lane;
      pg[k] = q < D ? __ldcs(g + q) : 0;
    }
  }

  // Interval i: the worker warps mark tile i - 2 and find tile i's exits,
  // the hop warp hops over tile i - 1; one barrier an interval.  slot is
  // i % 2, the place of tile i's (and tile i - 2's) exits and paths.
  auto interval = [&](auto slot, int i) {
    constexpr int S = decltype(slot)::value;
    if (warp < WARPS) {
      // ---- 3. marking and stores: tile i - 2, from each segment's entry
      const int j = i - 2;
      if (j >= 0 && j < ntiles) {
        const int gbase = j * TILE + warp * GROUP;
        int cur = gentry_s[j & 1][warp];   // uniform across the warp
#pragma unroll
        for (int k = 0; k < SEGS; ++k) {
          const int s0 = gbase + k * 32;
          unsigned on = 0;
          if (cur >= 0 && cur < s0 + 32) {   // cur >= s0 here
            on = __shfl_sync(FULL, pr[S][k], cur - s0);
            cur = __shfl_sync(FULL, xr[S][k], cur - s0);
          }
          if (s0 + lane < D) mark[s0 + lane] = (on >> lane) & 1u;
        }
      }
      // ---- 1. loads and doubling: tile i's segment and group exits -----
      if (i < ntiles) {
        const int gbase = i * TILE + warp * GROUP;
        int* ex = ex_s + warp * GROUP;
#pragma unroll
        for (int k = 0; k < SEGS; ++k) {
          const int s0 = gbase + k * 32;
          const int q = s0 + lane;
          int h = pg[k] <= q ? STOP : (pg[k] >= D ? ENDED : pg[k]);
          unsigned m = 1u << lane;
#pragma unroll
          for (int r = 0; r < 5; ++r) {  // h >= q + 1: 32 steps at most
            // h - s0 > 0; past the segment its lane wraps, and the value
            // read there is not taken
            const int nx = __shfl_sync(FULL, h, h - s0);
            const unsigned mx = __shfl_sync(FULL, m, h - s0);
            if (h < s0 + 32) {
              h = nx;
              m |= mx;
            }
          }
          xr[S][k] = h;                  // >= s0 + 32, or a code
          pr[S][k] = m;
          ex[k * 32 + lane] = h;
          pg[k] = q + TILE < D ? __ldcs(g + q + TILE) : 0;
        }
        __syncwarp();
#pragma unroll
        for (int k = 0; k < SEGS; ++k) { // at most 3 segment exits on
          int e = ex[k * 32 + lane];
          while (e < gbase + GROUP) e = ex[e - gbase];
          gx_s[i & 1][warp * GROUP + k * 32 + lane] = e;
        }
      }
    } else {
      // ---- 2. group hops: the orbit's entries into tile i - 1's groups --
      const int j = i - 1;
      if (j >= 0 && j < ntiles) {
        const int t0 = j * TILE;
        int* gentry = gentry_s[j & 1];
        if (lane < WARPS) gentry[lane] = -1;
        __syncwarp();
        if (lane == 0) {
          int pos = carry;
          while (pos < t0 + TILE) {
            gentry[(pos - t0) / GROUP] = pos;
            pos = gx_s[j & 1][pos - t0];
          }
          carry = pos;
        }
      }
    }
    __syncthreads();
  };
  for (int i = 0; i < ntiles + 2; i += 2) {
    interval(std::integral_constant<int, 0>(), i);
    interval(std::integral_constant<int, 1>(), i + 1);
  }
}

}  // namespace
}  // namespace lz4t

extern "C" int lz4t_mark_chain(const void* g, void* mark, int B, int D,
                               void* stream) {
  if (B <= 0 || D <= 0) return 0;
  lz4t::chain_kernel<<<B, lz4t::THREADS, 0, (cudaStream_t)stream>>>(
      (const int*)g, (int*)mark, D);
  return (int)cudaGetLastError();
}
