// Shared constants and helpers of the port's kernels (sm_90a).
//
// Every kernel takes int32 rows laid out [B, N] row-major, one CTA per
// block, and launches on the caller's stream.  Each C entry point returns
// cudaGetLastError() so the Python wrapper can raise on a refused launch.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace lz4t {

constexpr int M17 = (1 << 17) - 1;   // comp-domain length clamp
constexpr int VFLAG = 1 << 19;       // value-terminal flag in state words
constexpr int BIG = 1 << 30;

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

struct MinOp {
  __device__ __forceinline__ int operator()(int a, int b) const {
    return a < b ? a : b;
  }
};

struct MaxOp {
  __device__ __forceinline__ int operator()(int a, int b) const {
    return a > b ? a : b;
  }
};

struct SumOp {
  __device__ __forceinline__ int operator()(int a, int b) const {
    // int32 wraparound, as XLA's int32 cumsum
    return (int)((unsigned)a + (unsigned)b);
  }
};

// Tile expansion (emit_kernel.cu, records_kernel.cu): which entry of a
// non-decreasing key array governs each byte of the tile [o0, o0 + TILE),
// the governing entry of byte o being the last with key <= o.  Entries
// (t_lo, t_hi] hold every key that lies in the tile; t_lo governs o0 (-1
// where no entry does).  Each of them whose key lies in the tile marks
// owner[key - o0] with its index (atomicMax: of equal keys the last
// wins); an inclusive max-scan over owner, seeded with t_lo, then gives
// thread i's bytes o0 + i*ITEMS + j their entry in gov[j] (an entry
// longer than the tile has no key in it and reaches it through the
// seed).  owner: TILE ints of shared memory, 16-byte aligned, -1
// everywhere and visible to the whole CTA; Scan a cub::BlockScan<int,
// THREADS>.
template <int THREADS, int ITEMS, typename Scan>
__device__ __forceinline__ void expand_tile(
    const int* __restrict__ keys, int t_lo, int t_hi, int o0, int* owner,
    typename Scan::TempStorage& scan_tmp, int (&gov)[ITEMS]) {
  static_assert(ITEMS % 4 == 0, "owner is read as int4");
  constexpr int TILE = THREADS * ITEMS;
  for (int t = t_lo + 1 + threadIdx.x; t <= t_hi; t += THREADS) {
    const int e = __ldg(keys + t);
    if (e >= o0 && e - o0 < TILE) atomicMax(&owner[e - o0], t);
  }
  __syncthreads();
#pragma unroll
  for (int h = 0; h < ITEMS; h += 4) {
    const int4 ow =
        reinterpret_cast<const int4*>(owner)[(threadIdx.x * ITEMS + h) / 4];
    gov[h] = ow.x;
    gov[h + 1] = ow.y;
    gov[h + 2] = ow.z;
    gov[h + 3] = ow.w;
  }
  // the seed: max is associative, so it enters as the tile's first item
  if (threadIdx.x == 0) gov[0] = gov[0] > t_lo ? gov[0] : t_lo;
  Scan(scan_tmp).InclusiveScan(gov, gov, MaxOp());
}

// Running prefix carried across the tiles of one CTA's block-wide scan
// (cub::BlockScan's BlockPrefixCallbackOp protocol: called by warp 0,
// lane 0's return value is the tile's prefix).
template <typename Op, typename T = int>
struct TileCarry {
  T carry;
  Op op;
  __device__ explicit TileCarry(T init) : carry(init) {}
  __device__ T operator()(T tile_aggregate) {
    T old = carry;
    carry = op(carry, tile_aggregate);
    return old;
  }
};

}  // namespace lz4t
