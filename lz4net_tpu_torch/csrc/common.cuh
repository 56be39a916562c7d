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

struct SumOp {
  __device__ __forceinline__ int operator()(int a, int b) const {
    // int32 wraparound, as XLA's int32 cumsum
    return (int)((unsigned)a + (unsigned)b);
  }
};

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
