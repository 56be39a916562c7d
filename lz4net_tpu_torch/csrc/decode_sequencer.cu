// decode_sequencer: known-length LZ4 block decode, one token walk per block.
//
// Replaces the TPU kernel lz4net_tpu/ops/decode_pallas.py:
// build_decode_call (_decode_kernel): token, literal run with
// 255-extensions, 16-bit offset, a match of mlen + 4 bytes with LZ4's
// overlapping-copy semantics, looping while dp < out_len, and the status
// (bytes read, bytes written).  The TPU kernel's 128-lane barrel
// rotations and periodic fills were how its vector unit copied unaligned
// bytes; here the copies are plain byte loads and stores.
//
// The TPU kernel trusts its input.  Here junk must not read or write out
// of bounds, so the walk stops at the first fault and reports (-1, dp):
// a read at or past comp_len, a run that would write past D, a match
// offset of 0 or past dp, or a break of the reference decoder's
// end-of-block rules (a literal run ending past out_len - 8 must end at
// out_len; a match must end by out_len - 5).  ops/decode_sequencer.py
// states the rules; its plain version applies the same ones.
//
// One warp per block.  Every lane walks the tokens in step (the same
// loads, broadcast to the warp), so the walk needs no shuffles; the warp
// copies 32 bytes a step.  A match byte k is out[dp - offset + k % offset]
// for every offset, which lies before dp: all sources of a match were
// written by earlier steps, so one __syncwarp() after each copy orders it.
// After the walk the warp writes zeros over the rest of the row.
//
// What bounds it on the H100: the walk is a chain of dependent loads, a
// few per token (thousands of tokens in a 64 KB block); the bytes bound
// (compressed bytes read once, output written once) is far below it.
// 256 blocks run as 256 warps at once, so a batch costs about one block's
// walk.  A later version can parse tokens ahead in the other lanes.
#include "common.cuh"

namespace lz4t {
namespace {

constexpr int WARP = 32;
constexpr int COPYLENGTH = 8;
constexpr int LASTLITERALS = 5;
constexpr unsigned FULL = 0xffffffffu;

__global__ void __launch_bounds__(WARP)
decode_sequencer_kernel(const uint8_t* __restrict__ comp_all,
                        const int* __restrict__ comp_len_all,
                        const int* __restrict__ out_len_all,
                        uint8_t* __restrict__ out_all,
                        int* __restrict__ status_all, int C, int D) {
  const int b = blockIdx.x;
  const int lane = threadIdx.x;
  const uint8_t* comp = comp_all + (size_t)b * C;
  uint8_t* out = out_all + (size_t)b * D;
  const int lim = clampi(comp_len_all[b], 0, C);
  const int out_len = out_len_all[b];

  int sp = 0, dp = 0;
  bool fault = false;
  // 255-extension bytes from sp; false at a read past lim
  auto ext = [&](int& n) {
    for (;;) {
      if (sp >= lim) return false;
      const int v = __ldg(comp + sp++);
      n += v;
      if (v != 255) return true;
    }
  };

  while (dp < out_len) {
    if (sp >= lim) { fault = true; break; }
    const int token = __ldg(comp + sp++);
    int lit = token >> 4;
    if (lit == 15 && !ext(lit)) { fault = true; break; }
    const int end = dp + lit;
    if (sp + lit > lim || end > D ||
        (end > out_len - COPYLENGTH && end != out_len)) {
      fault = true;
      break;
    }
    for (int k = lane; k < lit; k += WARP) out[dp + k] = __ldg(comp + sp + k);
    __syncwarp(FULL);
    sp += lit;
    dp = end;
    if (dp >= out_len) break;

    if (sp + 2 > lim) { fault = true; break; }
    const int offset = __ldg(comp + sp) | (__ldg(comp + sp + 1) << 8);
    sp += 2;
    int mlen = token & 15;
    if (mlen == 15 && !ext(mlen)) { fault = true; break; }
    mlen += 4;
    if (offset == 0 || offset > dp || dp + mlen > D ||
        dp + mlen > out_len - LASTLITERALS) {
      fault = true;
      break;
    }
    const int base = dp - offset;
    for (int k = lane; k < mlen; k += WARP)
      out[dp + k] = out[base + (k < offset ? k : k % offset)];
    __syncwarp(FULL);
    dp += mlen;
  }

  for (int k = dp + lane; k < D; k += WARP) out[k] = 0;
  if (lane == 0) {
    status_all[2 * b] = fault ? -1 : sp;
    status_all[2 * b + 1] = dp;
  }
}

}  // namespace
}  // namespace lz4t

extern "C" int lz4t_decode_sequencer(const void* comp, const void* comp_len,
                                     const void* out_len, void* out,
                                     void* status, int B, int C, int D,
                                     void* stream) {
  if (B <= 0) return 0;
  lz4t::decode_sequencer_kernel<<<B, lz4t::WARP, 0,
                                  (cudaStream_t)stream>>>(
      (const uint8_t*)comp, (const int*)comp_len, (const int*)out_len,
      (uint8_t*)out, (int*)status, C, D);
  return (int)cudaGetLastError();
}
