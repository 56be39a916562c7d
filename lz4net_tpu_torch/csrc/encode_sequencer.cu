// encode_sequencer: strict greedy LZ4 block encode, the reference parse.
//
// Replaces the TPU kernel lz4net_tpu/ops/encode_pallas.py:
// build_encode_call (_encode_kernel), which is bit-identical to the
// reference compressor (lz4net_tpu_torch/models/reference.py:
// compress_block): skip acceleration, every probed position inserted,
// backward catch-up, the exact output-limit checks before the literals,
// before the match length and before the last literals, the "fill table"
// insertion at p - 2 and the token=0 immediate re-match.
//
// Unlike the TPU kernel it keeps both hash variants of the reference, so
// every block size gives the reference's bytes: an 8192-entry table on
// 4-byte words >> 19 below LZ4_64KLIMIT, a 4096-entry table (>> 20) with
// the 64 KB window check at or above it.  The 48 KB cap of the TPU kernel
// was its SMEM budget and is gone.
//
// One CTA per block.  Its threads zero the hash table in shared memory;
// one thread runs the parse, reading the source from device memory
// (through L1) and writing the payload byte by byte.  Bytes of the output
// row past the payload are left as they were (no caller reads them).
//
// What bounds it on the H100: the parse is one dependent chain of byte
// loads, table probes and compares per block, a few cycles to tens of
// cycles each; the bytes bound (source read once, payload written once)
// is ~1000x below it.  All blocks run at once (256 blocks of 64 KB fill
// the 132 SMs about twice), so a batch costs about one block's parse.
// A later version can stage the block in shared memory and compare 4
// bytes at a time in the match extension.
#include "common.cuh"

namespace lz4t {
namespace {

constexpr int THREADS = 256;
constexpr int MINMATCH = 4;
constexpr int LASTLITERALS = 5;
constexpr int MFLIMIT = 12;
constexpr int MINLENGTH = MFLIMIT + 1;
constexpr int SKIPSTRENGTH = 6;
constexpr int RUN_MASK = 15;
constexpr int ML_MASK = 15;
constexpr int MAX_DISTANCE = 65535;
constexpr int LZ4_64KLIMIT = (1 << 16) + (MFLIMIT - 1);
constexpr int TABLE64K = 1 << 13;     // HASH64K_TABLESIZE
constexpr uint32_t HASH_MULTIPLIER = 2654435761u;

struct Parse {
  const uint8_t* __restrict__ src;
  uint8_t* __restrict__ out;
  int* table;
  int O;
  int adjust;   // 19 (8192 entries) or 20 (4096)

  __device__ __forceinline__ int rd(int i) const { return __ldg(src + i); }

  __device__ __forceinline__ int hash(int i) const {
    uint32_t w = (uint32_t)rd(i) | ((uint32_t)rd(i + 1) << 8) |
                 ((uint32_t)rd(i + 2) << 16) | ((uint32_t)rd(i + 3) << 24);
    return (int)((w * HASH_MULTIPLIER) >> adjust);   // uint32: logical
  }

  __device__ __forceinline__ bool eq4(int a, int c) const {
    return rd(a) == rd(c) && rd(a + 1) == rd(c + 1) &&
           rd(a + 2) == rd(c + 2) && rd(a + 3) == rd(c + 3);
  }

  __device__ __forceinline__ void wr(int i, int v) const {
    if (i < O) out[i] = (uint8_t)v;
  }

  // 255-extension bytes of a run length past its nibble; returns new dp
  __device__ __forceinline__ int ext(int dp, int rem) const {
    for (; rem > 254; rem -= 255) wr(dp++, 255);
    wr(dp++, rem);
    return dp;
  }

  // The reference parse of n bytes into at most dst_maxlen; returns the
  // payload length, or -1 when it would not fit.
  __device__ int run(int n, int dst_maxlen) const {
    const bool use64k = n < LZ4_64KLIMIT;
    const int mflimit = n - MFLIMIT;
    const int cap = n - LASTLITERALS;   // matches extend at most here
    const int dst_last1 = dst_maxlen - (1 + LASTLITERALS);
    const int dst_last3 = dst_maxlen - (2 + 1 + LASTLITERALS);
    int dp = 0, anchor = 0;

    // The table starts zeroed, so it already holds position 0 in every
    // bucket: that covers the large variant's pre-insertion of position 0.
    if (n >= MINLENGTH) {
      int p = 1;
      int h_fwd = hash(p);
      bool ended = false;   // the last match reached mflimit
      while (!ended) {
        // ---- find a match (skip-accelerated probe loop) -------------
        int attempts = (1 << SKIPSTRENGTH) + 3;
        int p_fwd = p, ref = 0;
        bool found = false;
        for (;;) {
          const int h = h_fwd;
          const int step = attempts >> SKIPSTRENGTH;
          ++attempts;
          p = p_fwd;
          p_fwd = p + step;
          if (p_fwd > mflimit) break;
          h_fwd = hash(p_fwd);
          ref = table[h];
          table[h] = p;
          if ((use64k || ref >= p - MAX_DISTANCE) && eq4(ref, p)) {
            found = true;
            break;
          }
        }
        if (!found) break;

        // ---- catch up: extend the match backwards ---------------------
        while (p > anchor && ref > 0 && rd(p - 1) == rd(ref - 1)) {
          --p;
          --ref;
        }

        // ---- literal run ----------------------------------------------
        const int lit_len = p - anchor;
        int token_pos = dp++;
        if (dp + lit_len + (lit_len >> 8) > dst_last3) return -1;
        int token;
        if (lit_len >= RUN_MASK) {
          token = RUN_MASK << 4;
          dp = ext(dp, lit_len - RUN_MASK);
        } else {
          token = lit_len << 4;
        }
        for (int k = 0; k < lit_len; ++k) wr(dp + k, rd(anchor + k));
        dp += lit_len;

        for (;;) {
          // ---- offset, then extend the match forwards ---------------
          const int offset = p - ref;
          wr(dp, offset & 0xFF);
          wr(dp + 1, offset >> 8);
          dp += 2;
          p += MINMATCH;
          ref += MINMATCH;
          anchor = p;
          while (p < cap && rd(p) == rd(ref)) {
            ++p;
            ++ref;
          }
          const int mlen = p - anchor;
          if (dp + (mlen >> 8) > dst_last1) return -1;
          if (mlen >= ML_MASK) {
            token += ML_MASK;
            dp = ext(dp, mlen - ML_MASK);
          } else {
            token += mlen;
          }
          wr(token_pos, token);

          if (p > mflimit) {
            anchor = p;
            ended = true;
            break;
          }
          table[hash(p - 2)] = p - 2;   // the reference's "fill table"

          // immediate re-match at p (a token with no literals)
          const int h = hash(p);
          ref = table[h];
          table[h] = p;
          if ((use64k || ref > p - (MAX_DISTANCE + 1)) && eq4(ref, p)) {
            token_pos = dp++;
            token = 0;
            continue;
          }
          anchor = p;
          ++p;
          h_fwd = hash(p);
          break;
        }
      }
    }

    // ---- last literals ------------------------------------------------
    const int last = n - anchor;
    if (dp + last + 1 + (last + 255 - RUN_MASK) / 255 > dst_maxlen)
      return -1;
    const int token_pos = dp++;
    if (last >= RUN_MASK) {
      wr(token_pos, RUN_MASK << 4);
      dp = ext(dp, last - RUN_MASK);
    } else {
      wr(token_pos, last << 4);
    }
    for (int k = 0; k < last; ++k) wr(dp + k, rd(anchor + k));
    return dp + last;
  }
};

__global__ void __launch_bounds__(THREADS)
encode_sequencer_kernel(const uint8_t* __restrict__ src_all,
                        const int* __restrict__ src_len_all,
                        const int* __restrict__ dst_maxlen_all,
                        uint8_t* __restrict__ out_all,
                        int* __restrict__ written_all, int S, int O) {
  __shared__ int table[TABLE64K];
  const int b = blockIdx.x;
  for (int i = threadIdx.x; i < TABLE64K; i += THREADS) table[i] = 0;
  __syncthreads();

  if (threadIdx.x == 0) {
    const int n = clampi(src_len_all[b], 0, S);
    Parse parse{src_all + (size_t)b * S, out_all + (size_t)b * O, table, O,
                n < LZ4_64KLIMIT ? 19 : 20};
    const int w = parse.run(n, dst_maxlen_all[b]);
    written_all[b] = w > O ? -1 : w;
  }
}

}  // namespace
}  // namespace lz4t

extern "C" int lz4t_encode_sequencer(const void* src, const void* src_len,
                                     const void* dst_maxlen, void* out,
                                     void* written, int B, int S, int O,
                                     void* stream) {
  if (B <= 0) return 0;
  lz4t::encode_sequencer_kernel<<<B, lz4t::THREADS, 0,
                                  (cudaStream_t)stream>>>(
      (const uint8_t*)src, (const int*)src_len, (const int*)dst_maxlen,
      (uint8_t*)out, (int*)written, S, O);
  return (int)cudaGetLastError();
}
