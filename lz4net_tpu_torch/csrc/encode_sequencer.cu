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
// One parse, WarpParse, run by one warp a block, in two kernels chosen by
// the row width S (one launch a batch either way), which differ only in
// where the parse reads the row (its Row).  Both keep the hash table, 16
// KB (8192 16-bit positions below LZ4_64KLIMIT, where every inserted
// position is at most 65534; 4096 32-bit positions at or above it), and
// 32 KB of slot masks in shared memory:
//
// * StagedRow: rows that fit the device's opt-in shared memory beside
//   the table and the slot masks (staged_row_max: at most 183,232 bytes
//   on the H100).  One CTA a block stages the source row in shared
//   memory (16-byte loads).  A 64 KB block, its table and the slot masks
//   take 112 KB, so two CTAs share an SM and 256 blocks run in one wave.
// * DeviceRow: wider rows.  The parse reads the row where it lies in
//   device memory, through the L1 cache.  Every row this wide takes the
//   large hash variant, whose window check rejects a candidate more than
//   65,535 bytes back, so the parse reads within about 64 KB behind its
//   position and a window's reach ahead of it: the kernel asks for the
//   least shared memory (48 KB, the table and the masks) so that L1 keeps
//   the rest of the SM's 256 KB, and that reach stays in it.  A batch of
//   1 MB stream chunks is at most 64 rows, one wave.
//
// The parse: the skip loop probes 32 positions at once: until a match is
// found the positions depend only on the attempt counter, so lane i
// takes probe k + i, finds the lanes of the window that hash to its slot
// (each sets its bit in a 32 KB array of slot masks), takes the latest
// earlier one's position as its candidate or else reads the table, and
// the first lane whose candidate passes the window check and the 4-byte
// compare is the match; of each slot's writers up to that lane only the
// last writes, and a lane whose next position passes mflimit ends the
// search; so the table and the result are the serial loop's.  A token's
// forward extension (one word by every lane alike, then 4 bytes a lane,
// 128 a step) and the re-match check at its end come before its catch-up
// (32 bytes backwards a step, after a first byte each window lane checks
// for its own candidate) and its bytes, which do not feed them; the
// literals are copied by the lanes, and the token, the length bytes and
// the three output-limit checks are uniform across the warp, in the
// reference's order.  Bytes of the output row past the payload are left
// as they were (no caller reads them).
//
// What bounds it on the H100 (NVIDIA H100 80GB HBM3, 700 W; PERF.md
// section 6, kernel table): the parse is one chain of dependent warp
// steps a block, shared loads, shuffles and ballots of some 30 cycles and
// the branches between them, about 830 cycles a token: 4.69 ms for 256
// blocks of 64 KB, set by the slowest block's 11,221 tokens (8.85 ms
// for the first, one-thread, walk).  The bytes bound is 0.008 ms.  A
// batch of wide rows is set by its densest row alone: 8 chunks of 1 MB
// of the corpus take 88.0 ms, the densest's 173K tokens at 0.51 us each
// (137.7 ms with the first, one-thread, kernel for wide rows).  On the
// same rows a row read from device memory takes 1.15 times the staged
// row's time: the parse's chain waits on L1 hits in place of shared
// loads.  (A form that moved the row through a ring in shared memory,
// refilled by the parsing warp, took 0.96 times this one's time on the 8
// chunks, for some 300 more lines and 176 KB of shared memory.)
// lz4net_tpu_torch/tools/parse_clocks.py splits a block's cycles by
// section and times the primitives.
// What a later design could still take: fewer dependent steps and
// branches a token (the next window's hashes while a token's bytes are
// written; a window that stops at its first lanes, where most matches
// are found).
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
constexpr uint32_t HASH_MULTIPLIER = 2654435761u;
constexpr int TABLE_BYTES = 16384;    // either table variant
constexpr int PEERS_BYTES = 32768;    // a lane mask for each table slot
constexpr int PAD = 32;               // staged bytes past the row
constexpr unsigned FULL = 0xFFFFFFFFu;

// ---- where the parse reads the row -------------------------------------

// A row staged whole in shared memory.  Every read is a shared load.
struct StagedRow {
  const uint32_t* sw;   // staged row as words; byte i at shift + i
  int shift;            // 16 bytes of zeros, then the row's alignment

  // the word at byte i: a probe, a match's start or end, or a table
  // candidate (one that fails the window check may read bytes the row
  // does not hold, which the parse then ignores)
  __device__ __forceinline__ uint32_t word(int i) const {
    const int a = shift + i;
    return __funnelshift_r(sw[a >> 2], sw[(a >> 2) + 1], (a & 3) * 8);
  }

  // the word at i and the byte before it (i >= 0: byte -1 is padding)
  __device__ __forceinline__ uint32_t word_before(int i, int& before) const {
    const int a = shift + i - 1;
    const uint64_t v =
        ((uint64_t)sw[(a >> 2) + 1] << 32 | sw[a >> 2]) >> ((a & 3) * 8);
    before = (int)(v & 0xFF);
    return (uint32_t)(v >> 8);
  }

  // the byte at i: a literal, or a byte of a catch-up
  __device__ __forceinline__ int byte(int i) const {
    return ((const uint8_t*)sw)[shift + i];
  }
};

// A row read where it lies in device memory, through the L1 cache (it is
// read only while the kernel runs), as aligned words.  The parse reads no
// word past byte n - 3 (its probes and re-matches start at most at n - 11,
// an extension's last word at n - 6), so each aligned word it loads holds
// bytes of the row, save two it ignores: the word before byte 0 (the
// byte before a candidate at 0), for which it loads word 0, and a literal
// lane past p near the row's end, which loads the row's last byte.
struct DeviceRow {
  const uint32_t* w;    // the row's words; byte i at shift + i
  int shift;            // the row's alignment, 0-3
  int end;              // shift + n - 1: the row's last byte

  __device__ __forceinline__ uint32_t word(int i) const {
    const int a = shift + i;
    return __funnelshift_r(__ldg(w + (a >> 2)), __ldg(w + (a >> 2) + 1),
                           (a & 3) * 8);
  }

  __device__ __forceinline__ uint32_t word_before(int i, int& before) const {
    const int a = shift + i - 1;
    const uint64_t v = ((uint64_t)__ldg(w + (a >> 2) + 1) << 32 |
                        __ldg(w + max(a >> 2, 0))) >> ((a & 3) * 8);
    before = (int)(v & 0xFF);
    return (uint32_t)(v >> 8);
  }

  __device__ __forceinline__ int byte(int i) const {
    return __ldg((const uint8_t*)w + min(shift + i, end));
  }
};

// ---- the warp parse ------------------------------------------------------

// The rare, longer steps of the warp parse, out of line: the common path
// of a token (under 15 literals, a match that ends inside its first word,
// room in the budget) is straight code with one test.

// 255-bytes of a long run length, written by the warp
__device__ __noinline__ void fill255(uint8_t* out, int O, int dp, int k,
                                     int lane) {
  for (int i = lane; i < k; i += 32)
    if (dp + i < O) out[dp + i] = 255;
}

// a literal run of more than 32 bytes, copied by the warp
template <class Row>
__device__ __noinline__ void copy_long(uint8_t* out, int O, Row row, int dp,
                                       int from, int len, int lane) {
  for (int i = lane; i < len; i += 32)
    if (dp + i < O) out[dp + i] = row.byte(from + i);
}

// a run length's 255-bytes past its nibble; returns the new dp, with the
// last byte's place and value for the caller to write
__device__ __forceinline__ int ext255(uint8_t* out, int O, int dp, int rem,
                                      int lane, int& at, int& last) {
  const int k = rem / 255;
  if (k) fill255(out, O, dp, k, lane);
  at = dp + k;
  last = rem - 255 * k;
  return dp + k + 1;
}

// A token in full: lit_len literals from `from` (lane i's byte of the
// first 32 in lit), the offset, and a match of MINMATCH + mlen bytes,
// with the reference's output-limit checks (the literal one for a token
// after a search).  Returns the new dp, or -1 when the payload would
// not fit.  Every lane stores the same byte where one byte is due.
template <class Row>
__device__ __noinline__ int emit_full(uint8_t* out, int O, Row row, int dp,
                                      int from, int lit_len, int lit,
                                      bool searched, int offset, int mlen,
                                      int dst_last1, int dst_last3,
                                      int lane) {
  const int tok = dp++;
  if (searched && dp + lit_len + (lit_len >> 8) > dst_last3) return -1;
  int lit_at = -1, lit_last = 0, ml_at = -1, ml_last = 0;
  if (lit_len >= RUN_MASK)
    dp = ext255(out, O, dp, lit_len - RUN_MASK, lane, lit_at, lit_last);
  if (lit_len <= 32) {
    if (lane < lit_len && dp + lane < O) out[dp + lane] = (uint8_t)lit;
  } else {
    copy_long(out, O, row, dp, from, lit_len, lane);
  }
  dp += lit_len;
  const int off_at = dp;
  dp += 2;
  if (dp + (mlen >> 8) > dst_last1) return -1;
  if (mlen >= ML_MASK)
    dp = ext255(out, O, dp, mlen - ML_MASK, lane, ml_at, ml_last);
  const int token = min(lit_len, RUN_MASK) << 4 | min(mlen, ML_MASK);
  if (tok < O) out[tok] = (uint8_t)token;
  if (lit_at >= 0 && lit_at < O) out[lit_at] = (uint8_t)lit_last;
  if (off_at < O) out[off_at] = (uint8_t)(offset & 0xFF);
  if (off_at + 1 < O) out[off_at + 1] = (uint8_t)(offset >> 8);
  if (ml_at >= 0 && ml_at < O) out[ml_at] = (uint8_t)ml_last;
  return dp;
}

// the end of an equal run from (p, ref) past its first word, at most
// cap: 4 bytes a lane, 128 a step
template <class Row>
__device__ __noinline__ int extend_long(Row row, int p, int ref, int cap,
                                        int lane) {
  for (;;) {
    const int qi = p + 4 * lane;
    const int left = cap - qi;
    int k = 0;
    if (left > 0) {
      const uint32_t e = row.word(qi) ^ row.word(ref + 4 * lane);
      k = e ? (__ffs(e) - 1) >> 3 : 4;
      if (k > left) k = left;
    }
    const unsigned partial = __ballot_sync(FULL, k != 4);
    if (partial) {
      const int l = __ffs(partial) - 1;
      return p + 4 * l + __shfl_sync(FULL, k, l);
    }
    p += 128;
    ref += 128;
  }
}

// backward catch-up past its first byte: the steps from (p, ref) while
// p > anchor, ref > 0 and the bytes before them are equal, 32 a step
template <class Row>
__device__ __noinline__ int catch_up(Row row, int p, int ref, int anchor,
                                     int lane) {
  int t = 0;
  for (;;) {
    const int pi = p - t - 1 - lane, ri = ref - t - 1 - lane;
    const bool same = pi >= anchor && ri >= 0 && row.byte(pi) == row.byte(ri);
    const unsigned stop = __ballot_sync(FULL, !same);
    if (stop) return t + __ffs(stop) - 1;
    t += 32;
  }
}

// The parse of one block by one warp.  Every lane holds the same parse
// state (p, ref, anchor, dp) and stores the same bytes where one byte is
// due; the lanes split the probes, the compares and the copies.  small:
// the 8192-entry, 16-bit table below LZ4_64KLIMIT.  A token's steps are
// ordered for a short dependent chain: the forward extension and the
// re-match check at its end run before the catch-up and the token's
// bytes, which do not feed them.
template <class Row>
struct WarpParse {
  Row row;
  void* table;
  uint32_t* peers;      // the lanes of a window on each slot, else 0
  uint8_t* __restrict__ out;
  int O;
  int lane;
  bool small;

  __device__ __forceinline__ int hash_of(uint32_t w) const {
    return (int)((w * HASH_MULTIPLIER) >> (small ? 19 : 20));
  }

  __device__ __forceinline__ int tget(int h) const {
    return small ? ((const uint16_t*)table)[h] : ((const int*)table)[h];
  }

  __device__ __forceinline__ void tset(int h, int p) const {
    if (small)
      ((uint16_t*)table)[h] = (uint16_t)p;
    else
      ((int*)table)[h] = p;
  }

  __device__ __forceinline__ void wr(int i, int v) const {
    if (i < O) out[i] = (uint8_t)v;
  }

  // p_k - p_0 for a window whose first probe has counter `attempts`
  // (k <= 64: the step grows at most once inside it)
  static __device__ __forceinline__ int advance(int attempts, int k) {
    const int s0 = attempts >> SKIPSTRENGTH;
    const int grow = k - ((s0 + 1) * (1 << SKIPSTRENGTH) - attempts);
    return k * s0 + (grow > 0 ? grow : 0);
  }

  // The end of a match's equal run from (p, ref), at most cap: one word
  // compared by every lane alike, then the warp 4 bytes a lane.
  __device__ __forceinline__ int extend(int p, int ref, int cap) const {
    const int room = cap - p;
    const uint32_t d = row.word(p) ^ row.word(ref);
    const int nb = d ? (__ffs(d) - 1) >> 3 : 4;
    if (nb < 4 || room <= 4) return p + max(min(nb, room), 0);
    return extend_long(row, p + 4, ref + 4, cap, lane);
  }

  // A token (emit_full): most have under 15 literals and a length
  // nibble under 15, and fit; both output-limit checks are then dp + 3 +
  // lit_len <= dst_last1 (dst_last3 is dst_last1 - 2), one test.
  __device__ __forceinline__ int emit(int dp, int from, int lit_len, int lit,
                                      bool searched, int offset, int mlen,
                                      int dst_last1, int dst_last3) const {
    if (lit_len < RUN_MASK && mlen < ML_MASK &&
        dp + 3 + lit_len <= dst_last1) {
      if (lane < lit_len && dp + 1 + lane < O) out[dp + 1 + lane] = lit;
      wr(dp, lit_len << 4 | mlen);
      wr(dp + 1 + lit_len, offset & 0xFF);
      wr(dp + 2 + lit_len, offset >> 8);
      return dp + 3 + lit_len;
    }
    return emit_full(out, O, row, dp, from, lit_len, lit, searched,
                     offset, mlen, dst_last1, dst_last3, lane);
  }

  // the last literals from anchor; the payload's length, or -1
  __device__ __noinline__ int last_literals(int dp, int anchor, int n,
                                            int dst_maxlen) const {
    const int last = n - anchor;
    if (dp + last + 1 + (last + 255 - RUN_MASK) / 255 > dst_maxlen)
      return -1;
    int at = -1, rem = 0;
    const int tok = dp++;
    if (last >= RUN_MASK)
      dp = ext255(out, O, dp, last - RUN_MASK, lane, at, rem);
    wr(tok, min(last, RUN_MASK) << 4);
    if (at >= 0) wr(at, rem);
    copy_long(out, O, row, dp, anchor, last, lane);
    return dp + last;
  }

  __device__ int run(int n, int dst_maxlen) const {
    const int mflimit = n - MFLIMIT;
    const int cap = n - LASTLITERALS;
    const int dst_last1 = dst_maxlen - (1 + LASTLITERALS);
    const int dst_last3 = dst_maxlen - (2 + 1 + LASTLITERALS);
    const unsigned below = (1u << lane) - 1;       // lanes before this one
    int dp = 0, anchor = 0;

    if (n >= MINLENGTH) {
      int p = 1;
      for (;;) {
        // ---- find a match: windows of 32 probes -----------------------
        int attempts = (1 << SKIPSTRENGTH) + 3;
        int ref = 0;
        bool found = false, back = false;
        for (;;) {
          const int pos = p + advance(attempts, lane);
          const bool valid = p + advance(attempts, lane + 1) <= mflimit;
          int bp, bt;
          const uint32_t wp = row.word_before(valid ? pos : p, bp);
          const int h = valid ? hash_of(wp) : -1 - lane;
          const int rt = valid ? tget(h) : 0;
          const uint32_t wt = row.word_before(rt, bt);
          // a slot an earlier lane of the window writes: its position.
          // The lanes on each slot come from a mask a lane sets its bit
          // in: __match_any_sync on 32 distinct keys takes several times
          // as long (tools/parse_clocks.py times both)
          if (valid) atomicOr(&peers[h], 1u << lane);
          __syncwarp();
          const unsigned same = valid ? peers[h] : 1u << lane;
          const unsigned earlier = same & below;
          const int from = earlier ? 31 - __clz(earlier) : lane;
          const int pc = __shfl_sync(FULL, pos, from);
          const uint32_t wc = __shfl_sync(FULL, wp, from);
          const int bc = __shfl_sync(FULL, bp, from);
          const int r = earlier ? pc : rt;
          const bool hit = valid && (small || r >= pos - MAX_DISTANCE) &&
                           (earlier ? wc : wt) == wp;
          // the catch-up's first step, for the lane that matches
          const bool back1 = pos - 1 >= anchor && r >= 1 &&
                             (earlier ? bc : bt) == bp;
          const unsigned hits = __ballot_sync(FULL, hit);
          const unsigned live = __ballot_sync(FULL, valid);
          const unsigned backs = __ballot_sync(FULL, back1);
          // the last lane that inserts: the match, or the last valid one
          const int last = hits ? __ffs(hits) - 1 : 31 - __clz(live);
          const unsigned upto = last < 0 ? 0u : (2u << last) - 1;
          __syncwarp();   // every read of the table before any write
          if (lane <= last && !(same & upto & ~((2u << lane) - 1)))
            tset(h, pos);
          if (valid) peers[h] = 0;
          __syncwarp();
          if (hits) {
            const int f = __ffs(hits) - 1;
            p = __shfl_sync(FULL, pos, f);
            ref = __shfl_sync(FULL, r, f);
            back = (backs >> f) & 1u;
            found = true;
            break;
          }
          if (live != FULL) break;   // the next probe passes mflimit
          p += advance(attempts, 32);
          attempts += 32;
        }
        if (!found) break;

        bool searched = true;
        // the literal run starts at anchor whatever the catch-up finds
        const int lit = row.byte(anchor + lane);
        for (;;) {   // a token: the search's, then each re-match's
          const int end = extend(p + MINMATCH, ref + MINMATCH, cap);
          // the re-match at end: "fill table" at end - 2 first
          int h2 = 0, h = 0, rref = 0;
          bool again = false;
          if (end <= mflimit) {
            h2 = hash_of(row.word(end - 2));
            h = hash_of(row.word(end));
            rref = h == h2 ? end - 2 : tget(h);
            again = (small || rref > end - (MAX_DISTANCE + 1)) &&
                    row.word(rref) == row.word(end);
          }
          if (back) {   // catch up: extend the match backwards
            const int t = 1 + catch_up(row, p - 1, ref - 1, anchor, lane);
            p -= t;
            ref -= t;
            back = false;
          }
          dp = emit(dp, anchor, p - anchor, lit, searched, p - ref,
                    end - p - MINMATCH, dst_last1, dst_last3);
          if (dp < 0) return -1;
          anchor = end;
          if (end > mflimit) break;
          tset(h2, end - 2);   // every lane the same slots and values
          tset(h, end);
          if (!again) {
            p = end + 1;
            break;
          }
          p = end;
          ref = rref;
          searched = false;
        }
        if (anchor > mflimit) break;   // the last match reached mflimit
      }
    }
    return last_literals(dp, anchor, n, dst_maxlen);
  }
};

// ---- the kernels ---------------------------------------------------------

// Both kernels ask for two CTAs an SM: ptxas then gives the parse the
// registers it needs (86, against 48 and 16 bytes of spills without it:
// 3.7% faster on 64 KB blocks).
__global__ void __launch_bounds__(THREADS, 2)
encode_smem_kernel(const uint8_t* __restrict__ src_all,
                   const int* __restrict__ src_len_all,
                   const int* __restrict__ dst_maxlen_all,
                   uint8_t* __restrict__ out_all,
                   int* __restrict__ written_all, int S, int O) {
  extern __shared__ uint4 smem4[];
  uint32_t* table = (uint32_t*)smem4;
  uint32_t* peers = table + TABLE_BYTES / 4;
  uint32_t* sw = peers + PEERS_BYTES / 4;
  uint8_t* sb = (uint8_t*)sw;
  const int b = blockIdx.x, tid = threadIdx.x;
  const int n = clampi(src_len_all[b], 0, S);
  const uint8_t* src = src_all + (size_t)b * S;

  // stage the row: byte i at sb[shift + i], after 16 bytes of zeros and
  // the row's own misalignment, so that its 16-byte aligned chunks land
  // on aligned shared words
  const int mis = (int)((uintptr_t)src & 15);
  const int shift = 16 + mis;
  const int head = min(n, (16 - mis) & 15);        // bytes before chunk 1
  const int chunks = (n + mis) >> 4;               // chunks [1 or 0, this)
  const uint4* src4 = (const uint4*)(src - mis);
  for (int k = (mis ? 1 : 0) + tid; k < chunks; k += THREADS)
    ((uint4*)sb)[k + 1] = src4[k];
  for (int i = tid; i < head; i += THREADS) sb[shift + i] = src[i];
  for (int i = max(head, 16 * chunks - mis) + tid; i < n; i += THREADS)
    sb[shift + i] = src[i];
  for (int i = tid; i < shift; i += THREADS) sb[i] = 0;
  for (int i = tid; i < PAD; i += THREADS) sb[shift + n + i] = 0;
  for (int i = tid; i < (TABLE_BYTES + PEERS_BYTES) / 4; i += THREADS)
    table[i] = 0;
  __syncthreads();
  if (tid >= 32) return;

  uint8_t* out = out_all + (size_t)b * O;
  const int dst_maxlen = dst_maxlen_all[b];
  const int w = WarpParse<StagedRow>{{sw, shift}, table, peers, out, O, tid,
                                     n < LZ4_64KLIMIT}.run(n, dst_maxlen);
  if (tid == 0) written_all[b] = w > O ? -1 : w;
}

__global__ void __launch_bounds__(THREADS, 2)
encode_device_kernel(const uint8_t* __restrict__ src_all,
                     const int* __restrict__ src_len_all,
                     const int* __restrict__ dst_maxlen_all,
                     uint8_t* __restrict__ out_all,
                     int* __restrict__ written_all, int S, int O) {
  extern __shared__ uint4 smem4[];
  uint32_t* table = (uint32_t*)smem4;
  uint32_t* peers = table + TABLE_BYTES / 4;
  const int b = blockIdx.x;
  const int t = threadIdx.x;
  for (int i = t; i < (TABLE_BYTES + PEERS_BYTES) / 16; i += THREADS)
    smem4[i] = make_uint4(0, 0, 0, 0);
  __syncthreads();
  if (t >= 32) return;

  const int n = clampi(src_len_all[b], 0, S);
  const uint8_t* src = src_all + (size_t)b * S;
  const int shift = (int)((uintptr_t)src & 3);
  const DeviceRow row{(const uint32_t*)(src - shift), shift, shift + n - 1};
  const int w = WarpParse<DeviceRow>{row, table, peers,
                                     out_all + (size_t)b * O, O, t,
                                     n < LZ4_64KLIMIT}
                    .run(n, dst_maxlen_all[b]);
  if (t == 0) written_all[b] = w > O ? -1 : w;
}

}  // namespace
}  // namespace lz4t

// The widest row the shared-memory kernel stages on the current device:
// its table, its slot masks, 16 bytes of zeros and up to 15 of
// alignment, the row and PAD zeros, rounded up to 16 bytes, within the
// device's opt-in shared memory a block (S_max = 183,232 bytes on the
// H100).  Wider rows go to the device-memory kernel.
static cudaError_t staged_row_max(int* row_max) {
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  cudaFuncAttributes attr;
  if (err == cudaSuccess)
    err = cudaFuncGetAttributes(&attr, lz4t::encode_smem_kernel);
  if (err != cudaSuccess) return err;
  const int room = optin - (int)attr.sharedSizeBytes - lz4t::TABLE_BYTES -
                   lz4t::PEERS_BYTES;
  *row_max = (room & ~15) - 32 - lz4t::PAD;
  return cudaSuccess;
}

extern "C" int lz4t_encode_sequencer(const void* src, const void* src_len,
                                     const void* dst_maxlen, void* out,
                                     void* written, int B, int S, int O,
                                     void* stream) {
  if (B <= 0) return 0;
  int row_max = 0;
  cudaError_t err = staged_row_max(&row_max);
  if (err != cudaSuccess) return (int)err;
  const bool staged = S <= row_max;
  auto kernel = staged ? lz4t::encode_smem_kernel : lz4t::encode_device_kernel;
  const int smem = lz4t::TABLE_BYTES + lz4t::PEERS_BYTES +
                   (staged ? (S + 32 + lz4t::PAD + 15) & ~15 : 0);
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  // the device-memory kernel's rows are read through L1: the least shared
  // memory that holds its table leaves L1 the rest of the SM's 256 KB
  if (err == cudaSuccess && !staged)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributePreferredSharedMemoryCarveout, 0);
  if (err != cudaSuccess) return (int)err;
  kernel<<<B, lz4t::THREADS, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)src, (const int*)src_len, (const int*)dst_maxlen,
      (uint8_t*)out, (int*)written, S, O);
  return (int)cudaGetLastError();
}

// the widest row the shared-memory kernel takes on the current device,
// into *row_max (an int)
extern "C" int lz4t_encode_sequencer_row_max(void* row_max, void* stream) {
  (void)stream;
  return (int)staged_row_max((int*)row_max);
}
