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
// Two kernels, chosen by the row widths in one launch:
//
// * output rows up to staged_row_max (167,072 bytes on the H100; the
//   compressed row up to LZ4's worst case for it): one CTA of nine warps a
//   block decodes into a shared-memory copy of its output row.  The serial
//   walk (one token after another, 11,290 on the cell's slowest block) is
//   cut as parse_kernel.cu cuts it, and the copies run a token a lane:
//   - eight warps (the parse group) first build the row's 0xFF mask below
//     comp_len and, for each 32-bit word, the next word with a clear bit,
//     so a 255-extension's end is two shared reads away anywhere in the
//     row.  Then tiles of 1024 compressed positions, in order, from the
//     walk's next token (tiles it skips are never read): every position
//     parses a token as if one started there (the literal run, the
//     offset's place, the match length, the next token; exact, not
//     clamped); warp exits by pointer doubling with shuffles; one thread
//     hops over the exits from the carried token (at most 32 hops a tile);
//     each warp marks its segments' tokens with shuffles; scans over the
//     tile give each token its index and its dp.  Then every token checks
//     the sequential walk's rules at once, and the first that stops (a
//     fault, or the literals that reach out_len) ends the walk: its status
//     is written, and later tokens are dropped.  The group copies the
//     tile's literal runs into the row (a warp a run, runs of 512 bytes or
//     more by the whole group) and hands the tile's matches (output start,
//     offset, length, the end of their sources) to the match warp through
//     a double buffer in shared memory.
//   - the match warp copies each tile's matches in order.  Byte k of a
//     match is row[dp - offset + k % offset], below dp, so a match needs
//     only bytes that earlier tokens wrote.  The next matches whose
//     sources all lie below the first one's output copy at once, a lane
//     each, four loads then four stores; a match longer than 64 bytes
//     takes the warp, 32 bytes a step with k % offset advanced by
//     32 % offset (a table below 32), and no division a byte.
//   - the row was zeroed first and is written once at the end by every
//     warp, 16-byte stores, so it is zero past dp.  Row b starts at b * D,
//     which need not be 16-byte aligned: the shared copy starts at the
//     same offset mod 16, so the same chunks are aligned in both.
//   A 64 KB row, its mask and next-word table take 81 KB beside 23 KB of
//   static shared memory, so two CTAs share an SM and a 256-block batch
//   runs in one wave.
// * wider rows: one warp a block walks the tokens in step (the same loads,
//   broadcast to the warp) and copies 32 bytes a step in device memory;
//   a match byte k is out[dp - offset + k % offset], so one __syncwarp()
//   after each copy orders it; then zeros over the rest of the row (the
//   first port of this kernel, unchanged).
//
// What bounds it on the H100: the bytes bound (compressed bytes read once,
// output written once; 0.0079 ms for the sequencer-decode cell, PERF.md
// section 6) is far below the kernel.  What is left serial is the hops
// (one a segment the walk enters) and the match warp's steps (a group of
// independent matches, or one long match, a step); the clock marks of
// tools/decode_clocks.py show the match warp busy for most of the kernel
// and the parse group waiting for it about a third of the time.  PERF.md
// gives the times of this design, of the first one (one warp walking in
// device memory) and of a parser warp and a copier warp that took one
// token a step each (2.9 ms).
#include "common.cuh"

namespace lz4t {
namespace {

constexpr int WARP = 32;
constexpr int COPYLENGTH = 8;
constexpr int LASTLITERALS = 5;
constexpr unsigned FULL = 0xffffffffu;
constexpr int PWARPS = 8;                   // the parse group
constexpr int PTHREADS = PWARPS * WARP;
constexpr int THREADS = PTHREADS + WARP;    // and the match warp
constexpr int ITEMS = 4;
constexpr int TILE = PTHREADS * ITEMS;      // compressed positions a tile
constexpr int SEGS = TILE / WARP;
constexpr int TOKMAX = TILE / 3 + 1;        // tokens step 3 bytes or more
constexpr int LONG_LIT = 512;               // copied by the whole group
constexpr int NAP = 64;                     // ns a waiting thread sleeps
constexpr int LANE_MATCH = 64;              // longer matches take the warp

__device__ __forceinline__ int ld_volatile(const int* p) {
  return *(const volatile int*)p;
}

__device__ __forceinline__ void st_volatile(int* p, int v) {
  *(volatile int*)p = v;
}

__device__ __forceinline__ void group_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(PTHREADS) : "memory");
}

// the first position at or after p whose mask bit is clear (not a 0xFF
// byte below lim), by the word's bits and then the next word with a clear
// bit; the mask's end (>= lim) if none
__device__ __forceinline__ int run_end(const uint32_t* mask,
                                       const int* nclear, int W, int p) {
  int w = p >> 5;
  if (w >= W) return W << 5;
  uint32_t m = ~mask[w] & (FULL << (p & 31));
  if (m == 0) {
    w = w + 1 < W ? nclear[w + 1] : W;
    if (w >= W) return W << 5;
    m = ~mask[w];
  }
  return (w << 5) + __ffs(m) - 1;
}

// ---- rows up to staged_row_max: a parse group and a match warp --------

struct Shared {
  int exit[TILE];              // segment exit of each tile position
  int entry[SEGS];             // the walk's first token in each segment
  int scan_n[SEGS], scan_s[SEGS];   // segment totals, then their prefixes
  int wmin[PWARPS];
  int4 lits[TOKMAX];           // (src, lit, dst): this tile's literal runs
  int longs[TOKMAX];           // the runs of LONG_LIT bytes or more
  int4 matches[2][TOKMAX];     // (end, offset, mlen, sources' end), by
                               // tile parity
  int nmatch[2], last[2];
  int ntok, nlong, stop_pos, carry, dp, tot_n, tot_s, wcarry;
  int ready, done;             // tiles published, tiles matched
  uint8_t mod[32 * 33];        // mod[o * 33 + x] = x % o, o < 32
};

__global__ void __launch_bounds__(THREADS)
decode_smem_kernel(const uint8_t* __restrict__ comp_all,
                   const int* __restrict__ comp_len_all,
                   const int* __restrict__ out_len_all,
                   uint8_t* __restrict__ out_all,
                   int* __restrict__ status_all, int C, int D) {
  extern __shared__ uint4 smem4[];   // the output row, mask, nclear
  __shared__ Shared sh;

  const int b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & (WARP - 1), warp = tid / WARP;
  const uint8_t* comp = comp_all + (size_t)b * C;
  uint8_t* out = out_all + (size_t)b * D;
  const int mis = (int)((uintptr_t)out & 15);
  uint8_t* row = (uint8_t*)smem4 + mis;   // row[j] and out[j] agree mod 16
  const int row_bytes = (D + 31) & ~15;
  const int W = (C + 31) / 32;
  uint32_t* mask = (uint32_t*)((uint8_t*)smem4 + row_bytes);
  int* nclear = (int*)(mask + W);
  const int lim = clampi(comp_len_all[b], 0, C);
  const int out_len = out_len_all[b];

  for (int i = tid; i < row_bytes >> 4; i += THREADS)
    smem4[i] = make_uint4(0, 0, 0, 0);
  for (int i = 33 + tid; i < 32 * 33; i += THREADS)
    sh.mod[i] = (i % 33) % (i / 33);
  if (tid == 0) {
    sh.ready = sh.done = 0;
    sh.carry = sh.dp = 0;
    sh.wcarry = W;
  }
  __syncthreads();

  if (tid < PTHREADS) {
    // ---- the 0xFF mask below lim, and the next clear word of each word ---
    for (int q = tid; q < W * 32; q += PTHREADS) {
      const unsigned m = __ballot_sync(FULL, q < lim && comp[q] == 255);
      if (lane == 0) mask[q >> 5] = m;
    }
    group_sync();
    for (int base = (W - 1) / PTHREADS * PTHREADS; base >= 0;
         base -= PTHREADS) {
      const int w = base + tid;
      int v = w < W && mask[w] != FULL ? w : W;
      for (int o = 1; o < WARP; o <<= 1) {      // suffix min in the warp
        const int u = __shfl_down_sync(FULL, v, o);
        v = lane + o < WARP && u < v ? u : v;
      }
      if (lane == 0) sh.wmin[warp] = v;
      group_sync();
      int later = sh.wcarry;
      for (int j = warp + 1; j < PWARPS; ++j) later = min(later, sh.wmin[j]);
      if (w < W) nclear[w] = min(v, later);
      group_sync();
      if (tid == 0) sh.wcarry = min(later, sh.wmin[0]);
      group_sync();
    }

    // ---- tiles of positions, in order, from the walk's next token ----------
    for (int t = 0;; ++t) {
      const int carry = sh.carry, dp0 = sh.dp;
      int ntok = 0;
      bool stopped = out_len <= 0 || carry >= lim;
      const bool tiled = !stopped;
      if (stopped) {               // no token: out_len reached, or a read at lim
        if (tid == 0) {
          status_all[2 * b] = out_len <= 0 ? 0 : -1;
          status_all[2 * b + 1] = dp0;
        }
      } else {
        const int t0 = carry / TILE * TILE;
        // 1. each position's token, as if one started there: the literal
        // run, the offset's position, the match length and the next token
        int lit[ITEMS], src[ITEMS], op[ITEMS], mlen[ITEMS], g[ITEMS];
        bool ok[ITEMS];
#pragma unroll
        for (int k = 0; k < ITEMS; ++k) {
          const int s0 = t0 + k * PTHREADS + warp * WARP;
          const int q = s0 + lane;
          const int c = q < lim ? comp[q] : 0;
          lit[k] = c >> 4;
          src[k] = q + 1;
          ok[k] = true;
          if (lit[k] == 15) {
            const int e = run_end(mask, nclear, W, q + 1);
            ok[k] = e < lim;
            lit[k] = ok[k] ? 15 + 255 * (e - q - 1) + comp[e] : 0;
            src[k] = ok[k] ? e + 1 : lim;
          }
          op[k] = src[k] + lit[k];
          mlen[k] = (c & 15) + 4;
          int nxt = op[k] + 2;
          if ((c & 15) == 15) {
            const int e = run_end(mask, nclear, W, nxt);
            if (e < lim) {
              mlen[k] = 19 + 255 * (e - nxt) + comp[e];
              nxt = e + 1;
            } else {
              mlen[k] = -1;        // its length runs past lim
            }
          }
          g[k] = nxt < q + 3 ? q + 3 : nxt;
          // 2. segment exits: the first token at or past the segment's end
          int h = g[k];
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const bool in = h < s0 + WARP;
            const int nx = __shfl_sync(FULL, h, in ? h - s0 : lane);
            h = in ? nx : h;
          }
          sh.exit[q - t0] = h;
        }
        if (tid < SEGS) sh.entry[tid] = -1;
        if (tid == 0) {
          sh.stop_pos = 0x7fffffff;
          sh.nlong = 0;
        }
        group_sync();
        // 3. the walk's entries into the tile's segments, and its next token
        if (tid == 0) {
          int pos = carry;
          while (pos < t0 + TILE) {
            sh.entry[(pos - t0) >> 5] = pos;
            pos = sh.exit[pos - t0];
          }
          sh.carry = pos;
        }
        group_sync();
        // 4. tokens: marks by shuffles inside each segment, their order and
        // dp by scans over the tile, then every check of the sequential walk
        int tok[ITEMS], idx[ITEMS], dpi[ITEMS];
#pragma unroll
        for (int k = 0; k < ITEMS; ++k) {
          const int s0 = t0 + k * PTHREADS + warp * WARP;
          int p = sh.entry[(s0 - t0) >> 5];
          unsigned bits = 0;
          if (p >= 0) {
            for (;;) {
              bits |= 1u << (p - s0);
              const int nx = __shfl_sync(FULL, g[k], p - s0);
              if (nx >= s0 + WARP) break;
              p = nx;
            }
          }
          tok[k] = (bits >> lane) & 1;
          int n = tok[k], s = tok[k] ? lit[k] + mlen[k] : 0;
          for (int o = 1; o < WARP; o <<= 1) {
            const int un = __shfl_up_sync(FULL, n, o);
            const int us = __shfl_up_sync(FULL, s, o);
            if (lane >= o) {
              n += un;
              s += us;
            }
          }
          idx[k] = n - tok[k];     // within the segment, so far
          dpi[k] = s - (tok[k] ? lit[k] + mlen[k] : 0);
          if (lane == WARP - 1) {
            sh.scan_n[k * PWARPS + warp] = n;
            sh.scan_s[k * PWARPS + warp] = s;
          }
        }
        group_sync();
        if (warp == 0) {
          int n = sh.scan_n[lane], s = sh.scan_s[lane];
          for (int o = 1; o < WARP; o <<= 1) {
            const int un = __shfl_up_sync(FULL, n, o);
            const int us = __shfl_up_sync(FULL, s, o);
            if (lane >= o) {
              n += un;
              s += us;
            }
          }
          sh.scan_n[lane] = n - sh.scan_n[lane];
          sh.scan_s[lane] = s - sh.scan_s[lane];
          if (lane == WARP - 1) {
            sh.tot_n = n;
            sh.tot_s = s;
          }
        }
        group_sync();
        int why[ITEMS], offset[ITEMS];
#pragma unroll
        for (int k = 0; k < ITEMS; ++k) {
          const int q = t0 + k * PTHREADS + warp * WARP + lane;
          idx[k] += sh.scan_n[k * PWARPS + warp];
          dpi[k] += dp0 + sh.scan_s[k * PWARPS + warp];
          // 0 go on; 1 fault at dp; 2 fault after the literals; 3 the end
          why[k] = 0;
          offset[k] = 0;
          if (tok[k]) {
            const int end = dpi[k] + lit[k];
            if (q >= lim || !ok[k] || src[k] + lit[k] > lim || end > D ||
                (end > out_len - COPYLENGTH && end != out_len)) {
              why[k] = 1;
            } else if (end >= out_len) {
              why[k] = 3;
            } else if (op[k] + 2 > lim || mlen[k] < 0) {
              why[k] = 2;
            } else {
              offset[k] = comp[op[k]] | (comp[op[k] + 1] << 8);
              if (offset[k] == 0 || offset[k] > end ||
                  end + mlen[k] > D || end + mlen[k] > out_len - LASTLITERALS)
                why[k] = 2;
            }
            if (why[k]) atomicMin(&sh.stop_pos, q);
          }
        }
        if (tid == 0) {            // the previous use of this match buffer
          while (ld_volatile(&sh.done) < t - 1) __nanosleep(NAP);
        }
        group_sync();
        const int stop_pos = sh.stop_pos;
        stopped = stop_pos != 0x7fffffff;
        // 5. this tile's literal runs and matches, up to the walk's end
#pragma unroll
        for (int k = 0; k < ITEMS; ++k) {
          const int q = t0 + k * PTHREADS + warp * WARP + lane;
          if (tok[k] && q <= stop_pos) {
            const int end = dpi[k] + lit[k];
            const bool lits_ok = why[k] != 1;
            sh.lits[idx[k]] = make_int4(src[k], lits_ok ? lit[k] : 0,
                                        dpi[k], 0);
            if (lits_ok && lit[k] >= LONG_LIT)
              sh.longs[atomicAdd(&sh.nlong, 1)] = idx[k];
            const int ml = why[k] ? 0 : mlen[k];
            sh.matches[t & 1][idx[k]] = make_int4(
                end, offset[k], ml, ml ? end - offset[k] + min(ml, offset[k])
                                       : 0);
            if (q == stop_pos) {
              sh.ntok = idx[k] + 1;
              status_all[2 * b] = why[k] == 3 ? src[k] + lit[k] : -1;
              status_all[2 * b + 1] = why[k] == 1 ? dpi[k] : end;
            }
          }
        }
        if (!stopped && tid == 0) sh.ntok = sh.tot_n;
        group_sync();
        ntok = sh.ntok;
        // the short runs a warp each, the long ones by the whole group
        for (int i = warp; i < ntok; i += PWARPS) {
          const int4 l = sh.lits[i];
          if (l.y < LONG_LIT)
            for (int k = lane; k < l.y; k += WARP) row[l.z + k] = comp[l.x + k];
        }
        for (int j = 0; j < sh.nlong; ++j) {
          const int4 l = sh.lits[sh.longs[j]];
          for (int k = tid; k < l.y; k += PTHREADS) row[l.z + k] = comp[l.x + k];
        }
        group_sync();
      }
      if (tid == 0) {
        if (!tiled)                // the buffer's previous tile matched
          while (ld_volatile(&sh.done) < t - 1) __nanosleep(NAP);
        sh.nmatch[t & 1] = ntok;
        sh.last[t & 1] = stopped;
        sh.dp = dp0 + sh.tot_s;
        __threadfence_block();     // the row and the matches before the count
        st_volatile(&sh.ready, t + 1);
      }
      group_sync();
      if (stopped) break;
    }
  } else {
    // ---- the match warp: each tile's matches in order, in the row --------
    for (int t = 0;; ++t) {
      if (lane == 0)
        while (ld_volatile(&sh.ready) <= t) __nanosleep(NAP);
      __syncwarp(FULL);
      __threadfence_block();
      const int n = ld_volatile(&sh.nmatch[t & 1]);
      const bool last = ld_volatile(&sh.last[t & 1]);
      const int4* mt = sh.matches[t & 1];
      for (int i = 0; i < n;) {
        // the next matches whose sources lie below match i's output (all
        // final) copy at once, a lane each; a long one takes the warp
        const int4 m = i + lane < n ? mt[i + lane] : make_int4(0, 1, 0, 0);
        const int start = __shfl_sync(FULL, m.x, 0);
        const unsigned ok = __ballot_sync(
            FULL, i + lane < n && m.z <= LANE_MATCH && m.w <= start);
        const int len = ~ok ? __ffs(~ok) - 1 : WARP;
        if (len == 0) {
          const int dp = m.x, offset = m.y, mlen = m.z;
          const int4 m0 = make_int4(__shfl_sync(FULL, dp, 0),
                                    __shfl_sync(FULL, offset, 0),
                                    __shfl_sync(FULL, mlen, 0), 0);
          // byte k is row[base + k % offset], below dp: no hazard, and
          // k % offset advances by 32 % offset a step
          const int base = m0.x - m0.y;
          const bool near = m0.y < WARP;
          int r = near ? sh.mod[m0.y * 33 + lane] : lane;
          const int step = near ? sh.mod[m0.y * 33 + WARP]
                                : (m0.y == WARP ? 0 : WARP);
          auto next = [&](int x) {
            x += step;
            return x >= m0.y ? x - m0.y : x;
          };
          int k = lane;
          for (; k + 3 * WARP < m0.z; k += 4 * WARP) {
            const int r1 = next(r), r2 = next(r1), r3 = next(r2);
            const uint8_t b0 = row[base + r], b1 = row[base + r1];
            const uint8_t b2 = row[base + r2], b3 = row[base + r3];
            row[m0.x + k] = b0;
            row[m0.x + k + WARP] = b1;
            row[m0.x + k + 2 * WARP] = b2;
            row[m0.x + k + 3 * WARP] = b3;
            r = next(r3);
          }
          for (; k < m0.z; k += WARP) {
            row[m0.x + k] = row[base + r];
            r = next(r);
          }
          i += 1;
        } else {
          if (lane < len && m.z > 0) {
            // byte k is row[base + k % offset], below dp: four loads, then
            // four stores
            const int base = m.x - m.y;
            int r = 0, k = 0;
            for (; k + 4 <= m.z; k += 4) {
              const int r1 = r + 1 == m.y ? 0 : r + 1;
              const int r2 = r1 + 1 == m.y ? 0 : r1 + 1;
              const int r3 = r2 + 1 == m.y ? 0 : r2 + 1;
              const uint8_t b0 = row[base + r], b1 = row[base + r1];
              const uint8_t b2 = row[base + r2], b3 = row[base + r3];
              row[m.x + k] = b0;
              row[m.x + k + 1] = b1;
              row[m.x + k + 2] = b2;
              row[m.x + k + 3] = b3;
              r = r3 + 1 == m.y ? 0 : r3 + 1;
            }
            for (; k < m.z; ++k) {
              row[m.x + k] = row[base + r];
              r = r + 1 == m.y ? 0 : r + 1;
            }
          }
          i += len;
        }
        __syncwarp(FULL);          // these bytes before the next matches
      }
      __syncwarp(FULL);
      if (lane == 0) st_volatile(&sh.done, t + 1);
      if (last) break;
    }
  }
  __syncthreads();

  // ---- the row, once: bytes up to 16-byte alignment, chunks, the tail ---
  const int head = min((16 - mis) & 15, D);
  const int body_end = head + ((D - head) & ~15);
  for (int j = tid; j < head; j += THREADS) out[j] = row[j];
  for (int j = head + 16 * tid; j < body_end; j += 16 * THREADS)
    *(uint4*)(out + j) = *(const uint4*)(row + j);
  for (int j = body_end + tid; j < D; j += THREADS) out[j] = row[j];
}

// ---- wider rows: one warp's walk in device memory ------------------------

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

// Shared memory the staged kernel needs beyond its static part: the output
// row, up to 15 bytes of alignment and 16 of slack, rounded to 16 bytes,
// and two words a 32 compressed bytes (the 0xFF mask and its next clear
// words).
static int staged_bytes(int C, int D) {
  return ((D + 31) & ~15) + 8 * ((C + 31) / 32);
}

// The room for them on the current device, and the widest output row (D)
// the staged kernel takes: with its compressed row at LZ4's worst case
// (D + D / 255 + 16 bytes), it fits the device's opt-in shared memory a
// block.  Wider rows, or compressed rows past that room, go to the
// one-warp kernel.
static cudaError_t staged_room(int* room, int* row_max) {
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  cudaFuncAttributes attr;
  if (err == cudaSuccess)
    err = cudaFuncGetAttributes(&attr, lz4t::decode_smem_kernel);
  if (err != cudaSuccess) return err;
  *room = optin - (int)attr.sharedSizeBytes;
  int lo = 0, hi = *room;          // staged_bytes grows with D
  while (lo < hi) {
    const int mid = lo + (hi - lo + 1) / 2;
    if (staged_bytes(mid + mid / 255 + 16, mid) <= *room) lo = mid;
    else hi = mid - 1;
  }
  *row_max = lo;
  return cudaSuccess;
}

extern "C" int lz4t_decode_sequencer(const void* comp, const void* comp_len,
                                     const void* out_len, void* out,
                                     void* status, int B, int C, int D,
                                     void* stream) {
  if (B <= 0) return 0;
  int room = 0, row_max = 0;
  cudaError_t err = staged_room(&room, &row_max);
  if (err != cudaSuccess) return (int)err;
  const int smem = staged_bytes(C, D);
  if (D > row_max || smem > room) {
    lz4t::decode_sequencer_kernel<<<B, lz4t::WARP, 0,
                                    (cudaStream_t)stream>>>(
        (const uint8_t*)comp, (const int*)comp_len, (const int*)out_len,
        (uint8_t*)out, (int*)status, C, D);
    return (int)cudaGetLastError();
  }
  err = cudaFuncSetAttribute(lz4t::decode_smem_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return (int)err;
  lz4t::decode_smem_kernel<<<B, lz4t::THREADS, smem,
                             (cudaStream_t)stream>>>(
      (const uint8_t*)comp, (const int*)comp_len, (const int*)out_len,
      (uint8_t*)out, (int*)status, C, D);
  return (int)cudaGetLastError();
}

// the widest output row the shared-memory kernel takes on the current
// device, into *row_max (an int)
extern "C" int lz4t_decode_sequencer_row_max(void* row_max, void* stream) {
  (void)stream;
  int room = 0;
  return (int)staged_room(&room, (int*)row_max);
}
