// resolve_wavefront: per-byte state words -> output bytes.
//
// Replaces the TPU kernel lz4net_tpu/ops/resolve_kernel.py:
// resolve_wavefront (_resolve_kernel).  State words: t0[o] = VFLAG|byte
// for a terminal (literal or dictionary byte), else the match source
// position, which precedes o in the words records_to_state makes.  The
// output is defined chunk by chunk (8 KB chunks, in order, as on the
// TPU): inside a chunk, match nesting collapses by pointer doubling over
// the chunk-local ordinals to each position's in-chunk root; the root's
// word gives the byte, either a terminal or a byte of an earlier chunk
// (the TPU used one-hot matmuls, lane-shuffle select loops and a
// staircase of select loops over bytes packed 4 a word).  Chunks below
// start_chunk hold a pre-resolved prefix and pass through.
//
// Only the last step needs earlier chunks, so every (block, chunk) pair
// has a CTA of its own (B * Dt/8192 CTAs, two on an SM), and the pairs
// collapse in parallel:
//   1. loads and parents: the chunk's 8192 words (int4 loads, 8 a
//      thread) and the in-chunk parent of each position (an ordinal,
//      itself for a root: a terminal, or a word outside the chunk).  In
//      shared memory, and in the thread's registers, each position holds
//      its parent's word index or, for a root, its root word:
//      ROOT|TERM|byte, or ROOT|p for the byte at p in an earlier chunk;
//   2. pointer jumping: each round every position that does not hold a
//      root word yet reads the word of its current target and keeps it,
//      with one barrier a round.  Writes race with reads, but every word
//      a position ever holds is one of its ancestors or its root word,
//      and the barrier makes each round read at least the previous
//      round's words, so the distance still doubles: at most 13 rounds
//      (2^13 = 8192), and a position stops reading once it holds its
//      root word.  A chunk with a forward pointer (words the decoder
//      never makes) runs the plain version's synchronous doubling
//      instead, exactly (14 rounds at most, two barriers each), and
//      clears ok[b] when it does not converge;
//   3. bytes: the chunk waits for chunk j-1 of its block (decoupled
//      look-back: CTAs take chunks in order from a counter, chunk-major,
//      so the CTA it waits on took its ticket B tickets earlier and is
//      running; a CTA never waits on a later one), then reads each
//      earlier-chunk byte from the output row in L2 and writes its bytes
//      with int4 stores;
//   4. publish: the chunk's ready flag, after a fence.  A prefix chunk
//      waits for chunk j-1 too, so a flag covers every earlier chunk.
// Shared memory holds position k's word at slot(k), the four lanes of an
// int4 apart, so that a warp's accesses fall in distinct banks; a
// pointer is held as its target's slot, so a round reads it directly.
//
// What bounds it on the H100: bytes - one int32 read of t0 and one int32
// write per output byte (the bound counts 2 words a position), plus the
// earlier-chunk reads, which hit L2.  The first form (one 1024-thread
// CTA a block, chunks in order) spent 0.60 of its cycles in doubling
// rounds, 0.19 on loads and 0.21 on the terminal reads and stores, all
// nine chunks of a block in series (tools/chunk_clocks.py).  Here a CTA
// spends about a third of its cycles waiting on its loads, a third in
// the rounds (4 on the decode cell's chunks, at most 7) and a fifth on
// the earlier-chunk reads and stores: latency, with two CTAs an SM.
#include "common.cuh"

namespace lz4t {
namespace {

constexpr int THREADS = 1024;
constexpr int CH = 8192;               // chunk, as decode_vector.CH
constexpr int PER = CH / THREADS;      // positions a thread
constexpr int VEC = PER / 4;           // the same, as int4s
constexpr int MAX_ROUNDS = 14;         // the plain version's rounds
constexpr int ROOT = 1 << 30;          // a root word, not an ordinal
constexpr int TERM = 1 << 29;          // root word: the byte in bits 0-7;
                                       // else the position in bits 0-28
constexpr int NAP = 32;                // ns a waiting thread sleeps

// chunk-local position of a thread's item i: int4 i / 4 of the thread
// (the chunk's int4s THREADS apart), lane i % 4
__device__ __forceinline__ int item_pos(int i) {
  return ((i / 4) * THREADS + (int)threadIdx.x) * 4 + i % 4;
}

// the shared-memory word of chunk position k: the four lanes of an int4
// CH / 4 words apart, so that a warp's items (and the consecutive
// sources of a match) fall in distinct banks
__device__ __forceinline__ int slot(int k) {
  return (k & 3) * (CH / 4) + (k >> 2);
}

// in-chunk parent of position k with state word t
__device__ __forceinline__ int parent(int t, int k, int lo) {
  return (t < VFLAG && t >= lo) ? (t - lo < CH - 1 ? t - lo : CH - 1) : k;
}

// the root word of a root whose state word is t
__device__ __forceinline__ int root_word(int t, int lo) {
  if (t >= VFLAG) return ROOT | TERM | ((t - VFLAG) & 0xFF);
  if (lo == 0) return ROOT | TERM;       // no earlier chunk: byte 0
  return ROOT | clampi(t, 0, lo - 1);
}

__global__ void __launch_bounds__(THREADS, 2)
resolve_kernel(const int* __restrict__ t0_all, int* __restrict__ out_all,
               uint8_t* __restrict__ ok, int* __restrict__ next,
               int* __restrict__ ready, int B, int Dt, int start_chunk) {
  __shared__ int n[CH];                  // each position's word, by slot
  __shared__ int s_v;
  if (threadIdx.x == 0) s_v = atomicAdd(next, 1);
  __syncthreads();
  const int nch = Dt / CH;
  const int j = s_v / B, b = s_v % B;    // chunk-major tickets
  const int lo = j * CH;
  const int* t0c = t0_all + (size_t)b * Dt + lo;
  const int* row = out_all + (size_t)b * Dt;
  int4* out = reinterpret_cast<int4*>(out_all + (size_t)b * Dt + lo);
  int* flag = ready + (size_t)b * nch + j;
  const bool prefix = j < start_chunk;

  // ---- 1. loads and parents ---------------------------------------------
  // a root's word is its root word; another position's, its parent's slot
  int v[PER], fwd = 0;
#pragma unroll
  for (int q = 0; q < VEC; ++q) {
    const int4 w = __ldg(reinterpret_cast<const int4*>(t0c) + q * THREADS +
                         threadIdx.x);
    const int t[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = 4 * q + e, k = item_pos(i);
      const int p = parent(t[e], k, lo);
      fwd |= !prefix && p > k;
      v[i] = prefix ? ROOT | TERM | (t[e] & 0xFF)       // passes through
             : p == k ? root_word(t[e], lo) : slot(p);
      n[slot(k)] = v[i];
    }
  }
  if (!__syncthreads_or(fwd)) {

  // ---- 2. pointer jumping -----------------------------------------------
    for (int pending = !prefix; pending;) {
      int all = ROOT;
#pragma unroll
      for (int i = 0; i < PER; ++i) {
        if (!(v[i] & ROOT)) {
          v[i] = n[v[i]];
          n[slot(item_pos(i))] = v[i];
        }
        all &= v[i];
      }
      pending = __syncthreads_or(!(all & ROOT));
    }
  } else {                               // a forward pointer: the plain rule
#pragma unroll
    for (int i = 0; i < PER; ++i)
      n[slot(item_pos(i))] = parent(__ldg(t0c + item_pos(i)), item_pos(i),
                                    lo);
    __syncthreads();
    int changed = 1;
    for (int r = 0; r < MAX_ROUNDS && changed; ++r) {
      int nn[PER];
#pragma unroll
      for (int i = 0; i < PER; ++i) nn[i] = n[slot(n[slot(item_pos(i))])];
      __syncthreads();                   // all reads of this round done
      int mine = 0;
#pragma unroll
      for (int i = 0; i < PER; ++i) {
        mine |= nn[i] != n[slot(item_pos(i))];
        n[slot(item_pos(i))] = nn[i];
      }
      changed = __syncthreads_or(mine);
    }
    if (changed && threadIdx.x == 0) ok[b] = 0;
#pragma unroll
    for (int i = 0; i < PER; ++i)
      v[i] = root_word(__ldg(t0c + n[slot(item_pos(i))]), lo);
  }

  // ---- 3. bytes ---------------------------------------------------------
  if (j > 0) {                           // chunk j-1, so every earlier one
    if (threadIdx.x == 0) {
      while (*(volatile int*)(flag - 1) == 0) __nanosleep(NAP);
      __threadfence();
    }
    __syncthreads();
  }
#pragma unroll
  for (int q = 0; q < VEC; ++q) {
    int r[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int w = v[4 * q + e];
      r[e] = (w & TERM) ? (w & 0xFF) : __ldcg(row + (w & (TERM - 1)));
    }
    out[q * THREADS + threadIdx.x] = make_int4(r[0], r[1], r[2], r[3]);
  }

  // ---- 4. publish -------------------------------------------------------
  __syncthreads();                       // every store of the chunk issued
  if (threadIdx.x == 0) {
    __threadfence();
    atomicExch(flag, 1);
  }
}

}  // namespace
}  // namespace lz4t

// scratch (ops/resolve_kernel.py sizes it): the ticket counter, then the
// ready flags [B, Dt / 8192]; both zeroed here, and ok set to 1.
extern "C" int lz4t_resolve_wavefront(const void* t0, void* out, void* ok,
                                      void* scratch, int B, int Dt,
                                      int start_chunk, void* stream) {
  if (B <= 0) return 0;
  if (Dt < 0 || Dt % lz4t::CH) return (int)cudaErrorInvalidValue;
  const int nch = Dt / lz4t::CH;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(ok, 1, (size_t)B, s);
  if (err == cudaSuccess)
    err = cudaMemsetAsync(scratch, 0, (1 + (size_t)B * nch) * 4, s);
  if (err != cudaSuccess || nch == 0) return (int)err;
  int* words = (int*)scratch;
  lz4t::resolve_kernel<<<B * nch, lz4t::THREADS, 0, s>>>(
      (const int*)t0, (int*)out, (uint8_t*)ok, words, words + 1, B, Dt,
      start_chunk);
  return (int)cudaGetLastError();
}
