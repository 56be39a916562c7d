"""Where the cycles of the sequencer decoder's shared-memory kernel go, on
the card.

    python3 -m lz4net_tpu_torch.tools.decode_clocks     # repository root

Copies ``csrc/decode_sequencer.cu`` with marks of ``clock64()`` put into
its shared-memory kernel (``MARKS`` below: thread 0 of the parse group
and lane 0 of the match warp add the cycles between marks, and counts,
to a device array), builds the copy alone into its own library beside
the port's build, decodes the 16 MB silesia-like corpus (seed 0) in 256
blocks of 64 KB, compressed by the port's strict encoder (the reference
compressor's bytes), checks every row and status against the port's own
kernel, and prints, for the mean block and the slowest one, the parse
group's cycles (the 0xFF mask and its next-word table, the tiles, the
waits for the match warp) and the match warp's (its waits for tiles, its
steps: a group of matches copied a lane each, or one long match), with
the counts behind them, and the kernel times of both builds (CUDA
events).  The marks cost time of their own: compare the two times.  The
port's own source carries no marks; a mark whose place in it is not
found once stops the tool.
"""

from __future__ import annotations

import ctypes
import os
import statistics
import subprocess

import numpy as np
import torch

from .. import _build
from ..models import cuda as cuda_engine
from ..ops import decode_sequencer as ds
from ..utils import corpus

# Row k of g_decode_clocks
NAMES = ("parse: mask and next-word table", "parse: waits for the match "
         "warp", "tiles", "parse: tiles", "match warp: waits for tiles",
         "match steps", "matches in them", "long matches (the warp's)",
         "match warp: all")
NCLK = 16

PRELUDE = """
namespace lz4t {
constexpr int NCLK = 16;
constexpr int CLK_BLOCKS = 8192;
__device__ unsigned long long g_decode_clocks[CLK_BLOCKS * NCLK];
}
// thread 0 (the parse group's) and thread 256 (the match warp's lane 0)
#define CLK_ADD(k, v)                                                  \\
  do {                                                                 \\
    if ((threadIdx.x & 255) == 0 && blockIdx.x < lz4t::CLK_BLOCKS)     \\
      atomicAdd(&lz4t::g_decode_clocks[blockIdx.x * lz4t::NCLK + (k)], \\
                (unsigned long long)(v));                              \\
  } while (0)
#define CLK_START long long clk_t_ = clock64();
#define CLK(k)                         \\
  do {                                 \\
    const long long t_ = clock64();    \\
    CLK_ADD(k, t_ - clk_t_);           \\
    clk_t_ = t_;                       \\
  } while (0)
"""

EPILOGUE = """
// zero the clocks, and read them back as [blocks, 16] uint64
extern "C" int lz4t_decode_clocks_reset(void* stream) {
  void* p = nullptr;
  cudaError_t err = cudaGetSymbolAddress(&p, lz4t::g_decode_clocks);
  if (err == cudaSuccess)
    err = cudaMemsetAsync(p, 0, sizeof(lz4t::g_decode_clocks),
                          (cudaStream_t)stream);
  return (int)err;
}

extern "C" int lz4t_decode_clocks_read(void* dst, int blocks,
                                       void* stream) {
  return (int)cudaMemcpyFromSymbolAsync(
      dst, lz4t::g_decode_clocks,
      sizeof(unsigned long long) * lz4t::NCLK * blocks, 0,
      cudaMemcpyDeviceToHost, (cudaStream_t)stream);
}
"""

# (text of the source, the same text with its marks); each text occurs
# once in the source
MARKS = [
    ('#include "common.cuh"\n', '#include "common.cuh"\n' + PRELUDE),
    ("  if (tid < PTHREADS) {\n    // ---- the 0xFF mask",
     "  if (tid < PTHREADS) {\n    CLK_START\n    // ---- the 0xFF mask"),
    ("    // ---- tiles of positions, in order",
     "    CLK(0);\n    // ---- tiles of positions, in order"),
    ("        const int t0 = carry / TILE * TILE;\n",
     "        const int t0 = carry / TILE * TILE;\n        CLK_ADD(2, 1);\n"),
    ("        if (tid == 0) {            // the previous use of this match "
     "buffer\n          while (ld_volatile(&sh.done) < t - 1) "
     "__nanosleep(NAP);\n        }\n",
     "        if (tid == 0) {            // the previous use of this match "
     "buffer\n          const long long w_ = clock64();\n"
     "          while (ld_volatile(&sh.done) < t - 1) __nanosleep(NAP);\n"
     "          CLK_ADD(1, clock64() - w_);\n        }\n"),
    ("      group_sync();\n      if (stopped) break;\n    }\n",
     "      group_sync();\n      if (stopped) break;\n    }\n    CLK(3);\n"),
    ("  } else {\n    // ---- the match warp",
     "  } else {\n    CLK_START\n    // ---- the match warp"),
    ("      if (lane == 0)\n        while (ld_volatile(&sh.ready) <= t) "
     "__nanosleep(NAP);\n",
     "      const long long w_ = clock64();\n      if (lane == 0)\n"
     "        while (ld_volatile(&sh.ready) <= t) __nanosleep(NAP);\n"
     "      CLK_ADD(4, clock64() - w_);\n"),
    ("        const int len = ~ok ? __ffs(~ok) - 1 : WARP;\n",
     "        const int len = ~ok ? __ffs(~ok) - 1 : WARP;\n"
     "        CLK_ADD(5, 1);\n        CLK_ADD(6, len ? len : 1);\n"
     "        CLK_ADD(7, len == 0);\n"),
    ("      if (last) break;\n    }\n",
     "      if (last) break;\n    }\n    CLK(8);\n"),
]


def clocked_source() -> str:
    """``decode_sequencer.cu`` with the marks and the clocks' reset and
    read entries."""
    with open(os.path.join(_build.CSRC, "decode_sequencer.cu")) as fh:
        src = fh.read()
    for old, new in MARKS:
        if src.count(old) != 1:
            raise SystemExit("decode_clocks: the place of a mark is not "
                             f"found once in decode_sequencer.cu: {old!r}")
        src = src.replace(old, new)
    return src + EPILOGUE


def build() -> ctypes.CDLL:
    """The sequencer decoder with clocks, in its own library beside the
    port's build."""
    out_dir = os.path.join(_build.BUILD_DIR, "dclocks-" + _build._digest())
    lib = os.path.join(out_dir, "liblz4t_dclocks.so")
    if not os.path.exists(lib):
        os.makedirs(out_dir, exist_ok=True)
        clocked = os.path.join(out_dir, "decode_sequencer_clocks.cu")
        with open(clocked, "w") as fh:
            fh.write(clocked_source())
        subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I",
                        _build.CSRC, "-shared", clocked, "-o", lib],
                       check=True)
    dll = ctypes.CDLL(lib)
    P, I = ctypes.c_void_p, ctypes.c_int
    dll.lz4t_decode_sequencer.argtypes = [P] * 5 + [I] * 3 + [P]
    dll.lz4t_decode_clocks_reset.argtypes = [P]
    dll.lz4t_decode_clocks_read.argtypes = [P, I, P]
    for fn in (dll.lz4t_decode_sequencer, dll.lz4t_decode_clocks_reset,
               dll.lz4t_decode_clocks_read):
        fn.restype = ctypes.c_int
    return dll


def _check(rc, what):
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc}")


def event_ms(fn, inner=10, reps=5):
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / inner)
    return statistics.median(times)


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("decode_clocks: needs a CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card)
    dll = build()
    blocks = corpus.split_blocks(corpus.silesia_like(16 << 20, seed=0),
                                 1 << 16)
    packed = cuda_engine.compress_blocks(blocks, device="cuda")
    B, C = len(packed), max(map(len, packed))
    D = max(map(len, blocks))
    comp = np.zeros((B, C), np.uint8)
    for j, blk in enumerate(packed):
        comp[j, :len(blk)] = np.frombuffer(blk, np.uint8)
    comp = torch.from_numpy(comp).cuda()
    comp_len = torch.tensor([len(b) for b in packed], dtype=torch.int32,
                            device="cuda")
    out_len = torch.tensor([len(b) for b in blocks], dtype=torch.int32,
                           device="cuda")
    out = torch.empty((B, D), dtype=torch.uint8, device="cuda")
    status = torch.empty((B, 2), dtype=torch.int32, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream

    def clocked():
        _check(dll.lz4t_decode_sequencer(
            comp.data_ptr(), comp_len.data_ptr(), out_len.data_ptr(),
            out.data_ptr(), status.data_ptr(), B, C, D, stream),
            "decode_sequencer")

    want_out, want_status = ds.decode_sequencer(comp, comp_len, out_len, D)
    _check(dll.lz4t_decode_clocks_reset(stream), "reset")
    clocked()
    rows = np.zeros((B, NCLK), np.uint64)
    _check(dll.lz4t_decode_clocks_read(rows.ctypes.data, B, stream), "read")
    torch.cuda.synchronize()
    if not torch.equal(out, want_out) or not torch.equal(status,
                                                          want_status):
        raise SystemExit("decode_clocks: rows differ from the kernel's")

    rows = rows.astype(np.float64)
    parse = rows[:, 0] + rows[:, 3]
    slow = int(np.argmax(np.maximum(parse, rows[:, 8])))
    print(f"{B} blocks, C={C} D={D}; rows and status equal the kernel's; "
          f"slowest block {slow}")
    print("clock: mean a block, slowest block")
    for k, name in enumerate(NAMES):
        print(f"  {name}: {rows[:, k].mean():.0f}, {rows[slow, k]:.0f}")
    busy = rows[:, 8] - rows[:, 4]
    print(f"  parse group busy {(parse - rows[:, 1]).mean():.0f} of "
          f"{parse.mean():.0f} cycles a block; match warp busy "
          f"{busy.mean():.0f} of {rows[:, 8].mean():.0f}, "
          f"{busy.sum() / rows[:, 5].sum():.1f} cycles a step, "
          f"{busy.sum() / rows[:, 6].sum():.1f} a match")
    ms_clocked = event_ms(clocked)
    ms_plain = event_ms(lambda: ds.decode_sequencer(comp, comp_len,
                                                    out_len, D))
    print(f"kernel time: clocked build {ms_clocked:.4f} ms, the port's "
          f"{ms_plain:.4f} ms; {card}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
