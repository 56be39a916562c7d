"""Where the cycles of the strict encoder's warp parse go, on the card.

    python3 -m lz4net_tpu_torch.tools.parse_clocks      # repository root

Copies ``csrc/encode_sequencer.cu`` with section marks of ``clock64()``
put into its shared-memory kernel (``MARKS`` below: lane 0 of each block
adds the cycles between marks, and counts, to a device array), builds
the copy alone into its own library beside the port's build, encodes the
16 MB silesia-like corpus (seed 0) in 256 blocks of 64 KB with it,
checks every payload against the port's own kernel, and prints the
cycles of each section a block (mean over the blocks and the slowest
block), the counts behind them (windows of 32 probes, sequences,
catch-up and extension steps, literal bytes, re-matches), and the kernel
times of both builds (CUDA events).  The marks cost time of their own:
compare the two kernel times.  Then the cycles a step of the primitives
the parse is made of (``warp_primitives.cu`` beside this file: shared
loads, shuffles, ballots, ``__match_any_sync`` and the atomicOr lane mask
that stands in for it, a short literal copy), each a chain of dependent
steps of one warp.  The port's own source carries no marks; a mark whose
place in it is not found once stops the tool.
"""

from __future__ import annotations

import ctypes
import os
import statistics
import subprocess

import numpy as np
import torch

from .. import _build
from ..constants import maximum_output_length
from ..ops import encode_sequencer as es
from ..utils import corpus

SECTIONS = ("stage", "windows", "catch-up", "token bytes", "extension",
            "re-match check", "last literals", "parse")
COUNTS = ("windows", "sequences", "catch-up steps past the first byte",
          "extension steps past the first word", "literal bytes",
          "re-matches", "match lane sum", "windows with a carried candidate")
NCLK = 16
PRIMITIVES = ("shared load", "shuffle", "ballot",
              "__match_any_sync, 32 keys", "__match_any_sync, 8 keys",
              "atomicOr lane mask", "literal copy under 8 bytes")

# Row k of g_parse_clocks: sections 0-7 (SECTIONS), counts 8-15 (COUNTS)
PRELUDE = """
namespace lz4t {
constexpr int NCLK = 16;
constexpr int CLK_BLOCKS = 8192;
__device__ unsigned long long g_parse_clocks[CLK_BLOCKS * NCLK];
}
#define CLK_ADD(k, v)                                                  \\
  do {                                                                 \\
    if (threadIdx.x == 0 && blockIdx.x < lz4t::CLK_BLOCKS)             \\
      atomicAdd(&lz4t::g_parse_clocks[blockIdx.x * lz4t::NCLK + (k)],  \\
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
// zero the section clocks, and read them back as [blocks, 16] uint64
extern "C" int lz4t_parse_clocks_reset(void* stream) {
  void* p = nullptr;
  cudaError_t err = cudaGetSymbolAddress(&p, lz4t::g_parse_clocks);
  if (err == cudaSuccess)
    err = cudaMemsetAsync(p, 0, sizeof(lz4t::g_parse_clocks),
                          (cudaStream_t)stream);
  return (int)err;
}

extern "C" int lz4t_parse_clocks_read(void* dst, int blocks, void* stream) {
  return (int)cudaMemcpyFromSymbolAsync(
      dst, lz4t::g_parse_clocks,
      sizeof(unsigned long long) * lz4t::NCLK * blocks, 0,
      cudaMemcpyDeviceToHost, (cudaStream_t)stream);
}
"""

# (text of the source, the same text with its marks); each text occurs
# once in the source
MARKS = [
    ('#include "common.cuh"\n', '#include "common.cuh"\n' + PRELUDE),
    # extension and catch-up steps past the first
    ("    const unsigned partial = __ballot_sync(FULL, k != 4);\n",
     "    const unsigned partial = __ballot_sync(FULL, k != 4);\n"
     "    CLK_ADD(11, 1);\n"),
    ("    const unsigned stop = __ballot_sync(FULL, !same);\n",
     "    const unsigned stop = __ballot_sync(FULL, !same);\n"
     "    CLK_ADD(10, 1);\n"),
    ("    const unsigned below = (1u << lane) - 1;       // lanes before "
     "this one\n    int dp = 0, anchor = 0;\n",
     "    const unsigned below = (1u << lane) - 1;       // lanes before "
     "this one\n    int dp = 0, anchor = 0;\n    CLK_START\n"),
    # windows, and those where a lane takes an earlier lane's position
    ("          const unsigned backs = __ballot_sync(FULL, back1);\n",
     "          const unsigned backs = __ballot_sync(FULL, back1);\n"
     "          const unsigned carried_any = __ballot_sync(FULL, earlier "
     "!= 0);\n          CLK_ADD(8, 1);\n"
     "          CLK_ADD(15, carried_any != 0);\n"),
    ("            back = (backs >> f) & 1u;\n            found = true;\n",
     "            back = (backs >> f) & 1u;\n            found = true;\n"
     "            CLK_ADD(14, f);\n"),
    ("          attempts += 32;\n        }\n        if (!found) break;\n",
     "          attempts += 32;\n        }\n        CLK(1);\n"
     "        if (!found) break;\n        CLK_ADD(9, 1);\n"),
    ("          const int end = extend(p + MINMATCH, ref + MINMATCH, "
     "cap);\n",
     "          const int end = extend(p + MINMATCH, ref + MINMATCH, "
     "cap);\n          CLK(4);\n"),
    ("          if (back) {   // catch up",
     "          CLK(5);\n          if (back) {   // catch up"),
    ("            back = false;\n          }\n",
     "            back = false;\n          }\n          CLK(2);\n"
     "          CLK_ADD(12, p - anchor);\n"),
    ("          if (dp < 0) return -1;\n          anchor = end;\n",
     "          CLK(3);\n          if (dp < 0) return -1;\n"
     "          anchor = end;\n"),
    ("          p = end;\n          ref = rref;\n",
     "          CLK_ADD(13, 1);\n          p = end;\n          ref = "
     "rref;\n"),
    ("    return last_literals(dp, anchor, n, dst_maxlen);\n",
     "    const int w_ = last_literals(dp, anchor, n, dst_maxlen);\n"
     "    CLK(6);\n    return w_;\n"),
    # the kernel: staging, then the whole parse
    ("  const int b = blockIdx.x, tid = threadIdx.x;\n",
     "  const int b = blockIdx.x, tid = threadIdx.x;\n  CLK_START\n"),
    ("  __syncthreads();\n  if (tid >= 32) return;\n",
     "  __syncthreads();\n  CLK(0);\n  if (tid >= 32) return;\n"),
    ("  if (tid == 0) written_all[b] = w > O ? -1 : w;\n",
     "  if (tid == 0) written_all[b] = w > O ? -1 : w;\n  CLK(7);\n"),
]


def clocked_source() -> str:
    """``encode_sequencer.cu`` with the section marks and the clocks'
    reset and read entries."""
    with open(os.path.join(_build.CSRC, "encode_sequencer.cu")) as fh:
        src = fh.read()
    for old, new in MARKS:
        if src.count(old) != 1:
            raise SystemExit("parse_clocks: the place of a mark is not "
                             f"found once in encode_sequencer.cu: {old!r}")
        src = src.replace(old, new)
    return src + EPILOGUE


def build() -> ctypes.CDLL:
    """The strict encoder with section clocks, and the primitives'
    kernel, in one library beside the port's build."""
    out_dir = os.path.join(_build.BUILD_DIR, "clocks-" + _build._digest())
    lib = os.path.join(out_dir, "liblz4t_clocks.so")
    if not os.path.exists(lib):
        os.makedirs(out_dir, exist_ok=True)
        clocked = os.path.join(out_dir, "encode_sequencer_clocks.cu")
        with open(clocked, "w") as fh:
            fh.write(clocked_source())
        prims = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "warp_primitives.cu")
        subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I",
                        _build.CSRC, "-shared", clocked, prims, "-o", lib],
                       check=True)
    dll = ctypes.CDLL(lib)
    P, I = ctypes.c_void_p, ctypes.c_int
    dll.lz4t_encode_sequencer.argtypes = [P] * 5 + [I] * 3 + [P]
    dll.lz4t_parse_clocks_reset.argtypes = [P]
    dll.lz4t_parse_clocks_read.argtypes = [P, I, P]
    dll.lz4t_warp_primitives.argtypes = [P]
    for fn in (dll.lz4t_encode_sequencer, dll.lz4t_parse_clocks_reset,
               dll.lz4t_parse_clocks_read, dll.lz4t_warp_primitives):
        fn.restype = ctypes.c_int
    return dll


def _check(rc, what):
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc}")


def event_ms(fn, inner=3, reps=5):
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
        raise SystemExit("parse_clocks: needs a CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card)
    dll = build()
    blocks = corpus.split_blocks(corpus.silesia_like(16 << 20, seed=0),
                                 1 << 16)
    B, S = len(blocks), max(map(len, blocks))
    src = np.zeros((B, S), np.uint8)
    for j, blk in enumerate(blocks):
        src[j, :len(blk)] = np.frombuffer(blk, np.uint8)
    src = torch.from_numpy(src).cuda()
    lens = torch.tensor([len(b) for b in blocks], dtype=torch.int32,
                        device="cuda")
    cap = torch.tensor([maximum_output_length(len(b)) for b in blocks],
                       dtype=torch.int32, device="cuda")
    O = int(cap.max())
    out = torch.empty((B, O), dtype=torch.uint8, device="cuda")
    written = torch.empty(B, dtype=torch.int32, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream

    def clocked():
        _check(dll.lz4t_encode_sequencer(
            src.data_ptr(), lens.data_ptr(), cap.data_ptr(), out.data_ptr(),
            written.data_ptr(), B, S, O, stream), "encode_sequencer")

    want_out, want_written = es.encode_sequencer(src, lens, cap, O)
    _check(dll.lz4t_parse_clocks_reset(stream), "reset")
    clocked()
    rows = np.zeros((B, NCLK), np.uint64)
    _check(dll.lz4t_parse_clocks_read(rows.ctypes.data, B, stream), "read")
    torch.cuda.synchronize()
    if not torch.equal(written, want_written):
        raise SystemExit("parse_clocks: written differs from the kernel's")
    cols = torch.arange(O, device="cuda")[None, :] < written[:, None]
    if not torch.equal(out * cols, want_out * cols):
        raise SystemExit("parse_clocks: payloads differ from the kernel's")

    rows = rows.astype(np.float64)
    slow = int(np.argmax(rows[:, 7]))
    print(f"{B} blocks of {S} bytes; payloads equal the kernel's; "
          f"slowest block {slow}")
    print("section: mean cycles a block (share of the parse), slowest "
          "block")
    for k, name in enumerate(SECTIONS):
        mean = rows[:, k].mean()
        print(f"  {name}: {mean:.0f} ({mean / rows[:, 7].mean():.3f}), "
              f"{rows[slow, k]:.0f}")
    for k, name in enumerate(COUNTS):
        print(f"  {name}: mean {rows[:, 8 + k].mean():.1f} a block, "
              f"slowest block {rows[slow, 8 + k]:.0f}")
    seqs = rows[:, 9].sum()
    print(f"  parse cycles a sequence {rows[:, 7].sum() / seqs:.1f}, "
          f"a window {rows[:, 1].sum() / rows[:, 8].sum():.1f}, a source "
          f"byte {rows[:, 7].sum() / float(lens.sum()):.2f}")
    ms_clocked = event_ms(clocked)
    ms_plain = event_ms(lambda: es.encode_sequencer(src, lens, cap, O))
    print(f"kernel time: clocked build {ms_clocked:.4f} ms, the port's "
          f"{ms_plain:.4f} ms; the slowest block's parse {rows[slow, 7]:.0f} "
          f"cycles; {card}")
    steps = np.zeros(len(PRIMITIVES), np.float64)
    _check(dll.lz4t_warp_primitives(steps.ctypes.data), "primitives")
    print("cycles a dependent step of one warp: " + "; ".join(
        f"{name} {c:.1f}" for name, c in zip(PRIMITIVES, steps))
        + f"; {card}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
