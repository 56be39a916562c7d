"""Where the cycles of the strict encoder's warp parse go, on the card.

    python3 -m lz4net_tpu_torch.tools.parse_clocks      # repository root

Copies ``csrc/encode_sequencer.cu`` with section marks of ``clock64()``
put into its warp parse and both of its kernels (``MARKS`` below: lane 0
of each block adds the cycles between marks, and counts, to a device
array), builds the copy alone into its own library beside the port's
build, encodes the 16 MB silesia-like corpus (seed 0) in 256 blocks of
64 KB with it (the shared-memory kernel), checks every payload against
the port's own kernel, and prints the cycles of each section a block
(mean over the blocks and the slowest block), the counts behind them
(windows of 32 probes, sequences, catch-up and extension steps, literal
bytes, re-matches), and the kernel times of both builds (CUDA events).
The marks cost time of their own: compare the two kernel times.  Then
the same for one 1 MB row of the corpus, which the kernel reads from
device memory.  Then the cycles a step of the primitives the parse is
made of (``warp_primitives.cu`` beside this file: shared loads,
shuffles, ballots, ``__match_any_sync`` and the atomicOr lane mask that
stands in for it, a short literal copy), each a chain of dependent steps
of one warp.  The port's own source carries no marks; a mark whose place
in it is not found once stops the tool.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np
import torch

from .. import _build
from ..constants import maximum_output_length
from ..ops import encode_sequencer as es
from ..utils import corpus
from . import _clocks
from ._clocks import check, event_ms

SECTIONS = ("stage", "windows", "catch-up", "token bytes", "extension",
            "re-match check", "last literals", "parse")
COUNTS = ("windows", "sequences", "catch-up steps past the first byte",
          "extension steps past the first word", "literal bytes",
          "re-matches", "match lane sum", "windows with a carried candidate")
PRIMITIVES = ("shared load", "shuffle", "ballot",
              "__match_any_sync, 32 keys", "__match_any_sync, 8 keys",
              "atomicOr lane mask", "literal copy under 8 bytes")

# Counter k of a block's clocks: sections 0-7 (SECTIONS), counts 8-15
# (COUNTS)
# (text of the source, the same text with its marks); each text occurs
# once in the source
MARKS = [
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
    # the device-memory kernel: its table cleared, then the whole parse
    ("  const int b = blockIdx.x;\n  const int t = threadIdx.x;\n",
     "  const int b = blockIdx.x;\n  const int t = threadIdx.x;\n"
     "  CLK_START\n"),
    ("  __syncthreads();\n  if (t >= 32) return;\n",
     "  __syncthreads();\n  CLK(0);\n  if (t >= 32) return;\n"),
    ("                    .run(n, dst_maxlen_all[b]);\n",
     "                    .run(n, dst_maxlen_all[b]);\n  CLK(7);\n"),
]


def build() -> ctypes.CDLL:
    """The strict encoder with section clocks (lane 0 of each block adds
    to them), and the primitives' kernel, in one library beside the
    port's build."""
    with open(os.path.join(_build.CSRC, "encode_sequencer.cu")) as fh:
        text = _clocks.marked(fh.read(), MARKS, "encode_sequencer.cu",
                              _clocks.counters())
    P, I = ctypes.c_void_p, ctypes.c_int
    prims = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "warp_primitives.cu")
    return _clocks.build("clocks", "encode_sequencer.cu", text, _build.CSRC,
                         {"lz4t_encode_sequencer": [P] * 5 + [I] * 3 + [P],
                          "lz4t_warp_primitives": [P]},
                         extra=[prims], plain=False)[0]


def clock_blocks(dll, blocks, card: str):
    """Encode ``blocks`` (one row each) with the clocked build, check
    every payload against the port's kernel, and print the sections and
    counts a block and both builds' kernel times."""
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
        check(dll.lz4t_encode_sequencer(
            src.data_ptr(), lens.data_ptr(), cap.data_ptr(), out.data_ptr(),
            written.data_ptr(), B, S, O, stream), "encode_sequencer")

    want_out, want_written = es.encode_sequencer(src, lens, cap, O)
    _clocks.reset(dll)
    clocked()
    rows = _clocks.read(dll, B)
    if not torch.equal(written, want_written):
        raise SystemExit("parse_clocks: written differs from the kernel's")
    cols = torch.arange(O, device="cuda")[None, :] < written[:, None]
    if not torch.equal(out * cols, want_out * cols):
        raise SystemExit("parse_clocks: payloads differ from the kernel's")

    slow = int(np.argmax(rows[:, 7]))
    kernel = "device-memory" if S > es.row_max("cuda") else "shared-memory"
    print(f"{B} blocks of {S} bytes ({kernel} kernel); payloads equal the "
          f"kernel's; slowest block {slow}")
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
    ms_clocked = event_ms(clocked, inner=3)
    ms_plain = event_ms(lambda: es.encode_sequencer(src, lens, cap, O),
                        inner=3)
    print(f"kernel time: clocked build {ms_clocked:.4f} ms, the port's "
          f"{ms_plain:.4f} ms; the slowest block's parse {rows[slow, 7]:.0f} "
          f"cycles; {card}")


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("parse_clocks: needs a CUDA device")
    card = _clocks.card()
    print(card)
    dll = build()
    clock_blocks(dll, corpus.split_blocks(
        corpus.silesia_like(16 << 20, seed=0), 1 << 16), card)
    # one 1 MB row read from device memory: the densest chunk of an
    # 8 MiB stream of the corpus at 1 MB chunks
    clock_blocks(dll, [corpus.split_blocks(
        corpus.silesia_like(8 << 20, seed=0), 1 << 20)[5]], card)
    steps = np.zeros(len(PRIMITIVES), np.float64)
    check(dll.lz4t_warp_primitives(steps.ctypes.data), "primitives")
    print("cycles a dependent step of one warp: " + "; ".join(
        f"{name} {c:.1f}" for name, c in zip(PRIMITIVES, steps))
        + f"; {card}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
