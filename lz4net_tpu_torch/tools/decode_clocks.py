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

import numpy as np
import torch

from .. import _build
from ..models import cuda as cuda_engine
from ..ops import decode_sequencer as ds
from ..utils import corpus
from . import _clocks
from ._clocks import check, event_ms

# Counter k of a block's clocks
NAMES = ("parse: mask and next-word table", "parse: waits for the match "
         "warp", "tiles", "parse: tiles", "match warp: waits for tiles",
         "match steps", "matches in them", "long matches (the warp's)",
         "match warp: all")
# (text of the source, the same text with its marks); each text occurs
# once in the source
MARKS = [
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


def build() -> ctypes.CDLL:
    """The sequencer decoder with clocks (thread 0, the parse group's,
    and thread 256, the match warp's lane 0, add to them), in its own
    library beside the port's build."""
    with open(os.path.join(_build.CSRC, "decode_sequencer.cu")) as fh:
        text = _clocks.marked(fh.read(), MARKS, "decode_sequencer.cu",
                              _clocks.counters("(threadIdx.x & 255) == 0"))
    P, I = ctypes.c_void_p, ctypes.c_int
    return _clocks.build("dclocks", "decode_sequencer.cu", text,
                         _build.CSRC,
                         {"lz4t_decode_sequencer": [P] * 5 + [I] * 3 + [P]},
                         plain=False)[0]


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("decode_clocks: needs a CUDA device")
    card = _clocks.card()
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
        check(dll.lz4t_decode_sequencer(
            comp.data_ptr(), comp_len.data_ptr(), out_len.data_ptr(),
            out.data_ptr(), status.data_ptr(), B, C, D, stream),
            "decode_sequencer")

    want_out, want_status = ds.decode_sequencer(comp, comp_len, out_len, D)
    _clocks.reset(dll)
    clocked()
    rows = _clocks.read(dll, B)
    if not torch.equal(out, want_out) or not torch.equal(status,
                                                          want_status):
        raise SystemExit("decode_clocks: rows differ from the kernel's")

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
