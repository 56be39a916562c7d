"""Where the cycles of ``sequence_records`` go, and how ``bucket_prev``'s
time splits between its two kernels, on the card.

    python3 -m lz4net_tpu_torch.tools.seq_clocks             # repository root
    python3 -m lz4net_tpu_torch.tools.seq_clocks --csrc DIR  # other sources

Copies ``seq_kernel.cu`` from ``--csrc`` (the port's ``csrc/`` by
default; another checkout's, to clock an earlier form) with a mark of
``clock64()`` before each of its kernel's phase headers (the top-level
``// ---- k. ...`` comments) and at the kernel's end: each mark is a
``__syncthreads()`` and thread 0 adding the cycles since the previous
mark to a device array.  It builds that copy into one library and the
same copy without marks, with ``hash_kernel.cu`` from the same
directory, into another, beside the port's build.  Then, on the encode
cell (the 16 MB silesia-like corpus, seed 0, in 256 blocks of 64 KB,
through the fast path's match stage), it checks both builds'
``sequence_records`` (fast mode's 2 catch-up rounds, and HC's 8) and
``bucket_prev`` against the port's own kernels, and prints:

* ``ptxas -v``'s registers and spills of each kernel of the unmarked
  build (when it is built, not when it is found built);
* the cycles of each phase a block (mean over the blocks, share, and the
  slowest block), and the kernel times of the clocked and unmarked
  builds (CUDA events; the marks' barriers cost time of their own);
* ``bucket_prev``'s time (CUDA events) and its kernels' device times by
  name from ``torch.profiler`` over 10 calls.

The sources carry no marks; a copy whose kernel has no phase headers
stops the tool.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import re

import numpy as np
import torch

from .. import _build
from ..ops import encode_vector as ev
from ..ops import hash_kernel, seq_kernel
from ..utils import corpus
from . import _clocks
from ._clocks import check, event_ms, kernel_split

def seq_pointer_args(src: str) -> int:
    """Pointer arguments of ``lz4t_sequence_records`` in this source (its
    first form also takes a [B, 2, D] chain scratch)."""
    m = re.search(r'extern "C" int lz4t_sequence_records\((.*?)\)', src,
                  re.S)
    if not m:
        raise SystemExit("seq_clocks: no lz4t_sequence_records entry")
    return m.group(1).count("void*") - 1          # less the stream


def build(csrc: str):
    """(clocked library, unmarked library with bucket_prev, phase names,
    pointer arguments of the sequence entry)."""
    with open(os.path.join(csrc, "seq_kernel.cu")) as fh:
        src = fh.read()
    text, layout = _clocks.phase_marks(src, "seq_kernel.cu")
    (kernel, phases), = layout
    P, I = ctypes.c_void_p, ctypes.c_int
    nptr = seq_pointer_args(src)
    clocked, plain = _clocks.build(
        "seqclocks", "seq_kernel.cu", text, csrc,
        {"lz4t_sequence_records": [P] * nptr + [I] * 6 + [P],
         "lz4t_bucket_prev": [P] * 6 + [I, I, P]},
        extra=[os.path.join(csrc, "hash_kernel.cu")])
    return clocked, plain, [n for _, n in phases], nptr


def encode_cell():
    """The encode cell's kernel inputs on the card: (x, data_len, D,
    S_cap, u32, us4, h4, h8)."""
    blocks = corpus.split_blocks(corpus.silesia_like(16 << 20, seed=0),
                                 1 << 16)
    D, _, S_cap = ev.batch_shapes(max(map(len, blocks)))
    xn = np.zeros((len(blocks), D), np.uint8)
    for j, blk in enumerate(blocks):
        xn[j, :len(blk)] = np.frombuffer(blk, np.uint8)
    x = torch.from_numpy(xn).cuda().to(torch.int32)
    dl = torch.tensor([len(b) for b in blocks], dtype=torch.int32,
                      device="cuda")
    u32 = ev._u32(x)
    us4 = ev._shift_left(u32, 4)
    return (x, dl, D, S_cap, u32, us4, hash_kernel.hash_bucket(u32),
            hash_kernel.hash_bucket8(u32, us4))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--csrc", default=_build.CSRC,
                    help="directory of seq_kernel.cu, hash_kernel.cu and "
                         "common.cuh (default: the port's csrc/)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("seq_clocks: needs a CUDA device")
    card = _clocks.card()
    print(card)
    csrc = os.path.abspath(args.csrc)
    clocked, plain, names, nptr = build(csrc)
    print(f"sources: {csrc}; phases: " + "; ".join(
        f"{k + 1}. {n}" for k, n in enumerate(names)))
    x, dl, D, S_cap, u32, us4, h4, h8 = encode_cell()
    B = x.shape[0]
    stream = torch.cuda.current_stream().cuda_stream

    # ---- bucket_prev: both kernels, then each by name -------------------
    prev = torch.empty_like(u32)
    near = torch.empty_like(u32)

    def bucket():
        check(plain.lz4t_bucket_prev(u32.data_ptr(), us4.data_ptr(),
                                    h4.data_ptr(), h8.data_ptr(),
                                    prev.data_ptr(), near.data_ptr(), B, D,
                                    stream), "bucket_prev")

    bucket()
    want_prev = hash_kernel.bucket_prev(u32, us4, h4, h8, D)
    torch.cuda.synchronize()
    if not torch.equal(prev, want_prev):
        raise SystemExit("seq_clocks: bucket_prev differs from the port's")
    ms = event_ms(bucket)
    split = kernel_split(bucket)
    print(f"bucket_prev [{B}, {D}]: {ms:.4f} ms (CUDA events), equal to "
          f"the port's; by kernel (torch.profiler, 10 calls): " + (
              "; ".join(f"{k} {v:.4f} ms" for k, v in split.items())
              if split else "not measured (no kernel in the trace)")
          + f"; {card}")

    # ---- sequence_records: phase clocks -------------------------------
    matched, off_all, mlen_all = ev._match_stage(
        x, dl, D, ev.RCAP, 0, None)[1:]
    pre = torch.zeros_like(dl)
    SR = seq_kernel.slot_width(S_cap)
    for rounds in (ev.CU_ROUNDS, ev.HC_CU_ROUNDS):
        outs = [torch.empty((B, SR), dtype=torch.int32, device="cuda")
                for _ in range(5)]
        stats = torch.empty((B, 8), dtype=torch.int32, device="cuda")
        scratch = [torch.empty((B, 2, D), dtype=torch.int32, device="cuda")
                   ] if nptr == 14 else []
        slots = torch.empty((B, 4, S_cap), dtype=torch.int32,
                            device="cuda")
        ptrs = [t.data_ptr() for t in (u32, matched, off_all, mlen_all, dl,
                                       pre, *outs, stats, *scratch, slots)]

        def seq(dll):
            check(dll.lz4t_sequence_records(*ptrs, B, D, S_cap, SR, 0,
                                             rounds, stream),
                   "sequence_records")

        want = seq_kernel.sequence_records(u32, matched, off_all, mlen_all,
                                           dl, pre, D, S_cap, 0, rounds)
        for dll in (plain, clocked):
            _clocks.reset(clocked)
            seq(dll)
            torch.cuda.synchronize()
            got = (*outs, stats)
            if not all(torch.equal(g, w) for g, w in zip(got, want)):
                raise SystemExit("seq_clocks: sequence_records differs "
                                 "from the port's")
        rows = _clocks.read(clocked, B)[:, :len(names)]
        total = rows.sum(1)
        slow = int(np.argmax(total))
        print(f"sequence_records, cu_rounds {rounds}, {B} blocks, D={D}, "
              f"S_cap={S_cap}: equal to the port's; tokens a block mean "
              f"{float(want[5][:, 0].float().mean()):.0f}; slowest block "
              f"{slow}; cycles a block, mean (share), slowest block:")
        for k, name in enumerate(names):
            print(f"  {k + 1}. {name}: {rows[:, k].mean():.0f} "
                  f"({rows[:, k].mean() / total.mean():.3f}), "
                  f"{rows[slow, k]:.0f}")
        print(f"  all: {total.mean():.0f}, {total[slow]:.0f}")
        ms_clocked = event_ms(lambda: seq(clocked))
        ms_plain = event_ms(lambda: seq(plain))
        print(f"  kernel time: clocked build {ms_clocked:.4f} ms, unmarked "
              f"{ms_plain:.4f} ms; {card}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
