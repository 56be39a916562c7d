"""Where the cycles of ``records_to_state`` and ``emit_bytes`` go, phase by
phase, on the card.

    python3 -m lz4net_tpu_torch.tools.expand_clocks             # repo root
    python3 -m lz4net_tpu_torch.tools.expand_clocks --csrc DIR  # other sources

Copies ``records_kernel.cu`` and ``emit_kernel.cu`` from ``--csrc`` (the
port's ``csrc/`` by default; another checkout's, to clock an earlier
form) with a mark of ``clock64()`` before each phase header of each
kernel (the ``// ---- k. ...`` comments at the kernel body's top level)
and at each kernel's end: a mark is a ``__syncthreads()`` and thread 0
adding the cycles since the previous mark to its CTA's counter of the
phase (``tools/_clocks.py``).  Each file is built twice, with and
without the marks, into libraries of their own beside the port's build.
Then it runs both on the cells of the main paths (the 16 MB silesia-like
corpus, seed 0, in 256 blocks of 64 KB):
``records_to_state`` on the decode cell (the blocks as the strict encoder
compresses them, parsed by the port's ``parse_tokens``) and
``emit_bytes`` on the encode cell (the fast path's records), checks every
output against the port's own kernels, and prints:

* ``ptxas -v``'s registers and spills of each kernel of the unmarked
  builds (when they are built, not when they are found built);
* each kernel's cycles a CTA by phase (mean over the CTAs that reached
  the phase's end, and share);
* the time of the clocked and the unmarked build (CUDA events; the
  marks' barriers cost time of their own), and the device time of each
  CUDA kernel behind one call (torch.profiler over 10 calls).

The sources carry no marks; a kernel file without phase headers stops
the tool (to clock a first form that has none, put ``// ---- k.``
comments at its parts in a copy, and pass the copy's directory).
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from .. import _build
from ..models import cuda as cuda_engine
from ..ops import decode_vector as dv
from ..ops import emit_kernel, parse_kernel, records_kernel, seq_kernel
from ..ops import encode_vector as ev
from ..utils import corpus
from . import _clocks
from ._clocks import check, event_ms, kernel_split
from .seq_clocks import encode_cell

def build(csrc: str, name: str, entry: str):
    """(clocked library, unmarked library, phase layout) of one kernel
    file; ``entry`` is its C entry point (``_build.SIGNATURES``)."""
    with open(os.path.join(csrc, name)) as fh:
        text, layout = _clocks.phase_marks(fh.read(), name)
    clocked, plain = _clocks.build("expandclocks", name, text, csrc,
                                   {entry: _build.SIGNATURES[entry]})
    return clocked, plain, layout


def report(title, clocked, plain, layout, run, check_outputs, card):
    """Run ``run(dll)`` on both builds, ``check_outputs()`` after each,
    and print the phase clocks and times."""
    for dll in (plain, clocked):
        _clocks.reset(clocked)
        run(dll)
        torch.cuda.synchronize()
        check_outputs()
    rows = _clocks.read(clocked)
    print(f"{title}: equal to the port's kernel")
    for kern, phases in layout:
        # a CTA that reached a phase's end holds its cycles there
        ctas = [int(np.count_nonzero(rows[:, k])) for k, _ in phases]
        mean = [rows[:, k].sum() / max(n, 1)
                for (k, _), n in zip(phases, ctas)]
        total = sum(mean)
        print(f"  {kern}, {ctas[0]} CTAs; cycles a CTA, mean (share):")
        for (k, name), m in zip(phases, mean):
            print(f"    {k + 1}. {name}: {m:.0f} ({m / total:.3f})")
        print(f"    all: {total:.0f}")
    ms_clocked = event_ms(lambda: run(clocked))
    ms_plain = event_ms(lambda: run(plain))
    split = kernel_split(lambda: run(plain))
    print(f"  time: clocked build {ms_clocked:.4f} ms, unmarked "
          f"{ms_plain:.4f} ms; by kernel (torch.profiler, 10 calls): " + (
              "; ".join(f"{k} {v:.4f} ms" for k, v in split.items())
              if split else "not measured (no kernel in the trace)")
          + f"; {card}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--csrc", default=_build.CSRC,
                    help="directory of records_kernel.cu, emit_kernel.cu "
                         "and common.cuh (default: the port's csrc/)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("expand_clocks: needs a CUDA device")
    card = _clocks.card()
    print(card)
    csrc = os.path.abspath(args.csrc)
    print(f"sources: {csrc}")
    rec = build(csrc, "records_kernel.cu", "lz4t_records_to_state")
    emit = build(csrc, "emit_kernel.cu", "lz4t_emit_bytes")
    stream = torch.cuda.current_stream().cuda_stream

    # ---- records_to_state on the decode cell ---------------------------
    blocks = corpus.split_blocks(corpus.silesia_like(16 << 20, seed=0),
                                 1 << 16)
    packed = cuda_engine.compress_blocks(blocks, device="cuda")
    comp_np, cl_np, ol_np, C, D = dv.pack_blocks(packed,
                                                 list(map(len, blocks)))
    comp, comp_len, out_len = dv.batch_from_numpy(comp_np, cl_np, ol_np,
                                                  "cuda")
    B = comp.shape[0]
    pre = torch.zeros_like(comp_len)
    mark, ll, ml, _ = parse_kernel.parse_tokens(comp, comp_len, C)
    want = records_kernel.records_to_state(comp, mark, ll, ml, comp_len,
                                           out_len, pre, C, D)
    got = [torch.empty_like(w) for w in want]
    # room for either form's scratch
    scratch = torch.empty((B, 4 * C + D), dtype=torch.int32, device="cuda")
    ins = [t.data_ptr() for t in (comp, mark, ll, ml, comp_len, out_len,
                                  pre)]

    def run_records(dll):
        check(dll.lz4t_records_to_state(
            *ins, *(g.data_ptr() for g in got), scratch.data_ptr(), B, C, D,
            0, stream), "records_to_state")

    def check_records():
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            raise SystemExit("expand_clocks: records_to_state differs "
                             "from the port's")

    report(f"records_to_state, decode cell, B={B} C={C} Dt={D}, "
           f"{int(mark.sum()) / B:.0f} tokens a block", *rec[:3],
           run_records, check_records, card)

    # ---- emit_bytes on the encode cell ---------------------------------
    x, dl, De, S_cap, *_ = encode_cell()
    _, O, _ = ev.batch_shapes(int(dl.max()))
    matched, off_all, mlen_all = ev._match_stage(x, dl, De, ev.RCAP, 0,
                                                 None)[1:]
    seq = seq_kernel.sequence_records(ev._u32(x), matched, off_all,
                                      mlen_all, dl, torch.zeros_like(dl),
                                      De, S_cap)
    fields = [t.contiguous() for t in seq[:5]]
    olen = seq[5][:, 2].contiguous()
    want_e = emit_kernel.emit_bytes(*fields, olen, O)[:2]
    got_e = [torch.empty_like(w) for w in want_e]
    S = fields[0].shape[1]

    def run_emit(dll):
        check(dll.lz4t_emit_bytes(
            *(t.data_ptr() for t in (*fields, olen)),
            *(g.data_ptr() for g in got_e), B, S, O, stream),
            "emit_bytes")

    def check_emit():
        if not all(torch.equal(g, w) for g, w in zip(got_e, want_e)):
            raise SystemExit("expand_clocks: emit_bytes differs from the "
                             "port's")

    report(f"emit_bytes, encode cell, B={B} S={S} O={O}, "
           f"{float(seq[5][:, 1].float().mean()) + 1:.0f} records a block",
           *emit, run_emit, check_emit, card)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
