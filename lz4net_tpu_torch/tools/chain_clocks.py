"""Where the cycles of ``mark_chain`` go, and what bounds each of the chain
record path's ``table_gather`` launches, on the card.

    python3 -m lz4net_tpu_torch.tools.chain_clocks             # repo root
    python3 -m lz4net_tpu_torch.tools.chain_clocks --csrc DIR  # other sources

Copies ``chain_kernel.cu`` from ``--csrc`` (the port's ``csrc/`` by
default; another checkout's, to clock an earlier form) with marks of
``clock64()`` put into its kernel (``MARKS`` below, one set for each form;
the set whose places all occur once in the source is taken): thread 0 of
each CTA (and, in the redesign, the hop warp's lane 0) adds the cycles
between marks to its CTA's counters (``tools/_clocks.py``).  The marks
add no barrier; each sits after one of the kernel's barriers or on the
clocking thread's own path, so a counter holds the time that thread
spends in that part: the first form's staging and walk; the redesign's
worker loads and doubling, group exits, marking and stores and barrier
wait, and the hop warp's hops and barrier wait.  The copy is built with and
without the marks into libraries of their own beside the port's build,
with an entry that asks the runtime how many of its CTAs fit on an SM;
``fused_gather.cu`` from the same directory is built the same way,
unmarked.  Then, on the encode cell (the 16 MB silesia-like corpus, seed
0, in 256 blocks of 64 KB, through the fast path's match stage), it
checks both builds against the port's own kernels and prints:

* ``ptxas -v``'s registers, shared memory and spills of each kernel of
  the unmarked builds (when they are built, not when they are found
  built);
* ``mark_chain`` on ``seq_kernel.chain_graph`` of the blocks' match
  state (B = 256, D = 73,728): the orbit's positions a block (the first
  form's hops: one a position) and the 128-position groups it enters
  (the redesign's hops), each as mean, least and most; the cycles a CTA
  by part; CTAs an SM and the waves of the grid; the times of the clocked
  and unmarked builds (CUDA events; the marks cost time of their own);
* ``table_gather`` at each of its launches on the chain path in fast
  mode (recorded from ``seq_kernel.parse_records``): the offsets and
  lengths at the tokens, the catch-up words (two a round), ``mcum`` at
  ``last`` and the four merged fields at ``kidx``; for each, the time of
  the sources' kernel (its C entry, CUDA events) and of this checkout's
  wrapper (``ops.fused_gather.table_gather``), the TB/s of the bytes
  its bound counts (the index read and each output written once, and a
  table entry a slot), the distinct 32-byte sectors of the tables that
  its indices touch (counted from the indices) with the bound at that
  granularity, and the time of ``torch.gather`` on the same tables.
"""

from __future__ import annotations

import argparse
import ctypes
import os

import torch

from .. import _build
from ..ops import chain_kernel, fused_gather, seq_kernel
from ..ops import encode_vector as ev
from . import _clocks
from ._clocks import check, event_ms
from .chunk_clocks import entry_pointers, report
from .seq_clocks import encode_cell

HBM_BYTES_PER_S = 3.35e12       # H100 SXM device memory
GROUP = 128                     # the redesign's hop: a group of positions

# (text of the source, the same text with its marks) for each form; each
# text occurs once in its form.  The parts: {counter: name}; a name
# "who: part" is a part of that thread's time.  The third item is the
# dynamic shared memory a CTA of the form asks for, as C; a fourth, where
# there is one, the test that picks the threads that clock.
MARKS = {
    "first form (one thread walks the orbit, 2 bytes a position staged)": ([
        ("  for (int i = threadIdx.x; i < D; i += THREADS) {\n",
         "  CLK_START\n  for (int i = threadIdx.x; i < D; i += THREADS) {\n"),
        ("  __syncthreads();   // the zeros land before the walk's ones\n",
         "  __syncthreads();   // the zeros land before the walk's ones\n"
         "  CLK(0);\n"),
        ("      pos = s == FAR ? g[pos] : pos + (int)s;   // g[pos] > pos "
         "here\n    }\n",
         "      pos = s == FAR ? g[pos] : pos + (int)s;   // g[pos] > pos "
         "here\n    }\n    CLK(1);\n"),
    ], {0: "staging (zero the marks, steps to shared memory)",
        1: "the walk (thread 0)"}, "2 * D"),
    "redesign (a hop warp, worker warps pipelined over tiles)": ([
        ("  int pg[SEGS];                          // g of the warp's next "
         "positions\n",
         "  CLK_START\n  int pg[SEGS];                          // g of the "
         "warp's next positions\n"),
        ("          if (s0 + lane < D) mark[s0 + lane] = (on >> lane) & 1u;\n"
         "        }\n",
         "          if (s0 + lane < D) mark[s0 + lane] = (on >> lane) & 1u;\n"
         "        }\n        CLK(2);\n"),
        ("        __syncwarp();\n#pragma unroll\n        for (int k = 0; k < "
         "SEGS; ++k) { // at most 3 segment exits on\n",
         "        CLK(0);\n        __syncwarp();\n#pragma unroll\n        for "
         "(int k = 0; k < SEGS; ++k) { // at most 3 segment exits on\n"),
        ("          gx_s[i & 1][warp * GROUP + k * 32 + lane] = e;\n        }\n",
         "          gx_s[i & 1][warp * GROUP + k * 32 + lane] = e;\n        }\n"
         "        CLK(1);\n"),
        ("          carry = pos;\n        }\n",
         "          carry = pos;\n        }\n        CLK(5);\n"),
        ("    __syncthreads();\n  };\n",
         "    __syncthreads();\n    CLK(warp < WARPS ? 4 : 6);\n  };\n"),
    ], {0: "worker: loads and doubling (segment exits and paths)",
        1: "worker: group exits", 2: "worker: marking and stores",
        4: "worker: barrier wait", 5: "hop warp: group hops",
        6: "hop warp: barrier wait"}, "0",
        "threadIdx.x % (32 * WARPS) == 0"),
}

OCCUPANCY = """
extern "C" int lz4t_chain_occupancy(int D, int* ctas) {
  const int smem = %s;
  cudaError_t err = cudaFuncSetAttribute(
      lz4t::chain_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        ctas, lz4t::chain_kernel, lz4t::THREADS, smem);
  return (int)err;
}
"""


def build_chain(csrc: str):
    """(clocked library, unmarked library, form, parts) of
    ``chain_kernel.cu``."""
    with open(os.path.join(csrc, "chain_kernel.cu")) as fh:
        src = fh.read()
    forms = [(form, *spec) for form, spec in MARKS.items()
             if all(src.count(old) == 1 for old, _ in spec[0])]
    if len(forms) != 1:
        raise SystemExit(f"chain_clocks: chain_kernel.cu in {csrc} matches "
                         f"{len(forms)} of the known forms' marks")
    form, marks, parts, smem, *lead = forms[0]
    prelude = _clocks.counters(**({"lead": lead[0]} if lead else {}))
    text = _clocks.marked(src, marks, "chain_kernel.cu",
                          prelude) + OCCUPANCY % smem
    P, I = ctypes.c_void_p, ctypes.c_int
    clocked, plain = _clocks.build(
        "chainclocks", "chain_kernel.cu", text, csrc,
        {"lz4t_mark_chain": _build.SIGNATURES["lz4t_mark_chain"],
         "lz4t_chain_occupancy": [I, P]})
    return clocked, plain, form, parts


def build_gather(csrc: str):
    """The unmarked library of ``fused_gather.cu`` from ``csrc``."""
    with open(os.path.join(csrc, "fused_gather.cu")) as fh:
        src = fh.read()
    text = _clocks.marked(src, (), "fused_gather.cu", _clocks.counters())
    nptr = entry_pointers(src, "lz4t_table_gather")
    entry = {"lz4t_table_gather": [ctypes.c_void_p] * nptr
             + _build.SIGNATURES["lz4t_table_gather"][nptr:]}
    return _clocks.build("chainclocks", "fused_gather.cu", text, csrc,
                         entry)[1]


def spread(v) -> str:
    v = v.double()
    return (f"mean {float(v.mean()):.1f}, least {int(v.min())}, most "
            f"{int(v.max())}")


def clock_mark_chain(csrc, stream, card, cell):
    clocked, plain, form, parts = build_chain(csrc)
    g, D = cell["g"], cell["D"]
    B = g.shape[0]
    want = chain_kernel.mark_chain(g, D)
    mark = torch.empty_like(g)

    def run(dll):
        check(dll.lz4t_mark_chain(g.data_ptr(), mark.data_ptr(), B, D,
                                  stream), "mark_chain")

    def check_outputs():
        if not torch.equal(mark, want):
            raise SystemExit("chain_clocks: mark_chain differs from the "
                             "port's")

    orbit = want.sum(1)
    groups = want.view(B, -1, GROUP).any(2).sum(1) if D % GROUP == 0 \
        else None
    print(f"mark_chain cell: B={B} D={D}; orbit positions a block "
          f"(the first form's hops) {spread(orbit)}, "
          f"{int(orbit.sum())} in all; 128-position groups entered a block "
          f"(the redesign's hops) "
          + (spread(groups) if groups is not None else "not counted"))
    report(f"mark_chain, {form}", clocked, plain, parts, run, check_outputs,
           card, ctas=B)
    ctas = ctypes.c_int(0)
    check(plain.lz4t_chain_occupancy(D, ctypes.byref(ctas)), "occupancy")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    per_wave = ctas.value * sms
    print(f"  CTAs an SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor): "
          f"{ctas.value}; {sms} SMs: {-(-B // per_wave) if per_wave else 0}"
          f" wave(s) of at most {per_wave} CTAs for {B} blocks")


def chain_gathers(cell):
    """Each ``table_gather`` launch of the chain path in fast mode:
    [(label, tables, idx, bits)]."""
    calls = []

    def gather(tables_bits, idx):
        tables = [t for t, _ in tables_bits]
        bits = [b for _, b in tables_bits]
        calls.append((tables, idx, bits))
        return fused_gather.table_gather(tables, idx, bits)

    D, S_cap = cell["D"], cell["S_cap"]
    seq_kernel.parse_records(
        cell["u32"], cell["matched"], cell["off"], cell["mlen"], cell["dl"],
        torch.zeros_like(cell["dl"]), D, S_cap, 0, ev.CU_ROUNDS,
        lambda g: chain_kernel.mark_chain(g, D), gather)
    labels = ["offsets and lengths at the tokens"]
    for r in range(ev.CU_ROUNDS):
        labels += [f"catch-up words at pa, round {r + 1}",
                   f"catch-up words at pb, round {r + 1}"]
    labels += ["mcum at last", "the four merged fields at kidx"]
    if len(calls) != len(labels):
        raise SystemExit(f"chain_clocks: the chain path made {len(calls)} "
                         f"table_gather launches, not {len(labels)}")
    return [(lab, *c) for lab, c in zip(labels, calls)]


def clock_table_gather(csrc, stream, card, cell):
    dll = build_gather(csrc)
    for label, tables, idx, bits in chain_gathers(cell):
        B, N = tables[0].shape
        K = idx.shape[1]
        nt = len(tables)
        outs = [torch.empty_like(idx) for _ in tables]
        masks = [fused_gather._byte_mask(b) for b in bits]
        pad = 4 - nt
        args = ([t.data_ptr() for t in tables] + [None] * pad
                + [idx.data_ptr()] + [o.data_ptr() for o in outs]
                + [None] * pad + masks + [0] * pad + [nt, B, N, K])

        def run():
            check(dll.lz4t_table_gather(*args, stream), "table_gather")

        run()
        want = fused_gather.table_gather_reference(tables, idx, bits)
        torch.cuda.synchronize()
        if not all(torch.equal(o, w) for o, w in zip(outs, want)):
            raise SystemExit(f"chain_clocks: table_gather ({label}) differs "
                             f"from its plain version")
        j = ((idx >> 7).clamp(0, N // 128 - 1) * 128 + (idx & 127)).long()
        rows = torch.arange(B, device=idx.device)[:, None]
        sectors = int(torch.unique(rows * (N // 8) + (j >> 3)).numel())
        ms = event_ms(run)
        wrap_ms = event_ms(lambda: fused_gather.table_gather(tables, idx,
                                                             bits))
        j64 = j.clone()
        lib_ms = event_ms(lambda: [torch.gather(t, 1, j64) for t in tables])
        n_bytes = B * K * 4 * (1 + 2 * nt)
        s_bytes = B * K * 4 * (1 + nt) + nt * sectors * 32
        print(f"table_gather, {label}: {nt} table(s) [{B}, {N}], idx "
              f"[{B}, {K}]: {ms:.4f} ms, {n_bytes / ms / 1e9:.3f} TB/s of "
              f"the bound's {n_bytes} bytes (bound "
              f"{n_bytes / HBM_BYTES_PER_S * 1e3:.4f} ms); distinct 32-byte "
              f"sectors a table {sectors} ({sectors / (B * K):.3f} a slot; "
              f"at sector granularity {s_bytes} bytes, "
              f"{s_bytes / HBM_BYTES_PER_S * 1e3:.4f} ms, "
              f"{s_bytes / ms / 1e9:.3f} TB/s); this checkout's wrapper "
              f"{wrap_ms:.4f} ms; torch.gather {lib_ms:.4f} ms; {card}")


def encode_chain_cell():
    """The encode cell's chain path operands on the card."""
    x, dl, D, S_cap, *_ = encode_cell()
    u32, matched, off, mlen = ev._match_stage(x, dl, D, ev.RCAP, 0, None)
    g = seq_kernel.chain_graph(matched == 1, mlen, D)
    return {"u32": u32, "matched": matched, "off": off, "mlen": mlen,
            "dl": dl, "D": D, "S_cap": S_cap, "g": g}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--csrc", default=_build.CSRC,
                    help="directory of chain_kernel.cu, fused_gather.cu and "
                         "common.cuh (default: the port's csrc/)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("chain_clocks: needs a CUDA device")
    card = _clocks.card()
    print(card)
    csrc = os.path.abspath(args.csrc)
    print(f"sources: {csrc}")
    stream = torch.cuda.current_stream().cuda_stream
    cell = encode_chain_cell()
    clock_mark_chain(csrc, stream, card, cell)
    clock_table_gather(csrc, stream, card, cell)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
