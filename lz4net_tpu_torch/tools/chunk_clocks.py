"""Where the cycles of ``resolve_wavefront`` and ``hc_tables`` go, on the
card, and how ``hc_tables``' call splits between its wrapper and its
kernel.

    python3 -m lz4net_tpu_torch.tools.chunk_clocks             # repo root
    python3 -m lz4net_tpu_torch.tools.chunk_clocks --csrc DIR  # other sources

Copies ``resolve_kernel.cu`` and ``hc_kernel.cu`` from ``--csrc`` (the
port's ``csrc/`` by default; another checkout's, to clock an earlier
form) with marks of ``clock64()`` put into each kernel (``MARKS`` below,
one set for each form of each file; the set whose places all occur once
in the source is taken): thread 0 of each CTA adds the cycles between
marks, and counts, to its CTA's counters (``tools/_clocks.py``).  The
marks add no barrier; each sits where the kernel has one or where thread
0 waits on its own loads (a move of a loaded register, in the clocked
build only), so a counter holds the CTA's time in that part.  Each file is built twice, with and without the marks, into
libraries of their own beside the port's build.  Then it runs both on
the cells of the main paths (the 16 MB silesia-like corpus, seed 0, in
256 blocks of 64 KB), checks every output against the port's own
kernels, and prints:

* ``ptxas -v``'s registers and spills of each kernel of the unmarked
  builds (when they are built, not when they are found built);
* ``resolve_wavefront`` on the decode cell's state words (the blocks as
  the strict encoder compresses them, through the port's decode
  kernels): cycles a CTA by part, the doubling rounds the chunks run
  (of the first form's synchronous doubling, from the words; and the
  rounds the clocked kernel ran), and the share of positions whose
  in-chunk root is a terminal, a pointer into an earlier chunk, or 0;
* ``hc_tables`` on the HC L5 cell's three run tables and the hash tiers'
  seven tables: cycles a CTA by part, and the times of the wrapper
  (``ops.hash_kernel.hc_tables`` of this checkout, whatever ``--csrc``
  says), of the kernel alone (the C entry of the sources clocked, on
  prepared operands) and of what the first form's wrapper does besides
  (``torch.stack`` of the streams), with the device time by kernel name
  of one wrapper call (torch.profiler over 10 calls);
* the times of the clocked and unmarked builds (CUDA events; the marks
  cost time of their own).
"""

from __future__ import annotations

import argparse
import ctypes
import os
import re

import numpy as np
import torch

from .. import _build
from ..models import cuda as cuda_engine
from ..ops import decode_vector as dv
from ..ops import encode_vector as ev
from ..ops import fused_gather, hash_kernel, parse_kernel, records_kernel
from ..ops import resolve_kernel
from ..utils import corpus
from . import _clocks
from ._clocks import check, event_ms

CH = resolve_kernel.CH
WAIT = "CLK_WAIT(w_);"
# CLK_WAIT(x): the thread waits for x (a move of x's register), in the
# clocked build only
WAIT_MACRO = """#ifdef LZ4T_CLOCKS
#define CLK_WAIT(x) asm volatile("mov.b32 %0, %0;" : "+r"(x))
#else
#define CLK_WAIT(x)
#endif
"""
# the redesigned hc_tables launches up to two grids (one-table groups,
# then the others, from group g0): a CTA is numbered by its block and
# group
HC_CTA = "8 * blockIdx.y + g0 + blockIdx.x"

# (text of the source, the same text with its marks) for each form; each
# text occurs once in its form.  The parts: {counter: name}; a name that
# starts with "#" is a count, not cycles.  A third item, where there is
# one, numbers the CTAs for the counters.
MARKS = {
    "resolve_kernel.cu": {
        "first form (one CTA a block, chunks in order)": ([
            ("  bool converged = true;\n",
             "  bool converged = true;\n  CLK_START\n"),
            ("    __syncthreads();\n\n    int changed = 1;",
             "    __syncthreads();\n    CLK(0);\n\n    int changed = 1;"),
            ("      changed = __syncthreads_or(mine);\n",
             "      changed = __syncthreads_or(mine);\n      CLK_ADD(3, 1);\n"),
            ("    converged = converged && !changed;\n",
             "    CLK(1);\n    converged = converged && !changed;\n"),
            ("    __syncthreads();                     // chunk j visible to "
             "chunk j+1\n",
             "    __syncthreads();                     // chunk j visible to "
             "chunk j+1\n    CLK(2);\n"),
        ], {0: "t0 loads and the ordinals", 1: "doubling rounds",
            2: "terminal and cross-chunk reads, stores", 3: "#rounds"}),
        "redesign (a CTA a chunk, look-back between chunks)": ([
            ("  __shared__ int s_v;\n", "  __shared__ int s_v;\n  CLK_START\n"),
            ("  if (threadIdx.x == 0) s_v = atomicAdd(next, 1);\n"
             "  __syncthreads();\n",
             "  if (threadIdx.x == 0) s_v = atomicAdd(next, 1);\n"
             "  __syncthreads();\n  CLK(5);\n"),
            ("  if (!__syncthreads_or(fwd)) {\n",
             "  if (!__syncthreads_or(fwd)) {\n    CLK(0);\n"),
            ("      pending = __syncthreads_or(!(all & ROOT));\n",
             "      CLK_ADD(6, 1);\n"
             "      pending = __syncthreads_or(!(all & ROOT));\n"),
            ("  // ---- 3. bytes", "  CLK(1);\n  // ---- 3. bytes"),
            ("      __threadfence();\n    }\n    __syncthreads();\n  }\n",
             "      __threadfence();\n    }\n    __syncthreads();\n  }\n"
             "  CLK(2);\n"),
            ("  __syncthreads();                       // every store of the "
             "chunk issued\n",
             "  __syncthreads();                       // every store of the "
             "chunk issued\n  CLK(3);\n"),
            ("    atomicExch(flag, 1);\n  }\n}",
             "    atomicExch(flag, 1);\n  }\n  CLK(4);\n}"),
        ], {5: "ticket", 0: "t0 loads and parents", 1: "pointer jumping rounds",
            2: "wait for chunk j-1", 3: "bytes (earlier-chunk reads, stores)",
            4: "publish (fence, flag)", 6: "#rounds"}),
    },
    "hc_kernel.cu": {
        "first form (one CTA a table, loads waited each chunk)": ([
            ("  __syncthreads();\n\n  const size_t row",
             "  __syncthreads();\n  CLK_START\n\n  const size_t row"),
            ("    const int k = clampi(h_all[hrow + i], 0, nb - 1);\n",
             "    const int k = clampi(h_all[hrow + i], 0, nb - 1);\n"
             "    { int w_ = a ^ k; " + WAIT + " }\n    CLK(0);\n"),
            ("    atomicAdd(&cnt[k], 1u);\n",
             "    atomicAdd(&cnt[k], 1u);\n    CLK(1);\n"),
            ("    __syncthreads();   // every probe done, every hit counted\n",
             "    __syncthreads();   // every probe done, every hit counted\n"
             "    CLK(2);\n"),
            ("      tw[k] = (unsigned)a;\n    }\n",
             "      tw[k] = (unsigned)a;\n    }\n    CLK(3);\n"),
            ("    __syncthreads();   // every count read before any reset\n",
             "    __syncthreads();   // every count read before any reset\n"
             "    CLK(4);\n"),
            ("    __syncthreads();   // counts reset before the next chunk's "
             "hits\n",
             "    __syncthreads();   // counts reset before the next chunk's "
             "hits\n    CLK(5);\n"),
        ], {0: "loads (wa, h)", 1: "probe and count", 2: "barrier 1",
            3: "update", 4: "barrier 2", 5: "reset and barrier 3"}),
        "redesign (a CTA a table group, loads PF chunks ahead)": ([
            ("  __syncthreads();                      // tables zeroed\n",
             "  __syncthreads();                      // tables zeroed\n"
             "  CLK_START\n"),
            ("      for (int q = 0; q < G; ++q) k[q] = clampi(h_buf[s][q], 0, "
             "nb[q] - 1);\n",
             "      for (int q = 0; q < G; ++q) k[q] = clampi(h_buf[s][q], 0, "
             "nb[q] - 1);\n      { int w_ = a ^ k[0]; " + WAIT + " }\n"
             "      CLK(0);\n"),
            ("      __syncthreads();                  // every probe done, "
             "every hit counted\n",
             "      CLK(1);\n      __syncthreads();                  // every "
             "probe done, every hit counted\n      CLK(2);\n"),
            ("      __syncthreads();                  // updates seen by the "
             "next probes\n",
             "      CLK(3);\n      __syncthreads();                  // "
             "updates seen by the next probes\n      CLK(4);\n"),
        ], {0: "loads (waiting on wa, h)", 1: "probe and count",
            2: "barrier 1", 3: "update", 4: "barrier 2"}, HC_CTA),
    },
}


def entry_pointers(src: str, entry: str) -> int:
    """Pointer arguments of C entry ``entry`` in ``src``, less the
    stream."""
    m = re.search(rf'extern "C" int {entry}\((.*?)\)', src, re.S)
    if not m:
        raise SystemExit(f"chunk_clocks: no {entry} entry")
    return m.group(1).count("void*") - 1


def build(csrc: str, name: str, entry: str):
    """(clocked library, unmarked library, form, parts, source) of one
    kernel file."""
    with open(os.path.join(csrc, name)) as fh:
        src = fh.read()
    forms = [(form, *spec) for form, spec in MARKS[name].items()
             if all(src.count(old) == 1 for old, _ in spec[0])]
    if len(forms) != 1:
        raise SystemExit(f"chunk_clocks: {name} in {csrc} matches "
                         f"{len(forms)} of the known forms' marks")
    form, marks, parts, *cta = forms[0]
    prelude = _clocks.counters(**({"cta": cta[0]} if cta else {}))
    text = _clocks.marked(src, marks, name, prelude + WAIT_MACRO)
    argtypes = ([ctypes.c_void_p] * entry_pointers(src, entry)
                + _build.SIGNATURES[entry][-4:])
    clocked, plain = _clocks.build("chunkclocks", name, text, csrc,
                                   {entry: argtypes})
    return clocked, plain, form, parts, src


def report(title, clocked, plain, parts, run, check_outputs, card,
           ctas=None):
    """Run ``run(dll)`` on both builds, ``check_outputs()`` after each,
    print the parts' cycles a CTA and the two builds' times; returns the
    counters [ctas, NCLK]."""
    for dll in (plain, clocked):
        _clocks.reset(clocked)
        run(dll)
        torch.cuda.synchronize()
        check_outputs()
    rows = _clocks.read(clocked, ctas or _clocks.CLK_BLOCKS)
    live = rows[rows.any(1)]
    cyc = {k: n for k, n in parts.items() if not n.startswith("#")}
    mean = {k: live[:, k].mean() for k in cyc}
    # a part named "who: part" is a share of that thread's time, the
    # others of the CTA's
    who = {k: n.split(": ")[0] if ": " in n else "" for k, n in cyc.items()}
    total = {w: sum(mean[k] for k in cyc if who[k] == w)
             for w in set(who.values())}
    print(f"{title}: equal to the port's; {len(live)} CTAs; cycles a CTA, "
          f"mean (share):")
    for k, n in cyc.items():
        print(f"  {k + 1}. {n}: {mean[k]:.0f} "
              f"({mean[k] / total[who[k]]:.3f})")
    for w, t in sorted(total.items()):
        ks = [k for k in cyc if who[k] == w]
        print(f"  all{f' ({w})' if w else ''}: {t:.0f} (slowest CTA "
              f"{live[:, ks].sum(1).max():.0f})")
    for k, n in parts.items():
        if n.startswith("#"):
            print(f"  {n[1:]} a CTA: mean {live[:, k].mean():.2f}, most "
                  f"{live[:, k].max():.0f}")
    ms_clocked = event_ms(lambda: run(clocked))
    ms_plain = event_ms(lambda: run(plain))
    print(f"  time: clocked build {ms_clocked:.4f} ms, unmarked "
          f"{ms_plain:.4f} ms; {card}")
    return live


def decode_states():
    """The decode cell's state words T0 [256, 73728] on the card."""
    blocks = corpus.split_blocks(corpus.silesia_like(16 << 20, seed=0),
                                 1 << 16)
    packed = cuda_engine.compress_blocks(blocks, device="cuda")
    comp_np, cl_np, ol_np, C, D = dv.pack_blocks(packed,
                                                 list(map(len, blocks)))
    comp, comp_len, out_len = dv.batch_from_numpy(comp_np, cl_np, ol_np,
                                                  "cuda")
    mark, ll, ml, _ = parse_kernel.parse_tokens(comp, comp_len, C)
    t0m, cidx, _ = records_kernel.records_to_state(
        comp, mark, ll, ml, comp_len, out_len, torch.zeros_like(comp_len),
        C, D, 0)
    is_lit = cidx >= 0
    lit_idx = torch.cummax(torch.where(is_lit, cidx.clamp(0, C - 1), 0),
                           dim=1).values
    vals, _ = fused_gather.rowbase_gather(comp, lit_idx)
    return torch.where(is_lit, dv.VFLAG | (vals & 0xFF), t0m)


def chunk_rounds(t0):
    """The rounds the first form's synchronous doubling runs on each
    (block, chunk), [B, nch], and the counts of in-chunk roots that are
    terminals, pointers into an earlier chunk, and 0 (chunk 0's
    non-terminal roots)."""
    B, Dt = t0.shape
    k = torch.arange(CH, device=t0.device).expand(B, CH)
    rounds = torch.zeros((B, Dt // CH), dtype=torch.int32,
                         device=t0.device)
    kinds = torch.zeros(3, dtype=torch.int64, device=t0.device)
    for j in range(Dt // CH):
        lo = j * CH
        t = t0[:, lo:lo + CH]
        n = torch.where((t < dv.VFLAG) & (t >= lo),
                        (t - lo).clamp(max=CH - 1), k).long()
        live = torch.ones(B, dtype=torch.bool, device=t0.device)
        for _ in range(resolve_kernel.MAX_ROUNDS):
            rounds[:, j] += live.int()
            n2 = torch.gather(n, 1, n)
            live &= (n2 != n).any(1)
            n = n2
        tt = torch.gather(t, 1, n)
        term = tt >= dv.VFLAG
        kinds += torch.stack([term.sum(), (~term).sum() * (lo > 0),
                              (~term).sum() * (lo == 0)])
    return rounds, kinds


def hc_cell():
    """The HC L5 cell's ``hc_tables`` operands for the run tables and for
    the hash tiers' seven: [(label, wa, hs, sticky, nrows, D)]."""
    blocks = corpus.split_blocks(corpus.silesia_like(16 << 20, seed=0),
                                 1 << 16)
    D, _, _ = ev.batch_shapes(max(map(len, blocks)))
    xn = np.zeros((len(blocks), D), np.uint8)
    for j, blk in enumerate(blocks):
        xn[j, :len(blk)] = np.frombuffer(blk, np.uint8)
    x = torch.from_numpy(xn).cuda().to(torch.int32)
    u32 = ev._u32(x)
    us4 = ev._shift_left(u32, 4)
    run_fwd, is_rs = ev._byte_runs(x)
    cells = []
    for tables, label in (("runs", "3 run tables (HC L5)"),
                          (None, "7 tables (hash tiers)")):
        _, hs, sticky, nrows = hash_kernel.hc_streams(x, u32, us4, is_rs,
                                                      run_fwd, tables)
        cells.append((label, u32, hs, sticky, nrows, D))
    return cells


def device_split(fn, calls=10):
    """Device ms a call of ``fn`` by kernel, every kernel it runs (the
    port's and PyTorch's), from torch.profiler: [(name, ms)], each
    kernel's mean over the launches the trace kept."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return [(e.key[:70], e.self_device_time_total / 1e3 / e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and not e.key.startswith("Activity Buffer")]


def clock_resolve(csrc, stream, card):
    """``resolve_wavefront`` on the decode cell."""
    clocked, plain, form, parts, src = build(csrc, "resolve_kernel.cu",
                                             "lz4t_resolve_wavefront")
    T0 = decode_states()
    B, Dt = T0.shape
    want = resolve_kernel.resolve_wavefront(T0, 0)
    out = torch.empty_like(T0)
    ok = torch.empty(B, dtype=torch.bool, device="cuda")
    scratch = ([torch.empty(resolve_kernel.scratch_words(B, Dt),
                            dtype=torch.int32, device="cuda")]
               if entry_pointers(src, "lz4t_resolve_wavefront") == 4
               else [])
    ptrs = [t.data_ptr() for t in (T0, out, ok, *scratch)]

    def run_resolve(dll):
        check(dll.lz4t_resolve_wavefront(*ptrs, B, Dt, 0, stream),
              "resolve_wavefront")

    def check_resolve():
        if not (torch.equal(out, want[0]) and torch.equal(ok, want[1])):
            raise SystemExit("chunk_clocks: resolve_wavefront differs from "
                             "the port's")

    rounds, kinds = chunk_rounds(T0)
    hist = torch.bincount(rounds.flatten(),
                          minlength=resolve_kernel.MAX_ROUNDS + 1)
    print(f"decode cell, B={B} Dt={Dt}: rounds of synchronous doubling a "
          f"(block, chunk) (first form): mean "
          f"{float(rounds.float().mean()):.2f}, chunks by rounds "
          + ", ".join(f"{r}: {int(c)}" for r, c in enumerate(hist.tolist())
                      if c)
          + f"; in-chunk roots: terminal {int(kinds[0])}, earlier chunk "
          f"{int(kinds[1])}, zero {int(kinds[2])} of {B * Dt}")
    report(f"resolve_wavefront, {form}", clocked, plain, parts,
           run_resolve, check_resolve, card)


def clock_hc(csrc, stream, card):
    """``hc_tables`` on the HC L5 cell's table sets."""
    clocked, plain, form, parts, src = build(csrc, "hc_kernel.cu",
                                             "lz4t_hc_tables")
    # the first form takes the streams stacked [nt, B, D], a later one a
    # host array of their pointers
    stacked = re.search(r"int lz4t_hc_tables\(const void\* wa, const void\* h,",
                        src) is not None
    for label, wa, hs, sticky, nrows, D in hc_cell():
        B, nt = wa.shape[0], len(hs)
        want = hash_kernel.hc_tables(wa, hs, sticky, nrows, D)
        meta = (ctypes.c_int * (2 * nt))(*(v for r, s in zip(nrows, sticky)
                                           for v in (r * hash_kernel.LANE,
                                                     int(bool(s)))))
        cands = torch.empty((nt, B, D), dtype=torch.int32, device="cuda")
        if stacked:
            h_all = torch.stack(hs)
            h_arg = h_all.data_ptr()
        else:
            h_ptrs = (ctypes.c_void_p * nt)(*(h.data_ptr() for h in hs))
            h_arg = ctypes.addressof(h_ptrs)

        def run_hc(dll):
            check(dll.lz4t_hc_tables(wa.data_ptr(), h_arg,
                                     ctypes.addressof(meta),
                                     cands.data_ptr(), B, D, nt, stream),
                  "hc_tables")

        def check_hc():
            if not all(torch.equal(c, w) for c, w in zip(cands, want)):
                raise SystemExit("chunk_clocks: hc_tables differs from the "
                                 "port's")

        report(f"hc_tables, {label}, B={B} D={D}, {form}", clocked, plain,
               parts, run_hc, check_hc, card)
        wrapper = lambda: hash_kernel.hc_tables(wa, hs, sticky, nrows, D)
        ms_wrap = event_ms(wrapper)
        ms_kernel = event_ms(lambda: run_hc(plain))
        ms_stack = event_ms(lambda: torch.stack(hs))
        split = device_split(wrapper)
        print(f"  this checkout's wrapper {ms_wrap:.4f} ms; kernel alone "
              f"(C entry, the sources clocked) "
              f"{ms_kernel:.4f} ms, torch.stack of the streams alone "
              f"{ms_stack:.4f} ms; the wrapper's device time by kernel "
              f"(torch.profiler, 10 calls): " + (
                  "; ".join(f"{k} {v:.4f} ms" for k, v in split)
                  if split else "not measured (no kernel in the trace)")
              + f"; {card}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--csrc", default=_build.CSRC,
                    help="directory of resolve_kernel.cu, hc_kernel.cu and "
                         "common.cuh (default: the port's csrc/)")
    ap.add_argument("--only", choices=("resolve_wavefront", "hc_tables"),
                    help="clock one of the two kernels")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("chunk_clocks: needs a CUDA device")
    card = _clocks.card()
    print(card)
    csrc = os.path.abspath(args.csrc)
    print(f"sources: {csrc}")
    stream = torch.cuda.current_stream().cuda_stream
    if args.only != "hc_tables":
        clock_resolve(csrc, stream, card)
    if args.only != "resolve_wavefront":
        clock_hc(csrc, stream, card)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
