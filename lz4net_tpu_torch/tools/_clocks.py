"""What the clock tools share: copies of the port's kernel files with
marks of ``clock64()`` put in at build time, their builds beside the
port's, and CUDA-event and torch.profiler timing.

A marked copy holds ``lz4t::g_clocks``, NCLK uint64 counters for each of
the first CLK_BLOCKS CTAs of a launch (numbered over its whole grid),
and three macros: ``CLK_ADD(k, v)`` adds v to the calling CTA's counter
k from its lead thread; ``CLK_START`` starts a clock and ``CLK(k)`` adds
the cycles since the previous mark to counter k (with ``barrier``: after
a ``__syncthreads()``, so that the counter holds the CTA's time in a
phase).  The macros count only in the build with ``-DLZ4T_CLOCKS``; the
same copy built without it is the unmarked build.  The C entries
``lz4t_clocks_reset(stream)`` and ``lz4t_clocks_read(dst, ctas, stream)``
zero the counters and copy [ctas, NCLK] of them to the host.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import statistics
import subprocess

import numpy as np
import torch

from .. import _build

NCLK = 16
CLK_BLOCKS = 16384


CTA = "blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z)"


def counters(lead: str = "threadIdx.x == 0", barrier: bool = False,
             cta: str = CTA) -> str:
    """The counters and macros; ``lead`` is the test that picks a CTA's
    lead thread, ``cta`` the expression that numbers the CTAs (by
    default over the launch's whole grid)."""
    sync = ("    __syncthreads();" + " " * 47 + "\\\n") if barrier else ""
    return f"""
namespace lz4t {{
constexpr int NCLK = {NCLK};
constexpr int CLK_BLOCKS = {CLK_BLOCKS};
__device__ unsigned long long g_clocks[CLK_BLOCKS * NCLK];
}}
#ifdef LZ4T_CLOCKS
#define CLK_ADD(k, v)                                                  \\
  do {{                                                                 \\
    const unsigned cta_ = {cta};                                       \\
    if (({lead}) && cta_ < lz4t::CLK_BLOCKS)                           \\
      atomicAdd(&lz4t::g_clocks[cta_ * lz4t::NCLK + (k)],              \\
                (unsigned long long)(v));                              \\
  }} while (0)
#define CLK_START long long clk_t_ = clock64();
#define CLK(k)                                                         \\
  do {{                                                                 \\
{sync}    const long long t_ = clock64();                                \\
    CLK_ADD(k, t_ - clk_t_);                                           \\
    clk_t_ = t_;                                                       \\
  }} while (0)
#else
#define CLK_ADD(k, v)
#define CLK_START
#define CLK(k)
#endif
"""


EPILOGUE = """
extern "C" int lz4t_clocks_reset(void* stream) {
  void* p = nullptr;
  cudaError_t err = cudaGetSymbolAddress(&p, lz4t::g_clocks);
  if (err == cudaSuccess)
    err = cudaMemsetAsync(p, 0, sizeof(lz4t::g_clocks),
                          (cudaStream_t)stream);
  return (int)err;
}

extern "C" int lz4t_clocks_read(void* dst, int ctas, void* stream) {
  return (int)cudaMemcpyFromSymbolAsync(
      dst, lz4t::g_clocks, sizeof(unsigned long long) * lz4t::NCLK * ctas,
      0, cudaMemcpyDeviceToHost, (cudaStream_t)stream);
}
"""


def marked(src: str, marks, name: str, prelude: str) -> str:
    """``src`` (the text of ``name``) with ``prelude`` after its include
    of common.cuh, each (text, marked text) of ``marks`` replaced, and
    the reset and read entries; a text not found once stops the tool."""
    include = '#include "common.cuh"\n'
    for old, new in ((include, include + prelude), *marks):
        if src.count(old) != 1:
            raise SystemExit(f"the place of a mark is not found once in "
                             f"{name}: {old!r}")
        src = src.replace(old, new)
    return src + EPILOGUE


HEADER = re.compile(r"^  // ---- (\d+)\. (.*?) -*$", re.M)
KERNEL = re.compile(r"__global__ void\s+(?:__launch_bounds__\([^)]*\)\s*)?"
                    r"(\w+)\(")


def phase_marks(src: str, name: str):
    """``src`` (the text of ``name``) with a barrier mark before each
    phase header (a ``// ---- k. ...`` comment at a kernel body's top
    level) and at the end of each kernel that has them, and the layout
    [(kernel, [(counter, phase)])] in the order of the source."""
    heads = list(HEADER.finditer(src))
    kernels = list(KERNEL.finditer(src))
    groups = []                       # (kernel match, [header matches])
    for h in heads:
        owner = [k for k in kernels if k.start() < h.start()]
        if not owner:
            raise SystemExit(f"a phase header of {name} lies outside "
                             f"every kernel")
        if groups and groups[-1][0] is owner[-1]:
            groups[-1][1].append(h)
        else:
            groups.append((owner[-1], [h]))
    if not groups:
        raise SystemExit(f"no phase headers in a kernel of {name}")
    out, at, idx, layout = [], 0, 0, []
    for kern, hs in groups:
        phases = []
        for j, h in enumerate(hs):
            out.append(src[at:h.start()])
            out.append("  CLK_START\n" if j == 0 else f"  CLK({idx - 1});\n")
            phases.append((idx, h.group(2)))
            at = h.start()
            idx += 1
        end = src.find("\n}\n", at)    # the kernel body's closing brace
        if end < 0:
            raise SystemExit(f"no end of {kern.group(1)} in {name}")
        out.append(src[at:end] + f"\n  CLK({idx - 1});")
        at = end
        layout.append((kern.group(1), phases))
    if idx > NCLK:
        raise SystemExit(f"more than {NCLK} phases in {name}")
    out.append(src[at:])
    return marked("".join(out), (), name, counters(barrier=True)), layout


def build(tag: str, name: str, text: str, csrc: str, entries,
          extra=(), plain: bool = True):
    """Libraries of ``text``, a marked copy of ``name`` from ``csrc``,
    each with the ``extra`` sources, built in the port's build directory:
    the clocked one and, with ``plain``, the unmarked one, whose ``ptxas
    -v`` registers and spills are printed when it is built (not when it
    is found built).  ``entries``: {C entry: argument types}, each
    returning int.  Returns [clocked] or [clocked, unmarked] (CDLLs)."""
    h = hashlib.sha256(text.encode() + " ".join(_build.NVCC_FLAGS).encode())
    for path in (os.path.join(csrc, "common.cuh"), *extra):
        with open(path, "rb") as fh:
            h.update(fh.read())
    out_dir = os.path.join(_build.BUILD_DIR, f"{tag}-{h.hexdigest()[:16]}")
    cu = os.path.join(out_dir, name.replace(".cu", "_clocks.cu"))
    libs = [os.path.join(out_dir, n)
            for n in ("libclocked.so", "libplain.so")[:1 + plain]]
    if not all(map(os.path.exists, libs)):
        os.makedirs(out_dir, exist_ok=True)
        with open(cu, "w") as fh:
            fh.write(text)
        base = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", csrc, "-shared"]
        procs = [subprocess.Popen(base + ["-DLZ4T_CLOCKS", cu, *extra,
                                          "-o", libs[0]])]
        if plain:
            procs.append(subprocess.Popen(
                base + ["-Xptxas", "-v", cu, *extra, "-o", libs[1]],
                stderr=subprocess.PIPE, text=True))
        log = procs[-1].communicate()[1] if plain else ""
        if any(p.wait() != 0 for p in procs):
            raise SystemExit(f"nvcc failed on {cu}\n{log or ''}")
        for line in log.splitlines():
            if "Compiling entry" in line or "registers" in line \
                    or "spill" in line:
                print(line.strip())
    P, I = ctypes.c_void_p, ctypes.c_int
    dlls = [ctypes.CDLL(p) for p in libs]
    for dll in dlls:
        for fn, args in (*entries.items(), ("lz4t_clocks_reset", [P]),
                         ("lz4t_clocks_read", [P, I, P])):
            getattr(dll, fn).argtypes = args
            getattr(dll, fn).restype = ctypes.c_int
    return dlls


def check(rc, what):
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc}")


def reset(dll):
    check(dll.lz4t_clocks_reset(torch.cuda.current_stream().cuda_stream),
          "clocks reset")


def read(dll, ctas: int = CLK_BLOCKS) -> np.ndarray:
    """The counters of the first ``ctas`` CTAs, [ctas, NCLK] float64."""
    if ctas > CLK_BLOCKS:
        raise SystemExit(f"the clocks hold {CLK_BLOCKS} CTAs, not {ctas}")
    rows = np.zeros((ctas, NCLK), np.uint64)
    check(dll.lz4t_clocks_read(rows.ctypes.data, ctas,
                               torch.cuda.current_stream().cuda_stream),
          "clocks read")
    torch.cuda.synchronize()
    return rows.astype(np.float64)


def card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def event_ms(fn, inner=10, reps=5):
    """Median over ``reps`` of the ms a call of ``fn`` (CUDA events
    around ``inner`` back-to-back calls)."""
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


def kernel_split(fn, calls=10):
    """Device ms a call of ``fn`` by the name of each of the port's CUDA
    kernels it runs (torch.profiler; each kernel's mean over the launches
    the trace kept, which may be fewer than the calls), or None where the
    trace holds none of them."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    # "lz4t::(anonymous namespace)::name(...)", or "void lz4t::...::
    # name<G, PF>(...)" for a template instance
    split = {"".join(re.search(r"(\w+)(<[^>(]*>)?\(", e.key).groups("")):
             e.self_device_time_total / 1e3 / e.count
             for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA and "lz4t::" in e.key}
    return split or None
