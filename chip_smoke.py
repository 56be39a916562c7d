#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (lz4net_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py            # from the repository root

1. prints the card's name and power limit (nvidia-smi);
2. builds the four CUDA kernels from lz4net_tpu_torch/csrc with nvcc;
3. runs each kernel and its plain PyTorch version on the card on the same
   inputs, at the shapes of the main path below, requires every int
   output to be equal, and times both (CUDA events around 10 back-to-back
   calls, median of 5; rowbase_gather also beside torch.gather, which
   the port never calls);
4. decodes a 16 MB silesia-like corpus (seed 0) in 256 blocks of 64 KB,
   compressed by the port's reference compressor, through
   lz4net_tpu_torch.codec.decode_batch on the card; requires every block
   to equal its source bytes, no host re-decode, and every kernel to have
   launched; prints ms per batch and GB/s of decoded output;
5. requires a truncated block to raise CorruptedBlockError;
6. prints one JSON line with the kernels, then, last,
   {"ok": true, "device": {...}}.

Any failure exits non-zero before the last line.  Without a CUDA device,
or without the package beside this script, it exits non-zero at once.
"""

import cProfile
import json
import pstats
import statistics
import subprocess
import sys
import time

CORPUS_BYTES = 16 << 20
BLOCK = 64 * 1024
SEED = 0
REPS = 5
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
# The integer work of these kernels has no published peak in NVIDIA's
# data sheet; the 67 TFLOP/s of float32 outside the tensor cores (the
# same pipes) stands in for it.
PEAK_OPS_PER_S = 67e12


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def time_ms(torch, fn, inner: int = 10) -> float:
    """Device time per call of ``fn``: CUDA events around ``inner``
    back-to-back calls, so the wrapper's host work overlaps the previous
    launch; median of REPS such runs, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(REPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def _flat(x):
    if isinstance(x, (list, tuple)):
        for y in x:
            yield from _flat(y)
    else:
        yield x


def max_abs_err(torch, got, want) -> int:
    err = 0
    for g, w in zip(_flat(got), _flat(want)):
        if g.shape != w.shape:
            fail(f"shape {tuple(g.shape)} != {tuple(w.shape)}")
        err = max(err, int((g.long() - w.long()).abs().max()))
    return err


def bound(n_bytes: float, n_ops: float):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def where_the_time_goes(torch, codec, packed, lens, card):
    """The device's busy share and time by kernel from torch.profiler over
    one codec.decode_batch call, the host's time by function from
    cProfile over another, then five more calls timed on the host clock
    (the steady state)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        codec.decode_batch(packed, lens, device="cuda")
        torch.cuda.synchronize()
        prof_ms = (time.perf_counter() - t) * 1e3
    # device-side events only (kernels and copies; the CPU ops that
    # launched them would count them twice), without the profiler's own
    dev = [e for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA
           and not e.key.startswith("Activity Buffer")]
    busy_ms = sum(e.self_device_time_total for e in dev) / 1e3
    print(f"profile: device busy {busy_ms:.3f} ms of a {prof_ms:.2f} ms "
          f"profiled call, idle share {1 - busy_ms / prof_ms:.3f}; {card}")
    for e in sorted(dev, key=lambda e: -e.self_device_time_total)[:10]:
        print(f"  device {e.self_device_time_total / 1e3:.4f} ms "
              f"x{e.count} {e.key[:90]}")

    # host time by function inside one call (cProfile's own time)
    cprof = cProfile.Profile()
    t = time.perf_counter()
    cprof.enable()
    codec.decode_batch(packed, lens, device="cuda")
    torch.cuda.synchronize()
    cprof.disable()
    call_ms = (time.perf_counter() - t) * 1e3
    top = sorted(pstats.Stats(cprof).stats.items(), key=lambda kv: -kv[1][2])
    print(f"host profile: {call_ms:.2f} ms call, own time by function:")
    for (path, line, fn), (_, ncalls, own, _, _) in top[:6]:
        print(f"  host {own * 1e3:.2f} ms x{ncalls} {fn} "
              f"({path.rsplit('/', 1)[-1]}:{line})")

    # the same calls again, now that the process has run a few
    late = []
    for _ in range(REPS):
        t = time.perf_counter()
        codec.decode_batch(packed, lens, device="cuda")
        torch.cuda.synchronize()
        late.append((time.perf_counter() - t) * 1e3)
    late_ms = statistics.median(late)
    print("late decode_batch calls (ms): "
          + " ".join(f"{w:.2f}" for w in late)
          + f"; median {late_ms:.2f} ms, "
          f"{sum(lens) / late_ms / 1e6:.4f} GB/s decoded; {card}")


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    try:
        from lz4net_tpu_torch import _build, codec
        from lz4net_tpu_torch.models import cuda as cuda_engine
        from lz4net_tpu_torch.models import reference
        from lz4net_tpu_torch.ops import decode_vector as dv
        from lz4net_tpu_torch.ops import (fused_gather, parse_kernel,
                                          records_kernel, resolve_kernel)
        from lz4net_tpu_torch.utils import corpus
    except ImportError as exc:
        print(f"chip_smoke: the lz4net_tpu_torch package is missing "
              f"({exc}); run from the repository root", file=sys.stderr)
        return 3

    card = card_line()
    print(card)
    name = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {name}")

    # ---- build --------------------------------------------------------
    t = time.perf_counter()
    _build.load()
    print(f"build: {time.perf_counter() - t:.1f} s")

    # ---- workload: bench.py's 16 MB in 64 KB blocks ---------------------
    t = time.perf_counter()
    data = corpus.silesia_like(CORPUS_BYTES, seed=SEED)
    blocks = corpus.split_blocks(data, BLOCK)
    packed = [reference.compress_block(b) for b in blocks]
    lens = [len(b) for b in blocks]
    print(f"workload: {len(blocks)} blocks, {len(data)} bytes -> "
          f"{sum(map(len, packed))} compressed, made in "
          f"{time.perf_counter() - t:.1f} s")

    comp_np, cl_np, ol_np, C, D = dv.pack_blocks(packed, lens)
    comp, comp_len, out_len = dv.batch_from_numpy(comp_np, cl_np, ol_np,
                                                  "cuda")
    B, Dt = comp.shape[0], D
    pre_len = torch.zeros_like(comp_len)
    print(f"shapes: B={B} C={C} Dt={Dt}")

    # ---- per-kernel phase: kernel vs plain version on the card ----------
    rows = []

    def kernel_row(kname, source, replaces, mod, fn, plain, n_bytes,
                   n_ops, library=None):
        got, want = fn(), plain()
        torch.cuda.synchronize()
        err = max_abs_err(torch, got, want)
        if err != 0:
            fail(f"{kname}: kernel differs from its plain version "
                 f"(max abs err {err})")
        ms, plain_ms = time_ms(torch, fn), time_ms(torch, plain)
        lib_ms = time_ms(torch, library) if library else None
        bound_ms, bound_by = bound(n_bytes, n_ops)
        rows.append({"name": kname, "route": "cuda", "source": source,
                     "replaces": replaces, "module": mod,
                     "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": bound_ms, "bound_by": bound_by,
                     "library_ms": lib_ms})
        print(f"kernel {kname}: {ms:.4f} ms (plain {plain_ms:.4f} ms, "
              f"bound {bound_ms:.4f} ms by {bound_by}"
              + (f", library {lib_ms:.4f} ms" if lib_ms else "")
              + f"), max abs err {err}; {card}")
        return got

    # Bytes each function must move: outputs written whole, inputs read
    # where this run's data needs them.  Compressed-side inputs (comp, and
    # ll/ml at the marked positions) are needed only below comp_len;
    # mark is scanned over all of C.
    i4 = 4
    n_comp = int(comp_len.sum())
    mark, ll, ml, _miss = kernel_row(
        "parse_tokens", "lz4net_tpu_torch/csrc/parse_kernel.cu",
        "lz4net_tpu/ops/parse_kernel.py:159", parse_kernel,
        lambda: parse_kernel.parse_tokens(comp, comp_len, C),
        lambda: parse_kernel.parse_tokens_reference(comp, comp_len, C),
        n_bytes=n_comp * i4 + B * C * i4 * 3 + B * i4 + B,
        n_ops=B * C * 30)
    n_tok = int(mark.sum())
    t0m, cidx, _stats = kernel_row(
        "records_to_state", "lz4net_tpu_torch/csrc/records_kernel.cu",
        "lz4net_tpu/ops/records_kernel.py:374", records_kernel,
        lambda: records_kernel.records_to_state(
            comp, mark, ll, ml, comp_len, out_len, pre_len, C, Dt, 0),
        lambda: records_kernel.records_to_state_reference(
            comp, mark, ll, ml, comp_len, out_len, pre_len, C, Dt, 0),
        n_bytes=B * C * i4 + 3 * n_comp * i4 + 3 * B * i4
        + 2 * B * Dt * i4 + B * 8 * i4,
        n_ops=B * C * 30 + B * Dt * (20 + 3 * max(n_tok // B, 1)
                                     .bit_length()))
    is_lit = cidx >= 0
    lit_idx = torch.cummax(torch.where(is_lit, cidx.clamp(0, C - 1), 0),
                           dim=1).values
    lit_idx64 = lit_idx.long()
    vals, _band = kernel_row(
        "rowbase_gather", "lz4net_tpu_torch/csrc/fused_gather.cu",
        "lz4net_tpu/ops/fused_gather.py:217", fused_gather,
        lambda: fused_gather.rowbase_gather(comp, lit_idx),
        lambda: fused_gather.rowbase_gather_reference(comp, lit_idx),
        # the indices are a running max of literal sources, all < comp_len
        n_bytes=n_comp * i4 + B * Dt * (i4 + i4 + 1), n_ops=B * Dt * 4,
        library=lambda: torch.gather(comp, 1, lit_idx64))
    T0 = torch.where(is_lit, dv.VFLAG | (vals & 0xFF), t0m)
    kernel_row(
        "resolve_wavefront", "lz4net_tpu_torch/csrc/resolve_kernel.cu",
        "lz4net_tpu/ops/resolve_kernel.py:222", resolve_kernel,
        lambda: resolve_kernel.resolve_wavefront(T0, 0),
        lambda: resolve_kernel.resolve_wavefront_reference(T0, 0),
        n_bytes=B * Dt * i4 * 2 + B, n_ops=B * Dt * 6)

    # ---- slice phase: the main path through the codec -------------------
    dec = cuda_engine.decoder("cuda")
    for row in rows:
        row["module"].launches = 0
    dec.host_decodes = 0
    t = time.perf_counter()
    got = codec.decode_batch(packed, lens, device="cuda")
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t
    launches = {row["name"]: row["module"].launches for row in rows}
    host_decodes = dec.host_decodes
    if got != blocks:
        bad = [i for i, (g, b) in enumerate(zip(got, blocks)) if g != b]
        fail(f"decoded bytes differ from the source in blocks {bad[:10]}")
    if host_decodes != 0:
        fail(f"{host_decodes} blocks were re-decoded on the host")
    for kname, n in launches.items():
        if n <= 0:
            fail(f"kernel {kname} was not launched on the main path")
    print(f"slice: {len(blocks)} blocks byte-exact, host_decodes=0, "
          f"launches {launches}, first call {first_s * 1e3:.1f} ms")

    walls = []
    for _ in range(REPS):
        t = time.perf_counter()
        codec.decode_batch(packed, lens, device="cuda")
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t)
    wall = statistics.median(walls)
    dev_ms = time_ms(torch, lambda: dv.decode_batch_vectorized(
        comp, comp_len, out_len, C, D))
    print(f"slice decode_batch, first calls (ms): "
          + " ".join(f"{w * 1e3:.2f}" for w in walls)
          + f"; median {wall * 1e3:.2f} ms per {len(blocks)}-block batch, "
          f"{len(data) / wall / 1e9:.4f} GB/s decoded (host clock, "
          f"end to end); device pass {dev_ms:.3f} ms, "
          f"{len(data) / dev_ms / 1e6:.3f} GB/s; {card}")
    where_the_time_goes(torch, codec, packed, lens, card)

    # ---- malformed input -------------------------------------------------
    try:
        codec.decode_batch([packed[0][:len(packed[0]) // 2]], [lens[0]],
                           device="cuda")
    except reference.CorruptedBlockError:
        print("malformed: truncated block raised CorruptedBlockError")
    else:
        fail("a truncated block decoded without CorruptedBlockError")

    for row in rows:
        del row["module"]
        row["launches"] = launches[row["name"]]
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
