#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (lz4net_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py            # from the repository root

1. prints the card's name and power limit (nvidia-smi);
2. builds the fifteen CUDA kernels from lz4net_tpu_torch/csrc with nvcc;
3. runs each decode kernel and its plain PyTorch version on the card on
   the same inputs, at the shapes of the decode path below, requires
   every int output to be equal, and times both (CUDA events around 10
   back-to-back calls, median of 5; rowbase_gather also beside
   torch.gather, which the port never calls); parse_tokens also on
   corpus.parse_edge_rows (tokens, 0xFF runs, comp_len and chain jumps
   across multiples of 32, 1024 and 4096, and junk); records_to_state
   also with a dictionary prefix of P = 8192 bytes (pre_len 0, 8192 and
   100 in turn) and on the edge rows (parse_edge_rows as parse_tokens
   marks them, then corpus.token_edge_rows: tied estarts, out_len inside
   a token, tokens longer than a tile) at P = 0 and 8192;
   resolve_wavefront also with a dictionary prefix of one chunk passed
   through (start_chunk 1, Dt = 81,920) and on corpus.resolve_edge_rows
   (junk rows included, ok compared) at start_chunk 0 and 1;
4. decodes a 16 MB silesia-like corpus (seed 0) in 256 blocks of 64 KB,
   compressed by the port's reference compressor, through
   lz4net_tpu_torch.codec.decode_batch on the card; requires every block
   to equal its source bytes, no host re-decode, and every decode kernel
   to have launched; prints ms per batch and GB/s of decoded output;
5. requires a truncated block to raise CorruptedBlockError;
6. the same for the four fast-encode kernels at the shapes of the encode
   path (the three slowest plain versions timed over single calls), with
   bucket_prev's time split between its two CUDA kernels
   (torch.profiler); bucket_prev also on corpus.bucket_edge_rows and
   sequence_records on corpus.seq_edge_rows, each at D = 4096 and at the
   widest block, D = 106496; emit_bytes also on corpus.emit_edge_rows
   (the length-extension edges, records longer than a tile, one-byte
   records, out_len inside a record) at S = 8192, O = 16384 and at the
   path's S and O;
7. encodes the same 256 blocks through
   lz4net_tpu_torch.models.cuda.compress_blocks_fast on the card;
   requires no host encode, every encode kernel and rowbase_gather to
   have launched, every payload to decode to its source on the host
   (models.reference) and on the card (codec.decode_batch), and the
   first 16 payloads to equal the CPU path's (the plain versions, which
   the CPU tests hold against the JAX encoder); encodes one block through
   codec.encode(mode="fast") too; prints ms per batch, GB/s of input,
   the device pass alone and the compressed size beside the reference
   compressor's;
8. the two sequencer kernels at the slice's shapes (B=256): the strict
   encoder on the 64 KB blocks and the sequencer decoder on their
   reference-compressed form, each against its plain version (a walk
   over CPU tensors, timed over one call; the encoder's rows up to each
   payload's length, as the kernel leaves the rest undefined); the
   strict encoder also on corpus.strict_edge_rows (16 rows: runs, noise,
   hash collisions inside probe windows, both table variants, budgets at
   each output-limit check), on 8 blocks of 256 KB, which its
   one-thread kernel for rows wider than shared memory takes, and on 4
   blocks as wide as the widest row it stages in shared memory
   (encode_sequencer.row_max) and 4 one byte wider; the sequencer
   decoder also on corpus.decode_edge_rows (at their D and one byte
   short of it) and on 4 rows as wide as the widest output row it
   decodes in shared memory (decode_sequencer.row_max) and 4 one byte
   wider;
9. encodes the 256 blocks through
   lz4net_tpu_torch.models.cuda.compress_blocks (strict) and decodes the
   reference-compressed blocks through
   lz4net_tpu_torch.ops.decode_sequencer.SequencerDecoder; requires each
   path to launch its kernel once and no other, the payloads to equal
   the reference compressor's bytes and the decoded blocks their source,
   codec.encode (the default strict
   mode) to equal the batch path, a budget overflow to give b"", and a
   truncated and an offset-0 block to raise CorruptedBlockError; prints
   ms per batch (first and later calls; the sequencer decoder in turns
   with the vector decoder) and the device pass alone;
10. the fast-HC kernel phase at the encode path's shapes: hc_tables with
   the suffix tiers' three run tables and with the hash tiers' seven
   tables (each with the device time of its CUDA kernels by name,
   torch.profiler, beside the wrapper's), and on corpus.hc_edge_rows'
   eight tables at D = 106496, match_lengths with 24 dominant offsets on a suffix tier's
   candidates (level 5's rcap) and on an exact sort tier's (level 9's
   rcap), and sequence_records with 8 catch-up rounds, on that tier's
   matches and on the whole match state of the level-9, level-5 and
   hash-tier paths, and emit_bytes on each of those paths' records,
   each against its plain version;
11. encodes the same 256 blocks at HC level 9 (sort tiers) and 5 (suffix
   tiers) through lz4net_tpu_torch.models.cuda.compress_blocks_hc_fast,
   and at level 5 with the hash tiers (hc_tiers="hash"); requires for
   each no host encode, each kernel of its path launched as often as
   the path says, every payload to decode to its source on the host and
   on the card, the first 8 payloads to equal the CPU path's, and the
   level-9 total to be at most the fast mode's; encodes one block
   through codec.encode_hc(mode="fast"); prints ms per batch (first and
   late calls), GB/s of input, the device pass alone, the compressed
   size beside fast mode's and, for the first 8 blocks, beside the
   reference HC compressor's (models.reference.compress_block_hc);
12. the chain record path's kernels at the fast path's shapes:
   mark_chain on the parse chain of the 256 blocks' match state and on
   corpus.chain_edge_rows (step-1 rows, jumps on and one short of the
   multiples of 32, 128 and 1024, tile skips, ends at, past and far past
   D, negative steps, steps back, encoder-like rows) at D = 4096 and at
   the widest block, D = 106496 (its plain version there checked, not
   timed: one call walks the step-1 row's 106,496 steps), and
   table_gather on the offsets and lengths at the tokens and on the
   catch-up words, each beside torch.gather (both again 20 times in turns
   with torch.gather), and on corpus.gather_edge_rows (indices below 0,
   at and past N and on row boundaries; K below 4 and not a multiple of
   4; N = 128; 1-4 tables; an index view off a 16-byte boundary);
   emit_bytes on the chain path's records; lane_lookup and diag_gather
   at tools/probe_fused.py's shapes with B=256, each against its plain
   version and beside torch.gather;
13. the probe phase: lane_lookup and diag_gather through their entry
   points, checked as tools/probe_fused.py checks them (their only
   caller);
14. encodes the 256 blocks through
   lz4net_tpu_torch.ops.encode_vector.encode_batch_chain in fast mode and
   at HC level 9; requires for each every kernel of its path launched as
   often as the path says (sequence_records never), every block to
   encode on the device, every payload to equal the sequence_records
   path's (encode_batch_vectorized) and to decode to its source on the
   host and on the card; prints ms per batch for both paths in turns
   (host clock) and their device passes;
15. prints one JSON line with the kernels (each with its launches by
   path, and the other shapes it was timed at under "variants"), then,
   last, {"ok": true, "device": {...}}.

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


def time_ms(torch, fn, inner: int = 10, reps: int = REPS) -> float:
    """Device time per call of ``fn``: CUDA events around ``inner``
    back-to-back calls, so the wrapper's host work overlaps the previous
    launch; median of ``reps`` such runs, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
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


def where_the_time_goes(torch, call, name, n_bytes, unit, card):
    """The device's busy share and time by kernel from torch.profiler over
    one ``call()``, the host's time by function from cProfile over
    another, then five more calls timed on the host clock (the steady
    state); ``n_bytes`` per call gives the rate in GB/s ``unit``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        call()
        torch.cuda.synchronize()
        prof_ms = (time.perf_counter() - t) * 1e3
    # device-side events only (kernels and copies; the CPU ops that
    # launched them would count them twice), without the profiler's own
    dev = [e for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA
           and not e.key.startswith("Activity Buffer")]
    busy_ms = sum(e.self_device_time_total for e in dev) / 1e3
    if any(e.key.startswith("lz4t::") for e in dev):
        print(f"{name} profile: device busy {busy_ms:.3f} ms of a "
              f"{prof_ms:.2f} ms profiled call, idle share "
              f"{1 - busy_ms / prof_ms:.3f}; {card}")
    else:   # the trace lost events: a busy share from it would be false
        print(f"{name} profile: the trace holds none of the port's "
              f"kernels, busy and idle share not measured; {card}")
    for e in sorted(dev, key=lambda e: -e.self_device_time_total)[:10]:
        print(f"  device {e.self_device_time_total / 1e3:.4f} ms "
              f"x{e.count} {e.key[:90]}")

    # host time by function inside one call (cProfile's own time)
    cprof = cProfile.Profile()
    t = time.perf_counter()
    cprof.enable()
    call()
    torch.cuda.synchronize()
    cprof.disable()
    call_ms = (time.perf_counter() - t) * 1e3
    top = sorted(pstats.Stats(cprof).stats.items(), key=lambda kv: -kv[1][2])
    print(f"{name} host profile: {call_ms:.2f} ms call, own time by "
          f"function:")
    for (path, line, fn), (_, ncalls, own, _, _) in top[:6]:
        print(f"  host {own * 1e3:.2f} ms x{ncalls} {fn} "
              f"({path.rsplit('/', 1)[-1]}:{line})")

    # the same calls again, now that the process has run a few
    late = []
    for _ in range(REPS):
        t = time.perf_counter()
        call()
        torch.cuda.synchronize()
        late.append((time.perf_counter() - t) * 1e3)
    late_ms = statistics.median(late)
    print(f"late {name} calls (ms): "
          + " ".join(f"{w:.2f}" for w in late)
          + f"; median {late_ms:.2f} ms, "
          f"{n_bytes / late_ms / 1e6:.4f} GB/s {unit}; {card}")


def encode_phases(torch, card, kernel_row, blocks, packed):
    """Steps 6-7 of the module docstring: the encode kernels against
    their plain versions, then the encode path through
    ``compress_blocks_fast``.  Returns that run's launches by kernel."""
    import numpy as np

    from lz4net_tpu_torch import codec
    from lz4net_tpu_torch.models import cuda as cuda_engine
    from lz4net_tpu_torch.models import reference
    from lz4net_tpu_torch.ops import encode_vector as ev
    from lz4net_tpu_torch.ops import (emit_kernel, fused_gather,
                                      hash_kernel, mlen_kernel, seq_kernel)
    from lz4net_tpu_torch.utils import corpus

    lens = [len(b) for b in blocks]
    n_data = sum(lens)
    B = len(blocks)
    D, O, S_cap = ev.batch_shapes(max(lens))
    SR = seq_kernel.slot_width(S_cap)
    xn = np.zeros((B, D), np.uint8)
    for j, b in enumerate(blocks):
        xn[j, :len(b)] = np.frombuffer(b, np.uint8)
    x = torch.from_numpy(xn).to("cuda").to(torch.int32)
    dl = torch.tensor(lens, dtype=torch.int32, device="cuda")
    pre = torch.zeros_like(dl)
    print(f"encode shapes: B={B} D={D} O={O} S_cap={S_cap} SR={SR} "
          f"rcap={ev.RCAP}")

    # ---- per-kernel phase ------------------------------------------------
    # Bytes each function must move: outputs written whole, inputs read
    # where this run's data needs them (token fields at the tokens only,
    # record fields for the live records only).
    i4 = 4
    u32 = ev._u32(x)
    us4 = ev._shift_left(u32, 4)
    h4, h8 = hash_kernel.hash_bucket(u32), hash_kernel.hash_bucket8(u32, us4)
    prev = kernel_row(
        "bucket_prev", "lz4net_tpu_torch/csrc/hash_kernel.cu",
        "lz4net_tpu/ops/hash_kernel.py:394", hash_kernel,
        lambda: hash_kernel.bucket_prev(u32, us4, h4, h8, D),
        lambda: hash_kernel.bucket_prev_reference(u32, us4, h4, h8, D),
        n_bytes=5 * B * D * i4, n_ops=B * D * 30, plain_reps=1, split=True)
    # the HC L5, hash-tier and chain-fast paths call it on these inputs too
    for De in (4096, seq_kernel.MAX_D):
        # corpus.bucket_edge_rows: one repeated byte, periods 127-256,
        # distinct words in one bucket, text, every position in one bucket
        names, xe = corpus.bucket_edge_rows(De, SEED)
        ue = ev._u32(torch.from_numpy(xe).to("cuda").to(torch.int32))
        use4 = ev._shift_left(ue, 4)
        one = torch.tensor([n == "one_bucket" for n in names],
                           device="cuda")[:, None]
        bargs = (ue, use4, hash_kernel.hash_bucket(ue).masked_fill(one, 0),
                 hash_kernel.hash_bucket8(ue, use4).masked_fill(one, 0), De)
        kernel_row(
            "bucket_prev", "", "", hash_kernel,
            lambda: hash_kernel.bucket_prev(*bargs),
            lambda: hash_kernel.bucket_prev_reference(*bargs),
            n_bytes=5 * ue.numel() * i4, n_ops=ue.numel() * 30, plain_reps=1,
            variant=f"edge rows, B={len(names)}, D={De}")
    off = torch.arange(D, dtype=torch.int32, device="cuda") - prev
    dks = ev._top_offsets_select(off, (prev >= 0) & (off <= 65535)
                                 & (off > 4))
    m8 = torch.zeros_like(prev)
    margs = (x, u32, prev, m8, dks, dl, dl, D, ev.RCAP)
    # x, prev and m8 read and three outputs written, 6 words a position
    # (u32 is not read: the kernel takes the words from x's bytes)
    matched, off_all, mlen_all = kernel_row(
        "match_lengths", "lz4net_tpu_torch/csrc/mlen_kernel.cu",
        "lz4net_tpu/ops/mlen_kernel.py:409", mlen_kernel,
        lambda: mlen_kernel.match_lengths_fused(*margs),
        lambda: mlen_kernel.match_lengths_reference(*margs),
        n_bytes=6 * B * D * i4 + B * dks.shape[1] * i4 + 2 * B * i4,
        n_ops=B * D * 40, plain_reps=3)
    sargs = (u32, matched, off_all, mlen_all, dl, pre, D, S_cap, 0,
             ev.CU_ROUNDS)
    # matched everywhere; off, mlen and 2 u32 words a catch-up round at
    # each token; five slot arrays and the stats written
    seq = kernel_row(
        "sequence_records", "lz4net_tpu_torch/csrc/seq_kernel.cu",
        "lz4net_tpu/ops/seq_kernel.py:531", seq_kernel,
        lambda: seq_kernel.sequence_records(*sargs),
        lambda: seq_kernel.sequence_records_reference(*sargs),
        n_bytes=lambda got: B * D * i4 + int(got[5][:, 0].sum()) * i4
        * (2 + 2 * ev.CU_ROUNDS) + 5 * B * SR * i4 + B * 8 * i4
        + 2 * B * i4,
        n_ops=B * D * 20, plain_reps=3)
    for De, rounds in ((4096, ev.CU_ROUNDS), (seq_kernel.MAX_D, ev.CU_ROUNDS),
                       (seq_kernel.MAX_D, ev.HC_CU_ROUNDS)):
        # corpus.seq_edge_rows: all literals, one match to the row's end, a
        # match past D, mlen <= 0 at matched positions, matches that skip
        # segments and tiles, a row past S_cap, catch-up over whole literal
        # runs, dense random matches
        _, *erows, eS = corpus.seq_edge_rows(De, SEED)
        eargs = (*(torch.from_numpy(a).to("cuda") for a in erows), De, eS,
                 0, rounds)
        eSR = seq_kernel.slot_width(eS)
        kernel_row(
            "sequence_records", "", "", seq_kernel,
            lambda: seq_kernel.sequence_records(*eargs),
            lambda: seq_kernel.sequence_records_reference(*eargs),
            n_bytes=lambda got: eargs[0].numel() * i4 + int(
                got[5][:, 0].clamp(max=eS).sum()) * i4 * (2 + 2 * rounds)
            + 5 * eargs[0].shape[0] * eSR * i4,
            n_ops=eargs[0].numel() * 20, plain_reps=1,
            variant=f"edge rows, B={eargs[0].shape[0]}, D={De}, "
                    f"cu_rounds={rounds}")
    out_len = seq[5][:, 2].contiguous()
    n_rec = int((seq[5][:, 1] + 1).sum())
    eargs = (*seq[:5], out_len, O)
    _direct, cidx, _miss = kernel_row(
        "emit_bytes", "lz4net_tpu_torch/csrc/emit_kernel.cu",
        "lz4net_tpu/ops/emit_kernel.py:195", emit_kernel,
        lambda: emit_kernel.emit_bytes(*eargs),
        lambda: emit_kernel.emit_bytes_reference(*eargs),
        n_bytes=5 * n_rec * i4 + 2 * B * O * i4 + B * i4,
        n_ops=B * O * 20)
    # corpus.emit_edge_rows: the length-extension edges, records longer
    # than a tile, one-byte records, out_len inside a record; at the CPU
    # tests' S and O and at this path's
    for eS, eO in ((8192, 16384), (SR, O)):
        _, *efields, eol = corpus.emit_edge_rows(eS, eO, SEED)
        e_args = (*(torch.from_numpy(a).to("cuda") for a in efields),
                  torch.from_numpy(eol).to("cuda"), eO)
        kernel_row(
            "emit_bytes", "", "", emit_kernel,
            lambda: emit_kernel.emit_bytes(*e_args),
            lambda: emit_kernel.emit_bytes_reference(*e_args),
            n_bytes=5 * int((e_args[0] < emit_kernel.BIGKEY).sum()) * i4
            + 2 * 3 * eO * i4 + 3 * i4,
            n_ops=3 * eO * 20, variant=f"edge rows, B=3, S={eS}, O={eO}")
    lit = torch.where(cidx >= 0, cidx, 0)
    err = max_abs_err(torch, fused_gather.rowbase_gather(x, lit),
                      fused_gather.rowbase_gather_reference(x, lit))
    if err != 0:
        fail(f"rowbase_gather differs from its plain version at the "
             f"encode path's shapes (max abs err {err})")
    print(f"kernel rowbase_gather at the encode path's shapes "
          f"[{B}, {O}] from [{B}, {D}]: max abs err 0")

    # ---- slice phase: the encode path through the engine ------------------
    mods = {"bucket_prev": hash_kernel, "match_lengths": mlen_kernel,
            "sequence_records": seq_kernel, "emit_bytes": emit_kernel,
            "rowbase_gather": fused_gather}
    enc = cuda_engine.encoder("cuda")
    for mod in mods.values():
        mod.launches = 0
    enc.host_encodes = 0
    t = time.perf_counter()
    got = cuda_engine.compress_blocks_fast(blocks, device="cuda")
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t) * 1e3
    launches = {k: mod.launches for k, mod in mods.items()}
    if enc.host_encodes != 0:
        fail(f"{enc.host_encodes} blocks were encoded on the host")
    for kname, n in launches.items():
        if n <= 0:
            fail(f"kernel {kname} was not launched on the encode path")
    bad = [j for j, (p, b) in enumerate(zip(got, blocks))
           if reference.decompress_block(p, len(b)) != b]
    if bad:
        fail(f"encoded blocks {bad[:10]} do not decode to their source "
             f"on the host")
    if codec.decode_batch(got, lens, device="cuda") != blocks:
        fail("encoded blocks do not decode to their source on the card")
    if got[:16] != ev.VectorEncoder("cpu").encode_batch(blocks[:16]):
        fail("the first 16 payloads differ from the CPU path's")
    one = codec.encode(blocks[0], mode="fast", device="cuda")
    if one != got[0] or reference.decompress_block(one, lens[0]) \
            != blocks[0]:
        fail("codec.encode(mode='fast') differs from the batch path")
    total = sum(map(len, got))
    strict = sum(map(len, packed))
    print(f"encode slice: {B} blocks, host_encodes=0, launches "
          f"{launches}, every payload decodes on the host and the card, "
          f"first 16 equal the CPU path's, first call {first_ms:.1f} ms; "
          f"{total} compressed bytes ({total / n_data:.4f} of input) "
          f"against {strict} ({strict / n_data:.4f}) from the reference "
          f"compressor; {card}")

    walls = []
    for _ in range(REPS):
        t = time.perf_counter()
        cuda_engine.compress_blocks_fast(blocks, device="cuda")
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t) * 1e3)
    wall = statistics.median(walls)
    dev_ms = time_ms(torch, lambda: ev.encode_batch_vectorized(
        x, dl, D, O, S_cap))
    print("encode slice compress_blocks_fast, first calls (ms): "
          + " ".join(f"{w:.2f}" for w in walls)
          + f"; median {wall:.2f} ms per {B}-block batch, "
          f"{n_data / wall / 1e6:.4f} GB/s of input (host clock, end to "
          f"end); device pass {dev_ms:.3f} ms, "
          f"{n_data / dev_ms / 1e6:.3f} GB/s; {card}")
    where_the_time_goes(
        torch, lambda: cuda_engine.compress_blocks_fast(blocks,
                                                        device="cuda"),
        "compress_blocks_fast", n_data, "of input", card)
    return launches, total


# launches a batch of each HC path: (path, level, hc_tiers) -> counts
HC_PATHS = (
    ("hc9", 9, None, {"bucket_prev": 0, "hc_tables": 0, "match_lengths": 8,
                      "sequence_records": 1, "emit_bytes": 1,
                      "rowbase_gather": 1}),
    ("hc5", 5, None, {"bucket_prev": 1, "hc_tables": 1, "match_lengths": 2,
                      "sequence_records": 1, "emit_bytes": 1,
                      "rowbase_gather": 1}),
    ("hc5_hash", 5, "hash", {"bucket_prev": 1, "hc_tables": 1,
                             "match_lengths": 2, "sequence_records": 1,
                             "emit_bytes": 1, "rowbase_gather": 1}),
)


def hc_phases(torch, card, kernel_row, rows, blocks, fast_total):
    """Steps 10-11 of the module docstring.  Returns the launches by path
    and kernel."""
    import numpy as np

    from lz4net_tpu_torch import codec
    from lz4net_tpu_torch.models import cuda as cuda_engine
    from lz4net_tpu_torch.models import reference
    from lz4net_tpu_torch.ops import encode_vector as ev
    from lz4net_tpu_torch.ops import (emit_kernel, hash_kernel, mlen_kernel,
                                      seq_kernel)
    from lz4net_tpu_torch.utils import corpus

    lens = [len(b) for b in blocks]
    n_data = sum(lens)
    B = len(blocks)
    D, O, S_cap = ev.batch_shapes(max(lens))
    SR = seq_kernel.slot_width(S_cap)
    xn = np.zeros((B, D), np.uint8)
    for j, b in enumerate(blocks):
        xn[j, :len(b)] = np.frombuffer(b, np.uint8)
    x = torch.from_numpy(xn).to("cuda").to(torch.int32)
    dl = torch.tensor(lens, dtype=torch.int32, device="cuda")
    pre = torch.zeros_like(dl)
    i4 = 4

    # ---- per-kernel phase ------------------------------------------------
    u32 = ev._u32(x)
    us4 = ev._shift_left(u32, 4)
    run_fwd, is_rs = ev._byte_runs(x)
    for tables, variant in (("runs", None), (None, "hash tiers, 7 tables")):
        _, hs, sticky, nrows = hash_kernel.hc_streams(x, u32, us4, is_rs,
                                                      run_fwd, tables)
        hargs = (u32, hs, sticky, nrows, D)
        # wa and one bucket stream a table read, one candidate stream
        # a table written
        kernel_row(
            "hc_tables", "lz4net_tpu_torch/csrc/hc_kernel.cu",
            "lz4net_tpu/ops/hash_kernel.py:639", hash_kernel,
            lambda: hash_kernel.hc_tables(*hargs),
            lambda: hash_kernel.hc_tables_reference(*hargs),
            n_bytes=(1 + 2 * len(hs)) * B * D * i4,
            n_ops=B * D * len(hs) * 10, plain_reps=1,
            counter="hc_launches", variant=variant, split=True)
    # corpus.hc_edge_rows, all eight tables, at the widest block: buckets
    # hit once, twice and 512 times a chunk, sticky early entries, the
    # catch-all, 128- and 8192-bucket tables, ids outside [0, nb)
    EW = 106496
    ewa, ehs, esticky, enrows = corpus.hc_edge_rows(EW, SEED)
    ewa = torch.from_numpy(ewa).to("cuda")
    ehs = [torch.from_numpy(h).to("cuda") for h in ehs]
    eargs = (ewa, ehs, esticky, enrows, EW)
    kernel_row(
        "hc_tables", "", "", hash_kernel,
        lambda: hash_kernel.hc_tables(*eargs),
        lambda: hash_kernel.hc_tables_reference(*eargs),
        n_bytes=(1 + 2 * len(ehs)) * ewa.numel() * i4,
        n_ops=ewa.numel() * len(ehs) * 10, plain_reps=1,
        counter="hc_launches",
        variant=f"edge rows, {len(ehs)} tables, B={ewa.shape[0]}, D={EW}",
        split=True)
    # a suffix tier's candidates, as the level-5 path dispatches them
    prev = hash_kernel.bucket_prev(u32, us4, hash_kernel.hash_bucket(u32),
                                   hash_kernel.hash_bucket8(u32, us4), D)
    deep, _ = ev._suffix_candidates((u32, us4) + tuple(
        ev._shift_left(u32, 4 * k) for k in range(2, 8)))
    i = torch.arange(D, dtype=torch.int32, device="cuda")
    prev_t = torch.where((deep >= 0) & (i - deep <= 65535), deep, prev)
    off = i - prev_t
    dks = ev._top_offsets_select(off, (prev_t >= 0) & (off <= 65535)
                                 & (off > 4), ev.HC_TOP_OFFSETS,
                                 ev.HC_SUB_STEP)
    rcap = ev.hc_rcap(5, D)
    margs = (x, u32, prev_t, torch.zeros_like(prev_t), dks, dl, dl, D, rcap)
    mlen = kernel_row(
        "match_lengths", "lz4net_tpu_torch/csrc/mlen_kernel.cu",
        "lz4net_tpu/ops/mlen_kernel.py:409", mlen_kernel,
        lambda: mlen_kernel.match_lengths_fused(*margs),
        lambda: mlen_kernel.match_lengths_reference(*margs),
        n_bytes=6 * B * D * i4 + B * dks.shape[1] * i4 + 2 * B * i4,
        n_ops=B * D * 40, plain_reps=3,
        variant=f"HC tier, K={dks.shape[1]}, rcap={rcap}")
    # an exact sort tier of level 9 (the 12-byte previous occurrence, its
    # first 8 bytes verified), as that path dispatches it 7 times a batch
    prev4 = ev._prev_occurrence((u32,))
    c12 = ev._prev_occurrence((u32, us4, ev._shift_left(u32, 8)))
    ok12 = (c12 >= 0) & (i - c12 <= 65535)
    prev9 = torch.where(ok12, c12, prev4)
    off9 = i - prev9
    dks9 = ev._top_offsets_select(off9, (prev9 >= 0) & (off9 <= 65535)
                                  & (off9 > 4), ev.HC_TOP_OFFSETS,
                                  ev.HC_SUB_STEP)
    rcap9 = ev.hc_rcap(9, D)
    margs9 = (x, u32, prev9, ok12.to(torch.int32), dks9, dl, dl, D, rcap9)
    kernel_row(
        "match_lengths", "", "", mlen_kernel,
        lambda: mlen_kernel.match_lengths_fused(*margs9),
        lambda: mlen_kernel.match_lengths_reference(*margs9),
        n_bytes=6 * B * D * i4 + B * dks9.shape[1] * i4 + 2 * B * i4,
        n_ops=B * D * 40, plain_reps=3,
        variant=f"HC L9 sort tier, K={dks9.shape[1]}, rcap={rcap9}")
    sargs = (u32, *mlen, dl, pre, D, S_cap, 0, ev.HC_CU_ROUNDS)
    kernel_row(
        "sequence_records", "lz4net_tpu_torch/csrc/seq_kernel.cu",
        "lz4net_tpu/ops/seq_kernel.py:531", seq_kernel,
        lambda: seq_kernel.sequence_records(*sargs),
        lambda: seq_kernel.sequence_records_reference(*sargs),
        n_bytes=lambda got: B * D * i4 + int(got[5][:, 0].sum()) * i4
        * (2 + 2 * ev.HC_CU_ROUNDS) + 5 * B * SR * i4 + B * 8 * i4
        + 2 * B * i4,
        n_ops=B * D * 20, plain_reps=3,
        variant=f"HC, cu_rounds={ev.HC_CU_ROUNDS}")
    # the whole match state of each HC path, as the path hands it over
    for level, tiers in ((9, None), (5, None), (5, "hash")):
        state = ev._match_stage(x, dl, D, ev.hc_rcap(level, D), level, tiers)
        hargs = (*state, dl, pre, D, S_cap, 0, ev.HC_CU_ROUNDS)
        recs = kernel_row(
            "sequence_records", "", "", seq_kernel,
            lambda: seq_kernel.sequence_records(*hargs),
            lambda: seq_kernel.sequence_records_reference(*hargs),
            n_bytes=lambda got: B * D * i4 + int(got[5][:, 0].sum()) * i4
            * (2 + 2 * ev.HC_CU_ROUNDS) + 5 * B * SR * i4 + B * 8 * i4
            + 2 * B * i4,
            n_ops=B * D * 20, plain_reps=1,
            variant=f"HC L{level} path's match state"
                    + (f", {tiers} tiers" if tiers else "")
                    + f", cu_rounds={ev.HC_CU_ROUNDS}")
        # and emit_bytes on the records that state gives
        eargs = (*recs[:5], recs[5][:, 2].contiguous(), O)
        kernel_row(
            "emit_bytes", "", "", emit_kernel,
            lambda: emit_kernel.emit_bytes(*eargs),
            lambda: emit_kernel.emit_bytes_reference(*eargs),
            n_bytes=5 * int((recs[5][:, 1] + 1).sum()) * i4
            + 2 * B * O * i4 + B * i4,
            n_ops=B * O * 20, plain_reps=1,
            variant=f"HC L{level} path's records"
                    + (f", {tiers} tiers" if tiers else ""))

    # ---- slice phases: each HC path through the engine --------------------
    enc = cuda_engine.encoder("cuda")
    counted = {row["name"]: row for row in rows}
    by_path = {}
    sizes = {}
    # the reference HC parse is scalar Python: the first 8 blocks only
    ref8 = sum(len(reference.compress_block_hc(b)) for b in blocks[:8])
    for path, level, tiers, want in HC_PATHS:
        def call():
            if tiers is None:
                return cuda_engine.compress_blocks_hc_fast(
                    blocks, level=level, device="cuda")
            return enc.encode_batch(blocks, hc_level=level, hc_tiers=tiers)

        for row in rows:
            setattr(row["module"], row["counter"], 0)
        enc.host_encodes = 0
        t = time.perf_counter()
        got = call()
        torch.cuda.synchronize()
        first_ms = (time.perf_counter() - t) * 1e3
        launches = {k: getattr(counted[k]["module"], counted[k]["counter"])
                    for k in want}
        by_path[path] = launches
        if enc.host_encodes != 0:
            fail(f"{path}: {enc.host_encodes} blocks were encoded on the "
                 f"host")
        if launches != want:
            fail(f"{path}: launches {launches}, the path makes {want}")
        bad = [j for j, (p, b) in enumerate(zip(got, blocks))
               if reference.decompress_block(p, len(b)) != b]
        if bad:
            fail(f"{path}: blocks {bad[:10]} do not decode to their source "
                 f"on the host")
        if codec.decode_batch(got, lens, device="cuda") != blocks:
            fail(f"{path}: blocks do not decode to their source on the card")
        if got[:8] != ev.VectorEncoder("cpu").encode_batch(
                blocks[:8], hc_level=level, hc_tiers=tiers):
            fail(f"{path}: the first 8 payloads differ from the CPU path's")
        total = sum(map(len, got))
        sizes[path] = total
        got8 = sum(map(len, got[:8]))
        print(f"{path} slice (level {level}, tiers {tiers or 'by level'}): "
              f"{B} blocks, host_encodes=0, launches {launches}, every "
              f"payload decodes on the host and the card, first 8 equal "
              f"the CPU path's, first call {first_ms:.1f} ms; {total} "
              f"compressed bytes ({total / n_data:.4f} of input) against "
              f"{fast_total} ({fast_total / n_data:.4f}) in fast mode; "
              f"first 8 blocks {got8} bytes against {ref8} from the "
              f"reference HC compressor ({got8 / ref8:.4f}); {card}")

        walls = []
        for _ in range(REPS - 1):
            t = time.perf_counter()
            call()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t) * 1e3)
        wall = statistics.median(walls)
        dev_ms = time_ms(torch, lambda: ev.encode_batch_vectorized(
            x, dl, D, O, S_cap, ev.hc_rcap(level, D), level, tiers),
            inner=3)
        print(f"{path} slice, first calls (ms): {first_ms:.2f} "
              + " ".join(f"{w:.2f}" for w in walls)
              + f"; median of the later {wall:.2f} ms per {B}-block "
              f"batch, {n_data / wall / 1e6:.4f} GB/s of input (host clock, "
              f"end to end); device pass {dev_ms:.3f} ms, "
              f"{n_data / dev_ms / 1e6:.3f} GB/s; {card}")
        if path != "hc5_hash":
            where_the_time_goes(torch, call, f"{path} compress_blocks_hc_fast",
                                n_data, "of input", card)
    if sizes["hc9"] > fast_total:
        fail(f"HC level 9 wrote {sizes['hc9']} bytes, more than fast mode's "
             f"{fast_total}")
    one = codec.encode_hc(blocks[0], mode="fast", device="cuda")
    if one != cuda_engine.compress_blocks_hc_fast(blocks[:1])[0] \
            or reference.decompress_block(one, lens[0]) != blocks[0]:
        fail("codec.encode_hc(mode='fast') differs from the batch path")
    print(f"codec.encode_hc(mode='fast'): {lens[0]} -> {len(one)} bytes, "
          f"equal to the batch path, decodes to its source")
    return by_path


# launches a batch of each chain record path: (path, level) -> counts
CHAIN_PATHS = (
    ("chain_fast", 0, {"bucket_prev": 1, "hc_tables": 0, "match_lengths": 1,
                       "mark_chain": 1, "table_gather": 7,
                       "sequence_records": 0, "emit_bytes": 1,
                       "rowbase_gather": 1}),
    ("chain_hc9", 9, {"bucket_prev": 0, "hc_tables": 0, "match_lengths": 8,
                      "mark_chain": 1, "table_gather": 19,
                      "sequence_records": 0, "emit_bytes": 1,
                      "rowbase_gather": 1}),
)


def chain_phases(torch, card, kernel_row, rows, blocks):
    """Steps 12-14 of the module docstring.  Returns the launches by path
    and kernel."""
    import numpy as np

    from lz4net_tpu_torch import codec
    from lz4net_tpu_torch.models import reference
    from lz4net_tpu_torch.ops import (chain_kernel, emit_kernel,
                                      fused_gather, seq_kernel)
    from lz4net_tpu_torch.ops import encode_vector as ev
    from lz4net_tpu_torch.utils import corpus

    lens = [len(b) for b in blocks]
    n_data = sum(lens)
    B = len(blocks)
    D, O, S_cap = ev.batch_shapes(max(lens))
    xn = np.zeros((B, D), np.uint8)
    for j, b in enumerate(blocks):
        xn[j, :len(b)] = np.frombuffer(b, np.uint8)
    x = torch.from_numpy(xn).to("cuda").to(torch.int32)
    dl = torch.tensor(lens, dtype=torch.int32, device="cuda")
    i4 = 4

    # ---- per-kernel phase: the fast path's operands ----------------------
    u32, matched, off_all, mlen_all = ev._match_stage(x, dl, D, ev.RCAP, 0,
                                                      None)
    m = matched == 1
    g = seq_kernel.chain_graph(m, mlen_all, D)
    # the mark row written whole, g read at the orbit's positions
    mark = kernel_row(
        "mark_chain", "lz4net_tpu_torch/csrc/chain_kernel.cu",
        "lz4net_tpu/ops/chain_kernel.py:83", chain_kernel,
        lambda: chain_kernel.mark_chain(g, D),
        lambda: chain_kernel.mark_chain_reference(g, D),
        n_bytes=lambda got: B * D * i4 + int(got.sum()) * i4,
        n_ops=B * D, plain_reps=1)
    # corpus.chain_edge_rows at D = 4096 and at the widest block
    for eD in (4096, chain_kernel.MAX_D):
        enames, eg = corpus.chain_edge_rows(eD, SEED)
        eg = torch.from_numpy(eg).to("cuda")
        kernel_row(
            "mark_chain", "", "", chain_kernel,
            lambda: chain_kernel.mark_chain(eg, eD),
            lambda: chain_kernel.mark_chain_reference(eg, eD),
            n_bytes=lambda got: eg.numel() * i4 + int(got.sum()) * i4,
            n_ops=eg.numel(), plain_reps=1 if eD == 4096 else 0,
            variant=f"edge rows, B={len(enames)}, D={eD}")
    tok = seq_kernel.compact_indices((mark == 1) & m, S_cap, D) \
        .clamp(0, D - 1)
    tok64 = tok.long()
    pairs = [off_all, mlen_all]
    print(f"chain shapes: B={B} D={D} S_cap={S_cap}, "
          f"{int(((mark == 1) & m).sum())} tokens")
    # an index, and per table an entry read and a value written, a slot
    kernel_row(
        "table_gather", "lz4net_tpu_torch/csrc/fused_gather.cu",
        "lz4net_tpu/ops/fused_gather.py:296", fused_gather,
        lambda: fused_gather.table_gather(pairs, tok, (17, 17)),
        lambda: fused_gather.table_gather_reference(pairs, tok, (17, 17)),
        n_bytes=B * S_cap * i4 * 5, n_ops=B * S_cap * 8,
        library=lambda: [torch.gather(t, 1, tok64) for t in pairs],
        counter="table_launches")
    pa = (tok - 4).clamp(0, D - 1)
    pa64 = pa.long()
    kernel_row(
        "table_gather", "", "", fused_gather,
        lambda: fused_gather.table_gather([u32], pa, (32,)),
        lambda: fused_gather.table_gather_reference([u32], pa, (32,)),
        n_bytes=B * S_cap * i4 * 3, n_ops=B * S_cap * 6,
        library=lambda: torch.gather(u32, 1, pa64),
        variant="catch-up words, 1 table of 32 bits")
    # corpus.gather_edge_rows: (N, K, tables), and an index view off a
    # 16-byte boundary
    for gN, gK, nt in ((128, 3, 1), (128, 5, 2), (2048, 513, 3),
                       (2048, 512, 4), (18688, 18688, 4)):
        gt, gi, gbits = corpus.gather_edge_rows(gN, gK, SEED)
        gt = [torch.from_numpy(t).to("cuda") for t in gt[:nt]]
        gi = torch.from_numpy(gi).to("cuda")
        if gK == 512:
            gi = torch.cat([gi.new_zeros(1), gi.flatten()])[1:].view(
                gi.shape)
        kernel_row(
            "table_gather", "", "", fused_gather,
            lambda: fused_gather.table_gather(gt, gi, gbits[:nt]),
            lambda: fused_gather.table_gather_reference(gt, gi, gbits[:nt]),
            n_bytes=gi.numel() * i4 * (1 + 2 * nt),
            n_ops=gi.numel() * (4 + 2 * nt),
            variant=f"edge rows, {nt} table(s), B={gi.shape[0]}, N={gN}, "
            f"K={gK}" + (", index off a 16-byte boundary"
                         if gi.data_ptr() % 16 else ""))
    # the two-table and one-table shapes against torch.gather again, in
    # turns, 20 medians each: is the kernel slower by more than the spread?
    for label, tabs, idx, bits, idx64 in (
            ("offsets and lengths, 2 tables of 17 bits", pairs, tok,
             (17, 17), tok64),
            ("catch-up words, 1 table of 32 bits", [u32], pa, (32,), pa64)):
        k_ms, l_ms = [], []
        for _ in range(20):
            k_ms.append(time_ms(torch, lambda: fused_gather.table_gather(
                tabs, idx, bits)))
            l_ms.append(time_ms(torch, lambda: [torch.gather(t, 1, idx64)
                                                for t in tabs]))
        # the wrapper's host time a call: where it exceeds the kernel's,
        # back-to-back calls time the host
        t = time.perf_counter()
        for _ in range(200):
            fused_gather.table_gather(tabs, idx, bits)
        host_us = (time.perf_counter() - t) / 200 * 1e6
        torch.cuda.synchronize()
        retime = {"reps": 20, "ms": statistics.median(k_ms),
                  "ms_range": [min(k_ms), max(k_ms)],
                  "library_ms": statistics.median(l_ms),
                  "library_range": [min(l_ms), max(l_ms)],
                  "wrapper_host_us": host_us}
        next(r for r in rows if r["name"] == "table_gather")[
            "variants"][f"{label}, re-timed"] = retime
        print(f"kernel table_gather ({label}, re-timed in turns, 20 "
              f"medians): {retime['ms']:.4f} ms (range {min(k_ms):.4f}-"
              f"{max(k_ms):.4f}) against torch.gather "
              f"{retime['library_ms']:.4f} ms (range {min(l_ms):.4f}-"
              f"{max(l_ms):.4f}); the wrapper's host time {host_us:.1f} us "
              f"a call; {card}")

    # emit_bytes on the records this path makes (its own producer of s0)
    recs = ev.chain_records(u32, matched, off_all, mlen_all, dl,
                            torch.zeros_like(dl), D, S_cap)
    eargs = (*recs[:5], recs[5][:, 2].contiguous(), O)
    kernel_row(
        "emit_bytes", "", "", emit_kernel,
        lambda: emit_kernel.emit_bytes(*eargs),
        lambda: emit_kernel.emit_bytes_reference(*eargs),
        n_bytes=5 * int((recs[5][:, 1] + 1).sum()) * i4 + 2 * B * O * i4
        + B * i4, n_ops=B * O * 20, plain_reps=1,
        variant="chain path's records, fast")

    # lane_lookup and diag_gather at tools/probe_fused.py's shapes, B=256
    gen = torch.Generator(device="cuda").manual_seed(7)

    def rand(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=gen, device="cuda",
                             dtype=torch.int32)

    M = B * 544
    lt, li = rand(0, 1 << 20, (M, 128)), rand(0, 128, (M, 128))
    li64 = li.long()
    kernel_row(
        "lane_lookup", "lz4net_tpu_torch/csrc/fused_gather.cu",
        "lz4net_tpu/ops/fused_gather.py:95", fused_gather,
        lambda: fused_gather.lane_lookup(lt, li),
        lambda: fused_gather.lane_lookup_reference(lt, li),
        n_bytes=3 * M * 128 * i4, n_ops=M * 128 * 3,
        library=lambda: torch.gather(lt, 1, li64), counter="lane_launches")
    N = 69632
    dt = rand(0, 256, (B, N))
    q = torch.arange(N, dtype=torch.int32, device="cuda")
    di = (q + rand(-128, 15 * 128, (B, N))).clamp(0, N - 1)
    di64 = di.long()
    kernel_row(
        "diag_gather", "lz4net_tpu_torch/csrc/fused_gather.cu",
        "lz4net_tpu/ops/fused_gather.py:143", fused_gather,
        lambda: fused_gather.diag_gather(dt, di, 1, 16),
        lambda: fused_gather.diag_gather_reference(dt, di, 1, 16),
        n_bytes=B * N * (3 * i4 + 1), n_ops=B * N * 8,
        library=lambda: torch.gather(dt, 1, di64), counter="diag_launches")

    by_path = {}
    counted = {row["name"]: row for row in rows}

    def zero_counts():
        for row in rows:
            setattr(row["module"], row["counter"], 0)

    def read_counts(want):
        return {k: getattr(counted[k]["module"], counted[k]["counter"])
                for k in want}

    # ---- probe phase: the only caller of lane_lookup and diag_gather -----
    # tools/probe_fused.py's checks through the port's entry points, with
    # their answers from torch.gather and the band's definition
    zero_counts()
    got = fused_gather.lane_lookup(lt, li)
    vals, band = fused_gather.diag_gather(dt, di, 1, 16)
    torch.cuda.synchronize()
    by_path["probe"] = read_counts(("lane_lookup", "diag_gather"))
    if by_path["probe"] != {"lane_lookup": 1, "diag_gather": 1}:
        fail(f"probe: launches {by_path['probe']}")
    rows_d = (di >> 7) - (q >> 7)
    if not torch.equal(got, torch.gather(lt, 1, li64)) \
            or not torch.equal(band, (rows_d >= -1) & (rows_d < 15)) \
            or not torch.equal(vals[band], torch.gather(dt, 1, di64)[band]):
        fail("probe: lane_lookup or diag_gather gave a wrong answer")
    print(f"probe phase: lane_lookup and diag_gather answer as "
          f"tools/probe_fused.py checks, one launch each; {card}")

    # ---- slice phases: the chain record path, fast and HC level 9 --------
    def payloads(fn, level):
        """A batch through ``fn`` as VectorEncoder drives its device pass:
        the bytes shipped as uint8, widened on the card, the payloads
        fetched as bytes."""
        xt = torch.from_numpy(xn).to("cuda").to(torch.int32)
        out, out_len, ok = fn(xt, torch.tensor(lens, dtype=torch.int32,
                                                device="cuda"),
                              D, O, S_cap, ev.hc_rcap(level, D), level)
        out = out.to(torch.uint8).cpu().numpy()
        out_len, ok = out_len.cpu().numpy(), ok.cpu().numpy()
        return [out[j, :int(n)].tobytes() for j, n in enumerate(out_len)], ok

    for path, level, want in CHAIN_PATHS:
        zero_counts()
        t = time.perf_counter()
        got, ok = payloads(ev.encode_batch_chain, level)
        torch.cuda.synchronize()
        first_ms = (time.perf_counter() - t) * 1e3
        launches = read_counts(want)
        by_path[path] = launches
        if launches != want:
            fail(f"{path}: launches {launches}, the path makes {want}")
        if not ok.all():
            fail(f"{path}: blocks {np.flatnonzero(~ok)[:10]} flagged")
        seq, seq_ok = payloads(ev.encode_batch_vectorized, level)
        if got != seq or not seq_ok.all():
            bad = [j for j, (a, b) in enumerate(zip(got, seq)) if a != b]
            fail(f"{path}: payloads of blocks {bad[:10]} differ from the "
                 f"sequence_records path's")
        bad = [j for j, (p, b) in enumerate(zip(got, blocks))
               if reference.decompress_block(p, len(b)) != b]
        if bad:
            fail(f"{path}: blocks {bad[:10]} do not decode to their source "
                 f"on the host")
        if codec.decode_batch(got, lens, device="cuda") != blocks:
            fail(f"{path}: blocks do not decode to their source on the card")
        total = sum(map(len, got))
        # in turns: chain, sequence, chain, sequence, ...
        chain_walls, seq_walls = [], []
        for _ in range(REPS):
            for walls, fn in ((chain_walls, ev.encode_batch_chain),
                              (seq_walls, ev.encode_batch_vectorized)):
                t = time.perf_counter()
                payloads(fn, level)
                torch.cuda.synchronize()
                walls.append((time.perf_counter() - t) * 1e3)
        inner = 10 if level == 0 else 3
        dev = {}
        for name, fn in (("chain", ev.encode_batch_chain),
                         ("sequence", ev.encode_batch_vectorized),
                         ("chain again", ev.encode_batch_chain)):
            dev[name] = time_ms(torch, lambda: fn(
                x, dl, D, O, S_cap, ev.hc_rcap(level, D), level),
                inner=inner)
        chain_ms, seq_ms = (statistics.median(chain_walls),
                            statistics.median(seq_walls))
        print(f"{path} slice (level {level}): {B} blocks, launches "
              f"{launches}, every payload equal to the sequence_records "
              f"path's and decodes on the host and the card, first call "
              f"{first_ms:.2f} ms; {total} compressed bytes "
              f"({total / n_data:.4f} of input); later calls in turns (ms), "
              f"chain: " + " ".join(f"{w:.2f}" for w in chain_walls)
              + "; sequence: " + " ".join(f"{w:.2f}" for w in seq_walls)
              + f"; medians {chain_ms:.2f} and {seq_ms:.2f} ms per {B}-block "
              f"batch ({n_data / chain_ms / 1e6:.4f} and "
              f"{n_data / seq_ms / 1e6:.4f} GB/s of input, host clock); "
              f"device pass chain {dev['chain']:.3f} ms, sequence "
              f"{dev['sequence']:.3f} ms, chain again "
              f"{dev['chain again']:.3f} ms; {card}")
        if level == 0:
            where_the_time_goes(
                torch, lambda: payloads(ev.encode_batch_chain, 0),
                "encode_batch_chain", n_data, "of input", card)
    return by_path


def _uint8_rows(torch, rows):
    """rows as a [B, max len] uint8 tensor on the card (zero padded) and
    their lengths as [B] int32."""
    import numpy as np
    x = np.zeros((len(rows), max(map(len, rows))), np.uint8)
    for j, r in enumerate(rows):
        x[j, :len(r)] = np.frombuffer(r, np.uint8)
    return (torch.from_numpy(x).to("cuda"),
            torch.tensor([len(r) for r in rows], dtype=torch.int32,
                         device="cuda"))


def _on_card(pair):
    return tuple(t.to("cuda") for t in pair)


def strict_phases(torch, card, kernel_row, rows, blocks, packed):
    """Steps 8-9 of the module docstring: the two sequencer kernels
    against their plain versions, then strict encode through
    ``compress_blocks`` and sequencer decode through
    ``SequencerDecoder.decode_batch``.  Returns the launches by path and
    kernel."""
    from lz4net_tpu_torch import codec
    from lz4net_tpu_torch.constants import maximum_output_length
    from lz4net_tpu_torch.models import cuda as cuda_engine
    from lz4net_tpu_torch.models import reference
    from lz4net_tpu_torch.ops import decode_sequencer as ds
    from lz4net_tpu_torch.ops import encode_sequencer as es
    from lz4net_tpu_torch.utils import corpus

    lens = [len(b) for b in blocks]
    n_data = sum(lens)
    B = len(blocks)
    i4 = 4

    # ---- per-kernel phase: the plain versions walk CPU tensors ----------
    src, src_len = _uint8_rows(torch, blocks)
    cap = torch.tensor([maximum_output_length(n) for n in lens],
                       dtype=torch.int32, device="cuda")
    O = int(cap.max())
    cpu_args = (src.cpu(), src_len.cpu(), cap.cpu(), O)
    print(f"strict encode shapes: B={B} S={src.shape[1]} O={O}")
    def payloads(pair):
        """(out, written) with the row bytes past each payload zeroed: the
        kernel leaves them undefined."""
        out, written = pair
        cols = torch.arange(out.shape[1], device=out.device)
        return out * (cols < written.clamp(min=0)[:, None]), written

    # the source bytes and two lengths a block read, the payloads (this
    # run's `written`) and `written` stored; about ten integer operations
    # a byte
    kernel_row(
        "encode_sequencer", "lz4net_tpu_torch/csrc/encode_sequencer.cu",
        "lz4net_tpu/ops/encode_pallas.py:313", es,
        lambda: es.encode_sequencer(src, src_len, cap, O),
        lambda: _on_card(es.encode_sequencer_reference(*cpu_args)),
        n_bytes=lambda got: (n_data + 2 * B * i4
                             + int(got[1].clamp(min=0).sum()) + B * i4),
        n_ops=10 * n_data, plain_reps=1, defined=payloads)
    # the edge rows (corpus.strict_edge_rows: runs, noise, hash collisions
    # inside probe windows, both table variants, the budgets at each
    # output-limit check); 8 blocks of 256 KB, rows too wide for shared
    # memory, which go to the one-thread kernel; 4 blocks as wide as the
    # widest row staged in shared memory, then one byte wider
    edge = corpus.strict_edge_rows(SEED)
    wide = corpus.split_blocks(b"".join(blocks[:32]), 1 << 18)
    limit = es.row_max("cuda")
    at_limit = corpus.split_blocks(b"".join(blocks[:12]), limit)[:4]
    over = corpus.split_blocks(b"".join(blocks[:12]), limit + 1)[:4]
    for what, rows_in, caps in (
            ("edge rows", [d for _, d, _ in edge],
             [b if b is not None else maximum_output_length(len(d))
              for _, d, b in edge]),
            ("wide-row kernel, 256 KB rows", wide,
             [maximum_output_length(len(d)) for d in wide]),
            ("the widest staged rows", at_limit,
             [maximum_output_length(len(d)) for d in at_limit]),
            ("one byte wider, the wide-row kernel", over,
             [maximum_output_length(len(d)) for d in over])):
        vsrc, vlen = _uint8_rows(torch, rows_in)
        vcap = torch.tensor(caps, dtype=torch.int32, device="cuda")
        vO = int(vcap.max())
        vargs = (vsrc.cpu(), vlen.cpu(), vcap.cpu(), vO)
        n_in = sum(map(len, rows_in))
        kernel_row(
            "encode_sequencer", "", "", es,
            lambda: es.encode_sequencer(vsrc, vlen, vcap, vO),
            lambda: _on_card(es.encode_sequencer_reference(*vargs)),
            n_bytes=lambda got: (n_in + 2 * len(rows_in) * i4
                                 + int(got[1].clamp(min=0).sum())
                                 + len(rows_in) * i4),
            n_ops=10 * n_in, plain_reps=1, defined=payloads,
            variant=f"{what}, B={len(rows_in)}, S={vsrc.shape[1]}")
    comp, comp_len = _uint8_rows(torch, packed)
    out_len = torch.tensor(lens, dtype=torch.int32, device="cuda")
    D = max(lens)
    cpu_args = (comp.cpu(), comp_len.cpu(), out_len.cpu(), D)
    n_comp = sum(map(len, packed))
    print(f"sequencer decode shapes: B={B} C={comp.shape[1]} D={D}")
    kernel_row(
        "decode_sequencer", "lz4net_tpu_torch/csrc/decode_sequencer.cu",
        "lz4net_tpu/ops/decode_pallas.py:250", ds,
        lambda: ds.decode_sequencer(comp, comp_len, out_len, D),
        lambda: _on_card(ds.decode_sequencer_reference(*cpu_args)),
        n_bytes=n_comp + 2 * B * i4 + B * D + 2 * B * i4,
        n_ops=4 * B * D, plain_reps=1)
    # the edge rows (corpus.decode_edge_rows), at their D and one byte
    # short of it (the longest row faults by a write past D); then 4 rows
    # of the corpus as wide as the widest output row the kernel decodes
    # in shared memory (decode_sequencer.row_max), and one byte wider
    # (its one-warp kernel), compressed by the strict encoder
    edge = corpus.decode_edge_rows(SEED)
    limit = ds.row_max("cuda")
    variants = [(f"edge rows, D={D_e}", [b for _, b, _ in edge],
                 [n for *_, n in edge], D_e)
                for D_e in (max(n for *_, n in edge),
                            max(n for *_, n in edge) - 1)]
    for width, what in ((limit, "the widest shared-memory rows"),
                        (limit + 1, "one byte wider, the one-warp kernel")):
        datas = corpus.split_blocks(b"".join(blocks[:16]), width)[:4]
        variants.append((f"{what}, B=4, D={width}",
                         cuda_engine.compress_blocks(datas, device="cuda"),
                         [len(d) for d in datas], width))
    for what, vblocks, vlens, vD in variants:
        vcomp, vcl = _uint8_rows(torch, vblocks)
        vol = torch.tensor(vlens, dtype=torch.int32, device="cuda")
        vargs = (vcomp.cpu(), vcl.cpu(), vol.cpu(), vD)
        kernel_row(
            "decode_sequencer", "", "", ds,
            lambda: ds.decode_sequencer(vcomp, vcl, vol, vD),
            lambda: _on_card(ds.decode_sequencer_reference(*vargs)),
            n_bytes=int(vcl.sum()) + 4 * len(vblocks) * i4
            + len(vblocks) * vD, n_ops=4 * len(vblocks) * vD,
            plain_reps=1, variant=what)

    by_path = {}

    def run_path(path, call, kname):
        """Counts at 0, one call, the launches read; the path must launch
        ``kname`` once and no other kernel."""
        for row in rows:
            setattr(row["module"], row["counter"], 0)
        t = time.perf_counter()
        got = call()
        torch.cuda.synchronize()
        first_ms = (time.perf_counter() - t) * 1e3
        launches = {row["name"]: getattr(row["module"], row["counter"])
                    for row in rows}
        by_path[path] = launches
        if launches != {**{k: 0 for k in launches}, kname: 1}:
            fail(f"{path}: launches {launches}, the path makes one "
                 f"{kname} and nothing else")
        return got, first_ms

    def host_ms(call, n=REPS):
        walls = []
        for _ in range(n):
            t = time.perf_counter()
            call()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t) * 1e3)
        return walls

    # ---- slice phase: strict encode -------------------------------------
    def strict_call():
        return cuda_engine.compress_blocks(blocks, device="cuda")

    got, first_ms = run_path("strict_encode", strict_call,
                             "encode_sequencer")
    if got != packed:
        bad = [j for j, (g, p) in enumerate(zip(got, packed)) if g != p]
        fail(f"strict encode differs from the reference compressor in "
             f"blocks {bad[:10]}")
    if codec.encode(blocks[0]) != packed[0]:
        fail("codec.encode (strict) differs from the reference compressor")
    tight = len(packed[0]) - 1
    if codec.encode(blocks[0], tight) != b"" \
            or reference.compress_block(blocks[0], tight) != b"":
        fail("a budget overflow did not return b''")
    walls = host_ms(strict_call)
    dev_ms = time_ms(torch, lambda: es.encode_sequencer(src, src_len, cap,
                                                         O))
    late = statistics.median(walls)
    print(f"strict encode slice: {B} blocks equal the reference "
          f"compressor's ({n_comp} bytes), codec.encode equal, a budget "
          f"overflow gives b''; compress_blocks first call {first_ms:.2f} "
          f"ms, then (ms): " + " ".join(f"{w:.2f}" for w in walls)
          + f"; median {late:.2f} ms per {B}-block batch, "
          f"{n_data / late / 1e6:.4f} GB/s of input (host clock, end to "
          f"end); device pass {dev_ms:.3f} ms, "
          f"{n_data / dev_ms / 1e6:.3f} GB/s; {card}")
    where_the_time_goes(torch, strict_call, "compress_blocks", n_data,
                        "of input", card)

    # ---- slice phase: sequencer decode ----------------------------------
    def seq_call():
        return ds.SequencerDecoder("cuda").decode_batch(packed, lens)

    got, first_ms = run_path("sequencer_decode", seq_call,
                             "decode_sequencer")
    if got != blocks:
        bad = [j for j, (g, b) in enumerate(zip(got, blocks)) if g != b]
        fail(f"sequencer decode differs from the source in blocks "
             f"{bad[:10]}")
    off0 = bytearray(reference.compress_block(b"abcd" * 50))
    off0[5:7] = b"\x00\x00"            # the first match's offset
    for what, blk, n in (("truncated", packed[0][:len(packed[0]) // 2],
                          lens[0]), ("offset-0", bytes(off0), 200)):
        try:
            ds.SequencerDecoder("cuda").decode_batch([blk], [n])
        except reference.CorruptedBlockError:
            print(f"sequencer decode: a {what} block raised "
                  f"CorruptedBlockError")
        else:
            fail(f"sequencer decode accepted a {what} block")
    # in turns: sequencer, vector, sequencer, vector, ...
    seq_walls, vec_walls = [], []
    for _ in range(REPS):
        seq_walls += host_ms(seq_call, 1)
        vec_walls += host_ms(lambda: codec.decode_batch(packed, lens,
                                                        device="cuda"), 1)
    dev_ms = time_ms(torch, lambda: ds.decode_sequencer(comp, comp_len,
                                                         out_len, D))
    seq, vec = statistics.median(seq_walls), statistics.median(vec_walls)
    print(f"sequencer decode slice: {B} blocks byte-exact, truncated and "
          f"offset-0 blocks raise; first call {first_ms:.2f} ms, then "
          f"(ms): " + " ".join(f"{w:.2f}" for w in seq_walls)
          + f"; median {seq:.2f} ms per {B}-block batch, "
          f"{n_data / seq / 1e6:.4f} GB/s decoded (host clock), beside the "
          f"vector decoder's {vec:.2f} ms ({n_data / vec / 1e6:.4f} GB/s) "
          f"in the same turns; device pass {dev_ms:.3f} ms, "
          f"{n_data / dev_ms / 1e6:.3f} GB/s; {card}")
    where_the_time_goes(torch, seq_call, "SequencerDecoder.decode_batch",
                        n_data, "decoded", card)
    return by_path


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
        from lz4net_tpu_torch.tools._clocks import kernel_split
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
                   n_ops, library=None, plain_reps=REPS, counter="launches",
                   variant=None, defined=None, split=False):
        """Check ``fn`` (the kernel) against ``plain`` and time both; a
        ``variant`` adds these numbers to kernel ``kname``'s row;
        ``defined`` maps outputs to the part the kernel defines; ``split``
        adds the device ms of each CUDA kernel behind the call."""
        got, want = fn(), plain()
        torch.cuda.synchronize()
        err = max_abs_err(torch, defined(got) if defined else got,
                          defined(want) if defined else want)
        if err != 0:
            fail(f"{kname}: kernel differs from its plain version "
                 f"(max abs err {err})")
        if callable(n_bytes):              # counted from the outputs
            n_bytes = n_bytes(got)
        ms = time_ms(torch, fn)
        # plain_reps 0: the plain version checks the kernel, untimed
        plain_ms = time_ms(torch, plain, inner=1 if plain_reps < REPS
                           else 10, reps=plain_reps) if plain_reps else None
        lib_ms = time_ms(torch, library) if library else None
        bound_ms, bound_by = bound(n_bytes, n_ops)
        nums = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound_ms, "bound_by": bound_by,
                "library_ms": lib_ms}
        if split:
            nums["sub_ms"] = kernel_split(fn)
        if variant is None:
            rows.append({"name": kname, "route": "cuda", "source": source,
                         "replaces": replaces, "module": mod,
                         "counter": counter, **nums})
        else:
            row = next(r for r in rows if r["name"] == kname)
            row.setdefault("variants", {})[variant] = nums
        print(f"kernel {kname}" + (f" ({variant})" if variant else "")
              + f": {ms:.4f} ms (plain "
              + (f"{plain_ms:.4f} ms" if plain_ms else "not timed") + ", "
              f"bound {bound_ms:.4f} ms by {bound_by}"
              + (f", library {lib_ms:.4f} ms" if lib_ms else "")
              + f"), max abs err {err}"
              + ("; by kernel (torch.profiler): " + ("; ".join(
                  f"{k} {v:.4f} ms"
                  for k, v in nums["sub_ms"].items()) if nums["sub_ms"]
                  else "not measured") if split else "")
              + f"; {card}")
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
    # the edge rows (corpus.parse_edge_rows: decode_edge_rows packed, and
    # junk rows with 0xFF runs across tiles and comp_len at and below C)
    ecomp, ecl, eC = corpus.parse_edge_rows(SEED)
    ecomp, ecl = torch.from_numpy(ecomp).to("cuda"), torch.from_numpy(
        ecl).to("cuda")
    kernel_row(
        "parse_tokens", "", "", parse_kernel,
        lambda: parse_kernel.parse_tokens(ecomp, ecl, eC),
        lambda: parse_kernel.parse_tokens_reference(ecomp, ecl, eC),
        n_bytes=int(ecl.clamp(0, eC).sum()) * i4 + ecomp.numel() * i4 * 3
        + ecomp.shape[0] * (i4 + 1),
        n_ops=ecomp.numel() * 30,
        variant=f"edge rows, B={ecomp.shape[0]}, C={eC}")
    t0m, cidx, _stats = kernel_row(
        "records_to_state", "lz4net_tpu_torch/csrc/records_kernel.cu",
        "lz4net_tpu/ops/records_kernel.py:374", records_kernel,
        lambda: records_kernel.records_to_state(
            comp, mark, ll, ml, comp_len, out_len, pre_len, C, Dt, 0),
        lambda: records_kernel.records_to_state_reference(
            comp, mark, ll, ml, comp_len, out_len, pre_len, C, Dt, 0),
        n_bytes=B * C * i4 + 3 * n_comp * i4 + 3 * B * i4
        + 2 * B * Dt * i4 + B * 8 * i4,
        n_ops=B * C * 30 + B * Dt * 20)
    # a dictionary prefix of P = 8192 bytes (pre_len 0, P and 100 in turn)
    P8 = 8192
    pre8 = torch.tensor([(0, P8, 100)[j % 3] for j in range(B)],
                        dtype=torch.int32, device="cuda")
    kernel_row(
        "records_to_state", "", "", records_kernel,
        lambda: records_kernel.records_to_state(
            comp, mark, ll, ml, comp_len, out_len, pre8, C, P8 + Dt, P8),
        lambda: records_kernel.records_to_state_reference(
            comp, mark, ll, ml, comp_len, out_len, pre8, C, P8 + Dt, P8),
        n_bytes=B * C * i4 + 3 * n_comp * i4 + 3 * B * i4
        + 2 * B * (P8 + Dt) * i4 + B * 8 * i4,
        n_ops=B * C * 30 + B * (P8 + Dt) * 20,
        variant=f"P={P8}, pre_len 0/{P8}/100, Dt={P8 + Dt}")
    # the edge rows: parse_edge_rows as parse_tokens marks them (out_len
    # the decoded length, C for the junk rows), then
    # corpus.token_edge_rows (tied estarts, out_len inside a token, a
    # token longer than a tile), at P = 0 and P = 8192
    emark, ell, eml, _ = parse_kernel.parse_tokens(ecomp, ecl, eC)
    eol = [n for *_, n in corpus.decode_edge_rows(SEED)]
    eol += [eC] * (ecomp.shape[0] - len(eol))
    eDt = -(-(max(eol[:-6]) + 1) // 8192) * 8192
    _, *trows = corpus.token_edge_rows(eC, SEED)
    rargs = [torch.cat([a, torch.from_numpy(t).to("cuda")]) for a, t in zip(
        (ecomp, emark, ell, eml, ecl,
         torch.tensor(eol, dtype=torch.int32, device="cuda")), trows)]
    eB = rargs[0].shape[0]
    for eP in (0, P8):
        epre = torch.tensor([(0, eP, 100)[j % 3] if eP else 0
                             for j in range(eB)], dtype=torch.int32,
                            device="cuda")
        kernel_row(
            "records_to_state", "", "", records_kernel,
            lambda: records_kernel.records_to_state(*rargs, epre, eC,
                                                    eP + eDt, eP),
            lambda: records_kernel.records_to_state_reference(
                *rargs, epre, eC, eP + eDt, eP),
            n_bytes=eB * eC * i4 + 3 * int(rargs[4].clamp(0, eC).sum()) * i4
            + 3 * eB * i4 + 2 * eB * (eP + eDt) * i4 + eB * 8 * i4,
            n_ops=eB * eC * 30 + eB * (eP + eDt) * 20,
            variant=f"edge rows, B={eB}, C={eC}, P={eP}, Dt={eP + eDt}")
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
    # a dictionary prefix of one chunk passed through (start_chunk 1): the
    # same words after P8 dictionary bytes, their pointers moved by P8
    import numpy as np
    dict_bytes = torch.from_numpy(np.random.default_rng(SEED).integers(
        0, 256, (B, P8), np.int32)).to("cuda")
    T0p = torch.cat([dv.VFLAG | dict_bytes,
                     torch.where(T0 >= dv.VFLAG, T0, T0 + P8)], 1)
    kernel_row(
        "resolve_wavefront", "", "", resolve_kernel,
        lambda: resolve_kernel.resolve_wavefront(T0p, 1),
        lambda: resolve_kernel.resolve_wavefront_reference(T0p, 1),
        n_bytes=B * (P8 + Dt) * i4 * 2 + B, n_ops=B * (P8 + Dt) * 6,
        variant=f"start_chunk=1, P={P8}, Dt={P8 + Dt}")
    # corpus.resolve_edge_rows: chains through every chunk, pointers to
    # lo - 1, to 0 and into the prefix, a chunk with no terminal, and junk
    # rows (forward pointers, cycles, negative and big words), ok compared
    rnames, rt0 = corpus.resolve_edge_rows(Dt, SEED)
    rt0 = torch.from_numpy(rt0).to("cuda")
    for sc in (0, 1):
        kernel_row(
            "resolve_wavefront", "", "", resolve_kernel,
            lambda: resolve_kernel.resolve_wavefront(rt0, sc),
            lambda: resolve_kernel.resolve_wavefront_reference(rt0, sc),
            n_bytes=rt0.numel() * i4 * 2 + rt0.shape[0],
            n_ops=rt0.numel() * 6,
            variant=f"edge rows, B={len(rnames)}, Dt={Dt}, "
            f"start_chunk={sc}")

    # ---- slice phase: the main path through the codec -------------------
    dec = cuda_engine.decoder("cuda")
    for row in rows:
        setattr(row["module"], row["counter"], 0)
    dec.host_decodes = 0
    t = time.perf_counter()
    got = codec.decode_batch(packed, lens, device="cuda")
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t
    launches = {row["name"]: getattr(row["module"], row["counter"])
                for row in rows}
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
    where_the_time_goes(
        torch, lambda: codec.decode_batch(packed, lens, device="cuda"),
        "decode_batch", len(data), "decoded", card)

    # ---- malformed input -------------------------------------------------
    try:
        codec.decode_batch([packed[0][:len(packed[0]) // 2]], [lens[0]],
                           device="cuda")
    except reference.CorruptedBlockError:
        print("malformed: truncated block raised CorruptedBlockError")
    else:
        fail("a truncated block decoded without CorruptedBlockError")

    enc_launches, fast_total = encode_phases(torch, card, kernel_row,
                                             blocks, packed)
    strict_launches = strict_phases(torch, card, kernel_row, rows, blocks,
                                    packed)
    hc_launches = hc_phases(torch, card, kernel_row, rows, blocks,
                            fast_total)
    chain_launches = chain_phases(torch, card, kernel_row, rows, blocks)
    paths = [("decode", launches), ("encode", enc_launches),
             *strict_launches.items(), *hc_launches.items(),
             *chain_launches.items()]
    for row in rows:
        del row["module"], row["counter"]
        by_path = {path: counts[row["name"]] for path, counts in paths
                   if counts.get(row["name"])}
        row["launches"] = sum(by_path.values())
        row["launches_by_path"] = by_path
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
