#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (lz4net_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py            # from the repository root

1. prints the card's name and power limit (nvidia-smi);
2. builds the fifteen CUDA kernels from lz4net_tpu_torch/csrc with nvcc
   and the native host engine from lz4net_tpu_torch/native with g++,
   then selects the engines (lz4net_tpu_torch.registry, with its cache
   pointed at an empty temporary directory; the AutoTest runs here, before
   any counted call);
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
   a token, tokens longer than a tile) at P = 0 and 8192, each with
   the block ends it writes for the block-end rules (the main shape also
   without them);
   records_to_state also behind a full 64 KB window (P = 65,536, Dt =
   139,264, pre_len 65,536, 0 and 100 in turn); resolve_wavefront also
   with a dictionary prefix of one chunk passed through (start_chunk 1,
   Dt = 81,920), behind a 64 KB window (start_chunk 8, Dt = 139,264, one
   literal in 20 turned into a pointer up to 64 KB back) and on
   corpus.resolve_edge_rows (junk rows included, ok compared) at
   start_chunk 0 and 1;
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
   kernel reads from device memory, rows being wider than it stages in
   shared memory, on 4 blocks as wide as the widest row it stages
   (encode_sequencer.row_max) and 4 one byte wider, and on the stream
   cell's batch, 8 chunks of 1 MB of an 8 MiB corpus (with the rows it
   read from device memory, encode_sequencer.device_rows); the sequencer
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
   size beside fast mode's and the reference HC parse's on all 256
   blocks (models.native.compress_blocks at 256 attempts);
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
15. the dictionary workload (BASELINE.json's shared-dictionary,
   small-record configuration): the 16 MB corpus cut into 4096 records
   of 4 KB, records 0, 256, ..., 3840 concatenated as the 64 KB
   dictionary, and the 1024 records whose index is 1 mod 4 as the
   batch: rows of P + 8192 = 73,728 positions; on its first 256 rows,
   with the window cut to 65,536, 0 and 20,000 bytes, bucket_prev,
   match_lengths (end_abs = P + len), sequence_records (its first
   literal run at P) and emit_bytes against their plain versions, and
   with the whole window mark_chain (checked, not timed: its plain
   version walks) and table_gather on that match state;
16. encodes the 1024 records through
   lz4net_tpu_torch.models.cuda.compress_blocks_fast_dict, fast and at
   HC level 9; requires for each no host encode, each kernel of its path
   launched as the path says, the first 16 (fast) or 8 (HC) payloads
   equal to the CPU path's, the first 16 to decode with
   models.reference.decompress_block_dict and all on the card, and the
   HC total no larger than the fast one; prints ms per batch (first and
   later calls), GB/s of records, the device pass beside that of the
   same records without a window (the window's share), the peak device
   memory and the compressed size beside compress_blocks_fast's without
   the dictionary and the reference dictionary compressor's
   (models.native.compress_block_dict) on all 1024 records;
17. decodes the fast payloads through
   lz4net_tpu_torch.models.cuda.decompress_blocks_dict: byte-exact, no
   host re-decode, each decode kernel launched once; 16 payloads decoded
   with an all-zero window, and with the dictionary's last 1 KB (which
   leaves matches below the window), give the host decoder's bytes or
   raise, uncertified, where it raises; prints ms per batch and GB/s of
   records;
18. decodes the 256 reference-compressed 64 KB blocks through
   VectorDecoder.decode_batch_unknown with a 96 KB cap (D = 106,496):
   byte-exact, no host re-decode, a truncated block and a cap one byte
   short raise CorruptedBlockError; again with a 1 MB cap (and through
   codec.decode(max_output_length=)): byte-exact, no host re-decode, and
   a block that decodes to 128 KB too (a big block); prints ms per
   batch; then the block-end rules (C3): the three corpus.big_bad_blocks
   of a 30,000-byte block raise the host decoder's CorruptedBlockError
   through codec.decode_batch, decode_batch_unknown (caps of 96 KB and
   2 MB) and decompress_blocks_dict, corpus.block_end_rows give the
   reference decoders' bytes or errors on each path, and the rows those
   all take decode with no host re-decode;
19. the facade on the card: codec.wrap, wrap_hc and unwrap round-trip a
   64 KB block, 4 KB of random bytes (stored raw) and an empty buffer;
   codec.encode_hc(mode="strict") and wrap_hc's payload equal
   models.reference.compress_block_hc; codec.decode(max_output_length=)
   and codec.decode(dictionary=) equal the batch paths; and
   ops.encode_vector.encode_batch_chain in P mode equals the sequence
   path's bytes on the 1024 records with the chain path's launches (the
   mark_chain and table_gather gate);
20. the big-block workload: the 16 MB corpus in 16 blocks of 1 MB,
   compressed by the card's strict encoder, walked on the host
   (ops.bigblock.scan: fragments, waves, the walk's host time); on
   fragment wave 2 (each row behind a full 64 KB window, Dt = 172,032)
   parse_tokens, records_to_state and resolve_wavefront against their
   plain versions, the resolved bytes against the blocks'; on the 256
   64 KB segment rows of the blocks (D = 139,264) and on 64 records of
   96 KB behind the 64 KB dictionary (D = 172,032) bucket_prev,
   match_lengths (8 offsets at the fast rcap, 24 at HC level 9's),
   sequence_records (2 and 8 catch-up rounds), emit_bytes and, on the
   segment rows, hc_tables' run tables against their plain versions;
21. decodes the 16 blocks through codec.decode_batch (fragment waves):
   byte-exact, no host re-decode, each decode kernel launched once a
   wave; prints ms per batch and where the time goes; then through
   VectorDecoder.decode_batch_unknown with caps of 1 MB and 2 MB
   (byte-exact, no host re-decode), a cap one byte short and, under a
   2 MB cap, the first block's corpus.big_bad_blocks (ending on a match,
   on an empty final literal run, on a giant match), which must raise
   the host decoder's CorruptedBlockError, as must the first block with
   its final run cut to 3 literals (corpus.short_final_run) through
   codec.decode_batch;
22. encodes the 16 blocks through compress_blocks_fast and
   compress_blocks_hc_fast (level 9): no host encode, each kernel
   launched as the path says (one pass for the 256 segments), the first
   payload equal to the CPU path's, the first 2 decoded on the host and
   all on the card; prints ms per batch, the device pass, the peak
   device memory and the compressed size beside 64 KB-block fast mode's
   and the reference compressor's;
23. corpus.big_edge_blocks (giant matches and literal runs, a match tail
   under 4 bytes, a final literal run on a boundary, an incompressible
   block) decode, known and unknown length, and encode, fast and HC
   level 9, both ways with no host decode or encode;
24. 4 blocks of 1 MB and the 64 records of 96 KB behind the dictionary
   through compress_blocks_fast_dict (fast and HC level 9) and
   decompress_blocks_dict: no host encode or decode, the first fast
   payloads equal to the CPU path's, the first decoded on the host;
25. the stream cell: codec_name() must be "cuda/cuda/cudaHC"; the 16 MB
   through lz4net_tpu_torch.stream at 1 MB chunks (16) and at 64 KB
   (256): frames equal to those built from models.reference.
   compress_block, one encode_sequencer launch a write's batch of chunks
   (the whole 16 MB in one); a read-all
   (decompress_stream: one codec.decode_batch call for every chunk) and
   1 MB read() calls (a call for each 1 MB of chunks), byte-exact with no
   host re-decode, the decode kernels launched as those calls imply (a
   pass a call, a pass a fragment wave for 1 MB chunks); MB/s written and
   read (host clock) and the device's idle share of a read-all
   (torch.profiler); the 16 MB through an HC stream at 64 KB (frames equal
   to native.compress_block_hc's, the first 1 MB's to the Python
   reference.compress_block_hc's); an interactive read over a local
   socket pair returning each chunk as it arrives;
26. the tools as subprocesses: python -m lz4net_tpu_torch compress and
   decompress of the 16 MB file (byte-exact), verify on 1 MB, info
   (naming the card), continuous --mb 16 (both engines verified), and
   python -m lz4net_tpu_torch.tools.certify (CERTIFIED);
27. python -m lz4net_tpu_torch select on the card into the selection
   cache, then, selected again in this process with that cache:
   codec_name() must still be "cuda/cuda/cudaHC", and a read-all of 4 MB
   of 64 KB stream frames must decode on the card (host_decodes=0, each
   decode kernel launched once);
28. the data-parallel pipeline (lz4net_tpu_torch.parallel) in a world
   of one on NCCL (parallel.mesh.make_mesh()): the dry run of
   __graft_entry__.py at the main cell's size, make_distributed_encode on
   the 256 blocks (payloads equal to the reference compressor's, the
   all-reduced total their sum, one encode_sequencer launch and no other),
   then distributed_decode of those payloads (byte-exact, one
   decode_sequencer launch and no other; the step's total 16 MB); the
   batch less its last 3 blocks packed to a multiple of 8 (3 pad rows,
   dropped: the same blocks and total); a truncated and an offset-0 block
   raise CorruptedBlockError, a block with two trailing bytes gives its
   source; distributed_decode_dict on the dictionary workload's 1024
   records (fast-encoded on the card): byte-exact, 1024 certified, no host
   re-decode, each decode kernel launched once; ms per call (first and
   late), each step's device time, distributed_decode in turns with
   SequencerDecoder.decode_batch and codec.decode_batch, and the
   collectives' share (torch.profiler); the group is destroyed at the end;
29. the native host engine (lz4net_tpu_torch.models.native): registered
   on the card (available_services) while every role stays cuda, its
   AutoTest, its strict bytes equal to encode_sequencer's payloads on the
   256 blocks, its HC level 9, dictionary and HC dictionary bytes equal
   to the Python parses' (models.reference) on 8 blocks and 8 records,
   bigblock.scan equal to bigblock.scan_reference and
   native.unknown_output_length to the Python walk on the 16 blocks of
   1 MB and the first one's corpus.big_bad_blocks; prints the host
   library's build seconds, each walk's ms a 1 MB block beside the
   Python walk's, and, from steps 21 and 25, big decode's and big
   unknown decode's late ms and idle share, the 1 MB stream read rate
   and the HC stream's write rate;
30. prints one JSON line with the kernels (each with its launches by
   path, and the other shapes it was timed at under "variants"), then,
   last, {"ok": true, "device": {...}}.

Any failure exits non-zero before the last line.  Without a CUDA device,
or without the package beside this script, it exits non-zero at once.
"""

import cProfile
import json
import os
import pstats
import statistics
import subprocess
import sys
import tempfile
import time

CORPUS_BYTES = 16 << 20
BLOCK = 64 * 1024
SEED = 0
P64 = 65536                    # the prefix of a full 64 KB window
REPS = 5
REPORT = {}                    # the host engine's numbers for step 29
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


def zero_counts(rows):
    """Every kernel row's launch count at 0."""
    for row in rows:
        setattr(row["module"], row["counter"], 0)


def read_counts(rows, names=None):
    """{kernel: launches since ``zero_counts``} for ``names`` (every
    row's kernel if None)."""
    by_name = {row["name"]: row for row in rows}
    return {k: getattr(by_name[k]["module"], by_name[k]["counter"])
            for k in (by_name if names is None else names)}


def host_walls(torch, call, reps=REPS):
    """Host-clock ms of ``reps`` calls of ``call``, each ended by a
    device sync."""
    walls = []
    for _ in range(reps):
        t = time.perf_counter()
        call()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t) * 1e3)
    return walls


def first_call(torch, rows, call, names=None):
    """Counts at 0, one ``call()`` timed on the host clock, the counts
    read: (its result, ms, ``read_counts(rows, names)``)."""
    zero_counts(rows)
    t = time.perf_counter()
    got = call()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t) * 1e3
    return got, ms, read_counts(rows, names)


def only_path(torch, rows, by_path, path, call, names):
    """Counts at 0, one ``call()``, the launches read into
    ``by_path[path]``: the path must launch each kernel of ``names`` once
    and no other.  Returns (its result, ms)."""
    got, first_ms, launches = first_call(torch, rows, call)
    by_path[path] = launches
    if launches != {**{k: 0 for k in launches}, **{k: 1 for k in names}}:
        fail(f"{path}: launches {launches}, one each of {list(names)} and "
             f"nothing else expected")
    return got, first_ms


def where_the_time_goes(torch, call, name, n_bytes, unit, card):
    """The device's busy share and time by kernel from torch.profiler over
    one ``call()``, the host's time by function from cProfile over
    another, then five more calls timed on the host clock (the steady
    state); ``n_bytes`` per call gives the rate in GB/s ``unit``.
    Returns (the idle share, None where the trace lost the port's
    kernels; the late calls' median ms)."""
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
    idle = None
    if any(e.key.startswith("lz4t::") for e in dev):
        idle = 1 - busy_ms / prof_ms
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
    late = host_walls(torch, call)
    late_ms = statistics.median(late)
    print(f"late {name} calls (ms): "
          + " ".join(f"{w:.2f}" for w in late)
          + f"; median {late_ms:.2f} ms, "
          f"{n_bytes / late_ms / 1e6:.4f} GB/s {unit}; {card}")
    return idle, late_ms


def encode_phases(torch, card, kernel_row, rows, blocks, packed):
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
    enc = cuda_engine.encoder("cuda")
    enc.host_encodes = 0
    got, first_ms, launches = first_call(
        torch, rows, lambda: cuda_engine.compress_blocks_fast(
            blocks, device="cuda"),
        ("bucket_prev", "match_lengths", "sequence_records", "emit_bytes",
         "rowbase_gather"))
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

    walls = host_walls(torch, lambda: cuda_engine.compress_blocks_fast(
        blocks, device="cuda"))
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
    from lz4net_tpu_torch.models import native, reference
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
    by_path = {}
    sizes = {}
    # the reference HC parse on every block (the native host engine,
    # which step 29 holds against the Python parse)
    hc_lens = [len(b) for b in blocks]
    ref_hc = native.compress_blocks(
        b"".join(blocks), np.cumsum([0] + hc_lens[:-1]), hc_lens,
        hc_attempts=256)[1]
    ref_total = int(ref_hc.sum())
    for path, level, tiers, want in HC_PATHS:
        def call():
            if tiers is None:
                return cuda_engine.compress_blocks_hc_fast(
                    blocks, level=level, device="cuda")
            return enc.encode_batch(blocks, hc_level=level, hc_tiers=tiers)

        enc.host_encodes = 0
        got, first_ms, launches = first_call(torch, rows, call, want)
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
        print(f"{path} slice (level {level}, tiers {tiers or 'by level'}): "
              f"{B} blocks, host_encodes=0, launches {launches}, every "
              f"payload decodes on the host and the card, first 8 equal "
              f"the CPU path's, first call {first_ms:.1f} ms; {total} "
              f"compressed bytes ({total / n_data:.4f} of input) against "
              f"{fast_total} ({fast_total / n_data:.4f}) in fast mode and "
              f"{ref_total} ({ref_total / n_data:.4f}) from the reference "
              f"HC parse (level 9, native host engine) on all {B} blocks "
              f"({total / ref_total:.4f} of it); {card}")

        walls = host_walls(torch, call, REPS - 1)
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

    # ---- probe phase: the only caller of lane_lookup and diag_gather -----
    # tools/probe_fused.py's checks through the port's entry points, with
    # their answers from torch.gather and the band's definition
    (got, (vals, band)), _, by_path["probe"] = first_call(
        torch, rows, lambda: (fused_gather.lane_lookup(lt, li),
                              fused_gather.diag_gather(dt, di, 1, 16)),
        ("lane_lookup", "diag_gather"))
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
        out, out_len, ok, _ = fn(xt, torch.tensor(lens, dtype=torch.int32,
                                                   device="cuda"),
                                 D, O, S_cap, ev.hc_rcap(level, D), level)
        out = out.to(torch.uint8).cpu().numpy()
        out_len, ok = out_len.cpu().numpy(), ok.cpu().numpy()
        return [out[j, :int(n)].tobytes() for j, n in enumerate(out_len)], ok

    for path, level, want in CHAIN_PATHS:
        (got, ok), first_ms, launches = first_call(
            torch, rows, lambda: payloads(ev.encode_batch_chain, level),
            want)
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
                walls += host_walls(torch, lambda: payloads(fn, level), 1)
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


# launches a batch of each dictionary encode path: (path, level) -> counts
DICT_PATHS = (
    ("dict_fast", 0, {"bucket_prev": 1, "hc_tables": 0, "match_lengths": 1,
                      "sequence_records": 1, "emit_bytes": 1,
                      "rowbase_gather": 1}),
    ("dict_hc9", 9, {"bucket_prev": 0, "hc_tables": 0, "match_lengths": 8,
                     "sequence_records": 1, "emit_bytes": 1,
                     "rowbase_gather": 1}),
)
RECORD = 4096                  # the dictionary workload's record size
DECODE_KERNELS = ("parse_tokens", "records_to_state", "rowbase_gather",
                  "resolve_wavefront")


def dict_phases(torch, card, kernel_row, rows, data, blocks, packed):
    """Steps 15-19 of the module docstring: the encode kernels in P mode
    against their plain versions, then dictionary fast and fast-HC encode,
    dictionary decode, unknown-length decode and the facade.  Returns the
    launches by path and kernel."""
    import numpy as np

    from lz4net_tpu_torch import codec
    from lz4net_tpu_torch.models import cuda as cuda_engine
    from lz4net_tpu_torch.models import native, reference
    from lz4net_tpu_torch.ops import decode_vector as dv
    from lz4net_tpu_torch.ops import encode_vector as ev
    from lz4net_tpu_torch.ops import (chain_kernel, emit_kernel,
                                      fused_gather, hash_kernel, mlen_kernel,
                                      seq_kernel)
    from lz4net_tpu_torch.utils import corpus

    # ---- workload: 4 KB records behind a shared 64 KB dictionary -------
    records = corpus.split_blocks(data, RECORD)
    dictionary = b"".join(records[0::256])          # 16 records, 64 KB
    batch = records[1::4]                            # 1024 records
    lens = [len(r) for r in batch]
    n_rec = sum(lens)
    B = len(batch)
    xn, dln, pln, P, D, O, S_cap = ev.window_rows(batch, dictionary)
    xd = torch.from_numpy(xn).to("cuda").to(torch.int32)
    dld = torch.from_numpy(dln).to("cuda")
    pld = torch.from_numpy(pln).to("cuda")
    SR = seq_kernel.slot_width(S_cap)
    print(f"dictionary workload: {B} records of {RECORD} bytes (every "
          f"4th from 1), a {len(dictionary)}-byte dictionary (records 0, "
          f"256, ..., 3840); P={P} D={D} O={O} S_cap={S_cap} SR={SR}")
    if len(dictionary) != P or P != P64 or D != P64 + 8192:
        fail(f"the dictionary workload's shapes are P={P}, D={D}")

    # ---- per-kernel phase: the fast path's kernels in P mode -----------
    # the first 256 rows, the window cut to pre_len bytes (65,536, 0 and
    # 20,000): what the encoder gives each kernel, as variants of its row
    i4 = 4
    Bk = 256
    for L in (P, 0, 20000):
        xk = xd[:Bk].clone()
        xk[:, :P - L] = 0
        dk, plk = dld[:Bk], torch.full_like(dld[:Bk], L)
        tag = f"P mode, B={Bk}, D={D}, pre_len={L}"
        u32 = ev._u32(xk)
        us4 = ev._shift_left(u32, 4)
        h4, h8 = hash_kernel.hash_bucket(u32), hash_kernel.hash_bucket8(
            u32, us4)
        prev = kernel_row(
            "bucket_prev", "", "", hash_kernel,
            lambda: hash_kernel.bucket_prev(u32, us4, h4, h8, D),
            lambda: hash_kernel.bucket_prev_reference(u32, us4, h4, h8, D),
            n_bytes=5 * Bk * D * i4, n_ops=Bk * D * 30, plain_reps=1,
            variant=tag)
        off = torch.arange(D, dtype=torch.int32, device="cuda") - prev
        dks = ev._top_offsets_select(off, (prev >= 0) & (off <= 65535)
                                     & (off > 4))
        margs = (xk, u32, prev, torch.zeros_like(prev), dks, P + dk, dk, D,
                 ev.RCAP)
        matched, off_all, mlen_all = kernel_row(
            "match_lengths", "", "", mlen_kernel,
            lambda: mlen_kernel.match_lengths_fused(*margs),
            lambda: mlen_kernel.match_lengths_reference(*margs),
            n_bytes=6 * Bk * D * i4 + Bk * dks.shape[1] * i4 + 2 * Bk * i4,
            n_ops=Bk * D * 40, plain_reps=3,
            variant=tag + ", end_abs = P + len")
        i = torch.arange(D, dtype=torch.int32, device="cuda")
        matched = matched * ((i >= P) & (off_all <= i - (P - L)))
        if L == P:
            # the chain record path's two kernels on the same match
            # state: the orbit now starts in the window
            m = matched == 1
            g = seq_kernel.chain_graph(m, mlen_all, D)
            mark = kernel_row(
                "mark_chain", "", "", chain_kernel,
                lambda: chain_kernel.mark_chain(g, D),
                lambda: chain_kernel.mark_chain_reference(g, D),
                n_bytes=lambda got: Bk * D * i4 + int(got.sum()) * i4,
                n_ops=Bk * D, plain_reps=0, variant=tag)
            tok = seq_kernel.compact_indices((mark == 1) & m, S_cap, D) \
                .clamp(0, D - 1)
            tok64 = tok.long()
            pairs = [off_all, mlen_all]
            kernel_row(
                "table_gather", "", "", fused_gather,
                lambda: fused_gather.table_gather(pairs, tok, (17, 17)),
                lambda: fused_gather.table_gather_reference(pairs, tok,
                                                            (17, 17)),
                n_bytes=Bk * S_cap * i4 * 5, n_ops=Bk * S_cap * 8,
                library=lambda: [torch.gather(t, 1, tok64) for t in pairs],
                variant=tag + ", offsets and lengths, 2 tables of 17 bits")
            del g, mark, tok, tok64, pairs
        sargs = (u32, matched, off_all, mlen_all, P + dk, plk, D, S_cap, P,
                 ev.CU_ROUNDS)
        seq = kernel_row(
            "sequence_records", "", "", seq_kernel,
            lambda: seq_kernel.sequence_records(*sargs),
            lambda: seq_kernel.sequence_records_reference(*sargs),
            n_bytes=lambda got: Bk * D * i4 + int(got[5][:, 0].sum()) * i4
            * (2 + 2 * ev.CU_ROUNDS) + 5 * Bk * SR * i4 + Bk * 8 * i4
            + 2 * Bk * i4,
            n_ops=Bk * D * 20, plain_reps=3, variant=tag)
        if not bool((seq[1][:, 0] == P).all()):
            fail(f"sequence_records ({tag}): a first literal run does not "
                 f"start at P")
        n_live = int((seq[5][:, 1] + 1).sum())
        eargs = (*seq[:5], seq[5][:, 2].contiguous(), O)
        kernel_row(
            "emit_bytes", "", "", emit_kernel,
            lambda: emit_kernel.emit_bytes(*eargs),
            lambda: emit_kernel.emit_bytes_reference(*eargs),
            n_bytes=5 * n_live * i4 + 2 * Bk * O * i4 + Bk * i4,
            n_ops=Bk * O * 20, variant=tag)
    del xk, u32, us4, h4, h8, prev, off, matched, off_all, mlen_all, seq

    # ---- slice phases: dictionary fast and fast-HC encode ---------------
    enc = cuda_engine.encoder("cuda")
    by_path, sizes, payloads = {}, {}, {}
    # the same records without a dictionary, on the card, and the
    # reference dictionary compressor on every record (the native host
    # engine, which step 29 holds against the Python parse)
    plain_total = sum(map(len, cuda_engine.compress_blocks_fast(
        batch, device="cuda")))
    ref_total = sum(len(native.compress_block_dict(dictionary, r))
                    for r in batch)
    x0n, dl0n, _, _, D0, O0, S0 = ev.window_rows(batch)
    x0 = torch.from_numpy(x0n).to("cuda").to(torch.int32)
    dl0 = torch.from_numpy(dl0n).to("cuda")
    for path, level, want in DICT_PATHS:
        def call():
            return cuda_engine.compress_blocks_fast_dict(
                batch, dictionary, level=level, device="cuda")

        enc.host_encodes = 0
        torch.cuda.reset_peak_memory_stats()
        got, first_ms, launches = first_call(torch, rows, call, want)
        peak = torch.cuda.max_memory_allocated() / 2**30
        by_path[path] = launches
        if enc.host_encodes != 0:
            fail(f"{path}: {enc.host_encodes} records were encoded on the "
                 f"host")
        if launches != want:
            fail(f"{path}: launches {launches}, the path makes {want}")
        n_cpu = 16 if level == 0 else 8
        if got[:n_cpu] != ev.VectorEncoder("cpu").encode_batch(
                batch[:n_cpu], hc_level=level, dictionary=dictionary):
            fail(f"{path}: the first {n_cpu} payloads differ from the CPU "
                 f"path's")
        bad = [j for j, (p, r) in enumerate(zip(got[:16], batch))
               if reference.decompress_block_dict(p, dictionary, len(r))
               != r]
        if bad:
            fail(f"{path}: records {bad} do not decode to their source on "
                 f"the host")
        if cuda_engine.decompress_blocks_dict(got, lens, dictionary,
                                              "cuda") != batch:
            fail(f"{path}: records do not decode to their source on the "
                 f"card")
        payloads[path] = got
        sizes[path] = total = sum(map(len, got))
        walls = host_walls(torch, call, REPS - 1)
        rcap = ev.hc_rcap(level, D)
        dev_ms = time_ms(torch, lambda: ev.encode_batch_vectorized(
            xd, dld, D, O, S_cap, rcap, level, None, P, pld),
            inner=10 if level == 0 else 3)
        dev0_ms = time_ms(torch, lambda: ev.encode_batch_vectorized(
            x0, dl0, D0, O0, S0, ev.hc_rcap(level, D0), level),
            inner=10 if level == 0 else 3)
        wall = statistics.median(walls)
        print(f"{path} slice (level {level}): {B} records, host_encodes=0, "
              f"launches {launches}, first {n_cpu} equal the CPU path's, "
              f"every payload decodes on the card (first 16 on the host "
              f"too), peak device memory {peak:.2f} GiB; {total} compressed "
              f"bytes ({total / n_rec:.4f} of the records) against "
              f"{plain_total} ({plain_total / n_rec:.4f}) in fast mode "
              f"without the dictionary and {ref_total} "
              f"({ref_total / n_rec:.4f}) from the reference dictionary "
              f"compressor (native host engine) on all {B} records "
              f"({total / ref_total:.4f} of it); first call "
              f"{first_ms:.2f} ms, later "
              + " ".join(f"{w:.2f}" for w in walls)
              + f"; median {wall:.2f} ms per {B}-record batch, "
              f"{n_rec / wall / 1e6:.4f} GB/s of records (host clock, end "
              f"to end); device pass {dev_ms:.3f} ms, "
              f"{n_rec / dev_ms / 1e6:.3f} GB/s, against {dev0_ms:.3f} ms "
              f"for the same records without a window (D={D0}): the "
              f"window's share {1 - dev0_ms / dev_ms:.3f}; {card}")
        if level == 0:
            where_the_time_goes(torch, call, "compress_blocks_fast_dict",
                                n_rec, "of records", card)
    if sizes["dict_hc9"] > sizes["dict_fast"]:
        fail(f"dictionary HC level 9 wrote {sizes['dict_hc9']} bytes, more "
             f"than fast mode's {sizes['dict_fast']}")

    # ---- slice phase: dictionary decode ---------------------------------
    dec = cuda_engine.decoder("cuda")
    fast = payloads["dict_fast"]

    def dict_call():
        return cuda_engine.decompress_blocks_dict(fast, lens, dictionary,
                                                  "cuda")

    dec.host_decodes = 0
    got, first_ms, launches = first_call(torch, rows, dict_call,
                                         DECODE_KERNELS)
    by_path["dict_decode"] = launches
    if got != batch:
        fail("dictionary decode: records differ from their source")
    if dec.host_decodes != 0:
        fail(f"dictionary decode: {dec.host_decodes} records were "
             f"re-decoded on the host")
    if any(n != 1 for n in launches.values()):
        fail(f"dictionary decode: launches {launches}, one each expected")
    # a wrong window: the host decoder's bytes, or its error.  Zeros of
    # the dictionary's length give wrong bytes; the dictionary's last
    # 1 KB leaves matches below the window, which must raise uncertified
    wrong = {}
    for what, window in (("an all-zero window", bytes(len(dictionary))),
                         ("the dictionary's last 1 KB", dictionary[-1024:])):
        raised = certified = 0
        for p, n in zip(fast[:16], lens):
            before = dec.host_decodes
            try:
                want = reference.decompress_block_dict(p, window, n)
            except reference.CorruptedBlockError:
                raised += 1
                try:
                    cuda_engine.decompress_block_dict(p, window, n, "cuda")
                except reference.CorruptedBlockError:
                    if dec.host_decodes == before:
                        fail(f"a payload with {what} raised without the "
                             f"host decoder")
                    continue
                fail(f"a payload decoded with {what} did not raise")
            if cuda_engine.decompress_block_dict(p, window, n, "cuda") \
                    != want:
                fail(f"a payload decoded with {what} differs from the "
                     f"host decoder's bytes")
            certified += dec.host_decodes == before
        wrong[what] = (raised, certified)
    if wrong["the dictionary's last 1 KB"][0] == 0:
        fail("no payload reached below a 1 KB window: the gate saw no "
             "match below the window")
    walls = host_walls(torch, dict_call)
    wall = statistics.median(walls)
    comp, comp_len, out_len, C, Dd = dv.pack_blocks(fast, lens)
    pre, pre_len, _ = dv.pack_windows(dictionary, B)
    dargs = (*dv.batch_from_numpy(comp, comp_len, out_len, "cuda"), C, Dd,
             torch.from_numpy(pre).to("cuda").to(torch.int32),
             torch.from_numpy(pre_len).to("cuda"))
    dev_ms = time_ms(torch, lambda: dv.decode_batch_vectorized(*dargs))
    print(f"dict_decode slice: {B} records byte-exact, host_decodes=0, "
          f"launches {launches}; 16 payloads with "
          + "; with ".join(f"{what}: {r} raised uncertified as the host "
                           f"decoder does, {16 - r} gave its bytes ({c} of "
                           f"them certified on the card)"
                           for what, (r, c) in wrong.items())
          + f"; first call {first_ms:.2f} ms, later "
          + " ".join(f"{w:.2f}" for w in walls)
          + f"; median {wall:.2f} ms per {B}-record batch, "
          f"{n_rec / wall / 1e6:.4f} GB/s of records (host clock); device "
          f"pass {dev_ms:.3f} ms (C={C}, Dt={P + Dd}), "
          f"{n_rec / dev_ms / 1e6:.3f} GB/s; {card}")

    # ---- slice phase: unknown-length decode -----------------------------
    cap = 96 * 1024
    blens = [len(b) for b in blocks]

    def unknown_call():
        return dec.decode_batch_unknown(packed, [cap] * len(packed))

    dec.host_decodes = 0
    got, first_ms, launches = first_call(torch, rows, unknown_call,
                                         DECODE_KERNELS)
    by_path["unknown_decode"] = launches
    if got != blocks:
        fail("unknown-length decode: blocks differ from their source")
    if dec.host_decodes != 0:
        fail(f"unknown-length decode: {dec.host_decodes} blocks were "
             f"re-decoded on the host")
    if any(n != 1 for n in launches.values()):
        fail(f"unknown-length decode: launches {launches}, one each "
             f"expected")
    for what, blk, c in (("a truncated block", packed[0][:len(packed[0])
                                                         // 2], cap),
                         ("a cap one byte short", packed[0], blens[0] - 1)):
        try:
            dec.decode_batch_unknown([blk], [c])
        except reference.CorruptedBlockError:
            continue
        fail(f"unknown-length decode: {what} did not raise")
    # a cap above 96 KB stays on the card (its pass cut to 96 KB); a
    # block that decodes to more is walked for its length and decodes as
    # a big block, on the card too
    big_cap = 1 << 20
    dec.host_decodes = 0
    if dec.decode_batch_unknown(packed, [big_cap] * len(packed)) != blocks \
            or codec.decode(packed[0], max_output_length=big_cap,
                            device="cuda") != blocks[0]:
        fail(f"unknown-length decode with a {big_cap}-byte cap: blocks "
             f"differ from their source")
    if dec.decode_batch_unknown([reference.compress_block(
            data[:2 * BLOCK])], [big_cap]) != [data[:2 * BLOCK]]:
        fail("unknown-length decode: a block that decodes to 128 KB "
             "differs from its source")
    if dec.host_decodes != 0:
        fail(f"unknown-length decode with a {big_cap}-byte cap: "
             f"{dec.host_decodes} blocks were re-decoded on the host")
    # in turns: 96 KB cap, 1 MB cap, ...
    walls, big_walls = [], []
    for _ in range(REPS):
        walls += host_walls(torch, unknown_call, 1)
        big_walls += host_walls(torch, lambda: dec.decode_batch_unknown(
            packed, [big_cap] * len(packed)), 1)
    wall, big_wall = statistics.median(walls), statistics.median(big_walls)
    comp, comp_len, _, C, _ = dv.pack_blocks(packed, blens)
    Dc = -(-(cap + 1) // dv.CH) * dv.CH
    uargs = (*dv.batch_from_numpy(comp, comp_len, [cap] * len(packed),
                                  "cuda"), C, Dc)
    dev_ms = time_ms(torch, lambda: dv.decode_batch_vectorized(*uargs))
    n_data = sum(blens)
    print(f"unknown_decode slice: {len(packed)} blocks of 64 KB with a "
          f"{cap}-byte cap byte-exact, host_decodes=0, launches {launches}; "
          f"a truncated block and a cap one byte short raise "
          f"CorruptedBlockError; with a {big_cap}-byte cap byte-exact, "
          f"host_decodes=0, a 128 KB block too (as a big block); first "
          f"call {first_ms:.2f} ms, later "
          + " ".join(f"{w:.2f}" for w in walls)
          + f"; median {wall:.2f} ms per batch, "
          f"{n_data / wall / 1e6:.4f} GB/s decoded (host clock); with the "
          f"{big_cap}-byte cap in the same turns "
          + " ".join(f"{w:.2f}" for w in big_walls)
          + f", median {big_wall:.2f} ms; device "
          f"pass {dev_ms:.3f} ms (D={Dc}), {n_data / dev_ms / 1e6:.3f} "
          f"GB/s; {card}")

    block_end_gates(card)

    # ---- slice phase: the facade -----------------------------------------
    noise = np.random.default_rng(SEED).integers(0, 256, RECORD,
                                                 np.uint8).tobytes()
    ref_hc = reference.compress_block_hc(blocks[0])
    for src in (blocks[0], noise, b""):
        for env in (codec.wrap(src, device="cuda"),
                    codec.wrap_hc(src, device="cuda")):
            if codec.unwrap(env, device="cuda") != src:
                fail(f"the envelope of a {len(src)}-byte buffer does not "
                     f"unwrap to it")
            if src is noise and env != (len(noise).to_bytes(4, "little")
                                        * 2 + noise):
                fail("an incompressible buffer is not stored raw")
        if src is blocks[0] and codec.wrap_hc(src, device="cuda")[8:] \
                != ref_hc:
            fail("wrap_hc's payload differs from the reference HC parse")
    if codec.encode_hc(blocks[0], device="cuda") != ref_hc:
        fail("codec.encode_hc(mode='strict') differs from "
             "reference.compress_block_hc")
    if codec.decode(packed[0], max_output_length=cap, device="cuda") \
            != got[0]:
        fail("codec.decode(max_output_length=) differs from the batch path")
    if codec.decode(fast[0], lens[0], dictionary=dictionary,
                    device="cuda") != batch[0]:
        fail("codec.decode(dictionary=) differs from the batch path")
    # the chain record path in P mode: the mark_chain and table_gather gate
    want = CHAIN_PATHS[0][2]
    chain, _, launches = first_call(
        torch, rows, lambda: ev.encode_batch_chain(
            xd, dld, D, O, S_cap, ev.RCAP, 0, None, P, pld), want)
    by_path["dict_chain"] = launches
    if launches != want:
        fail(f"dict_chain: launches {launches}, the path makes {want}")
    seq = ev.encode_batch_vectorized(xd, dld, D, O, S_cap, ev.RCAP, 0, None,
                                     P, pld)
    if any(not torch.equal(a, b) for a, b in zip(chain, seq)) \
            or not bool(chain[2].all()):
        fail("dict_chain: the chain record path's bytes differ from the "
             "sequence path's in P mode")
    print(f"facade: wrap, wrap_hc and unwrap round-trip a 64 KB block, "
          f"{RECORD} incompressible bytes (stored raw) and an empty "
          f"buffer; encode_hc(mode='strict') and wrap_hc's payload equal "
          f"reference.compress_block_hc ({len(ref_hc)} bytes); "
          f"decode(max_output_length=) and decode(dictionary=) equal the "
          f"batch paths; encode_batch_chain in P mode equals the sequence "
          f"path on the {B} records, launches {launches}; {card}")
    return by_path


# launches a batch of each big-block path: (path, level) -> counts; the
# 256 segments of 16 blocks of 1 MB take one device pass
BIG_BLOCK = 1 << 20             # the big-block workload's block size
BIG_PATHS = (
    ("big_fast", 0, {"bucket_prev": 1, "hc_tables": 0, "match_lengths": 1,
                     "sequence_records": 1, "emit_bytes": 1,
                     "rowbase_gather": 1}),
    ("big_hc9", 9, {"bucket_prev": 0, "hc_tables": 0, "match_lengths": 8,
                    "sequence_records": 1, "emit_bytes": 1,
                    "rowbase_gather": 1}),
)


def big_phases(torch, card, kernel_row, rows, data, fast_total):
    """Steps 20-24 of the module docstring: the decode kernels on a
    fragment wave and the widened encode kernels on big-block segment
    rows and 96 KB P-mode rows against their plain versions, then
    big-block decode, unknown-length decode, fast and fast-HC encode,
    the edge blocks and dictionary big blocks through the engine.
    Returns the launches by path and kernel."""
    import numpy as np

    from lz4net_tpu_torch import codec
    from lz4net_tpu_torch.models import cuda as cuda_engine
    from lz4net_tpu_torch.models import reference
    from lz4net_tpu_torch.ops import bigblock
    from lz4net_tpu_torch.ops import decode_vector as dv
    from lz4net_tpu_torch.ops import encode_vector as ev
    from lz4net_tpu_torch.ops import (emit_kernel, fused_gather, hash_kernel,
                                      mlen_kernel, parse_kernel,
                                      records_kernel, resolve_kernel,
                                      seq_kernel)
    from lz4net_tpu_torch.utils import corpus

    # ---- workload: the 16 MB in 16 blocks of 1 MB ----------------------
    big = corpus.split_blocks(data, BIG_BLOCK)
    lens = [len(b) for b in big]
    n_data = sum(lens)
    t = time.perf_counter()
    packed = cuda_engine.compress_blocks(big, device="cuda")
    strict_ms = (time.perf_counter() - t) * 1e3
    strict_total = sum(map(len, packed))
    t = time.perf_counter()
    scans = [bigblock.scan(p) for p in packed]
    scan_ms = (time.perf_counter() - t) * 1e3
    if any(s is None or s[2] != n for s, n in zip(scans, lens)):
        fail("the header walk does not give each 1 MB block's length")
    frags = [bigblock.split_fragments(p, n, s)
             for p, n, s in zip(packed, lens, scans)]
    n_frag, waves = sum(map(len, frags)), max(map(len, frags))
    print(f"big-block workload: {len(big)} blocks of {BIG_BLOCK} bytes, "
          f"compressed on the card by the strict encoder (compress_blocks) "
          f"to {strict_total} bytes in {strict_ms:.1f} ms; header walk "
          f"(bigblock.scan) {scan_ms:.2f} ms on the host for the 16 blocks, "
          f"{scan_ms / len(big):.2f} ms a block; {n_frag} fragments in "
          f"{waves} waves, {sum(len(s[3]) for s in scans)} giant sequences")

    # ---- per-kernel phase: the decode kernels on fragment wave 2 --------
    # each row behind a full 64 KB window of its block's output; D for a
    # fragment of 96 KB, the most a wave can hold: Dt = 172,032
    i4 = 4
    w = 2
    fr = [f[w][0] for f in frags]
    o0s = [f[w][1] for f in frags]
    spans = [f[w][2] for f in frags]
    windows = [b[max(0, o - P64):o] for b, o in zip(big, o0s)]
    comp_np, cl_np, ol_np, C, _ = dv.pack_blocks(fr, spans)
    comp, comp_len, out_len = dv.batch_from_numpy(comp_np, cl_np, ol_np,
                                                  "cuda")
    pre_np, pl_np, P = dv.pack_windows(windows, len(fr))
    pre = torch.from_numpy(pre_np).to("cuda").to(torch.int32)
    pre_len = torch.from_numpy(pl_np).to("cuda")
    Bw, Dt = len(fr), P + 13 * dv.CH
    n_comp = int(comp_len.sum())
    tag = f"fragment wave {w}, B={Bw}, C={C}"
    mark, ll, ml, _ = kernel_row(
        "parse_tokens", "", "", parse_kernel,
        lambda: parse_kernel.parse_tokens(comp, comp_len, C),
        lambda: parse_kernel.parse_tokens_reference(comp, comp_len, C),
        n_bytes=n_comp * i4 + Bw * C * i4 * 3 + Bw * i4 + Bw,
        n_ops=Bw * C * 30, variant=tag)
    t0m, cidx, stats, _ends = kernel_row(
        "records_to_state", "", "", records_kernel,
        with_ends(lambda e: records_kernel.records_to_state(
            comp, mark, ll, ml, comp_len, out_len, pre_len, C, Dt, P, e),
            Bw),
        with_ends(lambda e: records_kernel.records_to_state_reference(
            comp, mark, ll, ml, comp_len, out_len, pre_len, C, Dt, P, e),
            Bw),
        n_bytes=Bw * C * i4 + 3 * n_comp * i4 + 3 * Bw * i4
        + 2 * Bw * Dt * i4 + Bw * 8 * i4,
        n_ops=Bw * C * 30 + Bw * Dt * 20,
        variant=f"{tag}, P={P}, Dt={Dt}")
    if not bool((stats[:, 2] == 1).all()) \
            or stats[:, 4].tolist() != spans:
        fail("a fragment of wave 2 is not certified at its span")
    lit = torch.cummax(torch.where(cidx >= 0, cidx.clamp(0, C - 1), 0),
                       dim=1).values
    vals, _ = fused_gather.rowbase_gather(comp, lit)
    T0 = torch.where(cidx >= 0, dv.VFLAG | (vals & 0xFF), t0m)
    T0[:, :P] = dv.VFLAG | pre
    res, _ok = kernel_row(
        "resolve_wavefront", "", "", resolve_kernel,
        lambda: resolve_kernel.resolve_wavefront(T0, P // dv.CH),
        lambda: resolve_kernel.resolve_wavefront_reference(T0, P // dv.CH),
        n_bytes=Bw * Dt * i4 * 2 + Bw, n_ops=Bw * Dt * 6,
        variant=f"{tag}, start_chunk={P // dv.CH}, Dt={Dt}")
    got = res[:, P:].to(torch.uint8).cpu().numpy()
    if any(got[j, :n].tobytes() != b[o:o + n]
           for j, (b, o, n) in enumerate(zip(big, o0s, spans))):
        fail("fragment wave 2 does not resolve to its blocks' bytes")
    del comp, mark, ll, ml, t0m, cidx, lit, vals, T0, res

    # ---- per-kernel phase: the widened encode kernels -------------------
    # the 256 segment rows of the 16 blocks (D = 139,264), then 64
    # records of 96 KB behind the 64 KB dictionary (D = 172,032)
    dictionary = b"".join(corpus.split_blocks(data, RECORD)[0::256])
    recs96 = corpus.split_blocks(data[:64 * 96 * 1024], 96 * 1024)
    xn, sl, spl, P, D, O, S_cap = ev.segment_rows(big, ev.big_segments(big))
    x96, dl96, pl96, P96, D96, O96, S96 = ev.window_rows(recs96,
                                                         dictionary)
    if (P, D, P96, D96) != (P64, 139264, P64, 172032):
        fail(f"the wide rows' shapes are P={P}, D={D}, P={P96}, D={D96}")
    seg_x = None
    for xn_, dln, pln, D_, O_, S_, what in (
            (xn, sl, spl, D, O, S_cap, "segment rows"),
            (x96, dl96, pl96, D96, O96, S96, "96 KB P-mode rows")):
        x = torch.from_numpy(xn_).to("cuda").to(torch.int32)
        dl = torch.from_numpy(dln).to("cuda")
        pl = torch.from_numpy(pln).to("cuda")
        B, SR = x.shape[0], seq_kernel.slot_width(S_)
        tag = f"{what}, B={B}, D={D_}"
        u32 = ev._u32(x)
        us4 = ev._shift_left(u32, 4)
        h4, h8 = hash_kernel.hash_bucket(u32), hash_kernel.hash_bucket8(
            u32, us4)
        prev = kernel_row(
            "bucket_prev", "", "", hash_kernel,
            lambda: hash_kernel.bucket_prev(u32, us4, h4, h8, D_),
            lambda: hash_kernel.bucket_prev_reference(u32, us4, h4, h8, D_),
            n_bytes=5 * B * D_ * i4, n_ops=B * D_ * 30, plain_reps=1,
            variant=tag, split=True)
        if seg_x is None:
            # the suffix tiers' run tables (HC levels 1-7 on big blocks)
            run_fwd, is_rs = ev._byte_runs(x)
            _, hs, sticky, nrows = hash_kernel.hc_streams(
                x, u32, us4, is_rs, run_fwd, "runs")
            hargs = (u32, hs, sticky, nrows, D_)
            kernel_row(
                "hc_tables", "", "", hash_kernel,
                lambda: hash_kernel.hc_tables(*hargs),
                lambda: hash_kernel.hc_tables_reference(*hargs),
                n_bytes=(1 + 2 * len(hs)) * B * D_ * i4,
                n_ops=B * D_ * len(hs) * 10, plain_reps=1,
                counter="hc_launches", variant=tag + ", 3 run tables")
            del run_fwd, is_rs, hs, hargs
            seg_x = (x, dl, pl, D_, O_, S_)
        off = torch.arange(D_, dtype=torch.int32, device="cuda") - prev
        far = (prev >= 0) & (off <= 65535) & (off > 4)
        i = torch.arange(D_, dtype=torch.int32, device="cuda")
        for K, sub, rcap, rounds in (
                (ev.TOP_OFFSETS, ev.SUB_STEP, ev.RCAP, ev.CU_ROUNDS),
                (ev.HC_TOP_OFFSETS, ev.HC_SUB_STEP, ev.hc_rcap(9, D_),
                 ev.HC_CU_ROUNDS)):
            dks = ev._top_offsets_select(off, far, K, sub)
            margs = (x, u32, prev, torch.zeros_like(prev), dks, P + dl, dl,
                     D_, rcap)
            matched, off_all, mlen_all = kernel_row(
                "match_lengths", "", "", mlen_kernel,
                lambda: mlen_kernel.match_lengths_fused(*margs),
                lambda: mlen_kernel.match_lengths_reference(*margs),
                n_bytes=6 * B * D_ * i4 + B * K * i4 + 2 * B * i4,
                n_ops=B * D_ * 40, plain_reps=1,
                variant=f"{tag}, K={K}, rcap={rcap}")
            matched = matched * ((i >= P) & (off_all <= i - (P - pl[:, None])))
            sargs = (u32, matched, off_all, mlen_all, P + dl, pl, D_, S_, P,
                     rounds)
            recs = kernel_row(
                "sequence_records", "", "", seq_kernel,
                lambda: seq_kernel.sequence_records(*sargs),
                lambda: seq_kernel.sequence_records_reference(*sargs),
                n_bytes=lambda got: B * D_ * i4 + int(got[5][:, 0].sum())
                * i4 * (2 + 2 * rounds) + 5 * B * SR * i4 + B * 8 * i4
                + 2 * B * i4,
                n_ops=B * D_ * 20, plain_reps=1,
                variant=f"{tag}, cu_rounds={rounds}, on K={K}")
            if not bool((recs[0][:, 1:] >= recs[0][:, :-1]).all()):
                fail(f"sequence_records ({tag}): s0 decreases")
            eargs = (*recs[:5], recs[5][:, 2].contiguous(), O_)
            kernel_row(
                "emit_bytes", "", "", emit_kernel,
                lambda: emit_kernel.emit_bytes(*eargs),
                lambda: emit_kernel.emit_bytes_reference(*eargs),
                n_bytes=5 * int((recs[5][:, 1] + 1).sum()) * i4
                + 2 * B * O_ * i4 + B * i4,
                n_ops=B * O_ * 20, plain_reps=1,
                variant=f"{tag}, O={O_}, on K={K}")
        del u32, us4, h4, h8, prev, off, far, matched, off_all, mlen_all
        del recs
    x96 = xn = None

    # ---- slice phase: big-block decode ---------------------------------
    dec = cuda_engine.decoder("cuda")
    by_path = {}

    def decode_call():
        return codec.decode_batch(packed, lens, device="cuda")

    dec.host_decodes = 0
    got, first_ms, launches = first_call(torch, rows, decode_call,
                                         DECODE_KERNELS)
    by_path["big_decode"] = launches
    if got != big:
        fail("big-block decode: blocks differ from their source")
    if dec.host_decodes != 0:
        fail(f"big-block decode: {dec.host_decodes} fragments were "
             f"re-decoded on the host")
    if any(n != waves for n in launches.values()):
        fail(f"big-block decode: launches {launches}, one a wave ({waves}) "
             f"expected")
    walls = host_walls(torch, decode_call, 3)
    wall = statistics.median(walls)
    print(f"big_decode slice: {len(big)} blocks of 1 MB byte-exact through "
          f"codec.decode_batch, host_decodes=0, {n_frag} fragments in "
          f"{waves} waves, launches {launches}; first call {first_ms:.1f} "
          f"ms, later " + " ".join(f"{w_:.1f}" for w_ in walls)
          + f"; median {wall:.1f} ms, {n_data / wall / 1e6:.4f} GB/s decoded "
          f"(host clock, end to end), of which the header walk "
          f"{scan_ms:.1f} ms; {card}")
    REPORT["big_decode"] = where_the_time_goes(
        torch, decode_call, "big_decode", n_data, "decoded", card)
    REPORT["big_walk_ms"] = scan_ms / len(big)

    # unknown length: caps of 1 MB and 2 MB exact, a short cap raises
    dec.host_decodes = 0
    for cap in (BIG_BLOCK, 2 * BIG_BLOCK):
        if dec.decode_batch_unknown(packed, [cap] * len(packed)) != big:
            fail(f"big-block unknown-length decode with a {cap}-byte cap: "
                 f"blocks differ from their source")
    if dec.host_decodes != 0:
        fail(f"big-block unknown-length decode: {dec.host_decodes} blocks "
             f"were re-decoded on the host")
    try:
        dec.decode_batch_unknown([packed[0]], [lens[0] - 1])
    except reference.CorruptedBlockError:
        pass
    else:
        fail("big-block unknown-length decode: a cap one byte short did "
             "not raise")
    # blocks the header walk takes and the hardened decoder refuses
    for name, bad in corpus.big_bad_blocks(packed[0]):
        try:
            reference.decompress_block_unknown(bad, 2 * BIG_BLOCK)
        except reference.CorruptedBlockError as e:
            want = str(e)
        else:
            fail(f"big-block unknown-length decode: the host decoder took "
                 f"{name}")
        try:
            dec.decode_batch_unknown([bad], [2 * BIG_BLOCK])
        except reference.CorruptedBlockError as e:
            if str(e) != want:
                fail(f"big-block unknown-length decode: {name} raised "
                     f"{e!r}, the host decoder {want!r}")
        else:
            fail(f"big-block unknown-length decode: {name} did not raise")
    # the known-length block-end rules on the header walk: the first
    # block with its final run cut to 3 literals
    short, n_short = corpus.short_final_run(packed[0])
    want = _outcome(reference, lambda: reference.decompress_block(
        short, n_short))
    before = dec.host_decodes
    got = _outcome(reference, lambda: codec.decode_batch(
        [short], [n_short], device="cuda"))
    if not isinstance(want, Exception) or not _same(got, want) \
            or dec.host_decodes != before + 1:
        fail(f"big-block decode: the first block cut to 3 final literals "
             f"gave {got!r}, the host decoder {want!r}")
    print(f"big_decode: the first block cut to 3 final literals raises "
          f"{want!r} through codec.decode_batch, as the host decoder")
    walls = host_walls(torch, lambda: dec.decode_batch_unknown(
        packed, [2 * BIG_BLOCK] * len(packed)), 3)
    REPORT["big_unknown"] = where_the_time_goes(
        torch, lambda: dec.decode_batch_unknown(
            packed, [2 * BIG_BLOCK] * len(packed)),
        "big_unknown", n_data, "decoded", card)
    print(f"big_unknown slice: caps of 1 MB and 2 MB byte-exact, "
          f"host_decodes=0, a cap one byte short and the first block's "
          f"big_bad_blocks raise the host decoder's CorruptedBlockError; "
          f"2 MB cap "
          + " ".join(f"{w_:.1f}" for w_ in walls)
          + f" ms (host clock); {card}")

    # ---- slice phases: big-block fast and fast-HC encode ---------------
    enc = cuda_engine.encoder("cuda")
    x, dl, pl, D, O, S_cap = seg_x
    for path, level, want in BIG_PATHS:
        def call():
            if level == 0:
                return cuda_engine.compress_blocks_fast(big, device="cuda")
            return cuda_engine.compress_blocks_hc_fast(big, level=level,
                                                       device="cuda")

        enc.host_encodes = 0
        torch.cuda.reset_peak_memory_stats()
        got, first_ms, launches = first_call(torch, rows, call, want)
        peak = torch.cuda.max_memory_allocated() / 2**30
        by_path[path] = launches
        if enc.host_encodes != 0:
            fail(f"{path}: {enc.host_encodes} blocks were encoded on the "
                 f"host")
        if launches != want:
            fail(f"{path}: launches {launches}, the path makes {want}")
        if got[0] != ev.VectorEncoder("cpu").encode_batch(
                big[:1], hc_level=level)[0]:
            fail(f"{path}: the first payload differs from the CPU path's")
        if [reference.decompress_block(p, n) for p, n in zip(got[:2],
                                                             lens)] \
                != big[:2]:
            fail(f"{path}: the first 2 blocks do not decode on the host")
        dec.host_decodes = 0
        if codec.decode_batch(got, lens, device="cuda") != big \
                or dec.host_decodes:
            fail(f"{path}: blocks do not decode to their source on the "
                 f"card without the host")
        total = sum(map(len, got))
        walls = host_walls(torch, call, 3)
        wall = statistics.median(walls)
        dev_ms = time_ms(torch, lambda: ev.encode_batch_vectorized(
            x, dl, D, O, S_cap, ev.hc_rcap(level, D), level, None, P64, pl),
            inner=3)
        print(f"{path} slice (level {level}): {len(big)} blocks of 1 MB, "
              f"256 segment rows, host_encodes=0, launches {launches}, the "
              f"first payload equals the CPU path's, every block decodes on "
              f"the card (first 2 on the host too), peak device memory "
              f"{peak:.2f} GiB; {total} compressed bytes "
              f"({total / n_data:.4f} of input) against {fast_total} "
              f"({fast_total / n_data:.4f}) from fast mode in 64 KB blocks "
              f"and {strict_total} ({strict_total / n_data:.4f}) from the "
              f"reference compressor in 1 MB blocks; first call "
              f"{first_ms:.1f} ms, later "
              + " ".join(f"{w_:.1f}" for w_ in walls)
              + f"; median {wall:.1f} ms, {n_data / wall / 1e6:.4f} GB/s of "
              f"input (host clock, end to end); device pass {dev_ms:.3f} "
              f"ms, {n_data / dev_ms / 1e6:.3f} GB/s; {card}")
        if level == 0:
            where_the_time_goes(torch, call, "big_fast", n_data, "of input",
                                card)
    del x, dl, pl, seg_x

    # ---- slice phase: the edge blocks both ways -------------------------
    edge = corpus.big_edge_blocks(SEED)
    datas = [d for _, d, _ in edge]
    elens = [len(d) for d in datas]
    dec.host_decodes = enc.host_encodes = 0
    if dec.decode_batch([b for *_, b in edge], elens) != datas \
            or dec.decode_batch_unknown([b for *_, b in edge],
                                        [BIG_BLOCK] * len(edge)) != datas:
        fail("big_edge_blocks: a hand-made block does not decode to its "
             "bytes")
    for level in (0, 9):
        eg = enc.encode_batch(datas, hc_level=level)
        if dec.decode_batch(eg, elens) != datas:
            fail(f"big_edge_blocks: level {level} payloads do not decode")
    if dec.host_decodes or enc.host_encodes:
        fail("big_edge_blocks: host decodes or encodes")
    print(f"big_edge slice: {', '.join(n for n, *_ in edge)} decode "
          f"(known and unknown length) and encode (fast and HC level 9) "
          f"both ways, no host decode or encode")

    # ---- slice phase: big blocks and 96 KB records with a dictionary ----
    for what, batch, n_cpu in (("4 blocks of 1 MB", big[:4], 1),
                               ("64 records of 96 KB", recs96, 2)):
        blens = [len(b) for b in batch]
        for level in (0, 9):
            dec.host_decodes = enc.host_encodes = 0
            t = time.perf_counter()
            got = cuda_engine.compress_blocks_fast_dict(
                batch, dictionary, level=level, device="cuda")
            ms = (time.perf_counter() - t) * 1e3
            if enc.host_encodes:
                fail(f"dictionary {what}, level {level}: host encodes")
            if level == 0 and got[:n_cpu] != ev.VectorEncoder(
                    "cpu").encode_batch(batch[:n_cpu],
                                        dictionary=dictionary):
                fail(f"dictionary {what}: the first payloads differ from "
                     f"the CPU path's")
            if reference.decompress_block_dict(got[0], dictionary,
                                               blens[0]) != batch[0] \
                    or cuda_engine.decompress_blocks_dict(
                        got, blens, dictionary, "cuda") != batch \
                    or dec.host_decodes:
                fail(f"dictionary {what}, level {level}: payloads do not "
                     f"decode to their source")
            print(f"big_dict slice: {what} behind the {len(dictionary)}-"
                  f"byte dictionary, level {level}: host_encodes=0, "
                  + ("the first payloads equal the CPU path's, "
                     if level == 0 else "")
                  + f"decoded on the card with host_decodes=0 and the "
                  f"first on the host; {sum(map(len, got))} bytes "
                  f"({sum(map(len, got)) / sum(blens):.4f}); first call "
                  f"{ms:.1f} ms (host clock); {card}")
    return by_path


def _outcome(reference, call):
    """``call()``'s result, or the CorruptedBlockError it raised."""
    try:
        return call()
    except reference.CorruptedBlockError as exc:
        return exc


def _same(a, b) -> bool:
    """Equal bytes, or errors with equal messages."""
    if isinstance(a, Exception) or isinstance(b, Exception):
        return type(a) is type(b) and str(a) == str(b)
    return a == b


def block_end_gates(card):
    """Step 18's gates of the block-end rules (C3) on the card.  Each of
    ``corpus.big_bad_blocks`` of a 30,000-byte block must raise the host
    decoder's CorruptedBlockError through ``codec.decode_batch`` (at the
    length its header walk gives), ``decode_batch_unknown`` (caps of
    96 KB and 2 MB) and ``decompress_blocks_dict``, each through one host
    decode; every row of ``corpus.block_end_rows`` must give the
    reference decoders' bytes or errors on each path (caps of n, n + 1,
    96 KB and 2 MB), and the rows they all take must decode in one batch
    a path with no host decode."""
    from lz4net_tpu_torch import codec
    from lz4net_tpu_torch.models import cuda as cuda_engine
    from lz4net_tpu_torch.models import reference
    from lz4net_tpu_torch.ops import bigblock
    from lz4net_tpu_torch.utils import corpus

    dec = cuda_engine.decoder("cuda")
    window = corpus.silesia_like(5000, seed=21)
    small = reference.compress_block(corpus.silesia_like(30000, seed=3))
    for name, bad in corpus.big_bad_blocks(small):
        n = bigblock.scan(bad)[2]
        for what, call, host in (
                ("codec.decode_batch",
                 lambda: codec.decode_batch([bad], [n], device="cuda"),
                 lambda: reference.decompress_block(bad, n)),
                ("decode_batch_unknown (96 KB cap)",
                 lambda: dec.decode_batch_unknown([bad], [96 * 1024]),
                 lambda: reference.decompress_block_unknown(bad, 96 * 1024)),
                ("decode_batch_unknown (2 MB cap)",
                 lambda: dec.decode_batch_unknown([bad], [2 << 20]),
                 lambda: reference.decompress_block_unknown(bad, 2 << 20)),
                ("decompress_blocks_dict",
                 lambda: cuda_engine.decompress_blocks_dict(
                     [bad], [n], window, "cuda"),
                 lambda: reference.decompress_block_dict(bad, window, n))):
            want = _outcome(reference, host)
            before = dec.host_decodes
            got = _outcome(reference, call)
            if not isinstance(want, Exception) or not _same(got, want) \
                    or dec.host_decodes != before + 1:
                fail(f"block-end rules: {name} of a 30,000-byte block "
                     f"through {what} gave {got!r}, the host decoder "
                     f"{want!r}")
    rows = corpus.block_end_rows()
    taken = []
    for name, blk, n in rows:
        cases = [(lambda: dec.decode_batch([blk], [n])[0],
                  lambda: reference.decompress_block(blk, n)),
                 (lambda: dec.decode_batch([blk], [n], dictionary=window)[0],
                  lambda: reference.decompress_block_dict(blk, window, n))]
        cases += [(lambda c=c: dec.decode_batch_unknown([blk], [c])[0],
                   lambda c=c: reference.decompress_block_unknown(blk, c))
                  for c in (n, n + 1, 96 * 1024, 2 << 20)]
        outs = [(_outcome(reference, call), _outcome(reference, host))
                for call, host in cases]
        if not all(_same(g, w) for g, w in outs):
            fail(f"block-end rules: {name} gives {outs}")
        if not any(isinstance(w, Exception) for _, w in outs):
            taken.append((blk, n))
    blks, lens = [b for b, _ in taken], [n for _, n in taken]
    dec.host_decodes = 0
    want = [reference.decompress_block(b, n) for b, n in taken]
    if dec.decode_batch(blks, lens) != want \
            or dec.decode_batch(blks, lens, dictionary=window) != want \
            or dec.decode_batch_unknown(blks, lens) != want \
            or dec.decode_batch_unknown(blks, [2 << 20] * len(blks)) != want:
        fail("block-end rules: the rows every decoder takes differ")
    if dec.host_decodes != 0:
        fail(f"block-end rules: {dec.host_decodes} of the well-formed edge "
             f"rows were decoded on the host")
    print(f"block-end rules: the 3 big_bad_blocks of a 30,000-byte block "
          f"raise the host decoder's error through codec.decode_batch, "
          f"decode_batch_unknown (96 KB and 2 MB caps) and "
          f"decompress_blocks_dict; {len(rows)} block_end_rows give the "
          f"reference decoders' bytes or errors on each path, the "
          f"{len(taken)} they all take decode on the card with "
          f"host_decodes=0; {card}")


def _varint(v: int) -> bytes:
    out = bytearray()
    while True:
        b, v = v & 0x7F, v >> 7
        out.append(b | (0x80 if v else 0))
        if not v:
            return bytes(out)


def reference_frames(chunks, payloads, hc: bool) -> bytes:
    """The LZ4Stream frames of ``chunks`` (lz4net's chunk records: varint
    flags, original length, payload length, payload; a chunk whose
    payload does not shrink it stored raw) built from ``payloads``, the
    reference compressor's bytes for each chunk."""
    out = bytearray()
    for raw, p in zip(chunks, payloads):
        packed = bool(p) and len(p) < len(raw)
        out += _varint((1 if packed else 0) | (2 if hc else 0))
        out += _varint(len(raw))
        out += _varint(len(p)) + p if packed else raw
    return bytes(out)


def stream_phases(torch, card, rows, data, blocks, packed):
    """Step 25: the 16 MB through LZ4Stream on the card at 1 MB and 64 KB
    chunks, in HC at 64 KB, and an interactive read over a socket pair.
    Returns the launches by path."""
    import io
    import socket
    import threading

    from lz4net_tpu_torch import codec
    from lz4net_tpu_torch import stream as lz
    from lz4net_tpu_torch.models import cuda as cuda_engine
    from lz4net_tpu_torch.models import native, reference
    from lz4net_tpu_torch.ops import bigblock
    from lz4net_tpu_torch.ops.decode_vector import VectorDecoder
    from lz4net_tpu_torch.utils import corpus

    if codec.codec_name() != "cuda/cuda/cudaHC":
        fail(f"codec_name() is {codec.codec_name()!r}, not "
             f"'cuda/cuda/cudaHC', with an empty selection cache")
    dec = cuda_engine.decoder("cuda")
    n_data = len(data)
    big = corpus.split_blocks(data, BIG_BLOCK)
    t = time.perf_counter()
    ref_big = [reference.compress_block(b, len(b)) for b in big]
    print(f"stream workload: the reference compressor's payloads of the 16 "
          f"chunks of 1 MB in {time.perf_counter() - t:.1f} s on the host")
    frames = {BIG_BLOCK: (big, reference_frames(big, ref_big, False)),
              BLOCK: (blocks, reference_frames(blocks, packed, False))}
    calls = []
    real = codec.decode_batch

    def counting(blocks_, lens_, device="cuda"):
        calls.append(len(blocks_))
        return real(blocks_, lens_, device=device)

    def read_by_mb(framed):
        s = lz.LZ4Stream(io.BytesIO(framed), lz.LZ4StreamMode.DECOMPRESS)
        parts = []
        while part := s.read(1 << 20):
            parts.append(part)
        return b"".join(parts)

    by_path = {}
    codec.decode_batch = counting
    try:
        for chunk, (chunks, want) in frames.items():
            tag = "1mb" if chunk == BIG_BLOCK else "64kb"
            k = len(chunks)
            framed, w_ms, launches = first_call(
                torch, rows, lambda: lz.compress_stream(data,
                                                        block_size=chunk),
                ["encode_sequencer"])
            by_path[f"stream_write_{tag}"] = launches
            if framed != want:
                fail(f"stream at {chunk}-byte chunks: the frames differ "
                     f"from those of reference.compress_block")
            batches = -(-k // max(1, lz.BATCH_BYTES // chunk))
            if launches["encode_sequencer"] != batches:
                fail(f"stream write at {chunk}-byte chunks: launches "
                     f"{launches}, one encode_sequencer a batch of chunks "
                     f"({batches}) expected")
            # what the reads imply: a read-all decodes every compressed
            # chunk in one decode_batch call, 1 MB reads a call for each
            # 1 MB of chunks (`want` stops the read-ahead); a call makes a
            # device pass, a chunk over 96 KB a pass a fragment wave
            pays = ref_big if chunk == BIG_BLOCK else packed
            waves = [0 if not p or len(p) >= len(c) else
                     len(bigblock.split_fragments(p, len(c)))
                     if len(c) > VectorDecoder.MAX_BLOCK else 1
                     for c, p in zip(chunks, pays)]
            per = (1 << 20) // chunk
            groups = [waves[j:j + per] for j in range(0, k, per)]
            for how, call, want_calls, want_launch in (
                    ("read_all", lambda: lz.decompress_stream(framed),
                     [sum(map(bool, waves))], max(waves)),
                    ("read_1mb", lambda: read_by_mb(framed),
                     [sum(map(bool, g)) for g in groups if any(g)],
                     sum(max(g) for g in groups))):
                calls.clear()
                dec.host_decodes = 0
                got, r_ms, launches = first_call(torch, rows, call,
                                                 DECODE_KERNELS)
                by_path[f"stream_{how}_{tag}"] = launches
                if got != data:
                    fail(f"stream {how} at {chunk}-byte chunks: the bytes "
                         f"differ from the source")
                if dec.host_decodes != 0:
                    fail(f"stream {how} at {chunk}-byte chunks: "
                         f"{dec.host_decodes} chunks decoded on the host")
                if calls != want_calls:
                    fail(f"stream {how} at {chunk}-byte chunks: "
                         f"decode_batch calls of {calls} chunks, "
                         f"{want_calls} expected")
                if any(v != want_launch for v in launches.values()):
                    fail(f"stream {how} at {chunk}-byte chunks: launches "
                         f"{launches}, {want_launch} each expected")
                print(f"stream {how} at {chunk}-byte chunks: byte-exact, "
                      f"host_decodes=0, {len(calls)} decode_batch calls, "
                      f"launches {launches}; first call {r_ms:.1f} ms; "
                      f"{card}")
            w_walls = host_walls(torch, lambda: lz.compress_stream(
                data, block_size=chunk), 2)
            r_walls = host_walls(torch, lambda: lz.decompress_stream(
                framed), 3)
            w, r = statistics.median(w_walls), statistics.median(r_walls)
            print(f"stream_{tag} cell: {n_data} bytes in {k} chunks of "
                  f"{chunk} -> {len(framed)} bytes, equal to the reference "
                  f"compressor's frames; write (compress_stream, strict on "
                  f"the card) first {w_ms:.1f} ms, then "
                  + " ".join(f"{x:.1f}" for x in w_walls)
                  + f" ms, {n_data / w / 1e3:.2f} MB/s; read-all "
                  f"(decompress_stream) " + " ".join(f"{x:.1f}"
                                                     for x in r_walls)
                  + f" ms, {n_data / r / 1e3:.2f} MB/s (host clock); {card}")
            REPORT[f"stream_read_all_{tag}"] = where_the_time_goes(
                torch, lambda: lz.decompress_stream(framed),
                f"stream_read_all_{tag}", n_data, "decoded", card)
    finally:
        codec.decode_batch = real

    # ---- HC: the 16 MB at 64 KB chunks (strict HC: the native host
    # engine); the first 1 MB also against the Python HC parse's frames
    hc_chunks = blocks
    t = time.perf_counter()
    hc_pay = [native.compress_block_hc(c, len(c)) for c in hc_chunks]
    nat_ms = (time.perf_counter() - t) * 1e3
    want = reference_frames(hc_chunks, hc_pay, True)
    head = corpus.split_blocks(data[:BIG_BLOCK], BLOCK)
    t = time.perf_counter()
    head_want = reference_frames(head, [reference.compress_block_hc(
        c, len(c)) for c in head], True)
    ref_ms = (time.perf_counter() - t) * 1e3
    if lz.compress_stream(data[:BIG_BLOCK], high_compression=True,
                          block_size=BLOCK) != head_want:
        fail("HC stream: the first 1 MB's frames differ from those of "
             "reference.compress_block_hc")
    w_walls = []
    for _ in range(2):
        t = time.perf_counter()
        framed = lz.compress_stream(data, high_compression=True,
                                    block_size=BLOCK)
        w_walls.append((time.perf_counter() - t) * 1e3)
    if framed != want:
        fail("HC stream: the frames differ from those of "
             "native.compress_block_hc")
    dec.host_decodes = 0
    t = time.perf_counter()
    if lz.decompress_stream(framed) != data or dec.host_decodes != 0:
        fail("HC stream: the read differs from the source or decoded on "
             "the host")
    r_ms = (time.perf_counter() - t) * 1e3
    w_ms = statistics.median(w_walls)
    REPORT["stream_hc_MBps"] = n_data / w_ms / 1e3
    print(f"stream_hc cell: {n_data} bytes in {len(hc_chunks)} chunks of "
          f"64 KB -> {len(framed)} bytes, equal to the frames of "
          f"native.compress_block_hc (the first 1 MB to those of the Python "
          f"reference.compress_block_hc, {ref_ms:.0f} ms on the host); "
          f"write " + " ".join(f"{w:.0f}" for w in w_walls)
          + f" ms ({n_data / w_ms / 1e3:.2f} MB/s; the native HC parse "
          f"alone {nat_ms:.0f} ms), read-all {r_ms:.1f} ms, "
          f"host_decodes=0 (host clock); {card}")

    # ---- an interactive read over a socket pair ------------------------
    parts = [data[j * BLOCK:(j + 1) * BLOCK] for j in range(4)]
    stall = 0.2
    server, client = socket.socketpair()

    def serve():
        with server, server.makefile("wb") as sink:
            s = lz.LZ4Stream(sink, lz.LZ4StreamMode.COMPRESS,
                             block_size=BLOCK)
            for part in parts:
                s.write(part)
                s.flush()                 # one wire chunk a part
                sink.flush()
                time.sleep(stall)
            s.close()

    writer = threading.Thread(target=serve, daemon=True)
    got, arrival = [], []
    t0 = time.monotonic()
    writer.start()
    with client, client.makefile("rb") as source:
        s = lz.LZ4Stream(source, lz.LZ4StreamMode.DECOMPRESS,
                         lz.LZ4StreamFlags.INTERACTIVE_READ)
        while chunk := s.read(10 << 20):
            got.append(chunk)
            arrival.append(time.monotonic() - t0)
    writer.join(timeout=30)
    if writer.is_alive() or b"".join(got) != b"".join(parts):
        fail("interactive read: the bytes differ from what was written")
    if [len(g) for g in got] != [BLOCK] * 4 or arrival[0] >= 3 * stall:
        fail(f"interactive read: reads of {[len(g) for g in got]} bytes at "
             f"{arrival} s; one a chunk, the first before the writer's "
             f"stalls end, expected")
    print(f"interactive read over a socket pair: 4 chunks of 64 KB "
          f"written with {stall} s stalls arrive one a read at "
          + " ".join(f"{a:.3f}" for a in arrival) + f" s; {card}")
    return by_path


def tools_phases(torch, card, data, name):
    """Step 26: the command line and the certify tool as subprocesses on
    the card (each stopped by its time limit at the latest)."""
    import os
    import tempfile

    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=here + os.pathsep
               + os.environ.get("PYTHONPATH", ""))

    def tool(*args, timeout=300):
        t = time.perf_counter()
        r = subprocess.run([sys.executable, "-m", *args],
                           capture_output=True, text=True, timeout=timeout,
                           env=env, cwd=here)
        if r.returncode != 0:
            fail(f"python -m {' '.join(args)}: rc {r.returncode}: "
                 f"{r.stdout[-1500:]} {r.stderr[-1500:]}")
        return r, time.perf_counter() - t

    with tempfile.TemporaryDirectory() as tmp:
        src, packed, back, one = (os.path.join(tmp, f) for f in (
            "corpus.bin", "corpus.lz4s", "back.bin", "one.bin"))
        with open(src, "wb") as fh:
            fh.write(data)
        _, c_s = tool("lz4net_tpu_torch", "compress", src, packed)
        _, d_s = tool("lz4net_tpu_torch", "decompress", packed, back)
        with open(back, "rb") as fh:
            if fh.read() != data:
                fail("CLI: decompress does not give the compressed file")
        print(f"CLI compress and decompress of {len(data)} bytes (1 MB "
              f"chunks): byte-exact, {c_s:.1f} s and {d_s:.1f} s of "
              f"subprocess each, start-up included; {card}")
        with open(one, "wb") as fh:
            fh.write(data[:BIG_BLOCK])
        r, v_s = tool("lz4net_tpu_torch", "verify", one)
        if r.stdout.count("round-trip OK") != 2 \
                or "codec: cuda/cuda/cudaHC" not in r.stdout:
            fail(f"CLI verify: {r.stdout}")
        r, i_s = tool("lz4net_tpu_torch", "info")
        if name not in r.stdout:
            fail(f"CLI info does not name the card: {r.stdout}")
        out = os.path.join(tmp, "results.json")
        r, k_s = tool("lz4net_tpu_torch", "continuous", "--mb", "16",
                      "--out", out, timeout=600)
        run = json.loads(r.stdout)
        if set(run["engines"]) != {"cuda", "native", "python-reference"} \
                or not all(e.get("verified") for e in run["engines"].values()):
            fail(f"CLI continuous: {run}")
        print(f"CLI verify (1 MB, strict and HC streams) {v_s:.1f} s, info "
              f"names the card ({i_s:.1f} s), continuous --mb 16 "
              f"{k_s:.1f} s: "
              + "; ".join(f"{e}: encode {r_['encode_MBps']} MB/s, decode "
                          f"{r_['decode_MBps']} MB/s, HC "
                          f"{r_['encode_hc_MBps']} MB/s on "
                          f"{r_['corpus_mb']} MB"
                          for e, r_ in run["engines"].items())
              + f" (host clock, one block a call); {card}")
        r, t_s = tool("lz4net_tpu_torch.tools.certify")
        if "CERTIFIED" not in r.stdout.splitlines()[-1]:
            fail(f"certify: {r.stdout}")
        print(f"certify: {r.stdout.strip().splitlines()[-1]} in {t_s:.1f} s "
              f"of subprocess; {card}")


def select_phase(torch, card, rows, data):
    """Step 27: a measured selection on the card never moves its main
    path to the host.  Returns the launches of the read."""
    from lz4net_tpu_torch import codec, registry
    from lz4net_tpu_torch import stream as lz
    from lz4net_tpu_torch.models import cuda as cuda_engine

    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=here + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    t = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "lz4net_tpu_torch", "select"],
                       capture_output=True, text=True, timeout=300, env=env,
                       cwd=here)
    if r.returncode != 0:
        fail(f"python -m lz4net_tpu_torch select: rc {r.returncode}: "
             f"{r.stdout[-1500:]} {r.stderr[-1500:]}")
    got = json.loads(r.stdout.strip().splitlines()[-1])
    if got["cache"] != registry._select_cache_path() \
            or got["codec_name"] != "cuda/cuda/cudaHC":
        fail(f"select on the card: {got}")
    s_s = time.perf_counter() - t
    registry.initialize(force=True)
    if codec.codec_name() != "cuda/cuda/cudaHC":
        fail(f"after select, codec_name() is {codec.codec_name()!r}")
    part = data[:4 << 20]
    framed = lz.compress_stream(part, block_size=BLOCK)
    dec = cuda_engine.decoder("cuda")
    dec.host_decodes = 0
    back, r_ms, launches = first_call(
        torch, rows, lambda: lz.decompress_stream(framed), DECODE_KERNELS)
    if back != part or dec.host_decodes != 0 \
            or any(v != 1 for v in launches.values()):
        fail(f"stream read after select: byte-exact {back == part}, "
             f"host_decodes={dec.host_decodes}, launches {launches} (one "
             f"each expected)")
    print(f"select on the card ({s_s:.1f} s of subprocess): orders "
          f"{got['orders']}; selected again: {codec.codec_name()}; a "
          f"read-all of {len(part)} bytes in 64 KB frames byte-exact, "
          f"host_decodes=0, launches {launches}, {r_ms:.1f} ms; {card}")
    return launches


def with_ends(call, B):
    """A call of ``records_to_state`` (or its plain version) that passes
    ``call`` a [B, 4] block-ends buffer: its outputs and the buffer."""
    def run():
        import torch
        ends = torch.full((B, 4), -7, dtype=torch.int32, device="cuda")
        return (*call(ends), ends)
    return run


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
    # memory, which the kernel reads from device memory; 4 blocks as wide
    # as the widest row staged in shared memory, then one byte wider; the
    # stream cell's batch, 8 chunks of 1 MB of an 8 MiB corpus (its plain
    # version checks it untimed: about 8 s a call)
    edge = corpus.strict_edge_rows(SEED)
    wide = corpus.split_blocks(b"".join(blocks[:32]), 1 << 18)
    limit = es.row_max("cuda")
    at_limit = corpus.split_blocks(b"".join(blocks[:12]), limit)[:4]
    over = corpus.split_blocks(b"".join(blocks[:12]), limit + 1)[:4]
    chunks = corpus.split_blocks(corpus.silesia_like(8 << 20, SEED), 1 << 20)
    stream_batch = "the stream cell's batch, 8 chunks of 1 MB"
    for what, rows_in, caps in (
            ("edge rows", [d for _, d, _ in edge],
             [b if b is not None else maximum_output_length(len(d))
              for _, d, b in edge]),
            ("device-memory rows of 256 KB", wide,
             [maximum_output_length(len(d)) for d in wide]),
            ("the widest staged rows", at_limit,
             [maximum_output_length(len(d)) for d in at_limit]),
            ("one byte wider, read from device memory", over,
             [maximum_output_length(len(d)) for d in over]),
            (stream_batch, chunks,
             [maximum_output_length(len(d)) for d in chunks])):
        vsrc, vlen = _uint8_rows(torch, rows_in)
        vcap = torch.tensor(caps, dtype=torch.int32, device="cuda")
        vO = int(vcap.max())
        vargs = (vsrc.cpu(), vlen.cpu(), vcap.cpu(), vO)
        n_in = sum(map(len, rows_in))
        device = es.device_rows
        es.encode_sequencer(vsrc, vlen, vcap, vO)
        print(f"encode_sequencer ({what}): device_rows "
              f"+{es.device_rows - device}")
        kernel_row(
            "encode_sequencer", "", "", es,
            lambda: es.encode_sequencer(vsrc, vlen, vcap, vO),
            lambda: _on_card(es.encode_sequencer_reference(*vargs)),
            n_bytes=lambda got: (n_in + 2 * len(rows_in) * i4
                                 + int(got[1].clamp(min=0).sum())
                                 + len(rows_in) * i4),
            n_ops=10 * n_in, plain_reps=0 if what == stream_batch else 1,
            defined=payloads,
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
        return only_path(torch, rows, by_path, path, call, [kname])

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
    walls = host_walls(torch, strict_call)
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
        seq_walls += host_walls(torch, seq_call, 1)
        vec_walls += host_walls(torch, lambda: codec.decode_batch(
            packed, lens, device="cuda"), 1)
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


def collective_share(torch, call, card):
    """torch.profiler over one ``call()``: the device time of NCCL's
    kernels beside all device time, and the host time inside the c10d
    collectives beside the call's."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        call()
        torch.cuda.synchronize()
        call_ms = (time.perf_counter() - t) * 1e3
    events = prof.key_averages()
    dev = [e for e in events if e.device_type == DeviceType.CUDA
           and not e.key.startswith("Activity Buffer")]
    busy = sum(e.self_device_time_total for e in dev) / 1e3
    nccl = sum(e.self_device_time_total for e in dev
               if "nccl" in e.key.lower()) / 1e3
    host = [e for e in events if e.device_type == DeviceType.CPU
            and e.key.startswith("c10d::")]
    host_ms = sum(e.cpu_time_total for e in host) / 1e3
    print(f"distributed_decode profile ({call_ms:.2f} ms call): NCCL kernels "
          + (f"{nccl:.4f} ms of {busy:.4f} ms device time (share "
             f"{nccl / busy:.3f})" if busy else "device time not measured "
             "(the trace holds no device events)")
          + f"; host in c10d collectives {host_ms:.3f} ms (share "
          f"{host_ms / call_ms:.3f}: "
          + ", ".join(f"{e.key} x{e.count}" for e in host) + f"); {card}")


def parallel_phase(torch, card, rows, data, blocks, packed):
    """Step 28: the data-parallel pipeline (``lz4net_tpu_torch.parallel``)
    in a world of one on NCCL, the dry run of ``__graft_entry__.py``
    (sharded strict encode, then sharded decode, with all-reduced totals)
    at the main cell's size, then dictionary decode with the window
    broadcast.  Returns the launches by path."""
    import torch.distributed as dist

    from lz4net_tpu_torch import codec
    from lz4net_tpu_torch.constants import maximum_output_length
    from lz4net_tpu_torch.models import cuda as cuda_engine
    from lz4net_tpu_torch.models import reference
    from lz4net_tpu_torch.ops import decode_sequencer as ds
    from lz4net_tpu_torch.ops import decode_vector as dv
    from lz4net_tpu_torch.parallel import mesh as pmesh
    from lz4net_tpu_torch.parallel import pipeline as pl
    from lz4net_tpu_torch.utils import corpus

    t = time.perf_counter()
    mesh = pmesh.make_mesh()
    start_ms = (time.perf_counter() - t) * 1e3
    if (dist.get_backend(), mesh.size(), mesh.device_type) \
            != ("nccl", 1, "cuda"):
        fail(f"make_mesh(): {dist.get_backend()}, {mesh}")
    by_path = {}

    def run_path(path, call, names):
        return only_path(torch, rows, by_path, path, call, names)

    try:
        lens = [len(b) for b in blocks]
        n_data = sum(lens)
        B = len(blocks)
        shard, put = pmesh.block_sharding(mesh), pmesh.replicated(mesh)

        # ---- sharded strict encode --------------------------------------
        caps = [maximum_output_length(n) for n in lens]
        src, elens, S, O, _ = pl.pack_blocks(blocks, caps, mesh.size())
        enc = pl.make_distributed_encode(mesh, src.shape[0], S, O)
        src_d, elens_d = shard(src), shard(elens)

        def enc_call():
            out, written, total = enc(src_d, elens_d)
            out, written = (pl.gather_blocks(mesh, out),
                            pl.gather_blocks(mesh, written))
            return [out[i, :w].tobytes() for i, w in enumerate(written)], \
                int(total)

        (payloads, e_total), e_first = run_path("dist_encode", enc_call,
                                                ["encode_sequencer"])
        if payloads != packed or e_total != sum(map(len, packed)):
            fail(f"sharded strict encode: payloads equal the reference "
                 f"compressor's {payloads == packed}, total {e_total} for "
                 f"{sum(map(len, packed))} bytes")
        e_late = host_walls(torch, enc_call)

        # ---- sharded decode of those payloads ---------------------------
        def dec_call():
            return pl.distributed_decode(payloads, lens, mesh)

        got, d_first = run_path("dist_decode", dec_call,
                                ["decode_sequencer"])
        if got != blocks:
            fail("distributed_decode: blocks differ from their source")
        comp, plens, C, D, _ = pl.pack_blocks(payloads, lens, mesh.size())
        step = pl.make_distributed_decode(mesh, B, C, D)
        comp_d, plens_d = shard(comp), shard(plens)
        if int(step(comp_d, plens_d)[2]) != n_data:
            fail("distributed decode: the all-reduced total is not the "
                 "decoded size")
        # the batch less its last 3 blocks, packed to a multiple of 8: 3
        # pad rows, dropped on unpack, adding nothing to the total
        comp8, lens8, C8, D8, n8 = pl.pack_blocks(payloads[:-3], lens[:-3],
                                                  8)
        out8, st8, tot8 = pl.make_distributed_decode(
            mesh, comp8.shape[0], C8, D8)(shard(comp8), shard(lens8))
        got8 = pl.unpack_blocks(pl.gather_blocks(mesh, out8),
                                pl.gather_blocks(mesh, st8), lens8, n8,
                                comp8)
        if comp8.shape[0] - n8 != 3 or got8 != blocks[:-3] \
                or int(tot8) != sum(lens[:-3]):
            fail("distributed decode with 3 pad rows: the blocks or the "
                 "total differ")
        off0 = bytearray(reference.compress_block(b"abcd" * 50))
        off0[5:7] = b"\x00\x00"            # the first match's offset
        for what, blk, n in (("truncated", payloads[0][:len(payloads[0])
                                                         // 2], lens[0]),
                             ("offset-0", bytes(off0), 200)):
            try:
                pl.distributed_decode([blk], [n], mesh)
            except reference.CorruptedBlockError:
                continue
            fail(f"distributed_decode accepted a {what} block")
        if pl.distributed_decode([payloads[0] + b"\x00\x00"], [lens[0]],
                                 mesh) != [blocks[0]]:
            fail("distributed_decode: a block with two trailing bytes did "
                 "not give its source")

        # ---- dictionary decode, the window broadcast --------------------
        records = corpus.split_blocks(data, RECORD)
        dictionary = b"".join(records[0::256])
        batch = records[1::4]
        dlens = [len(r) for r in batch]
        dpay = cuda_engine.compress_blocks_fast_dict(batch, dictionary,
                                                     device="cuda")
        before = pl.host_decodes

        def dict_call():
            return pl.distributed_decode_dict(dpay, dlens, dictionary, mesh)

        got, dd_first = run_path("dist_decode_dict", dict_call,
                                 DECODE_KERNELS)
        if got != batch or pl.host_decodes != before:
            fail(f"distributed_decode_dict: records equal {got == batch}, "
                 f"{pl.host_decodes - before} host re-decodes")
        dcomp, dcl, dol, dC, dD = dv.pack_blocks(dpay, dlens)
        pre, pre_len, P = dv.pack_windows(dictionary, 1)
        dstep = pl.make_distributed_vector_decode_dict(mesh, len(dpay), dC,
                                                       dD, P)
        dargs = (shard(dcomp).to(torch.int32), shard(dcl), shard(dol),
                 put(pre[0]).to(torch.int32), put(pre_len[0]))
        certified = int(dstep(*dargs)[3])
        if certified != len(batch):
            fail(f"distributed_decode_dict: {certified} of {len(batch)} "
                 f"records certified")
        dd_late = host_walls(torch, dict_call)
        dd_dev = time_ms(torch, lambda: dstep(*dargs))

        # ---- times --------------------------------------------------------
        d_dev = time_ms(torch, lambda: step(comp_d, plens_d))
        k_dev = time_ms(torch, lambda: ds.decode_sequencer(
            comp_d, plens_d[:, 0], plens_d[:, 1], D))
        e_dev = time_ms(torch, lambda: enc(src_d, elens_d))
        dist_w, seq_w, vec_w = [], [], []
        for _ in range(REPS):          # in turns
            dist_w += host_walls(torch, dec_call, 1)
            seq_w += host_walls(torch, lambda: ds.SequencerDecoder(
                "cuda").decode_batch(payloads, lens), 1)
            vec_w += host_walls(torch, lambda: codec.decode_batch(
                payloads, lens, device="cuda"), 1)
        med = statistics.median
        print(f"parallel (NCCL, world 1, make_mesh {start_ms:.0f} ms): "
              f"sharded strict encode of {B} blocks equal to the reference "
              f"compressor's, total {e_total} bytes; first call "
              f"{e_first:.2f} ms, later " + " ".join(f"{w:.2f}" for w in
                                                      e_late)
              + f"; step (encode_sequencer and the all-reduce) {e_dev:.3f} "
              f"ms; {card}")
        print(f"parallel: distributed_decode of {B} blocks byte-exact, total "
              f"{n_data} bytes, 3 pad rows dropped, truncated and offset-0 "
              f"blocks raise, two trailing bytes accepted; first call "
              f"{d_first:.2f} ms; in turns (ms, host clock): "
              f"distributed_decode " + " ".join(f"{w:.2f}" for w in dist_w)
              + f" (median {med(dist_w):.2f}, {n_data / med(dist_w) / 1e6:.4f}"
              f" GB/s), SequencerDecoder.decode_batch "
              + " ".join(f"{w:.2f}" for w in seq_w)
              + f" (median {med(seq_w):.2f}), codec.decode_batch "
              + " ".join(f"{w:.2f}" for w in vec_w)
              + f" (median {med(vec_w):.2f}); step (decode_sequencer and "
              f"the all-reduce) {d_dev:.3f} ms, the kernel alone "
              f"{k_dev:.3f} ms; {card}")
        print(f"parallel: distributed_decode_dict of {len(batch)} records "
              f"byte-exact, {certified} certified, host re-decodes 0; first "
              f"call {dd_first:.2f} ms, later "
              + " ".join(f"{w:.2f}" for w in dd_late)
              + f"; step (device pass, certificate, all-reduce) "
              f"{dd_dev:.3f} ms; {card}")
        collective_share(torch, dec_call, card)
    finally:
        dist.destroy_process_group()
    return by_path


def native_phase(torch, card, data, blocks, host_build_s):
    """Step 29: the native host engine (``models.native``) on the card's
    machine: registered on the card but serving none of its roles, its
    AutoTest, its encoders against the card's strict kernel and the
    Python parses, its walks against the Python walks, and the numbers of
    the paths it carries (steps 21 and 25)."""
    from lz4net_tpu_torch import codec, registry
    from lz4net_tpu_torch.models import cuda as cuda_engine
    from lz4net_tpu_torch.models import native, reference
    from lz4net_tpu_torch.ops import bigblock
    from lz4net_tpu_torch.utils import corpus

    svcs = registry.available_services("cuda")
    if set(svcs) != {"cuda", "native", "python-reference"} \
            or codec.codec_name() != "cuda/cuda/cudaHC":
        fail(f"engines on the card {sorted(svcs)}, selection "
             f"{codec.codec_name()!r}: native registered and every role "
             f"on cuda expected")
    t = time.perf_counter()
    if not registry.auto_test(svcs["native"]):
        fail("the native engine failed its AutoTest")
    auto_ms = (time.perf_counter() - t) * 1e3

    # strict: the encode_sequencer kernel's payloads on all 256 blocks
    t = time.perf_counter()
    nat = [native.compress_block(b) for b in blocks]
    nat_ms = (time.perf_counter() - t) * 1e3
    if nat != cuda_engine.compress_blocks(blocks, device="cuda"):
        fail("native strict encode differs from the encode_sequencer "
             "kernel's payloads")
    # HC level 9 and dictionary: the Python parses' bytes on 8 blocks and
    # 8 of the dictionary workload's records
    records = corpus.split_blocks(data, RECORD)
    dictionary = b"".join(records[0::256])
    batch = records[1::4][:8]
    t = time.perf_counter()
    pairs = (
        ("HC L9", [native.compress_block_hc(b) for b in blocks[:8]],
         [reference.compress_block_hc(b) for b in blocks[:8]]),
        ("dictionary", [native.compress_block_dict(dictionary, r)
                        for r in batch],
         [reference.compress_block_dict(dictionary, r) for r in batch]),
        ("HC L9 dictionary", [native.compress_block_hc_dict(dictionary, r)
                              for r in batch],
         [reference.compress_block_hc_dict(dictionary, r) for r in batch]))
    py_ms = (time.perf_counter() - t) * 1e3
    for what, got, want in pairs:
        if got != want:
            fail(f"native {what} encode differs from the Python parse")

    # the big-block walks against the Python walks: the 16 blocks of 1 MB
    # (the card's strict payloads) and the first one's big_bad_blocks
    big = corpus.split_blocks(data, BIG_BLOCK)
    pays = cuda_engine.compress_blocks(big, device="cuda")
    t = time.perf_counter()
    walks = [bigblock.scan(p) for p in pays]
    walk_ms = (time.perf_counter() - t) * 1e3
    t = time.perf_counter()
    ref_walks = [bigblock.scan_reference(p) for p in pays]
    ref_walk_ms = (time.perf_counter() - t) * 1e3
    if walks != ref_walks:
        fail("bigblock.scan differs from scan_reference on the 1 MB blocks")
    cap = 2 * BIG_BLOCK
    t = time.perf_counter()
    lens = [native.unknown_output_length(p, cap) for p in pays]
    u_ms = (time.perf_counter() - t) * 1e3
    t = time.perf_counter()
    ref_lens = [reference.unknown_output_length(p, cap) for p in pays]
    ref_u_ms = (time.perf_counter() - t) * 1e3
    if lens != ref_lens or lens != [len(b) for b in big]:
        fail("native.unknown_output_length differs from the Python walk")
    for what, bad in corpus.big_bad_blocks(pays[0]):
        if bigblock.scan(bad) != bigblock.scan_reference(bad):
            fail(f"bigblock.scan differs from scan_reference on {what}")
        for c in (cap, len(big[0])):
            got = _outcome(reference, lambda: native.unknown_output_length(
                bad, c))
            want = _outcome(reference,
                            lambda: reference.unknown_output_length(bad, c))
            if not _same(got, want) or not isinstance(want, Exception):
                fail(f"native.unknown_output_length on {what}: {got!r}, "
                     f"the Python walk {want!r}")
    n = len(big)

    def share(key):
        idle, late = REPORT[key]
        return (f"late {late:.1f} ms, idle "
                + ("not measured" if idle is None else f"{idle:.3f}"))

    print(f"native host engine: built in {host_build_s:.1f} s (g++, "
          f"-O3 -march=native), AutoTest {auto_ms:.1f} ms; registered on "
          f"the card, selection {codec.codec_name()}; strict encode of the "
          f"{len(blocks)} blocks {nat_ms:.1f} ms on the host, equal to "
          f"encode_sequencer's payloads; HC L9, dictionary and HC L9 "
          f"dictionary equal to the Python parses on 8 blocks and 8 records "
          f"(the Python parses {py_ms:.0f} ms); {card}")
    print(f"native walks: bigblock.scan {walk_ms / n:.3f} ms a 1 MB block "
          f"(scan_reference {ref_walk_ms / n:.1f} ms), unknown_output_length "
          f"{u_ms / n:.3f} ms (the Python walk {ref_u_ms / n:.1f} ms), equal "
          f"on the {n} blocks and the big_bad_blocks; big_decode "
          f"{share('big_decode')}, the walk {REPORT['big_walk_ms']:.3f} ms "
          f"a block; big_unknown {share('big_unknown')}; stream read-all at "
          f"1 MB chunks {share('stream_read_all_1mb')} "
          f"({n * BIG_BLOCK / REPORT['stream_read_all_1mb'][1] / 1e3:.1f} "
          f"MB/s); stream HC at 64 KB chunks "
          f"{REPORT['stream_hc_MBps']:.2f} MB/s on 16 MB; {card}")


def main() -> int:
    with tempfile.TemporaryDirectory() as select_cache:
        return smoke(select_cache)


def smoke(select_cache) -> int:
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
        from lz4net_tpu_torch import _build, codec, registry
        from lz4net_tpu_torch.models import cuda as cuda_engine
        from lz4net_tpu_torch.models import native, reference
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
    t = time.perf_counter()
    native.build()
    host_build_s = time.perf_counter() - t
    print(f"native host engine build (g++): {host_build_s:.1f} s")
    # the engine selection, from an empty cache so that no order persisted
    # on this machine moves an engine, before any call whose launches
    # are counted (the AutoTest launches kernels)
    os.environ["LZ4NET_SELECT_CACHE"] = select_cache
    t = time.perf_counter()
    registry.initialize()
    print(f"registry: {codec.codec_name()} selected, AutoTest in "
          f"{(time.perf_counter() - t) * 1e3:.0f} ms")

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
    # with the block ends (ops/decode_vector.device_pass asks for them)
    t0m, cidx, _stats, _ends = kernel_row(
        "records_to_state", "lz4net_tpu_torch/csrc/records_kernel.cu",
        "lz4net_tpu/ops/records_kernel.py:374", records_kernel,
        with_ends(lambda e: records_kernel.records_to_state(
            comp, mark, ll, ml, comp_len, out_len, pre_len, C, Dt, 0, e), B),
        with_ends(lambda e: records_kernel.records_to_state_reference(
            comp, mark, ll, ml, comp_len, out_len, pre_len, C, Dt, 0, e), B),
        n_bytes=B * C * i4 + 3 * n_comp * i4 + 3 * B * i4
        + 2 * B * Dt * i4 + B * 12 * i4,
        n_ops=B * C * 30 + B * Dt * 20)
    kernel_row(
        "records_to_state", "", "", records_kernel,
        lambda: records_kernel.records_to_state(
            comp, mark, ll, ml, comp_len, out_len, pre_len, C, Dt, 0),
        lambda: records_kernel.records_to_state_reference(
            comp, mark, ll, ml, comp_len, out_len, pre_len, C, Dt, 0),
        n_bytes=B * C * i4 + 3 * n_comp * i4 + 3 * B * i4
        + 2 * B * Dt * i4 + B * 8 * i4,
        n_ops=B * C * 30 + B * Dt * 20, variant="without the block ends")
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
    # the 64 KB batch behind a 64 KB window (P = 65,536, Dt = 139,264;
    # pre_len P, 0 and 100 in turn), as a dictionary decode lays it out
    pre64 = torch.tensor([(P64, 0, 100)[j % 3] for j in range(B)],
                         dtype=torch.int32, device="cuda")
    kernel_row(
        "records_to_state", "", "", records_kernel,
        with_ends(lambda e: records_kernel.records_to_state(
            comp, mark, ll, ml, comp_len, out_len, pre64, C, P64 + Dt, P64,
            e), B),
        with_ends(lambda e: records_kernel.records_to_state_reference(
            comp, mark, ll, ml, comp_len, out_len, pre64, C, P64 + Dt, P64,
            e), B),
        n_bytes=B * C * i4 + 3 * n_comp * i4 + 3 * B * i4
        + 2 * B * (P64 + Dt) * i4 + B * 8 * i4,
        n_ops=B * C * 30 + B * (P64 + Dt) * 20,
        variant=f"P={P64}, pre_len {P64}/0/100, Dt={P64 + Dt}")
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
            with_ends(lambda e: records_kernel.records_to_state(
                *rargs, epre, eC, eP + eDt, eP, e), eB),
            with_ends(lambda e: records_kernel.records_to_state_reference(
                *rargs, epre, eC, eP + eDt, eP, e), eB),
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
    # a 64 KB window (start_chunk 8, Dt = 139,264), one literal in 20 of
    # the block turned into a pointer up to 64 KB back: into the window
    # and across chunks
    rng = np.random.default_rng(SEED + 1)
    far = torch.from_numpy(rng.random((B, Dt)) < 0.05).to("cuda")
    back = torch.from_numpy(rng.integers(1, P64 + 1, (B, Dt),
                                         np.int32)).to("cuda")
    o64 = P64 + torch.arange(Dt, dtype=torch.int32, device="cuda")
    body = torch.where(T0 >= dv.VFLAG, T0, T0 + P64)
    body = torch.where(far & (T0 >= dv.VFLAG), o64 - back, body)
    T0w = torch.cat([dv.VFLAG | torch.from_numpy(rng.integers(
        0, 256, (B, P64), np.int32)).to("cuda"), body], 1)
    del far, back, o64, body
    kernel_row(
        "resolve_wavefront", "", "", resolve_kernel,
        lambda: resolve_kernel.resolve_wavefront(T0w, P64 // dv.CH),
        lambda: resolve_kernel.resolve_wavefront_reference(T0w,
                                                           P64 // dv.CH),
        n_bytes=B * (P64 + Dt) * i4 * 2 + B, n_ops=B * (P64 + Dt) * 6,
        variant=f"start_chunk={P64 // dv.CH}, P={P64}, Dt={P64 + Dt}, "
                f"pointers into the window")
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
    dec.host_decodes = 0
    got, first_ms, launches = first_call(
        torch, rows, lambda: codec.decode_batch(packed, lens, device="cuda"))
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
          f"launches {launches}, first call {first_ms:.1f} ms")

    walls = host_walls(torch, lambda: codec.decode_batch(packed, lens,
                                                         device="cuda"))
    wall = statistics.median(walls)
    dev_ms = time_ms(torch, lambda: dv.decode_batch_vectorized(
        comp, comp_len, out_len, C, D))
    print(f"slice decode_batch, first calls (ms): "
          + " ".join(f"{w:.2f}" for w in walls)
          + f"; median {wall:.2f} ms per {len(blocks)}-block batch, "
          f"{len(data) / wall / 1e6:.4f} GB/s decoded (host clock, "
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

    enc_launches, fast_total = encode_phases(torch, card, kernel_row, rows,
                                             blocks, packed)
    strict_launches = strict_phases(torch, card, kernel_row, rows, blocks,
                                    packed)
    hc_launches = hc_phases(torch, card, kernel_row, rows, blocks,
                            fast_total)
    chain_launches = chain_phases(torch, card, kernel_row, rows, blocks)
    dict_launches = dict_phases(torch, card, kernel_row, rows, data, blocks,
                                packed)
    big_launches = big_phases(torch, card, kernel_row, rows, data,
                              fast_total)
    stream_launches = stream_phases(torch, card, rows, data, blocks, packed)
    tools_phases(torch, card, data, name)
    select_launches = select_phase(torch, card, rows, data)
    parallel_launches = parallel_phase(torch, card, rows, data, blocks,
                                       packed)
    native_phase(torch, card, data, blocks, host_build_s)
    paths = [("stream_read_after_select", select_launches),
             *parallel_launches.items(),
             ("decode", launches), ("encode", enc_launches),
             *strict_launches.items(), *hc_launches.items(),
             *chain_launches.items(), *dict_launches.items(),
             *big_launches.items(), *stream_launches.items()]
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
