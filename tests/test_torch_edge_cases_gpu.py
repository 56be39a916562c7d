"""The redesigned ``match_lengths`` and ``encode_sequencer`` kernels held
bit for bit against their plain versions on the card, on rows made to
reach their edge cases, with the launch counts checked.

``match_lengths``: equal runs at offsets 1-4 and at dominant offsets that
cross the 32-position words of the break bitmasks and their level
boundaries and reach the block's end, at K = 0, 8 and 24 dominant offsets
and at D = 106496.  ``encode_sequencer``: the rows and budgets of
``corpus.strict_edge_rows`` on both of its kernels (rows staged in shared
memory, and the same rows padded to 256 KB, which it reads from device
memory), rows at the widest width staged in shared memory (``row_max``)
and one byte wider, and the rows and budgets of
``corpus.strict_wide_rows`` at 1 MB and 4 MB, read from device memory,
with the count of such rows.  ``parse_tokens`` and ``decode_sequencer``:
the rows of ``corpus.decode_edge_rows`` (for ``parse_tokens`` packed with
seeded junk rows, ``corpus.parse_edge_rows``), and
``decode_sequencer`` on output rows at its ``row_max`` and one byte wider.
``sequence_records`` and ``bucket_prev``: the rows of
``corpus.seq_edge_rows`` and ``corpus.bucket_edge_rows`` at D = 4096 and
at the widest block, D = 106496 (``sequence_records`` at 2 and 8
catch-up rounds).  ``records_to_state``: ``corpus.parse_edge_rows``
through the plain ``parse_tokens`` beside ``corpus.token_edge_rows``, at
P = 0 and 8192, and with Dt 3 bytes short of a multiple of 4.
``emit_bytes``: ``corpus.emit_edge_rows`` at the CPU tests' S and O, at
the encode path's, and at an O that is not a multiple of 4, and, outside
its domain, on rows whose s0 decreases (no fault).
``resolve_wavefront``: ``corpus.resolve_edge_rows``, junk rows
included (``ok`` must match too), at start_chunk 0-3 and Dt = 8192,
73728 and 262144.  ``hc_tables``: ``corpus.hc_edge_rows`` with 1, 3, 7
and 8 tables at D = 512 and 106496.  ``mark_chain``:
``corpus.chain_edge_rows`` at D = 4096, at a width 3 short of it and at
the widest block, D = 106496.  ``table_gather``: ``corpus.gather_edge_rows``
with 1-4 tables, K below 4, not a multiple of 4 and at the chain path's
S_cap, N = 128, and an index view off a 16-byte boundary.  The prefix
(preset-dictionary) mode: ``corpus.dict_edge_rows`` at P = 8192 and
65536 through ``records_to_state`` and ``resolve_wavefront`` (start_chunk
P / 8192) and through ``bucket_prev``, ``match_lengths`` (end_abs = P +
len), ``sequence_records`` (each row's window length, P, 0 and P // 3)
and ``emit_bytes``, then whole dictionary decode and P-mode encode.
Blocks over 96 KB: ``corpus.big_edge_blocks`` both ways, and a 1 MB block
under a 2 MB cap, whose ``corpus.big_bad_blocks`` raise the hardened
unknown-length decoder's error.

The tests carry the ``gpu`` marker and skip without a CUDA device; on a
machine with one (no JAX needed) run them with

    python -m pytest --noconftest -m gpu tests/test_torch_edge_cases_gpu.py

``mlen_edge_rows`` is shared with ``tests/test_torch_edge_cases.py`` and
``bucket_inputs`` with ``tests/test_torch_seq_hash_edge_cases.py``, which
hold the plain versions against the JAX package on the CPU.
"""

import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from lz4net_tpu_torch.models import reference  # noqa: E402
from lz4net_tpu_torch.ops import chain_kernel  # noqa: E402
from lz4net_tpu_torch.ops import decode_sequencer as ds  # noqa: E402
from lz4net_tpu_torch.ops import decode_vector as dv  # noqa: E402
from lz4net_tpu_torch.ops import emit_kernel  # noqa: E402
from lz4net_tpu_torch.ops import encode_sequencer as es  # noqa: E402
from lz4net_tpu_torch.ops import encode_vector as ev  # noqa: E402
from lz4net_tpu_torch.ops import fused_gather  # noqa: E402
from lz4net_tpu_torch.ops import hash_kernel  # noqa: E402
from lz4net_tpu_torch.ops import mlen_kernel  # noqa: E402
from lz4net_tpu_torch.ops import parse_kernel  # noqa: E402
from lz4net_tpu_torch.ops import records_kernel  # noqa: E402
from lz4net_tpu_torch.ops import resolve_kernel  # noqa: E402
from lz4net_tpu_torch.ops import seq_kernel  # noqa: E402
from lz4net_tpu_torch.utils import corpus  # noqa: E402

# (K, sub_step, D, rcap): the fast path's 8 offsets, the HC tiers' 24,
# none, the widest row that keeps the class bytes in shared memory, a big
# block's 64 KB segment behind its 64 KB window (139,264) and a 96 KB
# block behind one (172,032, HC L9's rcap D // 4 = 43,008)
MLEN_CASES = [(0, 16, 8192, 512), (8, 16, 8192, 1024), (24, 8, 8192, 8192),
              (24, 8, 106496, 26624), (8, 16, 139264, 4096),
              (24, 8, 139264, 34816), (8, 16, 172032, 4096),
              (24, 8, 172032, 43008)]


def mlen_edge_rows(D, seed=0):
    """Five rows of D bytes as [5, D] int32, and their lengths [5] int32:

    0. zeros: one offset-1 run from position 1 to the block's end;
    1. periods 2, 3, 4 and 1 in quarters, each byte flipped at positions
       on either side of the bitmasks' 32-position words and their
       1024- and 32768-position level boundaries;
    2. 4000 random bytes, then period 777 to the end (a dominant offset
       whose runs reach the end), flipped at the same positions;
    3. 30 segments with periods 37, 40, ..., 124 (more dominant offsets
       than 24);
    4. silesia-like text, 300 bytes short of D (the end rules cut).
    """
    rng = np.random.default_rng(seed)
    q = D // 4
    per = np.concatenate([np.resize(rng.integers(0, 256, k, np.uint8), q)
                          for k in (2, 3, 4, 1)])
    far = np.concatenate([rng.integers(0, 256, 4000, np.uint8),
                          np.resize(rng.integers(0, 256, 777, np.uint8),
                                    D - 4000)])
    seg = D // 30
    many = np.resize(np.concatenate([
        np.resize(rng.integers(0, 256, p, np.uint8), seg)
        for p in range(37, 127, 3)]), D)
    text = np.frombuffer(corpus.silesia_like(D - 300, seed), np.uint8)
    flips = sorted({e + k for e in (32, 64, 1024, 2048, 32768, q, 2 * q,
                                    3 * q, 5000, D - 32, 131072)
                    for k in (-1, 0, 1) if 4 <= e + k < D})
    for row in (per, far):
        row[flips] ^= 0x5A
    x = np.zeros((5, D), np.int32)
    for j, row in enumerate((np.zeros(D, np.uint8), per, far, many, text)):
        x[j, :len(row)] = row
    return x, np.array([D, D, D, D - 7, D - 300], np.int32)


def mlen_inputs(x, dl):
    """u32, the exact previous occurrence of each position's word, and
    8-byte claims on every fifth position, as torch tensors."""
    xt = torch.from_numpy(x)
    u32 = ev._u32(xt)
    prev = ev._prev_occurrence((u32,))
    m8 = torch.arange(x.shape[1]) % 5 == 0
    return (xt, torch.from_numpy(dl), u32, prev,
            m8.expand(x.shape[0], -1).contiguous())


def bucket_inputs(names, x):
    """``bucket_prev``'s operands for ``corpus.bucket_edge_rows``: the
    words at i and i + 4 and their buckets, as torch tensors; the
    ``one_bucket`` row's buckets all 0."""
    u32 = ev._u32(torch.from_numpy(x.astype(np.int32)))
    us4 = ev._shift_left(u32, 4)
    h4 = hash_kernel.hash_bucket(u32)
    h8 = hash_kernel.hash_bucket8(u32, us4)
    one = torch.tensor([n == "one_bucket" for n in names])[:, None]
    return u32, us4, h4.masked_fill(one, 0), h8.masked_fill(one, 0)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _equal(got, want):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g.cpu(), w.cpu())


@pytest.mark.gpu
@pytest.mark.parametrize("K, sub_step, D, rcap", MLEN_CASES)
def test_match_lengths_edge_rows_on_the_card(cuda, K, sub_step, D, rcap):
    x, dl = mlen_edge_rows(D)
    xt, dlt, u32, prev, m8 = (t.to(cuda) for t in mlen_inputs(x, dl))
    i = torch.arange(D, dtype=torch.int32, device=cuda)
    off = i - prev
    dks = ev._top_offsets_select(off, (prev >= 0) & (off <= 65535)
                                 & (off > 4), K, sub_step)
    assert dks.shape == (5, K)
    args = (xt, u32, prev, m8.to(torch.int32), dks, dlt, dlt, D, rcap)
    before = mlen_kernel.launches
    got = mlen_kernel.match_lengths_fused(*args)
    assert mlen_kernel.launches == before + 1
    want = mlen_kernel.match_lengths_reference(*args)
    _equal(got, want)
    # the zero row's one run and the periodic rows reach the block's end
    mlen = want[2].cpu()
    end = D - 5                     # end_abs less the last literals
    assert int(mlen[0, 1]) == end - 1 and int(mlen[2, D - 12]) == 7


@pytest.mark.gpu
def test_match_lengths_matches_plain_on_junk_classes(cuda):
    """Every position a class, classes repeated in dks, dks past the
    block and offsets that break at every 32nd position."""
    D = 8192
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.integers(0, 2, (3, D), np.int32)).to(cuda)
    x[:, ::32] = 7
    u32 = ev._u32(x)
    i = torch.arange(D, device=cuda, dtype=torch.int32)
    prev = (i - torch.from_numpy(rng.integers(1, 9, (3, D), np.int32)).to(
        cuda)).to(torch.int32)
    dks = torch.tensor([[5, 6, 7, 8, 5, 6, 9000, 0]] * 3, dtype=torch.int32,
                       device=cuda)
    dl = torch.tensor([D, D - 1, 13], dtype=torch.int32, device=cuda)
    args = (x, u32, prev, torch.zeros_like(prev), dks, dl, dl, D, 64)
    _equal(mlen_kernel.match_lengths_fused(*args),
           mlen_kernel.match_lengths_reference(*args))


def _strict_batch(rows, width):
    src = np.zeros((len(rows), width), np.uint8)
    for j, (_, data, _) in enumerate(rows):
        src[j, :len(data)] = np.frombuffer(data, np.uint8)
    lens = torch.tensor([len(d) for _, d, _ in rows], dtype=torch.int32)
    cap = torch.tensor([b if b is not None else len(d) + len(d) // 255 + 16
                        for _, d, b in rows], dtype=torch.int32)
    return torch.from_numpy(src), lens, cap


@pytest.mark.gpu
@pytest.mark.parametrize("wide", [False, True])
def test_encode_sequencer_edge_rows_on_the_card(cuda, wide):
    """The shared-memory kernel (rows as wide as the widest block) and
    the device-memory kernel (the same rows in 256 KB rows); written and
    every payload byte equal to the plain version's."""
    rows = corpus.strict_edge_rows(0)
    width = max(len(d) for _, d, _ in rows)
    if wide:
        width = 1 << 18
    assert (width > es.row_max(cuda)) == wide
    src, lens, cap = _strict_batch(rows, width)
    O = int(cap.max())
    before, device = es.launches, es.device_rows
    out, written = es.encode_sequencer(src.to(cuda), lens.to(cuda),
                                       cap.to(cuda), O)
    assert es.launches == before + 1
    assert es.device_rows == device + wide * len(rows)
    want, want_written = es.encode_sequencer_reference(src, lens, cap, O)
    assert written.cpu().tolist() == want_written.tolist()
    assert (want_written < 0).sum() == 6          # the budgets below fit
    for (name, _, _), g, w, n in zip(rows, out.cpu(), want,
                                     want_written.tolist()):
        assert torch.equal(g[:max(n, 0)], w[:max(n, 0)]), name


@pytest.mark.gpu
@pytest.mark.parametrize("extra", [0, 1])
def test_encode_sequencer_at_the_staged_row_limit(cuda, extra):
    """Rows at the widest width the shared-memory kernel takes on this
    card and one byte wider (the device-memory kernel): text, zeros,
    noise and a short row, each payload equal to the plain version's."""
    limit = es.row_max(cuda)
    assert limit >= 128 * 1024
    width = limit + extra
    rng = np.random.default_rng(5)
    rows = [("text", corpus.silesia_like(width, 5), None),
            ("zeros", bytes(width), None),
            ("noise", rng.integers(0, 256, width, np.uint8).tobytes(),
             None),
            ("short", corpus.silesia_like(4000, 6), None)]
    src, lens, cap = _strict_batch(rows, width)
    O = int(cap.max())
    before, device = es.launches, es.device_rows
    out, written = es.encode_sequencer(src.to(cuda), lens.to(cuda),
                                       cap.to(cuda), O)
    assert es.launches == before + 1
    assert es.device_rows == device + extra * len(rows)
    want, want_written = es.encode_sequencer_reference(src, lens, cap, O)
    assert written.cpu().tolist() == want_written.tolist()
    assert (want_written > 0).all()
    for (name, _, _), g, w, n in zip(rows, out.cpu(), want,
                                     want_written.tolist()):
        assert torch.equal(g[:n], w[:n]), name


@pytest.mark.gpu
@pytest.mark.parametrize("width", [1 << 20, 4 << 20])
def test_encode_sequencer_wide_rows_on_the_card(cuda, width):
    """``corpus.strict_wide_rows`` through the device-memory kernel in
    one batch (its odd_width row makes the batch's width 5 bytes over a
    multiple of 16, so the rows start at each alignment of a word and
    every row but the first off a 16-byte boundary): written, with its -1 at
    each output-limit check, and every payload byte equal to the plain
    version's; every row counted in ``device_rows``."""
    rows = corpus.strict_wide_rows(0, width)
    S = max(len(d) for _, d, _ in rows)
    assert S % 16 and S > es.row_max(cuda)
    src, lens, cap = _strict_batch(rows, S)
    O = int(cap.max())
    before, device = es.launches, es.device_rows
    out, written = es.encode_sequencer(src.to(cuda), lens.to(cuda),
                                       cap.to(cuda), O)
    assert es.launches == before + 1
    assert es.device_rows == device + len(rows)
    want, want_written = es.encode_sequencer_reference(src, lens, cap, O)
    assert written.cpu().tolist() == want_written.tolist()
    assert (want_written < 0).sum() == 5
    for (name, _, _), g, w, n in zip(rows, out.cpu(), want,
                                     want_written.tolist()):
        assert torch.equal(g[:max(n, 0)], w[:max(n, 0)]), name


@pytest.mark.gpu
def test_parse_tokens_edge_rows_on_the_card(cuda):
    comp, comp_len, C = corpus.parse_edge_rows(0)
    comp, comp_len = torch.from_numpy(comp), torch.from_numpy(comp_len)
    before = parse_kernel.launches
    got = parse_kernel.parse_tokens(comp.to(cuda), comp_len.to(cuda), C)
    assert parse_kernel.launches == before + 1
    _equal(got, parse_kernel.parse_tokens_reference(comp, comp_len, C))


def _decode_batch(rows):
    blocks = [b for _, b, _ in rows]
    comp = np.zeros((len(blocks), max(map(len, blocks))), np.uint8)
    for i, b in enumerate(blocks):
        comp[i, :len(b)] = np.frombuffer(b, np.uint8)
    return (torch.from_numpy(comp),
            torch.tensor([len(b) for b in blocks], dtype=torch.int32),
            torch.tensor([n for *_, n in rows], dtype=torch.int32))


@pytest.mark.gpu
@pytest.mark.parametrize("short", [0, 1])
def test_decode_sequencer_edge_rows_on_the_card(cuda, short):
    """Every row of ``corpus.decode_edge_rows``; with D one byte short of
    the longest row, that row faults by a write past D."""
    rows = corpus.decode_edge_rows(0)
    comp, comp_len, out_len = _decode_batch(rows)
    D = int(out_len.max()) - short
    before = ds.launches
    got = ds.decode_sequencer(comp.to(cuda), comp_len.to(cuda),
                              out_len.to(cuda), D)
    assert ds.launches == before + 1
    want = ds.decode_sequencer_reference(comp, comp_len, out_len, D)
    _equal(got, want)
    faults = [r[0] for r, s in zip(rows, want[1].tolist()) if s[0] < 0]
    assert faults == [r[0] for r in rows if r[0].startswith("junk_")
                      or (short and r[2] > D)]


@pytest.mark.gpu
@pytest.mark.parametrize("extra", [0, 1])
def test_decode_sequencer_at_the_staged_row_limit(cuda, extra):
    """Output rows as wide as the widest the shared-memory kernel takes on
    this card, then one byte wider (the one-warp kernel): text, zeros and
    noise blocks of that length, a truncated block and a short one, at D
    and at D - 5 (where the full rows fault by a write past D)."""
    limit = ds.row_max(cuda)
    assert limit >= 128 * 1024
    width = limit + extra
    rng = np.random.default_rng(7)
    datas = [corpus.silesia_like(width, 5), bytes(width),
             rng.integers(0, 256, width, np.uint8).tobytes()]
    rows = [(str(i), reference.compress_block(d), width)
            for i, d in enumerate(datas)]
    rows += [("truncated", rows[0][1][:len(rows[0][1]) // 2], width),
             ("short", reference.compress_block(datas[0][:3000]), 3000)]
    comp, comp_len, out_len = _decode_batch(rows)
    for D in (width, width - 5):
        before = ds.launches
        got = ds.decode_sequencer(comp.to(cuda), comp_len.to(cuda),
                                  out_len.to(cuda), D)
        assert ds.launches == before + 1
        want = ds.decode_sequencer_reference(comp, comp_len, out_len, D)
        _equal(got, want)
        ok = want[1][:, 0] >= 0
        assert ok.tolist() == [D == width] * 3 + [False, True]


@pytest.mark.gpu
@pytest.mark.parametrize("D", [4096, 106496, 139264, 172032])
@pytest.mark.parametrize("cu_rounds", [2, 8])
def test_sequence_records_edge_rows_on_the_card(cuda, D, cu_rounds):
    names, *rows, S_cap = corpus.seq_edge_rows(D)
    args = [torch.from_numpy(a).to(cuda) for a in rows]
    for cap in (S_cap, 300):          # and a cap most rows pass
        before = seq_kernel.launches
        got = seq_kernel.sequence_records(*args, D, cap, 0, cu_rounds)
        assert seq_kernel.launches == before + 1
        _equal(got, seq_kernel.sequence_records_reference(
            *args, D, cap, 0, cu_rounds))
    assert int(got[5][names.index("overflow"), 0]) == D


@pytest.mark.gpu
@pytest.mark.parametrize("D", [4096, 106496, 130560, 131072, 139264,
                               172032])
def test_bucket_prev_edge_rows_on_the_card(cuda, D):
    """Up to 130,560 positions the kernel's table words keep 17
    position bits, from 131,072 on 18: rows on both sides of 2^17; the
    one-bucket row saturates a bucket at 512 hits in every chunk."""
    names, x = corpus.bucket_edge_rows(D)
    args = [t.to(cuda) for t in bucket_inputs(names, x)]
    before = hash_kernel.launches
    got = hash_kernel.bucket_prev(*args, D)
    assert hash_kernel.launches == before + 1
    _equal([got], [hash_kernel.bucket_prev_reference(*args, D)])


def records_edge_inputs():
    """``corpus.parse_edge_rows`` through the plain ``parse_tokens`` (out_len
    the decoded length of each ``decode_edge_rows`` row, C for the junk
    rows), then ``corpus.token_edge_rows``: (comp, mark, ll, ml, comp_len,
    out_len) int32 CPU tensors, C and the decode path's D for them."""
    comp, comp_len, C = corpus.parse_edge_rows(0)
    out_len = [n for *_, n in corpus.decode_edge_rows(0)]
    out_len += [C] * (len(comp) - len(out_len))
    mark, ll, ml, _ = parse_kernel.parse_tokens_reference(
        torch.from_numpy(comp), torch.from_numpy(comp_len), C)
    _, *rows = corpus.token_edge_rows(C)
    parsed = (comp, mark.numpy(), ll.numpy(), ml.numpy(), comp_len,
              np.array(out_len, np.int32))
    args = [torch.from_numpy(np.concatenate(pair)) for pair in zip(parsed,
                                                                   rows)]
    D = -(-(max(out_len[:-6]) + 1) // 8192) * 8192
    return args, C, D


@pytest.mark.gpu
@pytest.mark.parametrize("P", [0, 8192])
@pytest.mark.parametrize("short", [0, 3])
def test_records_to_state_edge_rows_on_the_card(cuda, P, short):
    args, C, D = records_edge_inputs()
    B = len(args[0])
    pre = torch.zeros(B, dtype=torch.int32) if P == 0 else torch.tensor(
        np.resize([0, P, 100], B), dtype=torch.int32)
    Dt = P + D - short
    before = records_kernel.launches
    got = records_kernel.records_to_state(*(t.to(cuda) for t in args),
                                          pre.to(cuda), C, Dt, P)
    assert records_kernel.launches == before + 1
    _equal(got, records_kernel.records_to_state_reference(*args, pre, C, Dt,
                                                          P))


@pytest.mark.gpu
@pytest.mark.parametrize("S, O", [(8192, 16384), (24576, 81920),
                                  (8192, 16381)])
def test_emit_bytes_edge_rows_on_the_card(cuda, S, O):
    _, *fields, out_len = corpus.emit_edge_rows(S, O)
    args = [torch.from_numpy(a) for a in (*fields, out_len)]
    before = emit_kernel.launches
    got = emit_kernel.emit_bytes(*(t.to(cuda) for t in args), O)
    assert emit_kernel.launches == before + 1
    _equal(got, emit_kernel.emit_bytes_reference(*args, O))


@pytest.mark.gpu
def test_emit_bytes_on_a_decreasing_s0_stays_in_its_buffers(cuda):
    """``emit_bytes`` holds its plain version only where ``s0`` never
    decreases; on rows where it does (the edge rows with their live starts
    shuffled, and random starts with dead records among them) the bytes
    are unspecified, but the kernel must not fault."""
    S, O = 8192, 16384
    _, *fields, out_len = corpus.emit_edge_rows(S, O)
    rng = np.random.default_rng(3)
    s0 = fields[0]
    for row in s0:
        live = int((row < emit_kernel.BIGKEY).sum())
        row[:live] = rng.permutation(row[:live])
    s0[2] = rng.integers(-5, O + 10, S)
    s0[2, rng.integers(0, S, 500)] = emit_kernel.BIGKEY
    args = [torch.from_numpy(a).to(cuda) for a in (*fields, out_len)]
    direct, cidx, miss = emit_kernel.emit_bytes(*args, O)
    torch.cuda.synchronize()
    assert direct.shape == cidx.shape == (3, O) and miss.shape == (3,)
    assert int(direct.min()) >= 0 and int(direct.max()) <= 255


@pytest.mark.gpu
@pytest.mark.parametrize("Dt", [8192, 73728, 262144])
@pytest.mark.parametrize("start_chunk", [0, 1, 2, 3])
def test_resolve_wavefront_edge_rows_on_the_card(cuda, Dt, start_chunk):
    names, t0 = corpus.resolve_edge_rows(Dt)
    t0 = torch.from_numpy(t0)
    before = resolve_kernel.launches
    got = resolve_kernel.resolve_wavefront(t0.to(cuda), start_chunk)
    assert resolve_kernel.launches == before + 1
    want = resolve_kernel.resolve_wavefront_reference(t0, start_chunk)
    _equal(got, want)
    # a 3-cycle never converges: its chunks clear ok
    assert bool(want[1][names.index("junk_cycles")]) == (
        start_chunk >= Dt // resolve_kernel.CH)


@pytest.mark.gpu
@pytest.mark.parametrize("D", [512, 106496])
@pytest.mark.parametrize("nt", [1, 3, 7, 8])
def test_hc_tables_edge_rows_on_the_card(cuda, D, nt):
    wa, hs, sticky, nrows = corpus.hc_edge_rows(D)
    wa = torch.from_numpy(wa).to(cuda)
    hs = [torch.from_numpy(h).to(cuda) for h in hs[:nt]]
    before = hash_kernel.hc_launches
    got = hash_kernel.hc_tables(wa, hs, sticky[:nt], nrows[:nt], D)
    assert hash_kernel.hc_launches == before + 1
    _equal(got, hash_kernel.hc_tables_reference(wa, hs, sticky[:nt],
                                                nrows[:nt], D))


@pytest.mark.gpu
@pytest.mark.parametrize("D, cut", [(4096, 0), (4096, 3), (106496, 0)])
def test_mark_chain_edge_rows_on_the_card(cuda, D, cut):
    names, g = corpus.chain_edge_rows(D)
    g = torch.from_numpy(np.ascontiguousarray(g[:, :D - cut]))
    before = chain_kernel.launches
    got = chain_kernel.mark_chain(g.to(cuda), D - cut)
    assert chain_kernel.launches == before + 1
    want = chain_kernel.mark_chain_reference(g, D - cut)
    _equal([got], [want])
    assert int(want[names.index("step_1")].sum()) == D - cut


@pytest.mark.gpu
@pytest.mark.parametrize("N, K", [(128, 1), (128, 3), (128, 5), (256, 7),
                                  (2048, 513), (18688, 18688)])
@pytest.mark.parametrize("nt", [1, 2, 3, 4])
@pytest.mark.parametrize("offset", [0, 1])
def test_table_gather_edge_rows_on_the_card(cuda, N, K, nt, offset):
    """offset 1: the index a view one int past a 16-byte boundary."""
    tables, idx, bits = corpus.gather_edge_rows(N, K)
    tables = [torch.from_numpy(t) for t in tables[:nt]]
    idx = torch.from_numpy(idx)
    flat = torch.cat([idx.new_zeros(offset), idx.flatten()]).to(cuda)
    view = flat[offset:].view(idx.shape)
    assert (view.data_ptr() % 16 != 0) == bool(offset)
    before = fused_gather.table_launches
    got = fused_gather.table_gather([t.to(cuda) for t in tables], view,
                                    bits[:nt])
    assert fused_gather.table_launches == before + 1
    _equal(got, fused_gather.table_gather_reference(tables, idx, bits[:nt]))


@pytest.mark.gpu
@pytest.mark.parametrize("P", [8192, 65536])
def test_prefix_decode_kernels_on_dict_edge_rows(cuda, P):
    """``records_to_state`` at P with each row's window length, and
    ``resolve_wavefront`` at start_chunk P / 8192 on the state words the
    decoder builds from it, against their plain versions; then the whole
    dictionary decode on the card against the CPU path, and the junk
    row's match below the window rejected."""
    rows, (comp, comp_len, out_len, pre, pre_len), C, D = \
        corpus.dict_decode_inputs(P)
    Dt = P + D
    mark, ll, ml, _ = parse_kernel.parse_tokens_reference(comp, comp_len, C)
    args = (comp, mark, ll, ml, comp_len, out_len, pre_len)
    before = records_kernel.launches
    got = records_kernel.records_to_state(*(t.to(cuda) for t in args), C,
                                          Dt, P)
    assert records_kernel.launches == before + 1
    t0m, cidx, stats = records_kernel.records_to_state_reference(*args, C,
                                                                 Dt, P)
    _equal(got, (t0m, cidx, stats))
    lit = torch.cummax(torch.where(cidx >= 0, cidx.clamp(0, C - 1), 0),
                       dim=1).values
    vals, _ = fused_gather.rowbase_gather_reference(comp, lit)
    t0 = torch.where(cidx >= 0, dv.VFLAG | (vals & 0xFF), t0m)
    t0[:, :P] = dv.VFLAG | pre
    before = resolve_kernel.launches
    got = resolve_kernel.resolve_wavefront(t0.to(cuda), P // dv.CH)
    assert resolve_kernel.launches == before + 1
    _equal(got, resolve_kernel.resolve_wavefront_reference(t0, P // dv.CH))

    dev = [t.to(cuda) for t in (comp, comp_len, out_len)]
    _equal(dv.decode_batch_vectorized(*dev, C, D, pre.to(cuda),
                                      pre_len.to(cuda)),
           dv.decode_batch_vectorized(comp, comp_len, out_len, C, D, pre,
                                      pre_len))
    junk = [n.startswith("junk") for n, *_ in rows]
    assert stats[:, 2].tolist() == [int(not j) for j in junk]
    dec = dv.VectorDecoder(cuda)
    good = [r for r, j in zip(rows, junk) if not j]
    assert dec.decode_batch([b for *_, b in good],
                            [len(r) for _, _, r, _ in good],
                            [w for _, w, _, _ in good]) \
        == [r for _, _, r, _ in good]
    assert dec.host_decodes == 0
    bad = rows[junk.index(True)]
    with pytest.raises(reference.CorruptedBlockError, match="window"):
        dec.decode_batch([bad[3]], [len(bad[2])], bad[1])


@pytest.mark.gpu
@pytest.mark.parametrize("P", [8192, 65536])
@pytest.mark.parametrize("window", ["rows", "full", "none", "part"])
def test_prefix_encode_kernels_on_dict_edge_rows(cuda, P, window):
    """The fast encoder's kernels in P mode against their plain versions:
    ``bucket_prev`` over window and record, ``match_lengths`` with
    ``end_abs`` = P + len != ``blk_len``, ``sequence_records`` with each
    row's window length (or P, 0 and P // 3 for every row) and
    ``emit_bytes`` on its records; then the whole P-mode encode on the
    card against the CPU path (the chain record path too)."""
    x, dl, pre_len = corpus.dict_encode_inputs(P)
    pre_len = {"rows": pre_len, "full": torch.full_like(pre_len, P),
               "none": torch.zeros_like(pre_len),
               "part": torch.full_like(pre_len, P // 3)}[window]
    D = x.shape[1]
    _, O, S_cap = ev.batch_shapes(8191, P)
    end_abs = P + dl
    u32 = ev._u32(x)
    us4 = ev._shift_left(u32, 4)
    bargs = (u32, us4, hash_kernel.hash_bucket(u32),
             hash_kernel.hash_bucket8(u32, us4), D)
    prev = hash_kernel.bucket_prev_reference(*bargs)
    _equal([hash_kernel.bucket_prev(*(t.to(cuda) for t in bargs[:4]), D)],
           [prev])
    off = torch.arange(D, dtype=torch.int32) - prev
    dks = ev._top_offsets_select(off, (prev >= 0) & (off <= 65535)
                                 & (off > 4))
    margs = (x, u32, prev, torch.zeros_like(prev), dks, end_abs, dl)
    matched, off_all, mlen_all = mlen_kernel.match_lengths_reference(
        *margs, D, ev.RCAP)
    _equal(mlen_kernel.match_lengths_fused(*(t.to(cuda) for t in margs), D,
                                           ev.RCAP),
           (matched, off_all, mlen_all))
    i = torch.arange(D, dtype=torch.int32)
    matched = matched * ((i >= P) & (off_all <= i - (P - pre_len[:, None])))
    sargs = (u32, matched, off_all, mlen_all, end_abs, pre_len)
    recs = seq_kernel.sequence_records_reference(*sargs, D, S_cap, P,
                                                 ev.CU_ROUNDS)
    before = seq_kernel.launches
    _equal(seq_kernel.sequence_records(*(t.to(cuda) for t in sargs), D,
                                       S_cap, P, ev.CU_ROUNDS), recs)
    assert seq_kernel.launches == before + 1
    assert (recs[1][:, 0] == P).all()         # literals start at P
    eargs = (*recs[:5], recs[5][:, 2].contiguous())
    _equal(emit_kernel.emit_bytes(*(t.to(cuda) for t in eargs), O),
           emit_kernel.emit_bytes_reference(*eargs, O))

    want = ev.encode_batch_vectorized(x, dl, D, O, S_cap, ev.RCAP, 0, None,
                                      P, pre_len)
    dev = (x.to(cuda), dl.to(cuda), D, O, S_cap, ev.RCAP, 0, None, P,
           pre_len.to(cuda))
    _equal(ev.encode_batch_vectorized(*dev), want)
    _equal(ev.encode_batch_chain(*dev), want)


@pytest.mark.gpu
def test_wide_prefix_encode_kernels_on_the_card(cuda):
    """A 96 KB block behind a full 64 KB window (D = 172,032): the three
    widened kernels (``bucket_prev``; ``match_lengths`` with 8 offsets at
    the fast rcap and 24 at HC L9's D // 4; ``sequence_records`` at 2 and
    8 catch-up rounds) and ``emit_bytes`` against their plain versions,
    with windows of 65,536, 0 and 20,000 bytes and shorter blocks; then
    P-mode fast encode of the rows on the card against the CPU path."""
    text = corpus.silesia_like(3 * 65536 + 98304, 21)
    window = text[:65536]
    blocks = [text[65536:65536 + 98304], text[100000:100000 + 98303],
              text[140000:200000], text[131072 - 5:131072 + 40956]]
    x, dl, pre_len, P, D, O, S_cap = ev.window_rows(blocks, window)
    assert (P, D) == (65536, 172032)
    x = torch.from_numpy(x.astype(np.int32))
    for j, cut in ((1, 65536), (2, 45536)):     # windows of 0 and 20,000
        x[j, :cut] = 0
    dl, pre_len = torch.from_numpy(dl), torch.tensor(
        [65536, 0, 20000, 65536], dtype=torch.int32)
    end_abs = P + dl
    u32 = ev._u32(x)
    us4 = ev._shift_left(u32, 4)
    bargs = (u32, us4, hash_kernel.hash_bucket(u32),
             hash_kernel.hash_bucket8(u32, us4))
    prev = hash_kernel.bucket_prev_reference(*bargs, D)
    _equal([hash_kernel.bucket_prev(*(t.to(cuda) for t in bargs), D)],
           [prev])
    off = torch.arange(D, dtype=torch.int32) - prev
    far = (prev >= 0) & (off <= 65535) & (off > 4)
    for K, sub, rcap in ((8, 16, ev.RCAP), (24, 8, D // 4)):
        dks = ev._top_offsets_select(off, far, K, sub)
        margs = (x, u32, prev, torch.zeros_like(prev), dks, end_abs, dl)
        state = mlen_kernel.match_lengths_reference(*margs, D, rcap)
        _equal(mlen_kernel.match_lengths_fused(
            *(t.to(cuda) for t in margs), D, rcap), state)
    matched, off_all, mlen_all = state
    i = torch.arange(D, dtype=torch.int32)
    matched = matched * ((i >= P) & (off_all <= i - (P - pre_len[:, None])))
    sargs = (u32, matched, off_all, mlen_all, end_abs, pre_len)
    for rounds in (ev.CU_ROUNDS, ev.HC_CU_ROUNDS):
        recs = seq_kernel.sequence_records_reference(*sargs, D, S_cap, P,
                                                     rounds)
        _equal(seq_kernel.sequence_records(*(t.to(cuda) for t in sargs),
                                           D, S_cap, P, rounds), recs)
    eargs = (*recs[:5], recs[5][:, 2].contiguous())
    _equal(emit_kernel.emit_bytes(*(t.to(cuda) for t in eargs), O),
           emit_kernel.emit_bytes_reference(*eargs, O))
    enc = ev.VectorEncoder(cuda)
    got = enc.encode_batch(blocks, dictionary=window)
    assert enc.host_encodes == 0
    assert got == ev.VectorEncoder("cpu").encode_batch(blocks,
                                                       dictionary=window)
    assert [reference.decompress_block_dict(p, window, len(b))
            for p, b in zip(got, blocks)] == blocks


@pytest.mark.gpu
def test_big_edge_blocks_on_the_card(cuda):
    """``corpus.big_edge_blocks`` both ways on the card: each hand-made
    block decodes (known and unknown length, and behind a dictionary) to
    its bytes with no host re-decode, and each block's bytes encode, fast
    and at HC level 9, to the CPU path's payload with no host encode."""
    rows = corpus.big_edge_blocks(0)
    datas = [d for _, d, _ in rows]
    blks = [b for *_, b in rows]
    dec = dv.VectorDecoder(cuda)
    assert dec.decode_batch(blks, [len(d) for d in datas]) == datas
    assert dec.decode_batch_unknown(blks, [1 << 20] * len(blks)) == datas
    assert dec.host_decodes == 0
    enc = ev.VectorEncoder(cuda)
    window = corpus.silesia_like(65536, 22)
    for level in (0, 9):
        got = enc.encode_batch(datas, hc_level=level)
        assert got == ev.VectorEncoder("cpu").encode_batch(datas,
                                                           hc_level=level)
        assert dec.decode_batch(got, [len(d) for d in datas]) == datas
        got = enc.encode_batch(datas, hc_level=level, dictionary=window)
        assert dec.decode_batch(got, [len(d) for d in datas],
                                window) == datas
    assert enc.host_encodes == 0 and dec.host_decodes == 0


@pytest.mark.gpu
def test_big_unknown_decode_refuses_malformed_blocks_on_the_card(cuda):
    """A 1 MB block from the card's fast encoder decodes under a 2 MB cap
    with no host re-decode; each of its ``corpus.big_bad_blocks``, which
    the header walk takes, raises the hardened decoder's error."""
    data = corpus.silesia_like(1 << 20, seed=58)
    enc = ev.VectorEncoder(cuda)
    blk = enc.encode_batch([data])[0]
    dec = dv.VectorDecoder(cuda)
    cap = 2 << 20
    assert dec.decode_batch_unknown([blk], [cap]) == [data]
    assert enc.host_encodes == 0 and dec.host_decodes == 0
    for _, bad in corpus.big_bad_blocks(blk):
        with pytest.raises(reference.CorruptedBlockError) as want:
            reference.decompress_block_unknown(bad, cap)
        with pytest.raises(reference.CorruptedBlockError,
                           match=re.escape(str(want.value))):
            dec.decode_batch_unknown([bad], [cap])
    assert dec.host_decodes == 3
