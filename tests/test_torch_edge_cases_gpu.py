"""The redesigned ``match_lengths`` and ``encode_sequencer`` kernels held
bit for bit against their plain versions on the card, on rows made to
reach their edge cases, with the launch counts checked.

``match_lengths``: equal runs at offsets 1-4 and at dominant offsets that
cross the 32-position words of the break bitmasks and their level
boundaries and reach the block's end, at K = 0, 8 and 24 dominant offsets
and at D = 106496.  ``encode_sequencer``: the rows and budgets of
``corpus.strict_edge_rows`` on both of its kernels (rows staged in shared
memory, and the same rows padded to 256 KB for the one-thread kernel),
and rows at the widest width staged in shared memory (``row_max``) and
one byte wider.  ``parse_tokens`` and ``decode_sequencer``: the rows of
``corpus.decode_edge_rows`` (for ``parse_tokens`` packed with seeded junk
rows, ``corpus.parse_edge_rows``), and
``decode_sequencer`` on output rows at its ``row_max`` and one byte wider.

The tests carry the ``gpu`` marker and skip without a CUDA device; on a
machine with one (no JAX needed) run them with

    python -m pytest --noconftest -m gpu tests/test_torch_edge_cases_gpu.py

``mlen_edge_rows`` is shared with ``tests/test_torch_edge_cases.py``,
which holds the plain versions against the JAX package on the CPU.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from lz4net_tpu_torch.models import reference  # noqa: E402
from lz4net_tpu_torch.ops import decode_sequencer as ds  # noqa: E402
from lz4net_tpu_torch.ops import encode_sequencer as es  # noqa: E402
from lz4net_tpu_torch.ops import encode_vector as ev  # noqa: E402
from lz4net_tpu_torch.ops import mlen_kernel  # noqa: E402
from lz4net_tpu_torch.ops import parse_kernel  # noqa: E402
from lz4net_tpu_torch.utils import corpus  # noqa: E402

# (K, sub_step, D, rcap): the fast path's 8 offsets, the HC tiers' 24,
# none, and the widest block the kernel takes
MLEN_CASES = [(0, 16, 8192, 512), (8, 16, 8192, 1024), (24, 8, 8192, 8192),
              (24, 8, 106496, 26624)]


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
                                    3 * q, 5000, D - 32)
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
    the one-thread kernel (the same rows in 256 KB rows); written and
    every payload byte equal to the plain version's."""
    rows = corpus.strict_edge_rows(0)
    width = max(len(d) for _, d, _ in rows)
    if wide:
        width = 1 << 18
    assert (width > es.row_max(cuda)) == wide
    src, lens, cap = _strict_batch(rows, width)
    O = int(cap.max())
    before = es.launches
    out, written = es.encode_sequencer(src.to(cuda), lens.to(cuda),
                                       cap.to(cuda), O)
    assert es.launches == before + 1
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
    card and one byte wider (the one-thread kernel): text, zeros, noise
    and a short row, each payload equal to the plain version's."""
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
    before = es.launches
    out, written = es.encode_sequencer(src.to(cuda), lens.to(cuda),
                                       cap.to(cuda), O)
    assert es.launches == before + 1
    want, want_written = es.encode_sequencer_reference(src, lens, cap, O)
    assert written.cpu().tolist() == want_written.tolist()
    assert (want_written > 0).all()
    for (name, _, _), g, w, n in zip(rows, out.cpu(), want,
                                     want_written.tolist()):
        assert torch.equal(g[:n], w[:n]), name


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
