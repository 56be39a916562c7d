"""The edge-case rows of the two decode kernels redesigned for the card,
``parse_tokens`` and ``decode_sequencer``, held between the port's plain
versions and the JAX package on the CPU (tolerance 0: every output is an
integer or a byte).

The rows are ``corpus.decode_edge_rows``: matches at offsets 1-33 and
equal to dp, a 20,000-byte match whose 0xFF length bytes straddle
compressed offset 4096, literal runs across 4 KB boundaries, literal-only
blocks whose lengths sit on and beside multiples of 32, 1024 and 4096, a
text block, and one junk row for each fault rule of
``ops.decode_sequencer``.

* ``parse_tokens``: one JAX call in interpret mode on every row, compared
  where the JAX kernel reports no window miss; and on the well-formed rows
  the marks are the token starts of a plain walk of the block.
* ``decode_sequencer``: the well-formed rows through JAX
  ``PallasDecoder(interpret=True)`` in one batch (bytes and status
  equal), the junk rows through the JAX reference decoder (it raises
  where the port reports a fault).

The same rows hold the kernels against these plain versions on the card
(``tests/test_torch_edge_cases_gpu.py``).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from lz4net_tpu.models import reference as jreference  # noqa: E402
from lz4net_tpu.ops import decode_pallas  # noqa: E402
from lz4net_tpu.ops import parse_kernel as jpk  # noqa: E402
from lz4net_tpu_torch.ops import decode_sequencer as ds  # noqa: E402
from lz4net_tpu_torch.ops import decode_vector as dv  # noqa: E402
from lz4net_tpu_torch.ops import parse_kernel  # noqa: E402
from lz4net_tpu_torch.utils import corpus  # noqa: E402

ROWS = corpus.decode_edge_rows(0)
GOOD = [r for r in ROWS if not r[0].startswith("junk_")]
JUNK = [r for r in ROWS if r[0].startswith("junk_")]


def _token_starts(block):
    """Token start positions and their (literal, match) lengths, by a plain
    walk of a well-formed block."""
    starts, sp = {}, 0
    while sp < len(block):
        q, token = sp, block[sp]
        sp += 1
        lit = token >> 4
        if lit == 15:
            while True:
                sp += 1
                lit += block[sp - 1]
                if block[sp - 1] != 255:
                    break
        sp += lit
        mlen = 4 + (token & 15)
        if sp < len(block):
            sp += 2
            if mlen == 19:
                while True:
                    sp += 1
                    mlen += block[sp - 1]
                    if block[sp - 1] != 255:
                        break
        starts[q] = (lit, mlen)
    return starts


def test_parse_tokens_edge_rows_match_jax_interpret():
    blocks = [b for _, b, _ in ROWS]
    comp, comp_len, _, C, _ = dv.pack_blocks(blocks, [n for *_, n in ROWS])
    jmark, jll, jml, jmiss = (np.asarray(x) for x in jpk.parse_tokens(
        jnp.asarray(comp.astype(np.int32)), jnp.asarray(comp_len), C))
    mark, ll, ml, miss = (t.numpy() for t in parse_kernel.parse_tokens(
        torch.from_numpy(comp.astype(np.int32)), torch.from_numpy(comp_len),
        C))
    assert not miss.any()
    rows = ~jmiss
    assert rows.sum() >= len(ROWS) - 2
    np.testing.assert_array_equal(mark[rows], jmark[rows])
    sel = (jmark == 1) & rows[:, None]
    np.testing.assert_array_equal(ll[sel], jll[sel])
    np.testing.assert_array_equal(ml[sel], jml[sel])
    for i, (name, block, _) in enumerate(GOOD):
        starts = _token_starts(block)
        assert np.flatnonzero(mark[i]).tolist() == sorted(starts), name
        assert [(ll[i, q], ml[i, q]) for q in sorted(starts)] == \
            [starts[q] for q in sorted(starts)], name


def test_decode_sequencer_edge_rows_match_jax():
    blocks = [b for _, b, _ in GOOD]
    lens = [n for *_, n in GOOD]
    L = decode_pallas.LANES
    crows = -(-max(map(len, blocks)) // L) + 2
    drows = -(-max(lens) // L) + 2
    jcomp = np.zeros((len(blocks), crows, L), np.int32)
    jlens = np.zeros((len(blocks), 2), np.int32)
    for i, b in enumerate(blocks):
        jcomp[i].reshape(-1)[:len(b)] = np.frombuffer(b, np.uint8)
        jlens[i] = (len(b), lens[i])
    jout, jstatus = decode_pallas._decode_batch_jit(
        jnp.asarray(jcomp), jnp.asarray(jlens), crows, drows, True)
    jout = np.asarray(jout).reshape(len(blocks), -1)

    C, D = max(map(len, blocks)), max(lens)
    comp = np.zeros((len(blocks), C), np.uint8)
    for i, b in enumerate(blocks):
        comp[i, :len(b)] = np.frombuffer(b, np.uint8)
    out, status = ds.decode_sequencer(
        torch.from_numpy(comp),
        torch.tensor([len(b) for b in blocks], dtype=torch.int32),
        torch.tensor(lens, dtype=torch.int32), D)
    np.testing.assert_array_equal(status.numpy(), np.asarray(jstatus))
    assert status.tolist() == [[len(b), n] for b, n in zip(blocks, lens)]
    assert max(lens) == D            # the long match: out_len == D
    for i, n in enumerate(lens):
        assert out[i, :n].numpy().tobytes() == \
            jout[i, :n].astype(np.uint8).tobytes(), GOOD[i][0]
        assert not out[i, n:].any()


@pytest.mark.parametrize("name, block, out_len", JUNK,
                         ids=[r[0] for r in JUNK])
def test_decode_sequencer_junk_rows_fault_as_the_reference_raises(
        name, block, out_len):
    with pytest.raises(jreference.CorruptedBlockError):
        jreference.decompress_block(block, out_len)
    _, status = ds.decode_sequencer(
        torch.from_numpy(np.frombuffer(block, np.uint8).copy()[None]),
        torch.tensor([len(block)], dtype=torch.int32),
        torch.tensor([out_len], dtype=torch.int32), max(out_len, 1))
    assert status[0, 0] == -1
