"""The port's blocks over 96 KB on the CPU (plain PyTorch versions of the
kernels), held against the JAX package, tolerance 0 (bytes, offsets and
lengths are integers).

* the header walk: ``ops.bigblock.scan`` and ``split_fragments``
  against JAX ``lz4net_tpu.ops.bigblock.split_fragments`` and the native
  library's ``segment_index`` and ``giant_seqs`` on a 400 KB block, on
  ``corpus.big_edge_blocks`` (giant matches and literal runs, a match
  tail under 4 bytes, a final literal run on a boundary, an
  incompressible block) and on malformed blocks, ``None`` included; the
  synthetic pieces (``_synth_literals``, ``_synth_match``) for every
  length 0-600;
* big-block decode (``VectorDecoder``: fragment waves) against the native
  oracle's bytes with no host re-decode: known and unknown length (an
  over-cap block raises the reference's error), behind a dictionary whose
  bytes differ from the block's start, and a batch mixing small and big
  blocks; under a 2 MB cap, ``corpus.big_bad_blocks`` of a 1 MB block
  (its final literal run cut off, or replaced by an empty one or by a
  giant match) raise the hardened decoder's error, as in the JAX
  package;
* big-block fast encode (``VectorEncoder._encode_big``) against JAX
  ``VectorEncoder.encode_batch`` on a 256 KB block of 4 segments, with
  and without a dictionary, and P-mode ``encode_batch_vectorized`` on 4
  dictionary blocks of 64-72 KB at the same [4, 139,264] shape (one JAX
  compile for all three); one HC level-9 big block against JAX at 2
  segments (the second compile).
"""

import random
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # the test workers share the cores: one intra-op
                           # thread each, or they spin against each other

import jax.numpy as jnp  # noqa: E402

from lz4net_tpu.models import native as N  # noqa: E402
from lz4net_tpu.models import reference as jref  # noqa: E402
from lz4net_tpu.ops import bigblock as jbb  # noqa: E402
from lz4net_tpu.ops import decode_vector as jdv  # noqa: E402
from lz4net_tpu.ops import encode_vector as jev  # noqa: E402
from lz4net_tpu_torch.models import reference  # noqa: E402
from lz4net_tpu_torch.ops import bigblock as bb  # noqa: E402
from lz4net_tpu_torch.ops import decode_vector as dv  # noqa: E402
from lz4net_tpu_torch.ops import encode_vector as ev  # noqa: E402
from lz4net_tpu_torch.ops import parse_kernel  # noqa: E402
from lz4net_tpu_torch.utils import corpus  # noqa: E402

pytestmark = pytest.mark.skipif(not N.is_available(),
                                reason="the JAX package's walks are native")

SEG = ev.SEG_SIZE


@pytest.fixture(scope="module")
def edge():
    return corpus.big_edge_blocks(0)


@pytest.fixture(scope="module")
def text_block():
    data = corpus.silesia_like(400 * 1024, seed=51)
    return data, N.compress_block(data)


GOOD = ["text_400k", "giant_match_and_literals", "match_tail_under_4",
        "final_run_at_boundary", "incompressible"]
BAD = ["truncated", "extension_off_the_end", "giant_at_end_wrong_length",
       "more_giants_than_the_walk_holds", "junk"]


def _good(text_block, edge, name):
    """(data, block) of a well-formed test block."""
    if name == "text_400k":
        return text_block
    return next((d, b) for n, d, b in edge if n == name)


def _malformed(text_block, edge, name):
    """(block, out_len) that the walk or the split refuses."""
    _, blk = text_block
    last = edge[-1]                     # one giant literal run
    return {
        "truncated": lambda: (blk[:len(blk) // 2 + 1], 400 * 1024),
        "extension_off_the_end": lambda: (b"\xf0" + b"\xff" * 50, 1000),
        "giant_at_end_wrong_length": lambda: (last[2], len(last[1]) + 1),
        # ten giant matches in 2 KB: more than len // 48 KB + 8
        "more_giants_than_the_walk_holds": lambda: (corpus._lz4_sequences(
            [(b"a", 1, 50000)] * 10, b"tail" * 4), 500016),
        "junk": lambda: (random.Random(3).randbytes(200000), 1 << 20),
    }[name]()


@pytest.mark.parametrize("name", GOOD)
def test_split_fragments_matches_jax(text_block, edge, name):
    data, blk = _good(text_block, edge, name)
    got = bb.split_fragments(blk, len(data))
    assert got is not None
    assert got == jbb.split_fragments(blk, len(data))
    s = bb.scan(blk)
    assert s[2] == len(data)
    offs = N.segment_index(blk, bb.OUT_TARGET)
    assert (s[0], s[1]) == (offs[0].tolist(), offs[1].tolist())
    assert s[3] == N.giant_seqs(blk, bb.OUT_TARGET)
    pos = 0
    for frag, o0, span in got:
        assert o0 == pos and 0 < span <= bb.MAX_SEG_OUT
        pos += span
    assert pos == len(data)
    giants = {"text_400k": None, "giant_match_and_literals": 2,
              "match_tail_under_4": 2, "final_run_at_boundary": 0,
              "incompressible": 1}[name]
    if giants is not None:
        assert len(s[3]) == giants
    if name == "final_run_at_boundary":
        # the final literal run starts on the second boundary
        assert s[1] == [0, 49152, 98304] and got[-1][1] == 98304
    if name == "match_tail_under_4":
        # the 49,154-byte match leaves a 4-byte tail, not a 2-byte one
        assert [n for *_, n in got][1:3] == [49150, 4]


@pytest.mark.parametrize("name", BAD)
def test_split_fragments_refuses_malformed_blocks(text_block, edge, name):
    blk, n = _malformed(text_block, edge, name)
    assert bb.split_fragments(blk, n) is None
    assert jbb.split_fragments(blk, n) is None
    if name == "more_giants_than_the_walk_holds":
        assert bb.scan(blk)[3] is None and N.giant_seqs(
            blk, bb.OUT_TARGET) is None


def test_synthetic_pieces_match_jax():
    rng = random.Random(4)
    for n in range(601):
        data = rng.randbytes(n)
        assert bb._synth_literals(data) == jbb._synth_literals(data)
        if n >= 4:
            for off in (1, 300, 65535):
                assert bb._synth_match(off, n) == jbb._synth_match(off, n)


def _fragment_keys_never_decrease(frags):
    """The plain parse of a wave's fragments: every token's literal and
    match lengths are >= 0, so ``records_to_state``'s estart (their
    running sum) never decreases (the tile expansion's domain)."""
    comp, comp_len, _, C, _ = dv.pack_blocks([f for f, _, _ in frags],
                                             [n for *_, n in frags])
    mark, ll, ml, _ = parse_kernel.parse_tokens_reference(
        torch.from_numpy(comp.astype(np.int32)), torch.from_numpy(comp_len),
        C)
    m = mark == 1
    assert bool((ll[m] >= 0).all()) and bool((ml[m] >= 0).all())


def test_big_decode_matches_native_oracle(text_block, edge):
    data, blk = text_block
    small = corpus.silesia_like(30000, seed=6)
    datas = [data, small] + [d for _, d, _ in edge]
    blocks = [blk, N.compress_block(small)] + [b for *_, b in edge]
    for _, d, b in edge:
        _fragment_keys_never_decrease(bb.split_fragments(b, len(d)))
    dec = dv.VectorDecoder("cpu")
    got = dec.decode_batch(blocks, [len(d) for d in datas])
    assert got == [N.decompress_block(b, len(d))
                   for b, d in zip(blocks, datas)] == datas
    assert dec.decode_batch_unknown(blocks, [1 << 20] * len(blocks)) \
        == datas
    assert dec.host_decodes == 0
    # over its cap: the host's hardened decoder, the reference's error
    with pytest.raises(jref.CorruptedBlockError) as want:
        jref.decompress_block_unknown(blk, len(data) - 1)
    with pytest.raises(reference.CorruptedBlockError,
                       match=re.escape(str(want.value))):
        dec.decode_batch_unknown([blk], [len(data) - 1])
    assert dec.host_decodes == 1


@pytest.fixture(scope="module")
def block_1m():
    return N.compress_block(corpus.silesia_like(1 << 20, seed=58))


@pytest.mark.parametrize("name", ["final_run_cut", "empty_final_run",
                                  "giant_match_at_end"])
def test_big_unknown_decode_refuses_what_the_hardened_decoder_does(
        block_1m, name):
    """``corpus.big_bad_blocks`` of a 1 MB block under a 2 MB cap: the
    header walk takes each, the hardened decoder refuses it, and so do
    the JAX package (whose unknown-length path decodes every block over
    96 KB on its host) and the port, with the reference's error."""
    bad = dict(corpus.big_bad_blocks(block_1m))[name]
    cap = 2 << 20
    assert bb.scan(bad) is not None
    with pytest.raises(jref.CorruptedBlockError) as want:
        jref.decompress_block_unknown(bad, cap)
    with pytest.raises(jref.CorruptedBlockError):
        jdv.VectorDecoder().decode_batch_unknown([bad], [cap])
    dec = dv.VectorDecoder("cpu")
    with pytest.raises(reference.CorruptedBlockError,
                       match=re.escape(str(want.value))):
        dec.decode_batch_unknown([bad], [cap])
    assert dec.host_decodes == 1


def test_big_decode_with_a_dictionary(text_block):
    """Matches from the first 64 KB into a dictionary whose bytes differ
    from the block's start, through each early fragment's window (the
    dictionary's tail, then the block's own output)."""
    text = corpus.silesia_like(300 * 1024, seed=8)
    dictionary = text[200 * 1024:]            # 100 KB, cut to its last 64
    data = (text[:20000] + dictionary[-30000:-20000] + text[20000:60000]
            + dictionary[-9000:] + text[60000:200000])
    blk = N.compress_block_dict(dictionary, data)
    assert blk != N.compress_block(data)
    frags = bb.split_fragments(blk, len(data))
    assert len(frags) >= 4 and frags[1][1] < bb.WINDOW
    dec = dv.VectorDecoder("cpu")
    small = N.compress_block_dict(dictionary, data[:5000])
    assert dec.decode_batch([blk, small], [len(data), 5000], dictionary) \
        == [N.decompress_block_dict(blk, dictionary, len(data)),
            data[:5000]]
    assert dec.host_decodes == 0
    # the wrong window: the host raises the reference's error, or gives
    # the host decoder's bytes
    with pytest.raises(reference.CorruptedBlockError):
        dec.decode_batch([blk], [len(data)], dictionary[-1000:])


@pytest.fixture(scope="module")
def seg_block():
    """256 KB in 4 segments: text, a segment of random bytes (literal
    only: its bytes carry into the next segment), text, and random bytes
    to the end (a trailing literal-only tail)."""
    text = corpus.silesia_like(3 * SEG, seed=54)
    rng = random.Random(5)
    return (text[:SEG] + rng.randbytes(SEG) + text[SEG:2 * SEG]
            + rng.randbytes(SEG))


def test_big_fast_encode_matches_jax(seg_block):
    """One 256 KB block, 4 segment rows of 139,264 positions, then the
    same block behind a dictionary, then 4 dictionary blocks of 64-72 KB
    in P mode at the same shape: one JAX compile for the three."""
    enc = ev.VectorEncoder("cpu")
    jenc = jev.VectorEncoder()
    got = enc.encode_batch([seg_block])[0]
    assert got == jenc.encode_batch([seg_block])[0]
    assert reference.decompress_block(got, len(seg_block)) == seg_block
    # the port's segments: the second and the fourth are literal-only
    x, lens, pre_len, P, D, O, S_cap = ev.segment_rows(
        [seg_block], ev.big_segments([seg_block]))
    assert (x.shape, P, D) == ((4, 139264), 65536, 139264)
    x = x.astype(np.int32)
    want = jev.encode_batch_vectorized(
        jnp.asarray(x), jnp.asarray(lens), D, O, S_cap, rcap=ev.RCAP,
        hc_level=0, P=P, pre_len=jnp.asarray(pre_len), fused=False)
    port = ev.encode_batch_vectorized(
        torch.from_numpy(x), torch.from_numpy(lens), D, O, S_cap, ev.RCAP,
        0, None, P, torch.from_numpy(pre_len))
    for g, w in zip(port, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    aux = port[3].numpy()
    assert (aux[[1, 3]] == SEG).all() and (aux[[0, 2]] < SEG).all()

    window = corpus.silesia_like(80000, seed=56)
    got = enc.encode_batch([seg_block], dictionary=window)[0]
    assert got == jenc.encode_batch([seg_block], dictionary=window)[0]
    assert reference.decompress_block_dict(got, window, len(seg_block)) \
        == seg_block

    text = corpus.silesia_like(4 * 73727, seed=57)
    records = [text[:65536], text[70000:70000 + 73727],
               text[150000:150000 + 69999], window[:70000]]
    xr, dl, pl, Pr, Dr, *_ = ev.window_rows(records, window)
    assert (Pr, Dr) == (P, D)
    xr = xr.astype(np.int32)
    pl[1] = 20000
    xr[1, :P - 20000] = 0
    want = jev.encode_batch_vectorized(
        jnp.asarray(xr), jnp.asarray(dl), D, O, S_cap, rcap=ev.RCAP,
        hc_level=0, P=P, pre_len=jnp.asarray(pl), fused=False)
    port = ev.encode_batch_vectorized(
        torch.from_numpy(xr), torch.from_numpy(dl), D, O, S_cap, ev.RCAP,
        0, None, P, torch.from_numpy(pl))
    for g, w in zip(port, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert bool(port[2].all())
    assert enc.host_encodes == 0


def test_big_hc_encode_matches_jax():
    """HC level 9 on a 120 KB block, 2 segment rows (the file's second
    JAX compile)."""
    data = corpus.silesia_like(120 * 1024, seed=55)
    enc = ev.VectorEncoder("cpu")
    got = enc.encode_batch([data], hc_level=9)[0]
    assert got == jev.VectorEncoder().encode_batch([data], hc_level=9)[0]
    assert enc.host_encodes == 0
    assert reference.decompress_block(got, len(data)) == data
    # a batch of a small and a big block: the big one's payload as alone
    mixed = enc.encode_batch([data[:3000], data], hc_level=9)
    assert mixed[1] == got
    assert reference.decompress_block(mixed[0], 3000) == data[:3000]
