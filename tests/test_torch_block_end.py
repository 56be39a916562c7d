"""The vector decoder's block-end rules (the port's fault C3): the port
refuses what the reference decoders refuse, on its known-length,
unknown-length and dictionary paths, and keeps well-formed blocks at
the same edges on the device path.

* ``corpus.block_end_rows`` (last matches that end 0-7 bytes before the
  end, that start within 12 bytes of the cap, whose length extension
  byte lies in the last 6 compressed bytes) at the known length and
  under caps of n, n + 1, 96 KB and 2 MB: the port's bytes or error
  equal ``models.reference``'s and ``lz4net_tpu.models.reference``'s,
  and the port decodes on the host exactly where the reference refuses
  or parses the block otherwise;
* ``corpus.big_bad_blocks`` of a 30,000-byte block through each path;
* a 1 MB block whose final run is cut to 3 literals, through the big
  known-length path (its header walk), beside the block itself.
"""

import re

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # the test workers share the cores: one intra-op
                           # thread each, or they spin against each other

from lz4net_tpu.models import reference as jref  # noqa: E402
from lz4net_tpu_torch.models import reference  # noqa: E402
from lz4net_tpu_torch.ops import bigblock  # noqa: E402
from lz4net_tpu_torch.ops import decode_vector as dv  # noqa: E402
from lz4net_tpu_torch.utils import corpus  # noqa: E402

ROWS = corpus.block_end_rows(seed=0)
DICT = corpus.silesia_like(5000, seed=21)
# the rows the hardened decoder parses otherwise than the token walk (it
# stops reading the match length 6 bytes before the end): the device pass
# must leave them to the host even where the host decoder accepts them
OTHER_PARSE = {"ext_final_run_4"}


def _outcome(call, error):
    try:
        return call()
    except error as exc:
        return exc


def _check(port, ref, jax_ref, dec, parse_agrees=True):
    """``port()`` gives ``ref()``'s bytes or raises its error, ``jax_ref``
    agrees, and ``dec`` went to the host exactly where the reference
    refused or parses otherwise."""
    want = _outcome(ref, reference.CorruptedBlockError)
    jwant = _outcome(jax_ref, jref.CorruptedBlockError)
    before = dec.host_decodes
    if isinstance(want, Exception):
        assert isinstance(jwant, Exception)
        with pytest.raises(reference.CorruptedBlockError,
                           match=re.escape(str(want))):
            port()
        assert dec.host_decodes == before + 1
    else:
        assert jwant == want
        assert port() == want
        assert dec.host_decodes == before + (0 if parse_agrees else 1)


@pytest.mark.parametrize("name,blk,n", ROWS, ids=[r[0] for r in ROWS])
def test_block_end_rules_at_the_edges(name, blk, n):
    dec = dv.VectorDecoder("cpu")
    _check(lambda: dec.decode_batch([blk], [n])[0],
           lambda: reference.decompress_block(blk, n),
           lambda: jref.decompress_block(blk, n), dec)
    _check(lambda: dec.decode_batch([blk], [n], dictionary=DICT)[0],
           lambda: reference.decompress_block_dict(blk, DICT, n),
           lambda: jref.decompress_block_dict(blk, DICT, n), dec)
    for cap in (n, n + 1, 96 * 1024, 2 << 20):
        _check(lambda: dec.decode_batch_unknown([blk], [cap])[0],
               lambda: reference.decompress_block_unknown(blk, cap),
               lambda: jref.decompress_block_unknown(blk, cap), dec,
               parse_agrees=name not in OTHER_PARSE)


def test_well_formed_edges_stay_on_the_device():
    """The rows every decoder takes decode in one batch with no host
    decode, on each path."""
    good = [(b, n) for name, b, n in ROWS
            if name.startswith(("final_run_5", "final_run_6", "final_run_7",
                                "short_match_8", "ext_final_run_5",
                                "ext_final_run_6", "literals_only"))]
    blocks, lens = [b for b, _ in good], [n for _, n in good]
    want = [reference.decompress_block(b, n) for b, n in good]
    dec = dv.VectorDecoder("cpu")
    assert dec.decode_batch(blocks, lens) == want
    assert dec.decode_batch(blocks, lens, dictionary=DICT) == want
    for caps in (lens, [2 << 20] * len(lens)):
        assert dec.decode_batch_unknown(blocks, caps) == want
    assert dec.host_decodes == 0


@pytest.mark.parametrize("name", ["final_run_cut", "empty_final_run",
                                  "giant_match_at_end"])
def test_big_bad_blocks_of_a_small_block(name):
    """The fault as found: ``empty_final_run`` (its last match, then a
    0x00 token) decoded to 29,990 bytes on every path.  At a known length
    of 30,000, ``giant_match_at_end`` is a block the known-length decoder
    takes: it stops at the literal run that reaches the end and never
    reads the giant match, so the port's token walk parses it otherwise
    and leaves it to the host."""
    blk = reference.compress_block(corpus.silesia_like(30000, seed=3))
    bad = dict(corpus.big_bad_blocks(blk))[name]
    walk = bigblock.scan(bad)[2]
    dec = dv.VectorDecoder("cpu")
    for n in (29990, 30000, 150000):
        _check(lambda: dec.decode_batch([bad], [n])[0],
               lambda: reference.decompress_block(bad, n),
               lambda: jref.decompress_block(bad, n), dec, n == walk)
        _check(lambda: dec.decode_batch([bad], [n], dictionary=DICT)[0],
               lambda: reference.decompress_block_dict(bad, DICT, n),
               lambda: jref.decompress_block_dict(bad, DICT, n), dec,
               n == walk)
    for cap in (29990, 29991, 96 * 1024, 2 << 20):
        _check(lambda: dec.decode_batch_unknown([bad], [cap])[0],
               lambda: reference.decompress_block_unknown(bad, cap),
               lambda: jref.decompress_block_unknown(bad, cap), dec)


def test_big_known_length_decode_keeps_the_rules():
    """A 1 MB block decodes as fragment waves with no host decode; cut
    to 3 final literals, its header walk refuses it before any wave (no
    fragment is held to the rules: mid-block fragments end on a match)."""
    data = corpus.silesia_like(1 << 20, seed=58)
    blk = reference.compress_block(data)
    bad, n = corpus.short_final_run(blk)
    dec = dv.VectorDecoder("cpu")
    assert dec.decode_batch([blk], [len(data)]) == [data]
    assert dec.host_decodes == 0
    _check(lambda: dec.decode_batch([bad], [n])[0],
           lambda: reference.decompress_block(bad, n),
           lambda: jref.decompress_block(bad, n), dec)
    _check(lambda: dec.decode_batch([bad], [n], dictionary=DICT)[0],
           lambda: reference.decompress_block_dict(bad, DICT, n),
           lambda: jref.decompress_block_dict(bad, DICT, n), dec)
