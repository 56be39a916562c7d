"""The port's native host engine (``lz4net_tpu_torch.models.native``, the
port's copy of the JAX package's C++ oracle) on the CPU.

* its encoders (strict, HC at levels 1, 5 and 9, dictionary and HC
  dictionary) give the bytes of ``lz4net_tpu.models.native`` and of the
  port's ``models.reference`` at 0 B to 1 MB of two kinds of data, also
  under output budgets at and around the payload's length, and write
  inside their buffer under budgets at the match-length check of 1 and
  4 MB of zeros;
* its decoders (known length, unknown length, dictionary, fragment) give
  the Python decoders' bytes or raise their errors, message for message,
  on a seeded mutation fuzz of small blocks;
* the batched, multithreaded calls equal the one-block calls;
* its header walks (``scan``, ``unknown_output_length``) equal the Python
  walks (``bigblock.scan_reference``, ``reference.unknown_output_length``)
  on the malformed and edge blocks of big-block decode and on 1 MB
  blocks.

No JAX compile: the JAX package's library is called through ctypes.
"""

import functools
import hashlib
import random

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # the test workers share the cores: one intra-op
                           # thread each, or they spin against each other

from lz4net_tpu.models import native as jnative  # noqa: E402
from lz4net_tpu_torch.models import native, reference  # noqa: E402
from lz4net_tpu_torch.ops import bigblock  # noqa: E402
from lz4net_tpu_torch.utils import corpus  # noqa: E402

pytestmark = pytest.mark.skipif(not jnative.is_available(),
                                reason="the JAX package's library is native")

Err = reference.CorruptedBlockError
SIZES = (0, 1, 12, 13, 4096, 65536, 98304, 1 << 20)
MODES = ("strict", "hc1", "hc5", "hc9", "dict", "hc_dict")
# the Python encoders are scalar: where their bytes are compared too
# (the JAX library's bytes are compared everywhere)
REFERENCE_AT = {"strict": 1 << 20, "dict": 98304, "hc9": 65536,
                "hc1": 4096, "hc5": 4096, "hc_dict": 4096}


def _mixed(size: int, seed: int = 0) -> bytes:
    """A compressible and incompressible mix (the JAX package's
    ``tests/test_native_oracle.py``)."""
    out = bytearray()
    words = [b"the quick brown fox ", b"lorem ipsum dolor ",
             b"0123456789abcdef", b"zzzzzzzzzzzzzzzz"]
    i = seed
    while len(out) < size:
        h = hashlib.sha256(i.to_bytes(4, "little")).digest()
        if h[0] % 3 == 0:
            out += h[:1 + h[1] % 24]
        else:
            out += words[h[2] % len(words)] * (1 + h[3] % 6)
        i += 1
    return bytes(out[:size])


@functools.cache
def _data(kind: str, n: int) -> bytes:
    return (corpus.silesia_like(n, seed=5) if kind == "silesia"
            else _mixed(n, seed=n))


@functools.cache
def _dictionary(kind: str) -> bytes:
    """A dictionary past the 64 KB window for one kind, a short one for
    the other."""
    return (corpus.silesia_like(70_000, seed=9) if kind == "silesia"
            else _mixed(4096, seed=77))


@functools.cache
def _text() -> bytes:
    return corpus.silesia_like(1 << 18, seed=31)


def _encoders(mode: str, window: bytes):
    """(port, JAX library, port reference) encoders of ``mode``, each
    ``f(data, dst_maxlen)``."""
    if mode.startswith("hc") and mode != "hc_dict":
        att = 1 << int(mode[2:])
        return tuple(lambda d, cap, m=m: m.compress_block_hc(d, cap, att)
                     for m in (native, jnative, reference))
    if mode == "strict":
        return tuple(lambda d, cap, m=m: m.compress_block(d, cap)
                     for m in (native, jnative, reference))
    name = "compress_block_dict" if mode == "dict" else \
        "compress_block_hc_dict"
    return tuple(lambda d, cap, f=getattr(m, name): f(window, d, cap)
                 for m in (native, jnative, reference))


@pytest.mark.parametrize("kind", ["silesia", "mixed"])
@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("mode", MODES)
def test_encoders_give_the_reference_bytes(mode, n, kind):
    data = _data(kind, n)
    window = _dictionary(kind)
    port, jax_lib, ref = _encoders(mode, window)
    want = jax_lib(data, None)
    assert port(data, None) == want
    if n <= REFERENCE_AT[mode]:
        assert ref(data, None) == want
    if n:
        assert native.decompress_block_dict(
            want, window if "dict" in mode else b"", n) == data
    # budgets at and around the payload, below 1 MB (where they cost
    # little): the same bytes or the same b""
    caps = {len(want) - 1, len(want), len(want) + 8, 0} if n < 1 << 20 \
        else ()
    for cap in caps:
        got = port(data, cap)
        assert got == jax_lib(data, cap)
        if n <= 4096 and "dict" not in mode:
            assert got == ref(data, cap)


def _outcome(call):
    """``call()``'s bytes, or its CorruptedBlockError's message."""
    try:
        return call()
    except Err as exc:
        return ("raised", str(exc))


def _mutate(rng: random.Random, blk: bytes) -> tuple[str, bytes]:
    """One of the fuzz's mutations of ``blk``."""
    kind = rng.choice(["flip", "cut", "append", "tail", "none"])
    b = bytearray(blk)
    if kind == "flip" and b:
        for _ in range(rng.randint(1, 3)):
            b[rng.randrange(len(b))] ^= 1 << rng.randrange(8)
    elif kind == "cut" and b:
        del b[rng.randrange(len(b)):]
    elif kind == "append":
        b += rng.randbytes(rng.randint(1, 6))
    elif kind == "tail" and b:
        k = rng.randint(1, min(6, len(b)))
        b[-k:] = rng.randbytes(k)
    return kind, bytes(b)


def _slice(rng: random.Random, n: int) -> bytes:
    at = rng.randrange(len(_text()) - n + 1)
    return _text()[at:at + n]


def _fuzz_cases(seed: int, count: int):
    """(block, its source length, window) triples: blocks of 1 B to 8 KB
    compressed behind a window or none, then mutated."""
    rng = random.Random(seed)
    for _ in range(count):
        n = int(2 ** rng.uniform(0, 13))
        data = _slice(rng, n) if rng.random() < 0.7 else rng.randbytes(n)
        window = _slice(rng, rng.choice([0, 100, 5000]))
        blk = (native.compress_block_dict(window, data) if window
               else native.compress_block(data))
        yield _mutate(rng, blk)[1], n, window


@pytest.mark.parametrize("seed", range(10))
def test_decoders_on_a_mutation_fuzz(seed):
    """50 mutated blocks a seed, each through the known-length decoder at
    n - 1, n and n + 1, the unknown-length decoder under caps of n, n +
    100 and 128 KB, the dictionary decoder and the fragment decoder:
    the Python decoders' bytes, or their error."""
    for blk, n, window in _fuzz_cases(seed, 50):
        for m in {max(n - 1, 0), n, n + 1}:
            assert _outcome(lambda: native.decompress_block(blk, m)) == \
                _outcome(lambda: reference.decompress_block(blk, m))
            assert _outcome(lambda: native.decompress_block_dict(
                blk, window, m)) == _outcome(
                lambda: reference.decompress_block_dict(blk, window, m))
            assert _outcome(lambda: native.decompress_fragment(
                blk, window, m)) == _outcome(
                lambda: reference.decompress_fragment(blk, window, m))
        for cap in (n, n + 100, 128 * 1024):
            want = _outcome(lambda: reference.decompress_block_unknown(
                blk, cap))
            assert _outcome(lambda: native.decompress_block_unknown(
                blk, cap)) == want
            assert _outcome(lambda: native.unknown_output_length(
                blk, cap)) == (len(want) if isinstance(want, bytes)
                               else want)


def test_empty_and_zero_length_blocks_follow_the_reference():
    """An output length of 0 takes only a first token without literals,
    as the reference decoder (the JAX library returns b"" for any
    block)."""
    for blk in (b"", b"\x00", b"\x00junk", b"\x10a", b"\xf0"):
        for m in (0, 1):
            assert _outcome(lambda: native.decompress_block(blk, m)) == \
                _outcome(lambda: reference.decompress_block(blk, m))
            assert _outcome(lambda: native.decompress_block_dict(
                blk, b"win", m)) == _outcome(
                lambda: reference.decompress_block_dict(blk, b"win", m))
        assert _outcome(lambda: native.decompress_block_unknown(blk, 9)) \
            == _outcome(lambda: reference.decompress_block_unknown(blk, 9))
    assert native.compress_block(b"") == native.compress_block_hc(b"") \
        == native.compress_block_dict(b"win", b"") == b""


def test_long_length_extensions_do_not_wrap():
    """A literal length of 15 + 255 x 9 Mi passes 2**31: the sums are 64
    bits wide, so each decoder and walk refuses the block as the Python
    one does (its messages, not run here: the Python decoders walk the
    9 MB a byte at a time)."""
    blk = b"\xf0" + b"\xff" * (9 << 20) + b"\x01" + b"abc"
    with pytest.raises(Err, match="^literal run overruns block end$"):
        native.decompress_block(blk, 100)
    with pytest.raises(Err, match="^output overflow$"):
        native.decompress_block_unknown(blk, 1 << 30)
    with pytest.raises(Err, match="^literal run overruns the fragment$"):
        native.decompress_fragment(blk, b"", 100)
    assert native.scan(blk, bigblock.OUT_TARGET) is None
    # lengths past the C ints are refused before any call, and a budget
    # past the worst case is the worst case (nothing that size is made)
    with pytest.raises(ValueError, match="2 GB"):
        native.decompress_block(b"\x00", 1 << 31)
    with pytest.raises(ValueError, match="2 GB"):
        native.decompress_fragment(b"\x00", b"w", (1 << 31) - 1)
    data = _data("mixed", 4096)
    assert native.compress_block(data, 1 << 40) == \
        native.compress_block(data) == jnative.compress_block(data)


@pytest.mark.parametrize("n", [1 << 20, 4 << 20])
def test_budgets_at_the_length_checks_write_inside_the_buffer(n):
    """Budgets at the match-length check of n bytes of zeros (one match
    of n - 10 bytes): the check counts its 255-bytes as length >> 8, so
    the parse that passes it writes about n / 65,280 bytes past the
    budget before its last check refuses it; the payload buffer holds
    the worst case (at 4 MB a buffer of the budget's size was overrun and
    the heap corrupted).  Both give b"", as the reference."""
    zeros = bytes(n)
    for budget in (9 + ((n - 10) >> 8), 10 + ((n - 10) >> 8)):
        assert native.compress_block(zeros, budget) == b"" == \
            reference.compress_block(zeros, budget)
    assert native.compress_block(zeros) == reference.compress_block(zeros)


def test_batched_calls_equal_the_one_block_calls():
    rng = random.Random(4)
    blocks = [_slice(rng, n) for n in [0, 1, 13, 4096, 30000, 65536, 70000]
              + [rng.randrange(1, 9000) for _ in range(25)]]
    src = b"".join(blocks)
    lens = [len(b) for b in blocks]
    offs = np.cumsum([0] + lens[:-1])
    for att in (0, 32):
        packed, sizes = native.compress_blocks(src, offs, lens,
                                               hc_attempts=att)
        one = [native.compress_block_hc(b, None, att) if att
               else native.compress_block(b) for b in blocks]
        assert sizes.tolist() == [len(p) for p in one]
        assert packed == b"".join(one)
    payloads = [native.compress_block(b) for b in blocks if b]
    plens = [len(p) for p in payloads]
    poffs = np.cumsum([0] + plens[:-1])
    out, read = native.decompress_blocks(b"".join(payloads), poffs, plens,
                                         [n for n in lens if n])
    assert out == b"".join(b for b in blocks if b)
    assert read.tolist() == plens
    bad = payloads[:3] + [payloads[3][:-7]] + payloads[4:]
    blens = [len(p) for p in bad]
    with pytest.raises(Err) as got:
        native.decompress_blocks(b"".join(bad), np.cumsum([0] + blens[:-1]),
                                 blens, [n for n in lens if n])
    with pytest.raises(Err) as want:
        reference.decompress_block(bad[3], lens[4])
    assert str(got.value) == str(want.value)


WALKS = ["1mb_silesia", "1mb_mixed"] + [
    f"{tag}_{name}" for tag in ("1mb", "30k")
    for name in ("final_run_cut", "empty_final_run", "giant_match_at_end",
                 "short_final_run")] + [
    "giant_match_and_literals", "match_tail_under_4",
    "final_run_at_boundary", "incompressible", "truncated",
    "extension_off_the_end", "giant_at_end_cut",
    "more_giants_than_the_walk_holds", "ends_on_a_match", "junk", "empty",
    "one_token", "offset_cut"]


@pytest.fixture(scope="module")
def walk_blocks():
    """The blocks of the walks: the malformed and edge blocks of big-block
    decode, and two 1 MB blocks."""
    big = [native.compress_block(corpus.silesia_like(1 << 20, seed=61)),
           native.compress_block(_mixed(1 << 20, seed=3))]
    small = native.compress_block(corpus.silesia_like(30000, seed=3))
    rows = {"1mb_silesia": big[0], "1mb_mixed": big[1]}
    for tag, blk in (("1mb", big[0]), ("30k", small)):
        rows.update((f"{tag}_{n}", b) for n, b in corpus.big_bad_blocks(blk))
        rows[f"{tag}_short_final_run"] = corpus.short_final_run(blk)[0]
    edge = corpus.big_edge_blocks(0)
    rows.update((n, b) for n, _, b in edge)
    rows.update({
        "truncated": big[0][:len(big[0]) // 2 + 1],
        "extension_off_the_end": b"\xf0" + b"\xff" * 50,
        "giant_at_end_cut": edge[-1][2][:-1],
        "more_giants_than_the_walk_holds": corpus._lz4_sequences(
            [(b"a", 1, 50000)] * 10, b"tail" * 4),
        "ends_on_a_match": b"\x11a\x01\x00",
        "junk": random.Random(3).randbytes(200000),
        "empty": b"", "one_token": b"\x00", "offset_cut": b"\x10a\x01",
    })
    assert set(rows) == set(WALKS)
    return rows


@pytest.mark.parametrize("name", WALKS)
def test_walks_equal_the_python_walks(walk_blocks, name):
    blk = walk_blocks[name]
    got = bigblock.scan(blk)
    assert got == bigblock.scan_reference(blk)
    caps = {2 << 20} if got is None else {got[2], max(got[2] - 1, 0)}
    for cap in caps:
        assert _outcome(lambda: native.unknown_output_length(blk, cap)) == \
            _outcome(lambda: reference.unknown_output_length(blk, cap))
