"""The port's sequencer decode on the CPU (``decode_sequencer``'s plain
version), held against the JAX package:

* on well-formed blocks (the cases of ``tests/test_tpu_decode.py``, one
  batch), bytes and status ``(sp, dp)`` equal the JAX kernel's
  (``decode_pallas``, interpret mode), exactly;
* a 64 KB block against the JAX package's ``reference.decompress_block``;
* on junk the rule is one-sided: wherever the JAX kernel's status
  rejects a block, the port raises ``CorruptedBlockError``, and a block
  the port accepts decodes to the reference decoder's bytes.
"""

import hashlib
import random

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # the test workers share the cores: one intra-op
                           # thread each, or they spin against each other

import jax.numpy as jnp  # noqa: E402

from lz4net_tpu.models import reference as jreference  # noqa: E402
from lz4net_tpu.ops import decode_pallas  # noqa: E402
from lz4net_tpu_torch.models import cuda as cuda_engine  # noqa: E402
from lz4net_tpu_torch.models import reference  # noqa: E402
from lz4net_tpu_torch.ops import decode_sequencer as ds  # noqa: E402
from lz4net_tpu_torch.utils import corpus  # noqa: E402

CASES = {
    "text": (b"the quick brown fox jumps over the lazy dog. " * 100)[:3000],
    "rle1": b"\x07" * 4000,
    "rle2": b"ab" * 2000,
    "period7": b"abcdefg" * 500,
    "period100": bytes(range(100)) * 40,
    "incompressible": bytes(map(random.Random(5).randrange, [256] * 2500)),
    "tiny": b"x" * 13,
    "pure_literal_tail": b"0123456789abcdef" * 4,
    "long_literal_run": b"".join(hashlib.sha256(bytes([i])).digest()
                                 for i in range(20)) + b"Z" * 100,
}


def _jax_status(blocks, out_lens):
    """The JAX kernel's (out, status) for a batch, packed as
    ``PallasDecoder.decode_batch`` packs it."""
    L = decode_pallas.LANES
    crows = -(-max(map(len, blocks)) // L) + 2
    drows = -(-max(out_lens) // L) + 2
    comp = np.zeros((len(blocks), crows, L), np.int32)
    lens = np.zeros((len(blocks), 2), np.int32)
    for i, b in enumerate(blocks):
        comp[i].reshape(-1)[:len(b)] = np.frombuffer(b, np.uint8)
        lens[i] = (len(b), out_lens[i])
    out, status = decode_pallas._decode_batch_jit(
        jnp.asarray(comp), jnp.asarray(lens), crows, drows, True)
    return np.asarray(out).reshape(len(blocks), -1), np.asarray(status)


def _plain(blocks, out_lens):
    C, D = max(map(len, blocks)), max(out_lens)
    comp = np.zeros((len(blocks), C), np.uint8)
    for i, b in enumerate(blocks):
        comp[i, :len(b)] = np.frombuffer(b, np.uint8)
    out, status = ds.decode_sequencer(
        torch.from_numpy(comp),
        torch.tensor([len(b) for b in blocks], dtype=torch.int32),
        torch.tensor(out_lens, dtype=torch.int32), D)
    return out.numpy(), status.numpy()


def test_plain_matches_pallas_decoder_on_well_formed_blocks():
    datas = list(CASES.values())
    packed = [reference.compress_block(d) for d in datas]
    lens = [len(d) for d in datas]
    jout, jstatus = _jax_status(packed, lens)
    out, status = _plain(packed, lens)
    np.testing.assert_array_equal(status, jstatus)
    np.testing.assert_array_equal(status, [(len(p), n) for p, n in
                                           zip(packed, lens)])
    for i, n in enumerate(lens):
        assert out[i, :n].tobytes() == jout[i, :n].astype(np.uint8).tobytes()
        assert not out[i, n:].any()
    assert decode_pallas.PallasDecoder(interpret=True).decode_batch(
        packed, lens) == datas
    assert ds.SequencerDecoder("cpu").decode_batch(packed, lens) == datas


def test_plain_matches_reference_at_64k():
    data = corpus.silesia_like(1 << 16, seed=6)
    packed = reference.compress_block(data)
    out, status = _plain([packed], [len(data)])
    assert status.tolist() == [[len(packed), len(data)]]
    assert out[0].tobytes() == jreference.decompress_block(packed,
                                                           len(data))
    assert ds.SequencerDecoder("cpu").decode_batch([packed], [len(data)]) \
        == [data]


def _junk():
    rng = np.random.default_rng(5)
    text = CASES["text"]
    packed = reference.compress_block(text)
    off0 = bytearray(reference.compress_block(b"abcd" * 50))
    off0[5:7] = b"\x00\x00"          # the first match's offset
    return {
        "truncated": (packed[:len(packed) // 2], len(text)),
        "random_4000": (rng.integers(0, 256, 4000, np.uint8).tobytes(), 9000),
        "random_9000": (rng.integers(0, 256, 9000, np.uint8).tobytes(),
                        20000),
        "all_ff": (b"\xff" * 3000, 4000),
        "offset_0": (bytes(off0), 200),
        # a literal, then a match that ends the block
        "ends_in_a_match": (b"\x15a\x01\x00", 10),
        "long_out_len": (packed, len(text) + 1),
    }


JUNK = _junk()


@pytest.fixture(scope="module")
def jax_rejects():
    blocks, lens = zip(*JUNK.values())
    _, status = _jax_status(list(blocks), list(lens))
    return {name: (int(s[0]), int(s[1])) != (len(b), n)
            for (name, (b, n)), s in zip(JUNK.items(), status)}


@pytest.mark.parametrize("name", list(JUNK))
def test_junk_raises_wherever_jax_rejects(name, jax_rejects):
    block, n = JUNK[name]
    dec = ds.SequencerDecoder("cpu")
    try:
        got = dec.decode_batch([block], [n])[0]
    except reference.CorruptedBlockError:
        return
    assert not jax_rejects[name]
    assert got == jreference.decompress_block(block, n)


@pytest.mark.parametrize("name", ["ends_in_a_match", "offset_0"])
def test_port_is_stricter_than_the_tpu_kernel(name, jax_rejects):
    """The TPU kernel's status accepts a block that ends in a match and
    a match of offset 0; the reference decoder and the port reject
    both.  It rejects every other junk row."""
    block, n = JUNK[name]
    assert not jax_rejects[name]
    with pytest.raises(jreference.CorruptedBlockError):
        jreference.decompress_block(block, n)
    _, status = _plain([block], [n])
    assert status[0, 0] == -1
    assert all(jax_rejects[k] for k in JUNK if k not in (
        "ends_in_a_match", "offset_0"))


def test_sequencer_decoder_raises_where_the_engine_decodes():
    """The engine's decode (the vector decoder) and the sequencer decoder
    give the same bytes; on a truncated block the sequencer decoder
    raises with no host re-decode, as the engine's decoder does after its
    host re-decode."""
    data = CASES["text"]
    packed = reference.compress_block(data)
    dec = ds.SequencerDecoder("cpu")
    assert cuda_engine.decompress_block(packed, len(data), device="cpu") \
        == dec.decode_batch([packed], [len(data)])[0] == data
    for decode in (dec.decode_batch, lambda b, n: cuda_engine.
                   decompress_blocks(b, n, device="cpu")):
        with pytest.raises(reference.CorruptedBlockError):
            decode([packed[:len(packed) // 2]], [len(data)])
