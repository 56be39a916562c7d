"""The port's preset-dictionary and unknown-length slice and its facade on
the CPU (plain PyTorch versions of the kernels), held against the JAX
package, tolerance 0 (bytes and certificates are integers).

* the port's host codecs (``models.reference``: ``compress_block_dict``,
  ``compress_block_hc_dict``, ``decompress_block_dict``,
  ``decompress_block_unknown``) against the JAX package's, pure Python;
* dictionary decode: ``decode_batch_vectorized(..., pre, pre_len)`` on
  ``corpus.dict_edge_rows`` at P = 8192 (windows of 0, 1, 5000, 8191 and
  8192 bytes, matches across the seam, a far match onto the window's
  first byte, a record inside the window, an empty record and a match one
  byte below the window) against the JAX XLA branch in all six outputs;
* dictionary fast encode: ``encode_batch_vectorized(..., P=8192,
  pre_len)`` on the same rows, and ``VectorEncoder.encode_batch(
  dictionary=)``, against the JAX encoder's bytes (``fused=False``, one
  compile shared by both); the chain record path in P mode against the
  sequence path; fast-HC in P mode by round trip (a JAX HC compile at
  this shape would cost more than the file's budget), and HC level 9 at
  the dictionary-records cell's row shape (P = 65,536, D = 73,728)
  against the JAX encoder's bytes (one compile);
* the facade: ``wrap``, ``wrap_hc`` and ``unwrap`` against
  ``lz4net_tpu.codec``'s envelopes, strict (HC and dictionary) encode,
  ``decode``'s three modes and its argument errors.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # the test workers share the cores: one intra-op
                           # thread each, or they spin against each other

import jax.numpy as jnp  # noqa: E402

import lz4net_tpu as jlz4  # noqa: E402
from lz4net_tpu.models import reference as jref  # noqa: E402
from lz4net_tpu.ops import decode_vector as jdv  # noqa: E402
from lz4net_tpu.ops import encode_vector as jev  # noqa: E402
from lz4net_tpu_torch import codec  # noqa: E402
from lz4net_tpu_torch.models import cuda as cuda_engine  # noqa: E402
from lz4net_tpu_torch.models import reference  # noqa: E402
from lz4net_tpu_torch.ops import decode_vector as dv  # noqa: E402
from lz4net_tpu_torch.ops import encode_vector as ev  # noqa: E402
from lz4net_tpu_torch.ops import host_rows  # noqa: E402
from lz4net_tpu_torch.utils import corpus  # noqa: E402

P = 8192
DICT = (b"GET /api/v1/users HTTP/1.1\r\nHost: example.com\r\n"
        b"Content-Type: application/json\r\nAuthorization: Bearer "
        b'{"user_id": 12345, "session": "abcdef", "permissions": ["read"]}'
        ) * 8
RECORD = (b'{"user_id": 98765, "session": "zyxwvu", "permissions": '
          b'["read", "write"], "host": "example.com"}')


def _host_cases():
    """(dictionary, data) pairs: tests/test_dictionary.py's inputs, then
    corpus slices against windows before and around them."""
    text = corpus.silesia_like(40000, seed=9)
    return [(DICT, RECORD), (DICT, RECORD * 40), (DICT, DICT[100:160]),
            (DICT, b"completely unrelated bytes 123"), (b"", RECORD * 3),
            (DICT, b""), (text[:8000], text[8000:12000]),
            (text[20000:21000], text[:3000] + text[20500:21500]),
            (text[30000:30001], b"x" * 600)]


def test_host_codecs_match_jax_reference():
    for dictionary, data in _host_cases():
        packed = reference.compress_block_dict(dictionary, data)
        assert packed == jref.compress_block_dict(dictionary, data)
        for attempts in (256, 16):
            assert reference.compress_block_hc_dict(
                dictionary, data, None, attempts) \
                == jref.compress_block_hc_dict(dictionary, data, None,
                                               attempts)
        if data:
            assert reference.decompress_block_dict(
                packed, dictionary, len(data)) == data \
                == jref.decompress_block_dict(packed, dictionary, len(data))
            plain = reference.compress_block(data)
            for cap in (len(data), len(data) + 77):
                assert reference.decompress_block_unknown(plain, cap) \
                    == data == jref.decompress_block_unknown(plain, cap)
    # the budget rule: b"" when the payload does not fit
    dictionary, data = _host_cases()[1]
    n = len(reference.compress_block_dict(dictionary, data))
    assert reference.compress_block_dict(dictionary, data, n - 1) == b"" \
        == jref.compress_block_dict(dictionary, data, n - 1)


@pytest.mark.parametrize("case", ["short_cap", "truncated", "empty",
                                  "offset_0", "wrong_window"])
def test_host_decoders_raise_as_jax(case):
    data = corpus.silesia_like(3000, seed=3)
    plain = reference.compress_block(data)
    packed = reference.compress_block_dict(DICT, RECORD * 20)
    calls = {
        "short_cap": lambda m: m.decompress_block_unknown(plain,
                                                          len(data) - 1),
        "truncated": lambda m: m.decompress_block_unknown(
            plain[:len(plain) // 2], len(data)),
        "empty": lambda m: m.decompress_block_unknown(b"", 100),
        "offset_0": lambda m: m.decompress_block_dict(
            b"\x30abc\x00\x00\x50xyzwv", DICT, 12),
        "wrong_window": lambda m: m.decompress_block_dict(
            packed, DICT[:40], 20 * len(RECORD)),
    }
    with pytest.raises(jref.CorruptedBlockError) as want:
        calls[case](jref)
    with pytest.raises(reference.CorruptedBlockError) as got:
        calls[case](reference)
    assert str(got.value) == str(want.value)


def test_dictionary_decode_matches_jax_xla_branch():
    """``corpus.dict_edge_rows`` at P = 8192, packed by the decoder's own
    layout (``corpus.dict_decode_inputs``, as the card's tests pack
    them)."""
    rows, args, C, D = corpus.dict_decode_inputs(P)
    assert sorted(set(args[4].tolist())) == [0, 1, 5000, 8191, 8192]
    S_cap = -(-(C // 3 + 2) // 128) * 128
    comp, comp_len, out_len, pre, pre_len = (jnp.asarray(a.numpy())
                                             for a in args)
    want = jdv.decode_batch_vectorized(
        comp, comp_len, out_len, C, D, S_cap, 2 * S_cap, 8192, pre=pre,
        pre_len=pre_len, fused=False)
    got = dv.decode_batch_vectorized(*args[:3], C, D, *args[3:])
    windows = [w for _, w, _, _ in rows]
    blocks = [b for *_, b in rows]
    out_lens = [len(r) for _, _, r, _ in rows]
    junk = np.array([n.startswith("junk") for n, *_ in rows])
    np.testing.assert_array_equal(got[3].numpy(), ~junk)
    # a row that fails its certificate is never returned, and its bytes
    # are unspecified: under the junk row's illegal match the XLA branch
    # carries the literal source on, the TPU kernel (and the port) write 0
    np.testing.assert_array_equal(got[0].numpy()[~junk],
                                  np.asarray(want[0])[~junk], "out")
    for name, w, g in zip(("total_out", "ok", "strict", "consumed",
                           "needed"), want[1:], got[1:]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), name)

    dec = dv.VectorDecoder("cpu")
    good = [j for j, bad in enumerate(junk) if not bad]
    assert dec.decode_batch([blocks[j] for j in good],
                            [out_lens[j] for j in good],
                            [windows[j] for j in good]) \
        == [rows[j][2] for j in good]
    assert dec.host_decodes == 0
    j = int(np.flatnonzero(junk)[0])
    with pytest.raises(reference.CorruptedBlockError, match="window"):
        dec.decode_batch([blocks[j]], [out_lens[j]], windows[j])
    assert dec.host_decodes == 1


def test_dictionary_decode_shared_window_and_facade():
    text = corpus.silesia_like(30000, seed=12)
    window = text[:9000]
    records = [text[9000:12000], window[2000:5000], text[20000:20100]]
    packed = [reference.compress_block_dict(window, r) for r in records]
    lens = [len(r) for r in records]
    cuda_engine.decoder("cpu").host_decodes = 0
    got = cuda_engine.decompress_blocks_dict(packed, lens, window, "cpu")
    assert got == records
    assert cuda_engine.decoder("cpu").host_decodes == 0
    for p, r in zip(packed, records):
        assert codec.decode(p, len(r), dictionary=window, device="cpu") \
            == r == jlz4.decode(p, len(r), dictionary=window)
    # a wrong window decodes to the host decoder's bytes, or raises as it
    zeros = bytes(len(window))
    for p, n in zip(packed, lens):
        try:
            want = reference.decompress_block_dict(p, zeros, n)
        except reference.CorruptedBlockError:
            with pytest.raises(reference.CorruptedBlockError):
                codec.decode(p, n, dictionary=zeros, device="cpu")
        else:
            assert codec.decode(p, n, dictionary=zeros, device="cpu") \
                == want


def test_dictionary_fast_encode_matches_jax_bytes():
    """``corpus.dict_edge_rows`` at P = 8192 as P-mode rows, each with its
    own window, laid out by ``encode_vector.window_rows``
    (``corpus.dict_encode_inputs``, as the card's tests lay them out)."""
    rows = corpus.dict_edge_rows(P, 8192)
    x, dl, pre_len = corpus.dict_encode_inputs(P)
    D, O, S_cap = ev.batch_shapes(8191, P)
    assert D == x.shape[1]
    want = jev.encode_batch_vectorized(
        jnp.asarray(x.numpy()), jnp.asarray(dl.numpy()), D, O, S_cap,
        rcap=ev.RCAP, hc_level=0, P=P, pre_len=jnp.asarray(pre_len.numpy()),
        fused=False)
    args = (x, dl, D, O, S_cap, ev.RCAP, 0, None, P, pre_len)
    got = ev.encode_batch_vectorized(*args)
    for name, w, g in zip(("out", "out_len", "ok"), want[:3], got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), name)
    assert bool(got[2].all())
    # the chain record path gives the sequence path's bytes in P mode
    for g, c in zip(got, ev.encode_batch_chain(*args)):
        assert torch.equal(g, c)

    # VectorEncoder's own layout, one shared window: the same compile (as
    # many device rows, the same D, O, S_cap and P)
    window = rows[4][1]
    blocks = [r for _, _, r, _ in rows if r] \
        + [corpus.silesia_like(3000, seed=4), b""]
    assert len(blocks) - 1 == len(rows)
    enc = ev.VectorEncoder("cpu")
    payloads = enc.encode_batch(blocks, dictionary=window)
    assert payloads == jev.VectorEncoder().encode_batch(blocks,
                                                        dictionary=window)
    assert enc.host_encodes == 0
    for p, b in zip(payloads, blocks):
        assert (reference.decompress_block_dict(p, window, len(b))
                if b else p) == b
    assert cuda_engine.compress_blocks_fast_dict(
        blocks, window, device="cpu") == payloads
    assert codec.encode(blocks[0], dictionary=window, mode="fast",
                        device="cpu") == payloads[0]


@pytest.mark.parametrize("level", [5, 9])
def test_dictionary_fast_hc_round_trips(level):
    """Fast-HC in P mode (the card holds it against its plain version);
    the plain path's payloads decode with the window, on the host and
    through the port's dictionary decoder."""
    rows = corpus.dict_edge_rows(P, 8192)
    window = rows[4][1]
    blocks = [r for _, _, r, _ in rows if r]
    enc = ev.VectorEncoder("cpu")
    payloads = enc.encode_batch(blocks, hc_level=level, dictionary=window)
    assert enc.host_encodes == 0
    for p, b in zip(payloads, blocks):
        assert reference.decompress_block_dict(p, window, len(b)) == b
    assert dv.VectorDecoder("cpu").decode_batch(
        payloads, [len(b) for b in blocks], window) == blocks
    assert codec.encode_hc(blocks[0], level=level, dictionary=window,
                           mode="fast", device="cpu") == payloads[0]


def test_dictionary_fast_hc9_at_the_record_cells_row_shape():
    """The benchmark's dictionary-records rows (``records4k-dict``): 4
    records of 4 KB behind a 64 KB dictionary of 16 records spread
    through the corpus, at HC level 9, P = 65,536 and D = 73,728; the
    payloads decode with the dictionary and equal the JAX vector
    encoder's in the same mode (one JAX compile, about 70 s)."""
    records = corpus.split_blocks(corpus.silesia_like(1 << 20, seed=22),
                                  4096)
    dictionary = b"".join(records[::16])
    batch = records[1::4][:4]
    assert len(dictionary) == 65536
    _x, _dl, _pl, p, d, _o, _s = ev.window_rows(batch, dictionary)
    assert (p, d, ev.hc_rcap(9, d)) == (65536, 73728, 18432)
    enc = ev.VectorEncoder("cpu")
    payloads = enc.encode_batch(batch, hc_level=9, dictionary=dictionary)
    assert enc.host_encodes == 0
    assert enc.window_bytes == len(batch) * 65536
    for payload, record in zip(payloads, batch):
        assert reference.decompress_block_dict(
            payload, dictionary, len(record)) == record
    assert payloads == jev.VectorEncoder().encode_batch(
        batch, hc_level=9, dictionary=dictionary)


@pytest.mark.parametrize("kept", [False, True])
def test_window_rows_lay_a_shared_window_as_one_a_row(kept):
    """A shared dictionary is written once into every row; the rows equal
    ``pack_windows``' layout of the same window given once a row, and a
    thread's kept buffer (``HostRows``) holds no byte of the batches laid
    in it before."""
    window = corpus.silesia_like(20000, seed=3)
    big = [corpus.silesia_like(9000, seed=s) for s in (1, 2)]
    small = [b"abc" * 10, b"", b"z"]
    rows = host_rows.HostRows()
    zeros = rows.empty if kept else np.zeros
    for blocks, d in ((big, window), (small, None), (small, window[:5]),
                      (big, None), (small, window)):
        got = ev.window_rows(blocks, d, zeros)
        want = ev.window_rows(blocks, [d] * len(blocks) if d else None)
        for g, w in zip(got, want):
            if isinstance(w, np.ndarray):
                np.testing.assert_array_equal(g, w)
            else:
                assert g == w


def test_p_mode_rows_wider_than_the_kernels_raise():
    """Rows wider than 106,496 positions no longer raise: the encode
    kernels take 172,032, a 96 KB block behind a full 64 KB window, so
    blocks of 40,960 bytes and more encode in P mode and round-trip."""
    window = corpus.silesia_like(65536, seed=2)
    enc = ev.VectorEncoder("cpu")
    assert ev.batch_shapes(40959, 65536)[0] == 106496
    assert ev.batch_shapes(96 * 1024, 65536)[0] == 172032
    data = b"x" * 40960
    assert reference.decompress_block_dict(
        enc.encode_batch([data], dictionary=window)[0], window,
        len(data)) == data
    data = b"x" * 50000
    packed = codec.encode_hc(data, dictionary=window, mode="fast",
                             device="cpu")
    assert reference.decompress_block_dict(packed, window, len(data)) \
        == data
    assert enc.host_encodes == 0


def test_wrap_envelopes_match_jax():
    rng = np.random.default_rng(6)
    cases = [corpus.silesia_like(20000, seed=7),
             rng.integers(0, 256, 4096, np.uint8).tobytes(), b"", b"z",
             b"ab" * 40]
    for data in cases:
        env = codec.wrap(data, device="cpu")
        env_hc = codec.wrap_hc(data, device="cpu")
        assert env == jlz4.wrap(data)
        assert env_hc == jlz4.wrap_hc(data)
        assert codec.wrap_hc(data, 3, device="cpu") == jlz4.wrap_hc(data, 3)
        for e in (env, env_hc):
            assert codec.unwrap(e, device="cpu") == data == jlz4.unwrap(e)
    assert codec.wrap(b"", device="cpu") == bytes(8)
    raw = codec.wrap(cases[1], device="cpu")
    assert raw[8:] == cases[1] and raw[:4] == raw[4:8]   # passthrough
    packed = codec.wrap(cases[0], device="cpu")
    for bad in (packed[:7], packed[:4] + (len(packed)).to_bytes(4, "little")
                + packed[8:]):
        with pytest.raises(ValueError, match="invalid"):
            codec.unwrap(bad, device="cpu")
        with pytest.raises(ValueError, match="invalid"):
            jlz4.unwrap(bad)


def test_facade_strict_modes_and_decode_match_jax():
    text = corpus.silesia_like(12000, seed=13)
    data, window = text[6000:], text[:6000]
    assert codec.codec_name(device="cpu") == "cuda/cuda/cudaHC"
    for level in (9, 4):
        assert codec.encode_hc(data, level=level, device="cpu") \
            == jlz4.encode_hc(data, level=level) \
            == cuda_engine.compress_block_hc(data, None, level, "cpu")
        assert codec.encode_hc(data, level=level, dictionary=window,
                               device="cpu") \
            == jlz4.encode_hc(data, level=level, dictionary=window)
    strict = codec.encode(data, dictionary=window, device="cpu")
    assert strict == jlz4.encode(data, dictionary=window) \
        == reference.compress_block_dict(window, data)
    assert codec.encode(data, 10, dictionary=window, device="cpu") == b""
    assert codec.encode_hc(b"", dictionary=window, device="cpu") == b""
    assert codec.decode(strict, len(data), dictionary=window,
                        device="cpu") == data
    plain = reference.compress_block(data)
    for cap in (len(data), len(data) + 1000):
        assert codec.decode(plain, max_output_length=cap, device="cpu") \
            == data == jlz4.decode(plain, max_output_length=cap)
    assert codec.decode(b"", max_output_length=9, device="cpu") == b""
    assert codec.decode(strict, 0, dictionary=window, device="cpu") == b""
    with pytest.raises(reference.CorruptedBlockError):
        codec.decode(plain, max_output_length=len(data) - 1, device="cpu")
    for kwargs in ({}, {"dictionary": window}):
        with pytest.raises(ValueError) as want:
            jlz4.decode(plain, **kwargs)
        with pytest.raises(ValueError) as got:
            codec.decode(plain, device="cpu", **kwargs)
        assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="mode"):
        codec.encode(data, dictionary=window, mode="hc", device="cpu")
