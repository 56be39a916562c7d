"""The port's LZ4Stream (``lz4net_tpu_torch.stream``) on the CPU, held
against the JAX package's (``lz4net_tpu.stream``): the counterpart of
``tests/test_stream.py`` and ``tests/test_stream_tcp.py``.

* frames byte-identical to ``lz4net_tpu.stream.compress_stream``, strict
  and HC, at chunk sizes of 16 B, 4 KB, 64 KB and 1 MB, and each
  package's ``decompress_stream`` returns the data from the other's;
* the varints, raw storage of incompressible chunks, small writes and
  one-byte reads, interactive reads (from a buffer and over a socket
  pair with stalls), truncated frames and multiple-pass chunks;
* the read-ahead: one ``codec.decode_batch`` call a batch of chunks;
* the batched write: frames byte-identical to the JAX package's for
  whole chunks and a tail in one write, a write that completes a pending
  chunk, many small writes, an incompressible chunk inside a batch, a
  flush between writes, more chunks than one batch holds and strict HC;
  one ``codec.encode_batch`` call a write's batch, its frames in the
  inner stream when the write returns.
"""

import io
import socket
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # the test workers share the cores: one intra-op
                           # thread each, or they spin against each other

from lz4net_tpu import stream as jstream  # noqa: E402
from lz4net_tpu_torch import codec, stream  # noqa: E402
from lz4net_tpu_torch.stream import (EndOfStreamError,  # noqa: E402
                                     LZ4Stream, LZ4StreamFlags,
                                     LZ4StreamMode, compress_stream,
                                     decompress_stream, read_varint,
                                     try_read_varint, write_varint)
from lz4net_tpu_torch.utils import corpus  # noqa: E402

KB = 1024
# data sizes a chunk size: strict encode runs the plain sequencer (about
# 1 s a MB here), strict HC the Python reference parse (about 4 s a MB)
SIZES = {16: (700, 300), 4 * KB: (50_000, 20_000),
         64 * KB: (200_000, 70_000), 1 << 20: (1_200_000, 70_000)}
DATA = corpus.silesia_like(1_200_000, seed=11)


def _noise(n, seed=3):
    return np.random.default_rng(seed).integers(0, 256, n,
                                                np.uint8).tobytes()


@pytest.mark.parametrize("hc", [False, True], ids=["strict", "hc"])
@pytest.mark.parametrize("block", list(SIZES), ids=["16B", "4KB", "64KB",
                                                    "1MB"])
def test_frames_equal_jax(block, hc):
    data = DATA[:SIZES[block][hc]]
    mine = compress_stream(data, high_compression=hc, block_size=block,
                           device="cpu")
    theirs = jstream.compress_stream(data, high_compression=hc,
                                     block_size=block)
    assert mine == theirs
    assert len(mine) < len(data) or block == 16
    assert decompress_stream(theirs, device="cpu") == data
    assert jstream.decompress_stream(mine) == data


def _written(mod, writes, block, hc=False, **kw):
    """The frames of ``mod``'s (either package's stream module) LZ4Stream
    after the ``writes`` (bytes, or None for a ``flush()``) and
    ``close()``."""
    sink = io.BytesIO()
    flags = mod.LZ4StreamFlags.ISOLATE_INNER_STREAM | (
        mod.LZ4StreamFlags.HIGH_COMPRESSION if hc else 0)
    out = mod.LZ4Stream(sink, mod.LZ4StreamMode.COMPRESS, flags,
                        block_size=block, **kw)
    for piece in writes:
        if piece is None:
            out.flush()
        else:
            assert out.write(piece) == len(piece)
    out.close()
    return sink.getvalue()


def _pieces(data, cuts):
    return [data[a:b] for a, b in zip([0] + cuts, cuts + [len(data)])]


B = 2048
NOISE = _noise(B, seed=8)
# (writes, chunk size, HC, batch bound or None), each against the JAX
# package's LZ4Stream fed the same writes
WRITE_PATTERNS = {
    "whole_chunks_and_a_tail": ([DATA[:5 * B + 700]], B, False, None),
    "completes_a_pending_chunk": (
        _pieces(DATA[:6 * B + 300], [900, 4 * B + 100]), B, False, None),
    "many_small_writes": (
        _pieces(DATA[:4 * B + 50], list(range(333, 4 * B, 333))), B, False,
        None),
    "incompressible_chunk_mid_batch": (
        [DATA[:2 * B] + NOISE + DATA[2 * B:3 * B + 10]], B, False, None),
    "flush_between_writes": (
        [DATA[:B + 500], None, DATA[B + 500:4 * B]], B, False, None),
    "more_chunks_than_a_batch": ([DATA[:11 * B + 99]], B, False, 3 * B),
    "high_compression": (
        _pieces(DATA[:5 * B + 40], [700, 3 * B]), B, True, None),
}


@pytest.mark.parametrize("pattern", list(WRITE_PATTERNS))
def test_write_patterns_equal_jax(pattern, monkeypatch):
    writes, block, hc, bound = WRITE_PATTERNS[pattern]
    if bound is not None:
        monkeypatch.setattr(stream, "BATCH_BYTES", bound)
    mine = _written(stream, writes, block, hc, device="cpu")
    assert mine == _written(jstream, writes, block, hc)
    data = b"".join(w for w in writes if w is not None)
    assert decompress_stream(mine, device="cpu") == data
    assert (NOISE in mine) == (pattern == "incompressible_chunk_mid_batch")


@pytest.mark.parametrize("value", [0, 1, 127, 128, 300, 16383, 16384,
                                   1 << 20, (1 << 32) - 1])
def test_varints(value):
    sink, jsink = io.BytesIO(), io.BytesIO()
    write_varint(sink, value)
    jstream.write_varint(jsink, value)
    assert sink.getvalue() == jsink.getvalue()
    sink.seek(0)
    assert read_varint(sink) == value


def test_varint_wire_format_and_eof():
    sink = io.BytesIO()
    write_varint(sink, 300)
    assert sink.getvalue() == b"\xac\x02"
    assert try_read_varint(io.BytesIO(b"")) is None
    with pytest.raises(EndOfStreamError):
        read_varint(io.BytesIO(b"\x80"))    # continuation bit, then EOF


def test_incompressible_chunks_stored_raw():
    data = _noise(50_000)
    framed = compress_stream(data, block_size=8192, device="cpu")
    assert framed == jstream.compress_stream(data, block_size=8192)
    assert len(framed) < len(data) + 64       # headers only
    assert framed[0] == 0                     # flags: not compressed
    assert decompress_stream(framed, device="cpu") == data
    mixed = DATA[:20_000] + data[:20_000]
    framed = compress_stream(mixed, block_size=10_000, device="cpu")
    assert framed == jstream.compress_stream(mixed, block_size=10_000)
    assert decompress_stream(framed, device="cpu") == mixed


def test_small_writes_and_one_byte_reads():
    data = DATA[:10_000]
    sink = io.BytesIO()
    out = LZ4Stream(sink, LZ4StreamMode.COMPRESS,
                    LZ4StreamFlags.ISOLATE_INNER_STREAM, block_size=1024,
                    device="cpu")
    for i in range(0, len(data), 7):
        out.write(data[i:i + 7])
    out.close()
    assert not sink.closed
    assert sink.getvalue() == jstream.compress_stream(data, block_size=1024)
    stream = LZ4Stream(io.BytesIO(sink.getvalue()), LZ4StreamMode.DECOMPRESS,
                       device="cpu")
    got = bytearray()
    while b := stream.read(1):
        got += b
    assert bytes(got) == data


def test_modes_empty_and_concatenated_streams():
    stream = LZ4Stream(io.BytesIO(), LZ4StreamMode.COMPRESS, device="cpu")
    with pytest.raises(io.UnsupportedOperation):
        stream.read(1)
    assert not stream.seekable()
    with pytest.raises(io.UnsupportedOperation):
        LZ4Stream(io.BytesIO(), LZ4StreamMode.DECOMPRESS,
                  device="cpu").write(b"x")
    assert compress_stream(b"", device="cpu") == b""
    assert decompress_stream(b"", device="cpu") == b""
    a, b = b"first segment " * 500, b"second segment " * 500
    framed = compress_stream(a, block_size=2048, device="cpu") \
        + compress_stream(b, block_size=2048, device="cpu")
    src = io.BytesIO(framed)
    with LZ4Stream(src, LZ4StreamMode.DECOMPRESS, device="cpu") as s:
        assert s.read() == a + b
        assert s.read(10) == b""              # a clean EOF, no error


def test_interactive_read_returns_partial_data():
    data = DATA[:5000]
    framed = compress_stream(data, block_size=1024, device="cpu")
    inner = io.BytesIO(framed)
    stream = LZ4Stream(inner, LZ4StreamMode.DECOMPRESS,
                       LZ4StreamFlags.INTERACTIVE_READ, device="cpu")
    first = stream.read(len(data))            # never waits past one chunk
    assert 0 < len(first) <= 1024
    assert inner.tell() < len(framed) // 2    # and reads no further ahead
    rest = bytearray(first)
    while chunk := stream.read(len(data)):
        rest += chunk
    assert bytes(rest) == data


def _serve(conn, payloads, stall):
    with conn, conn.makefile("wb") as sink:
        stream = LZ4Stream(sink, LZ4StreamMode.COMPRESS, block_size=1 << 16,
                           device="cpu")
        for part in payloads:
            stream.write(part)
            stream.flush()                    # one wire chunk a part
            sink.flush()
            time.sleep(stall)
        stream.close()


def test_socket_interactive_read_returns_partial_data():
    """A writer stalls between chunks on a socket: an interactive read
    returns each chunk as it arrives instead of waiting for its count."""
    payloads = [DATA[i * 40_000:(i + 1) * 40_000] for i in range(4)]
    server, client = socket.socketpair()
    t = threading.Thread(target=_serve, args=(server, payloads, 0.15),
                         daemon=True)
    t.start()
    got, arrival = [], []
    t0 = time.monotonic()
    with client, client.makefile("rb") as source:
        stream = LZ4Stream(source, LZ4StreamMode.DECOMPRESS,
                           LZ4StreamFlags.INTERACTIVE_READ, device="cpu")
        while chunk := stream.read(10 << 20):
            got.append(chunk)
            arrival.append(time.monotonic() - t0)
    t.join(timeout=10)
    assert b"".join(got) == b"".join(payloads)
    assert len(got) >= 2 and arrival[0] < 3 * 0.15


def test_truncated_frames_raise_when_reached():
    data = DATA[:40_000]
    framed = compress_stream(data, block_size=8192, device="cpu")
    for cut in (1, 2, len(framed) // 2):
        with pytest.raises(EndOfStreamError):
            decompress_stream(framed[:-cut], device="cpu")
    # read ahead past a good chunk: the error waits for the bad one
    stream = LZ4Stream(io.BytesIO(framed[:-3]), LZ4StreamMode.DECOMPRESS,
                       device="cpu")
    assert stream.read(8192) == data[:8192]
    with pytest.raises(EndOfStreamError):
        stream.read()
    # a compressed length over the original length is a corrupt header
    with pytest.raises(EndOfStreamError, match="corrupted"):
        decompress_stream(b"\x01\x04\x05abcde", device="cpu")
    with pytest.raises(NotImplementedError, match="multiple passes"):
        decompress_stream(b"\x05\x04\x02ab", device="cpu")


def test_read_ahead_makes_one_decode_batch_call_a_batch(monkeypatch):
    data = DATA[:400_000]
    block = 16 * KB
    framed = compress_stream(data, block_size=block, device="cpu")
    n_chunks = -(-len(data) // block)
    calls = []
    real = codec.decode_batch

    def counting(blocks, lens, device="cuda"):
        calls.append(len(blocks))
        return real(blocks, lens, device=device)

    monkeypatch.setattr(codec, "decode_batch", counting)
    assert decompress_stream(framed, device="cpu") == data   # a read-all
    assert calls == [n_chunks]
    calls.clear()
    stream = LZ4Stream(io.BytesIO(framed), LZ4StreamMode.DECOMPRESS,
                       device="cpu")
    got = bytearray()
    while part := stream.read(4 * block):     # `want` stops the read-ahead
        got += part
    assert bytes(got) == data and calls == [4] * (n_chunks // 4) + [1]
    calls.clear()
    stream = LZ4Stream(io.BytesIO(framed), LZ4StreamMode.DECOMPRESS,
                       read_ahead_chunks=3, device="cpu")
    assert stream.read(len(data)) == data
    assert calls == [3] * (n_chunks // 3) + [n_chunks % 3]


def test_write_makes_one_encode_batch_call_a_batch(monkeypatch):
    """A write encodes the chunks it completes in one ``codec.encode_batch``
    call (at most ``BATCH_BYTES`` a call), and its frames are in the inner
    stream when it returns; the tail waits for ``close()``."""
    block = 4 * KB
    data = DATA[:10 * block + 1500]
    calls = []
    real = codec.encode_batch

    def counting(blocks, caps, device="cuda"):
        calls.append(len(blocks))
        return real(blocks, caps, device=device)

    monkeypatch.setattr(codec, "encode_batch", counting)

    def run(cuts, want):
        calls.clear()
        sink = io.BytesIO()
        out = LZ4Stream(sink, LZ4StreamMode.COMPRESS,
                        LZ4StreamFlags.ISOLATE_INNER_STREAM,
                        block_size=block, device="cpu")
        done = 0
        for piece in _pieces(data, cuts):
            out.write(piece)
            done += len(piece)
            whole = done - done % block
            assert decompress_stream(sink.getvalue(), device="cpu") \
                == data[:whole]
        out.close()
        assert calls == want
        assert sink.getvalue() == jstream.compress_stream(data,
                                                          block_size=block)

    run([], [10, 1])
    # 1,000 pending; 5 completed (the pending one first); 300 pending; 5
    run([1000, 5 * block + 200, 5 * block + 300], [5, 5, 1])
    monkeypatch.setattr(stream, "BATCH_BYTES", 4 * block)
    run([], [4, 4, 2, 1])
    monkeypatch.setattr(stream, "BATCH_BYTES", block // 2)   # one a call
    run([3 * block], [1] * 10 + [1])
