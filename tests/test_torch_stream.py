"""The port's LZ4Stream (``lz4net_tpu_torch.stream``) on the CPU, held
against the JAX package's (``lz4net_tpu.stream``): the counterpart of
``tests/test_stream.py`` and ``tests/test_stream_tcp.py``.

* frames byte-identical to ``lz4net_tpu.stream.compress_stream``, strict
  and HC, at chunk sizes of 16 B, 4 KB, 64 KB and 1 MB, and each
  package's ``decompress_stream`` returns the data from the other's;
* the varints, raw storage of incompressible chunks, small writes and
  one-byte reads, interactive reads (from a buffer and over a socket
  pair with stalls), truncated frames and multiple-pass chunks;
* the read-ahead: one ``codec.decode_batch`` call a batch of chunks.
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
from lz4net_tpu_torch import codec  # noqa: E402
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
