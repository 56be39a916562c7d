"""LZ4Stream: lz4net's chunked stream framing, on the card (counterpart of
``lz4net_tpu/stream.py``, whose frames it writes byte for byte).

Wire format per chunk (`LZ4Stream.cs:239-312` of the reference):

    varint flags            -- ChunkFlags (Compressed=0x01,
                               HighCompression=0x02, Passes=0x1C
                               reserved/unsupported)
    varint originalLength
    varint compressedLength -- present only when Compressed flag set
    payload bytes           -- compressed block, or raw bytes when storing
                               an incompressible chunk

Varints are little-endian base-128 with 0x80 continuation
(`LZ4Stream.cs:167-187,225-236`).  A chunk whose compressed form is not
strictly smaller than the original is stored raw (`LZ4Stream.cs:248-255`).

Writes batch the chunks that one ``write()`` completes into one
``codec.encode_batch`` call (strict, the reference compressor's bytes, one
launch on the card), at most ``BATCH_BYTES`` of input a call, and frame
them before the call returns; ``flush()`` and ``close()`` encode the
pending chunk alone.  Strict HC encodes each chunk through
``codec.encode_hc`` (the reference HC parse on the native host engine).
Reads batch the chunk records they read ahead into one
``codec.decode_batch`` call, the port's main decode path.  Every entry
point takes ``device=``, the card by default.
"""

from __future__ import annotations

import enum
import io
import itertools
from typing import BinaryIO

from . import codec
from .constants import (CHUNK_COMPRESSED, CHUNK_HIGH_COMPRESSION,
                        DEFAULT_BLOCK_SIZE, HC_LEVEL_DEFAULT, MIN_BLOCK_SIZE)
from .spans import span

# the most input one encode call of a write takes, so that a write of any
# size stages at most this much on the host and the card at a time: 64
# chunks of 1 MB (a CTA each, fewer than the H100's 132 SMs), 1,024 of
# 64 KB
BATCH_BYTES = 64 << 20


class LZ4StreamMode(enum.Enum):
    """Compress (write-only) or Decompress (read-only), as
    `LZ4StreamMode.cs`."""
    COMPRESS = "compress"
    DECOMPRESS = "decompress"


class LZ4StreamFlags(enum.IntFlag):
    """Stream behaviour flags (`LZ4StreamFlags.cs:9-26`)."""
    NONE = 0x00
    INTERACTIVE_READ = 0x01
    HIGH_COMPRESSION = 0x02
    ISOLATE_INNER_STREAM = 0x04
    DEFAULT = NONE


class EndOfStreamError(EOFError):
    """Unexpected end of the inner stream (truncated chunk)."""


def write_varint(sink: BinaryIO, value: int) -> None:
    while True:
        b = value & 0x7F
        value >>= 7
        sink.write(bytes((b | (0x80 if value else 0),)))
        if not value:
            break


def try_read_varint(source: BinaryIO) -> int | None:
    """Read one varint; None at a clean EOF, EndOfStreamError mid-value."""
    result = 0
    count = 0
    while True:
        chunk = source.read(1)
        if not chunk:
            if count == 0:
                return None
            raise EndOfStreamError("unexpected end of stream")
        b = chunk[0]
        result += (b & 0x7F) << count
        count += 7
        if not (b & 0x80) or count >= 64:
            return result


def read_varint(source: BinaryIO) -> int:
    value = try_read_varint(source)
    if value is None:
        raise EndOfStreamError("unexpected end of stream")
    return value


def _read_exactly(source: BinaryIO, length: int) -> bytes:
    """Blocking full read (`LZ4Stream.ReadBlock`, `LZ4Stream.cs:207-221`)."""
    parts = []
    remaining = length
    while remaining > 0:
        chunk = source.read(remaining)
        if not chunk:
            break
        parts.append(chunk)
        remaining -= len(chunk)
    return b"".join(parts)


class LZ4Stream(io.RawIOBase):
    """File-like decorator compressing on write, decompressing on read.

    As `LZ4.LZ4Stream` (`LZ4Stream.cs:35-484`): write-side chunk
    buffering with incompressible chunks stored raw, read-side decode with
    optional interactive (return as soon as possible) reads, no seeking.
    """

    def __init__(self, inner_stream: BinaryIO, mode: LZ4StreamMode,
                 flags: LZ4StreamFlags = LZ4StreamFlags.DEFAULT,
                 block_size: int = DEFAULT_BLOCK_SIZE,
                 hc_level: int = HC_LEVEL_DEFAULT,
                 read_ahead_chunks: int = 64, *, device="cuda"):
        super().__init__()
        self._inner = inner_stream
        self._mode = mode
        self._device = device
        self._high_compression = bool(flags & LZ4StreamFlags.HIGH_COMPRESSION)
        self._interactive = bool(flags & LZ4StreamFlags.INTERACTIVE_READ)
        self._isolate_inner = bool(flags & LZ4StreamFlags.ISOLATE_INNER_STREAM)
        self._block_size = max(MIN_BLOCK_SIZE, block_size)
        self._hc_level = hc_level
        self._buffer = bytearray()   # write: pending chunk, read: decoded one
        self._buffer_offset = 0      # read cursor into _buffer
        # read path: chunks already read and batch-decoded, oldest first;
        # interactive mode never reads ahead (socket semantics)
        self._read_ahead = 1 if self._interactive else max(1,
                                                           read_ahead_chunks)
        self._decoded_queue: list[bytearray] = []
        self._pending_error: Exception | None = None

    # --- capabilities -----------------------------------------------------

    def readable(self) -> bool:
        return self._mode is LZ4StreamMode.DECOMPRESS

    def writable(self) -> bool:
        return self._mode is LZ4StreamMode.COMPRESS

    def seekable(self) -> bool:
        return False

    # --- write path -------------------------------------------------------

    def _write_chunks(self, chunks) -> None:
        """Encode ``chunks`` in one ``codec.encode_batch`` call (strict
        HC: one ``codec.encode_hc`` a chunk) and frame them in order."""
        with span("lz4t.stream.chunk"):
            with span("lz4t.stream.frame"):
                raws = [bytes(c) for c in chunks]
            # each compressed into a budget of len(raw) bytes: "did not
            # fit" or "did not shrink" means the chunk is stored raw
            if self._high_compression:
                packed = [codec.encode_hc(raw, len(raw), self._hc_level,
                                          device=self._device)
                          for raw in raws]
            else:
                packed = codec.encode_batch(raws, [len(r) for r in raws],
                                            device=self._device)
            with span("lz4t.stream.frame"):
                for raw, payload in zip(raws, packed):
                    compressed = bool(payload) and len(payload) < len(raw)

                    flags = 0
                    if compressed:
                        flags |= CHUNK_COMPRESSED
                    if self._high_compression:
                        flags |= CHUNK_HIGH_COMPRESSION

                    write_varint(self._inner, flags)
                    write_varint(self._inner, len(raw))
                    if compressed:
                        write_varint(self._inner, len(payload))
                        self._inner.write(payload)
                    else:
                        self._inner.write(raw)

    def _flush_current_chunk(self) -> None:
        if self._buffer:
            self._write_chunks([self._buffer])
            self._buffer.clear()

    def write(self, data) -> int:
        """Frame every chunk that the pending bytes and ``data`` complete
        before returning, in batches of at most ``BATCH_BYTES``; the rest
        stays pending."""
        if not self.writable():
            raise io.UnsupportedOperation("write")
        size = self._block_size
        with span("lz4t.stream.frame"):
            data = bytes(data)
            view = memoryview(data)
            head = []
            if self._buffer:    # the head of data completes the pending chunk
                take = min(size - len(self._buffer), len(view))
                self._buffer += view[:take]
                view = view[take:]
                if len(self._buffer) == size:
                    head, self._buffer = [self._buffer], bytearray()
            whole = len(view) - len(view) % size
        chunks = itertools.chain(head, (view[i:i + size]
                                        for i in range(0, whole, size)))
        per_batch = max(1, BATCH_BYTES // size)
        while batch := list(itertools.islice(chunks, per_batch)):
            self._write_chunks(batch)
        with span("lz4t.stream.frame"):
            self._buffer += view[whole:]
        return len(data)

    def flush(self) -> None:
        if self.writable():
            self._flush_current_chunk()

    # --- read path --------------------------------------------------------

    def _read_chunk_record(self):
        """One raw chunk record (flags, original length, payload); None at
        a clean EOF (the header parse of `LZ4Stream.AcquireNextChunk`,
        `LZ4Stream.cs:274-312`)."""
        flags = try_read_varint(self._inner)
        if flags is None:
            return None
        compressed = bool(flags & CHUNK_COMPRESSED)
        original_length = read_varint(self._inner)
        compressed_length = (read_varint(self._inner) if compressed
                             else original_length)
        if compressed_length > original_length:
            raise EndOfStreamError("corrupted chunk header")
        payload = _read_exactly(self._inner, compressed_length)
        if len(payload) != compressed_length:
            raise EndOfStreamError("truncated chunk payload")
        return flags, original_length, payload

    def _read_records(self, want: int | None) -> list:
        """The chunk records of one read-ahead: as many as ``want`` bytes
        span, at most ``read_ahead_chunks`` (all of them for None).  An
        error met after the first record is kept in ``_pending_error``."""
        records = []
        got = 0
        while want is None or got < want or not records:
            try:
                rec = self._read_chunk_record()
            except (EndOfStreamError, NotImplementedError) as exc:
                if not records:
                    raise
                self._pending_error = exc   # raised when reached
                break
            if rec is None:
                break
            if (rec[0] & CHUNK_COMPRESSED) and rec[0] >> 2:
                exc = NotImplementedError(
                    "Chunks with multiple passes are not supported.")
                if not records:
                    raise exc
                self._pending_error = exc
                break
            records.append(rec)
            got += rec[1]
            if want is not None and len(records) >= self._read_ahead:
                break
        return records

    def _acquire_next_chunk(self, want: int | None = None) -> bool:
        """Make the next decoded chunk current; False at a clean EOF.

        The read path batches: it reads as many chunk records as the
        caller's request spans (at most ``read_ahead_chunks``, so a pipe
        or socket is never read further than the request needs; all of
        them for ``want=None``, a read-all), then decodes them in one
        ``codec.decode_batch`` call.  An error met while reading ahead is
        raised when the bad chunk is reached, as the reference raises it
        chunk by chunk.
        """
        while True:
            if self._decoded_queue:
                self._buffer = self._decoded_queue.pop(0)
                self._buffer_offset = 0
                if self._buffer:
                    return True
                continue                # an empty chunk: keep draining

            if self._pending_error is not None:
                err, self._pending_error = self._pending_error, None
                raise err

            with span("lz4t.stream.chunk"):
                with span("lz4t.stream.frame"):
                    records = self._read_records(want)
                if not records:
                    return False

                packed_idx = [i for i, (f, n, _p) in enumerate(records)
                              if (f & CHUNK_COMPRESSED) and n > 0]
                decoded = codec.decode_batch(
                    [records[i][2] for i in packed_idx],
                    [records[i][1] for i in packed_idx],
                    device=self._device) if packed_idx else []
                with span("lz4t.stream.frame"):
                    results = dict(zip(packed_idx, decoded))
                    for i, (_f, _n, payload) in enumerate(records):
                        self._decoded_queue.append(
                            bytearray(results.get(i, payload)))

    def read(self, size: int = -1) -> bytes:
        if not self.readable():
            raise io.UnsupportedOperation("read")
        out = bytearray()
        if size is None or size < 0:
            while True:
                if len(self._buffer) > self._buffer_offset:
                    with span("lz4t.stream.frame"):
                        out += self._buffer[self._buffer_offset:]
                        self._buffer_offset = len(self._buffer)
                elif not self._acquire_next_chunk(None):
                    break
            with span("lz4t.stream.frame"):
                return bytes(out)

        remaining = size
        while remaining > 0:
            avail = len(self._buffer) - self._buffer_offset
            if avail > 0:
                take = min(avail, remaining)
                with span("lz4t.stream.frame"):
                    out += self._buffer[self._buffer_offset:
                                        self._buffer_offset + take]
                self._buffer_offset += take
                remaining -= take
                if self._interactive:
                    break       # return whatever is available at once
            elif not self._acquire_next_chunk(remaining):
                break
        with span("lz4t.stream.frame"):
            return bytes(out)

    def readinto(self, b) -> int:
        data = self.read(len(b))
        b[:len(data)] = data
        return len(data)

    # --- lifecycle --------------------------------------------------------

    def close(self) -> None:
        if self.closed:
            return
        try:
            if self.writable():
                self._flush_current_chunk()
        finally:
            if not self._isolate_inner:
                self._inner.close()
            super().close()


def compress_stream(data: bytes, *, high_compression: bool = False,
                    block_size: int = DEFAULT_BLOCK_SIZE,
                    hc_level: int = HC_LEVEL_DEFAULT,
                    device="cuda") -> bytes:
    """One-shot helper: a complete LZ4Stream-framed byte string."""
    sink = io.BytesIO()
    flags = (LZ4StreamFlags.HIGH_COMPRESSION if high_compression
             else LZ4StreamFlags.DEFAULT) | LZ4StreamFlags.ISOLATE_INNER_STREAM
    with LZ4Stream(sink, LZ4StreamMode.COMPRESS, flags, block_size,
                   hc_level, device=device) as stream:
        stream.write(data)
    with span("lz4t.stream.frame"):
        return sink.getvalue()


def decompress_stream(data: bytes, *, device="cuda") -> bytes:
    """One-shot helper: decode a complete LZ4Stream-framed byte string
    (a read-all: one ``codec.decode_batch`` call for every chunk)."""
    source = io.BytesIO(data)
    with LZ4Stream(source, LZ4StreamMode.DECOMPRESS,
                   device=device) as stream:
        return stream.read()
