"""The plain reference: LZ4 block and LZ4Stream semantics in scalar Python.

A frozen copy of the port's Python oracle (``lz4net_tpu_torch/
models/reference.py``'s ``compress_block`` and ``decompress_block``, and
the chunk framing of ``lz4net_tpu_torch/stream.py``) as it stood when the
benchmark was written.  It imports nothing of the program and takes
nothing the program made: the checks hand it the seed's corpus and the
program's outputs, which it only judges.

* ``decompress_block``: the known-length decoder with the reference
  decoder's rules (the last five bytes are literals, no match starts in
  the last twelve, offsets inside the block); it raises
  ``CorruptedBlockError`` for a block that breaks one.
* ``compress_block``: the reference compressor's greedy parse, bit for
  bit, so the strict paths' bytes can be held to it.
* ``stream_frames``: the whole LZ4Stream a strict writer produces.

The keyword arguments exist for the controls (``portbench/controls.py``):
each breaks one guarantee a cell's configuration states, and the checks
must see it.
"""

from __future__ import annotations

from array import array

MINMATCH = 4
COPYLENGTH = 8
LASTLITERALS = 5
MFLIMIT = COPYLENGTH + MINMATCH
MINLENGTH = MFLIMIT + 1
ML_BITS = 4
ML_MASK = (1 << ML_BITS) - 1
RUN_MASK = (1 << (8 - ML_BITS)) - 1
MAX_DISTANCE = (1 << 16) - 1
SKIPSTRENGTH = 6
HASH_LOG = 12
HASH_TABLESIZE = 1 << HASH_LOG
HASH_ADJUST = (MINMATCH * 8) - HASH_LOG
HASH64K_LOG = HASH_LOG + 1
HASH64K_TABLESIZE = 1 << HASH64K_LOG
HASH64K_ADJUST = (MINMATCH * 8) - HASH64K_LOG
LZ4_64KLIMIT = (1 << 16) + (MFLIMIT - 1)
HASH_MULTIPLIER = 2654435761
CHUNK_COMPRESSED = 0x01
_U32 = 0xFFFFFFFF


class CorruptedBlockError(ValueError):
    """Raised when a compressed block breaks the LZ4 block format."""


def maximum_output_length(input_length: int) -> int:
    """Worst-case compressed size for a block of ``input_length`` bytes."""
    return input_length + input_length // 255 + 16


def _u32le(src, i: int) -> int:
    return src[i] | (src[i + 1] << 8) | (src[i + 2] << 16) | (src[i + 3] << 24)


def _hash(src, i: int, adjust: int) -> int:
    return ((_u32le(src, i) * HASH_MULTIPLIER) & _U32) >> adjust


def _eq4(src, a: int, b: int) -> bool:
    return src[a] == src[b] and src[a + 1] == src[b + 1] \
        and src[a + 2] == src[b + 2] and src[a + 3] == src[b + 3]


def _match_extension(src, p: int, ref: int, cap: int) -> int:
    """Length of the common run of src[p..] vs src[ref..], capped so the
    match never extends past ``cap`` (= src_end - LASTLITERALS)."""
    n = 0
    limit = cap - p
    while n < limit and src[p + n] == src[ref + n]:
        n += 1
    return n


def _emit_literal_run(dst: bytearray, token_pos: int, length: int,
                      src, anchor: int) -> None:
    """Write the literal-length field (with 255 extensions) and the literal
    bytes; dst already holds a reserved token byte at ``token_pos``."""
    if length >= RUN_MASK:
        dst[token_pos] = RUN_MASK << ML_BITS
        rem = length - RUN_MASK
        while rem > 254:
            dst.append(255)
            rem -= 255
        dst.append(rem)
    else:
        dst[token_pos] = length << ML_BITS
    dst += src[anchor:anchor + length]


def _emit_match_length(dst: bytearray, token_pos: int,
                       mlen_minus_minmatch: int) -> None:
    if mlen_minus_minmatch >= ML_MASK:
        dst[token_pos] += ML_MASK
        rem = mlen_minus_minmatch - ML_MASK
        while rem > 254:
            dst.append(255)
            rem -= 255
        dst.append(rem)
    else:
        dst[token_pos] += mlen_minus_minmatch


def compress_block(src, dst_maxlen: int | None = None, *,
                   skip_strength: int = SKIPSTRENGTH,
                   last_literals: int = LASTLITERALS) -> bytes:
    """Greedy-compress one block; returns b"" when the result would not fit
    ``dst_maxlen`` (the reference's "return 0" overflow convention).
    ``skip_strength`` and ``last_literals`` other than the reference's
    make the controls' blocks: another parse, or matches that run into
    the last five bytes."""
    src = bytes(src)
    n = len(src)
    if n == 0:
        return b""
    if dst_maxlen is None:
        dst_maxlen = maximum_output_length(n)

    use64k = n < LZ4_64KLIMIT
    adjust = HASH64K_ADJUST if use64k else HASH_ADJUST
    table = array("i", bytes(4 * (HASH64K_TABLESIZE if use64k
                                  else HASH_TABLESIZE)))

    dst = bytearray()
    src_end = n
    mflimit = src_end - MFLIMIT
    cap = src_end - last_literals         # matches may extend at most here
    dst_last1 = dst_maxlen - (1 + LASTLITERALS)
    dst_last3 = dst_maxlen - (2 + 1 + LASTLITERALS)

    anchor = 0
    p = 0

    if n >= MINLENGTH:
        if not use64k:
            table[_hash(src, 0, adjust)] = 0
        p = 1
        h_fwd = _hash(src, p, adjust)

        while True:
            # --- find a match (skip-accelerated probe loop) ----------------
            attempts = (1 << skip_strength) + 3
            p_fwd = p
            while True:
                h = h_fwd
                step = attempts >> skip_strength
                attempts += 1
                p = p_fwd
                p_fwd = p + step
                if p_fwd > mflimit:
                    p = None  # falls through to last-literals
                    break
                h_fwd = _hash(src, p_fwd, adjust)
                ref = table[h]
                table[h] = p
                if use64k:
                    if _eq4(src, ref, p):
                        break
                else:
                    if ref >= p - MAX_DISTANCE and _eq4(src, ref, p):
                        break
            if p is None:
                break

            # --- catch up: extend the match backwards ----------------------
            while p > anchor and ref > 0 and src[p - 1] == src[ref - 1]:
                p -= 1
                ref -= 1

            # --- emit literal run -----------------------------------------
            lit_len = p - anchor
            token_pos = len(dst)
            dst.append(0)
            if len(dst) + lit_len + (lit_len >> 8) > dst_last3:
                return b""
            _emit_literal_run(dst, token_pos, lit_len, src, anchor)

            while True:
                # --- emit offset ------------------------------------------
                offset = p - ref
                dst.append(offset & 0xFF)
                dst.append(offset >> 8)

                # --- extend match forwards --------------------------------
                p += MINMATCH
                ref += MINMATCH
                anchor = p
                p += _match_extension(src, p, ref, cap)

                mlen = p - anchor
                if len(dst) + (mlen >> 8) > dst_last1:
                    return b""
                _emit_match_length(dst, token_pos, mlen)

                if p > mflimit:
                    anchor = p
                    p = None
                    break

                # hash the position two back (reference "fill table" step)
                table[_hash(src, p - 2, adjust)] = p - 2

                # immediate re-match test at the current position (token=0)
                h = _hash(src, p, adjust)
                ref = table[h]
                table[h] = p
                rematch = _eq4(src, ref, p) if use64k else (
                    ref > p - (MAX_DISTANCE + 1) and _eq4(src, ref, p))
                if rematch:
                    token_pos = len(dst)
                    dst.append(0)
                    continue

                anchor = p
                p += 1
                h_fwd = _hash(src, p, adjust)
                break
            if p is None:
                break

    # --- last literals ------------------------------------------------
    last_run = src_end - anchor
    if len(dst) + last_run + 1 + (last_run + 255 - RUN_MASK) // 255 \
            > dst_maxlen:
        return b""
    if last_run >= RUN_MASK:
        dst.append(RUN_MASK << ML_BITS)
        rem = last_run - RUN_MASK
        while rem > 254:
            dst.append(255)
            rem -= 255
        dst.append(rem)
    else:
        dst.append(last_run << ML_BITS)
    dst += src[anchor:src_end]

    return bytes(dst)


def _copy_match(dst: bytearray, ref: int, mlen: int, overlap: bool) -> None:
    """Append ``mlen`` bytes starting at dst[ref], honouring the LZ4
    overlapping-match semantics (offset < length replicates the pattern);
    ``overlap=False`` copies the source as it stood before the copy, as a
    wide copy that ignores overlap does, zeros past the output's end (a
    control)."""
    dp = len(dst)
    offset = dp - ref
    if not overlap:
        part = dst[ref:ref + mlen]
        dst += part + bytes(mlen - len(part))
    elif offset >= mlen:
        dst += dst[ref:ref + mlen]
    else:
        pattern = dst[ref:dp]
        reps = mlen // offset + 1
        dst += (pattern * reps)[:mlen]


def decompress_block(src, output_length: int, *,
                     overlap: bool = True) -> bytes:
    """Known-output-length decode (reference ``LZ4_uncompress``).  Decodes
    exactly ``output_length`` bytes and requires the stream to be
    well-formed; raises CorruptedBlockError otherwise."""
    src = bytes(src)
    dst = bytearray()
    sp = 0
    dst_end = output_length
    dst_copylen = dst_end - COPYLENGTH
    dst_lastlits = dst_end - LASTLITERALS

    try:
        while True:
            token = src[sp]
            sp += 1

            # literal run
            length = token >> ML_BITS
            if length == RUN_MASK:
                while True:
                    b = src[sp]
                    sp += 1
                    length += b
                    if b != 255:
                        break
            lit_end = len(dst) + length
            if lit_end > dst_copylen:
                # terminal literal run must land exactly on the block end
                if lit_end != dst_end:
                    raise CorruptedBlockError("literal run overruns block end")
                if sp + length > len(src):
                    raise CorruptedBlockError("literal run overruns input")
                dst += src[sp:sp + length]
                sp += length
                break
            dst += src[sp:sp + length]
            sp += length

            # match
            offset = src[sp] | (src[sp + 1] << 8)
            sp += 2
            ref = len(dst) - offset
            if ref < 0 or offset == 0:
                raise CorruptedBlockError("match offset outside block")

            mlen = token & ML_MASK
            if mlen == ML_MASK:
                while src[sp] == 255:
                    mlen += 255
                    sp += 1
                mlen += src[sp]
                sp += 1
            mlen += MINMATCH

            if len(dst) + mlen > dst_lastlits:
                raise CorruptedBlockError(
                    "match extends into last-5-literals zone")
            _copy_match(dst, ref, mlen, overlap)
    except IndexError as exc:
        raise CorruptedBlockError("truncated input") from exc

    if len(dst) != output_length:
        raise CorruptedBlockError("decoded length mismatch")
    return bytes(dst)




def _varint(value: int) -> bytes:
    out = bytearray()
    while True:
        b = value & 0x7F
        value >>= 7
        out.append(b | (0x80 if value else 0))
        if not value:
            return bytes(out)


def stream_frames(data: bytes, chunk: int, **compress_args) -> bytes:
    """The LZ4Stream a strict writer makes of ``data`` in chunks of
    ``chunk`` bytes (flags DEFAULT): per chunk the varint flags, the
    original length, and the compressed length and the reference
    compressor's payload, or the raw bytes where that payload is not
    strictly smaller (compressed into a budget of the chunk's length)."""
    out = bytearray()
    for i in range(0, len(data), chunk):
        raw = data[i:i + chunk]
        packed = compress_block(raw, len(raw), **compress_args)
        if packed and len(packed) < len(raw):
            out += _varint(CHUNK_COMPRESSED) + _varint(len(raw))
            out += _varint(len(packed)) + packed
        else:
            out += _varint(0) + _varint(len(raw)) + raw
    return bytes(out)
