"""Pure-Python LZ4 block codec: the port's host oracle.

The port's own copy of the parts of ``lz4net_tpu/models/reference.py`` it
needs:

* ``decompress_block`` (:460-523 there) re-decodes any block the device
  cannot certify and raises ``CorruptedBlockError`` for malformed input,
  as the reference's known-length ``LZ4_uncompress`` does;
* ``compress_block`` (:117 there), the r88/r93 greedy parse, bit-identical
  to the reference compressor; ``chip_smoke.py`` uses it to make its
  input;
* ``compress_block_hc`` (:725 there, with ``_HcState`` and ``_hc_emit``),
  the r93 lazy two-ahead HC parser; the fast-HC encoder sends the blocks
  the device flags to it, and strict HC encode runs on it;
* the preset-dictionary codecs ``compress_block_dict`` (:248 there) and
  ``compress_block_hc_dict`` (:368), which strict dictionary encode runs
  on and to which the dictionary encoder sends the blocks the device
  flags, and ``decompress_block_dict`` (:380), which re-decodes the
  dictionary blocks the device cannot certify, and
  ``decompress_fragment`` (``models/native.py:269`` there), which
  re-decodes the big-block fragments the device cannot certify;
* ``decompress_block_unknown`` (:526 there), the hardened
  unknown-output-length decoder: the unknown-length path re-decodes
  with it every block the device cannot certify, and it raises the
  reference's errors for malformed input; ``unknown_output_length``
  walks its headers alone, for the length a block over 96 KB decodes
  to, or its error.

It is scalar Python on purpose: clarity and bit-exactness over speed.
"""

from __future__ import annotations

from array import array

from ..constants import (
    COPYLENGTH,
    HASH64K_ADJUST,
    HASH64K_TABLESIZE,
    HASH_ADJUST,
    HASH_MULTIPLIER,
    HASH_TABLESIZE,
    HASHHC_ADJUST,
    HASHHC_TABLESIZE,
    LASTLITERALS,
    LZ4_64KLIMIT,
    MAX_DISTANCE,
    MAX_NB_ATTEMPTS,
    MAXD,
    MAXD_MASK,
    MFLIMIT,
    MINLENGTH,
    MINMATCH,
    ML_BITS,
    ML_MASK,
    OPTIMAL_ML,
    RUN_MASK,
    SKIPSTRENGTH,
    maximum_output_length,
)

_U32 = 0xFFFFFFFF


class CorruptedBlockError(ValueError):
    """Raised when a compressed block violates the LZ4 format."""


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


def compress_block(src, dst_maxlen: int | None = None) -> bytes:
    """Greedy-compress one block; returns b"" when the result would not fit
    ``dst_maxlen`` (the reference's "return 0" overflow convention)."""
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
    cap = src_end - LASTLITERALS          # matches may extend at most here
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
            attempts = (1 << SKIPSTRENGTH) + 3
            p_fwd = p
            while True:
                h = h_fwd
                step = attempts >> SKIPSTRENGTH
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


def compress_block_dict(dictionary: bytes, data: bytes,
                        dst_maxlen: int | None = None) -> bytes:
    """Greedy-compress ``data`` with a preset dictionary window.

    Our extension over the reference vintage (r88/r93 has no dictionary
    API): the dictionary bytes logically precede the block, matches may
    reach back across the boundary within the 64 KB window, and the
    output covers only ``data``.
    """
    dictionary = bytes(dictionary)
    data = bytes(data)
    if not data:
        return b""
    if not dictionary:
        return compress_block(data, dst_maxlen)
    if dst_maxlen is None:
        dst_maxlen = maximum_output_length(len(data))

    src = dictionary + data
    data_start = len(dictionary)
    n = len(src)
    adjust = HASH_ADJUST
    table = array("i", bytes(4 * HASH_TABLESIZE))
    for i in range(0, data_start - 3):
        table[_hash(src, i, adjust)] = i

    dst = bytearray()
    mflimit = n - MFLIMIT
    cap = n - LASTLITERALS
    dst_last1 = dst_maxlen - (1 + LASTLITERALS)
    dst_last3 = dst_maxlen - (2 + 1 + LASTLITERALS)
    anchor = data_start

    if n - data_start >= MINLENGTH:
        p = data_start
        h_fwd = _hash(src, p, adjust)
        while True:
            attempts = (1 << SKIPSTRENGTH) + 3
            p_fwd = p
            while True:
                h = h_fwd
                step = attempts >> SKIPSTRENGTH
                attempts += 1
                p = p_fwd
                p_fwd = p + step
                if p_fwd > mflimit:
                    p = None
                    break
                h_fwd = _hash(src, p_fwd, adjust)
                ref = table[h]
                table[h] = p
                if ref >= p - MAX_DISTANCE and ref < p and _eq4(src, ref, p):
                    break
            if p is None:
                break

            while p > anchor and ref > 0 and src[p - 1] == src[ref - 1]:
                p -= 1
                ref -= 1

            lit_len = p - anchor
            token_pos = len(dst)
            dst.append(0)
            if len(dst) + lit_len + (lit_len >> 8) > dst_last3:
                return b""
            _emit_literal_run(dst, token_pos, lit_len, src, anchor)

            while True:
                offset = p - ref
                dst.append(offset & 0xFF)
                dst.append(offset >> 8)
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
                table[_hash(src, p - 2, adjust)] = p - 2
                h = _hash(src, p, adjust)
                ref = table[h]
                table[h] = p
                if ref > p - (MAX_DISTANCE + 1) and ref < p \
                        and _eq4(src, ref, p):
                    token_pos = len(dst)
                    dst.append(0)
                    continue
                anchor = p
                p += 1
                h_fwd = _hash(src, p, adjust)
                break
            if p is None:
                break

    last_run = n - anchor
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
    dst += src[anchor:n]
    return bytes(dst)


def _copy_match(dst: bytearray, ref: int, mlen: int) -> None:
    """Append ``mlen`` bytes starting at dst[ref], honouring the LZ4
    overlapping-match semantics (offset < length replicates the pattern)."""
    dp = len(dst)
    offset = dp - ref
    if offset >= mlen:
        dst += dst[ref:ref + mlen]
    else:
        pattern = dst[ref:dp]
        reps = mlen // offset + 1
        dst += (pattern * reps)[:mlen]


def decompress_block(src, output_length: int) -> bytes:
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
            _copy_match(dst, ref, mlen)
    except IndexError as exc:
        raise CorruptedBlockError("truncated input") from exc

    if len(dst) != output_length:
        raise CorruptedBlockError("decoded length mismatch")
    return bytes(dst)


def decompress_block_dict(src, dictionary: bytes, output_length: int) -> bytes:
    """Known-length decode with a preset dictionary: matches may reference
    into the dictionary bytes that logically precede the block."""
    dictionary = bytes(dictionary)
    if not dictionary:
        return decompress_block(src, output_length)
    src = bytes(src)
    dict_len = len(dictionary)
    dst = bytearray(dictionary)
    sp = 0
    dst_end = dict_len + output_length
    dst_copylen = dst_end - COPYLENGTH
    dst_lastlits = dst_end - LASTLITERALS

    try:
        while True:
            token = src[sp]
            sp += 1
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
                if lit_end != dst_end:
                    raise CorruptedBlockError("literal run overruns block end")
                if sp + length > len(src):
                    raise CorruptedBlockError("literal run overruns input")
                dst += src[sp:sp + length]
                sp += length
                break
            dst += src[sp:sp + length]
            sp += length

            offset = src[sp] | (src[sp + 1] << 8)
            sp += 2
            ref = len(dst) - offset
            if ref < 0 or offset == 0:
                raise CorruptedBlockError("match offset outside window")
            mlen = token & ML_MASK
            if mlen == ML_MASK:
                while src[sp] == 255:
                    mlen += 255
                    sp += 1
                mlen += src[sp]
                sp += 1
            mlen += MINMATCH
            if len(dst) + mlen > dst_lastlits:
                raise CorruptedBlockError("match extends into last-5 zone")
            _copy_match(dst, ref, mlen)
    except IndexError as exc:
        raise CorruptedBlockError("truncated input") from exc

    if len(dst) != dst_end:
        raise CorruptedBlockError("decoded length mismatch")
    return bytes(dst[dict_len:])


def decompress_fragment(src, window: bytes, out_len: int) -> bytes:
    """Decode a fragment of a big block (``ops/bigblock.py``): exactly
    ``out_len`` bytes behind ``window``, bounds-checked, without the
    block-end rules (a fragment ends wherever its segment ends, often on
    a match, with an empty final literal run appended).  The JAX
    package's ``models/native.decompress_fragment``
    (``lz4_oracle.cpp:decompress_fragment_core``).  Raises
    CorruptedBlockError for malformed input or another length."""
    src, window = bytes(src), bytes(window)
    if out_len == 0:
        return b""
    dst = bytearray(window)
    dict_len = len(window)
    dst_end = dict_len + out_len
    n = len(src)
    sp = 0
    while sp < n:
        token = src[sp]
        sp += 1
        length = token >> ML_BITS
        if length == RUN_MASK:
            while True:
                if sp >= n:
                    raise CorruptedBlockError("truncated literal length")
                b = src[sp]
                sp += 1
                length += b
                if b != 255:
                    break
        if sp + length > n or len(dst) + length > dst_end:
            raise CorruptedBlockError("literal run overruns the fragment")
        dst += src[sp:sp + length]
        sp += length
        if sp == n:
            break                       # the final literal run
        if sp + 2 > n:
            raise CorruptedBlockError("truncated match offset")
        offset = src[sp] | (src[sp + 1] << 8)
        sp += 2
        ref = len(dst) - offset
        if ref < 0 or offset == 0:
            raise CorruptedBlockError("match offset outside window")
        mlen = token & ML_MASK
        if mlen == ML_MASK:
            while True:
                if sp >= n:
                    raise CorruptedBlockError("truncated match length")
                b = src[sp]
                sp += 1
                mlen += b
                if b != 255:
                    break
        mlen += MINMATCH
        if len(dst) + mlen > dst_end:
            raise CorruptedBlockError("match overruns the fragment")
        _copy_match(dst, ref, mlen)
    if len(dst) != dst_end:
        raise CorruptedBlockError(
            f"fragment decode: {len(dst) - dict_len} != {out_len}")
    return bytes(dst[dict_len:])


def _unknown_sequences(src: bytes, max_output_length: int):
    """The hardened decoder's walk over the sequence headers of ``src``
    (reference `LZ4_uncompress_unknownOutputSize`,
    `Safe64.Dirty.cs:665-798`): yields (literal start, literal length,
    match offset, match length) for each sequence, offset and match
    length 0 for the final literal run, checking every rule of that
    decoder on the lengths alone; raises CorruptedBlockError where it
    does."""
    src_end = len(src)
    if src_end == 0:
        raise CorruptedBlockError("empty input")

    sp = 0
    dp = 0                              # the decoded length so far
    dst_end = max_output_length
    dst_mflimit = dst_end - MFLIMIT
    dst_lastlits = dst_end - LASTLITERALS
    src_last3 = src_end - (2 + 1 + LASTLITERALS)
    src_last1 = src_end - (LASTLITERALS + 1)

    try:
        while True:
            token = src[sp]
            sp += 1

            length = token >> ML_BITS
            if length == RUN_MASK:
                b = 255
                while sp < src_end and b == 255:
                    b = src[sp]
                    sp += 1
                    length += b

            lit_end = dp + length
            if lit_end > dst_mflimit or sp + length > src_last3:
                if lit_end > dst_end:
                    raise CorruptedBlockError("output overflow")
                if sp + length != src_end:
                    raise CorruptedBlockError(
                        "input not fully consumed at terminal run")
                yield sp, length, 0, 0
                return
            lit = sp
            sp += length

            offset = src[sp] | (src[sp + 1] << 8)
            sp += 2
            if lit_end - offset < 0 or offset == 0:
                raise CorruptedBlockError("match offset outside block")

            mlen = token & ML_MASK
            if mlen == ML_MASK:
                while sp < src_last1:
                    b = src[sp]
                    sp += 1
                    mlen += b
                    if b != 255:
                        break
            mlen += MINMATCH

            if lit_end + mlen > dst_lastlits:
                raise CorruptedBlockError(
                    "match extends into last-5-literals zone")
            yield lit, length, offset, mlen
            dp = lit_end + mlen
    except IndexError as exc:
        raise CorruptedBlockError("truncated input") from exc


def decompress_block_unknown(src, max_output_length: int) -> bytes:
    """Unknown-output-length decode — the hardened, fully bounds-checked
    variant (reference `LZ4_uncompress_unknownOutputSize`,
    `Safe64.Dirty.cs:665-798`).  Consumes the whole input and returns the
    decoded bytes (up to ``max_output_length``)."""
    src = bytes(src)
    dst = bytearray()
    for lit, length, offset, mlen in _unknown_sequences(src,
                                                        max_output_length):
        dst += src[lit:lit + length]
        if mlen:
            _copy_match(dst, len(dst) - offset, mlen)
    return bytes(dst)


def unknown_output_length(src, max_output_length: int) -> int:
    """The length ``decompress_block_unknown`` decodes ``src`` to, from
    its header walk alone (literal bytes are skipped, nothing is copied);
    raises its CorruptedBlockError where it does."""
    return sum(length + mlen for _, length, _, mlen in
               _unknown_sequences(bytes(src), max_output_length))


# ---------------------------------------------------------------------------
# High-compression (HC) encoder — r93 lazy two-ahead parser
# ---------------------------------------------------------------------------

class _HcState:
    """Chain-based match finder state: 32K-entry head table plus 64K-entry
    u16 delta chain (reference `LZ4HC_Data_Structure`, `Safe.cs:580-618`)."""

    __slots__ = ("src", "src_end", "cap", "heads", "chain", "next_to_update",
                 "attempts")

    def __init__(self, src: bytes, attempts: int = MAX_NB_ATTEMPTS):
        self.src = src
        self.src_end = len(src)
        self.cap = len(src) - LASTLITERALS
        self.heads = array("i", bytes(4 * HASHHC_TABLESIZE))
        self.chain = array("H", b"\xff\xff" * MAXD)
        self.next_to_update = 1
        self.attempts = attempts

    def insert_upto(self, p: int) -> None:
        src, heads, chain = self.src, self.heads, self.chain
        q = self.next_to_update
        while q < p:
            h = _hash(src, q, HASHHC_ADJUST)
            delta = q - heads[h]
            if delta > MAX_DISTANCE:
                delta = MAX_DISTANCE
            chain[q & MAXD_MASK] = delta
            heads[h] = q
            q += 1
        self.next_to_update = q

    def common_length(self, p: int, ref: int) -> int:
        return _match_extension(self.src, p, ref, self.cap)

    def find_best_match(self, p: int) -> tuple[int, int]:
        """Longest match at p; returns (match_len, match_pos), match_len==0
        if none.  Includes the repetition fast path that pre-fills the chain
        (`Safe64HC.Dirty.cs:125-192`)."""
        src, chain = self.src, self.chain
        self.insert_upto(p)
        ref = self.heads[_hash(src, p, HASHHC_ADJUST)]
        nb = self.attempts
        ml = 0
        match_pos = 0
        repl = 0
        delta = 0

        if ref >= p - 4:  # potential short-period repetition
            if _eq4(src, ref, p):
                delta = p - ref
                repl = ml = self.common_length(p + MINMATCH, ref + MINMATCH) + MINMATCH
                match_pos = ref
            ref -= chain[ref & MAXD_MASK]

        while ref >= p - MAX_DISTANCE and nb != 0:
            nb -= 1
            if src[ref + ml] == src[p + ml] and _eq4(src, ref, p):
                mlt = self.common_length(p + MINMATCH, ref + MINMATCH) + MINMATCH
                if mlt > ml:
                    ml = mlt
                    match_pos = ref
            ref -= chain[ref & MAXD_MASK]

        if repl != 0:  # pre-fill the chain across the repetitive region
            ptr = p
            end = p + repl - (MINMATCH - 1)
            while ptr < end - delta:
                chain[ptr & MAXD_MASK] = delta
                ptr += 1
            while ptr < end:
                chain[ptr & MAXD_MASK] = delta
                self.heads[_hash(src, ptr, HASHHC_ADJUST)] = ptr
                ptr += 1
            self.next_to_update = end

        return ml, match_pos

    def find_wider_match(self, p: int, start_limit: int, longest: int,
                         match_pos: int, start_pos: int) -> tuple[int, int, int]:
        """Search for a match at p that can also extend backwards past
        start_limit (`Safe64HC.Dirty.cs:194-265`); returns
        (longest, match_pos, start_pos)."""
        src, chain = self.src, self.chain
        self.insert_upto(p)
        ref = self.heads[_hash(src, p, HASHHC_ADJUST)]
        nb = self.attempts
        delta = p - start_limit

        while ref >= p - MAX_DISTANCE and nb != 0:
            nb -= 1
            if src[start_limit + longest] == src[ref - delta + longest] \
                    and _eq4(src, ref, p):
                fwd = self.common_length(p + MINMATCH, ref + MINMATCH) + MINMATCH
                # backwards extension
                back = 0
                while p - back > start_limit and ref - back > 0 \
                        and src[p - back - 1] == src[ref - back - 1]:
                    back += 1
                total = fwd + back
                if total > longest:
                    longest = total
                    match_pos = ref - back
                    start_pos = p - back
            ref -= chain[ref & MAXD_MASK]

        return longest, match_pos, start_pos


def _hc_emit(dst: bytearray, src: bytes, anchor: int, p: int, mlen: int,
             ref: int, dst_maxlen: int) -> tuple[int, int, bool]:
    """Emit one sequence; returns (new_p, new_anchor, overflowed)."""
    lit_len = p - anchor
    token_pos = len(dst)
    dst.append(0)
    if len(dst) + lit_len + (2 + 1 + LASTLITERALS) + (lit_len >> 8) > dst_maxlen:
        return p, anchor, True
    _emit_literal_run(dst, token_pos, lit_len, src, anchor)

    offset = p - ref
    dst.append(offset & 0xFF)
    dst.append(offset >> 8)

    if len(dst) + (1 + LASTLITERALS) + (lit_len >> 8) > dst_maxlen:
        return p, anchor, True
    _emit_match_length(dst, token_pos, mlen - MINMATCH)

    p += mlen
    return p, p, False


def compress_block_hc(src, dst_maxlen: int | None = None,
                      attempts: int = MAX_NB_ATTEMPTS,
                      data_start: int = 0) -> bytes:
    """HC-compress one block with the r93 lazy two-ahead parser
    (`Safe64HC.Dirty.cs:333-522`).  ``attempts`` generalises the reference's
    fixed 256-attempt chain walk into compression levels; attempts=256
    reproduces the reference parse bit-for-bit.

    ``data_start`` > 0 treats src[:data_start] as a preset dictionary:
    the match finder indexes it but emission starts at data_start."""
    src = bytes(src)
    n = len(src)
    if n - data_start <= 0:
        return b""
    if dst_maxlen is None:
        dst_maxlen = maximum_output_length(n - data_start)

    st = _HcState(src, attempts)
    dst = bytearray()
    mflimit = n - MFLIMIT
    anchor = data_start
    p = max(1, data_start)
    start2 = ref2 = ml2 = 0
    start3 = ref3 = ml3 = 0

    while p < mflimit:
        ml, ref = st.find_best_match(p)
        if ml == 0:
            p += 1
            continue

        start0, ref0, ml0 = p, ref, ml

        # The reference's goto-based lazy parser (_Search2/_Search3 labels)
        # expressed as an explicit two-state machine.
        state = "search2"
        while state != "done":
            if state == "search2":
                if p + ml < mflimit:
                    ml2, ref2, start2 = st.find_wider_match(
                        p + ml - 2, p + 1, ml, ref2, start2)
                else:
                    ml2 = ml

                if ml2 == ml:  # no better second match: emit and restart scan
                    p, anchor, ovf = _hc_emit(dst, src, anchor, p, ml, ref, dst_maxlen)
                    if ovf:
                        return b""
                    state = "done"
                    continue

                if start0 < p and start2 < p + ml0:  # rolled-forward too far
                    p, ref, ml = start0, ref0, ml0

                if start2 - p < 3:  # first match too small: adopt second, retry
                    ml, p, ref = ml2, start2, ref2
                    continue  # stay in search2

                state = "search3"
                continue

            # state == "search3"
            # trim overlap between match1 and match2 toward OPTIMAL_ML
            if start2 - p < OPTIMAL_ML:
                new_ml = min(ml, OPTIMAL_ML)
                if p + new_ml > start2 + ml2 - MINMATCH:
                    new_ml = start2 - p + ml2 - MINMATCH
                corr = new_ml - (start2 - p)
                if corr > 0:
                    start2 += corr
                    ref2 += corr
                    ml2 -= corr

            if start2 + ml2 < mflimit:
                ml3, ref3, start3 = st.find_wider_match(
                    start2 + ml2 - 3, start2, ml2, ref3, start3)
            else:
                ml3 = ml2

            if ml3 == ml2:  # no third match: emit the two sequences
                if start2 < p + ml:
                    ml = start2 - p
                p, anchor, ovf = _hc_emit(dst, src, anchor, p, ml, ref, dst_maxlen)
                if ovf:
                    return b""
                p = start2
                p, anchor, ovf = _hc_emit(dst, src, anchor, p, ml2, ref2, dst_maxlen)
                if ovf:
                    return b""
                state = "done"
                continue

            if start3 < p + ml + 3:  # not enough room for match2
                if start3 >= p + ml:
                    # drop match2 entirely; match3 becomes the new first match
                    if start2 < p + ml:
                        corr = p + ml - start2
                        start2 += corr
                        ref2 += corr
                        ml2 -= corr
                        if ml2 < MINMATCH:
                            start2, ref2, ml2 = start3, ref3, ml3
                    p, anchor, ovf = _hc_emit(dst, src, anchor, p, ml, ref, dst_maxlen)
                    if ovf:
                        return b""
                    p, ref, ml = start3, ref3, ml3
                    start0, ref0, ml0 = start2, ref2, ml2
                    state = "search2"
                    continue
                start2, ref2, ml2 = start3, ref3, ml3
                continue  # retry search3

            # three ascending matches: emit the first, shift the window
            if start2 < p + ml:
                if start2 - p < ML_MASK:
                    if ml > OPTIMAL_ML:
                        ml = OPTIMAL_ML
                    if p + ml > start2 + ml2 - MINMATCH:
                        ml = start2 - p + ml2 - MINMATCH
                    corr = ml - (start2 - p)
                    if corr > 0:
                        start2 += corr
                        ref2 += corr
                        ml2 -= corr
                else:
                    ml = start2 - p
            p, anchor, ovf = _hc_emit(dst, src, anchor, p, ml, ref, dst_maxlen)
            if ovf:
                return b""
            p, ref, ml = start2, ref2, ml2
            start2, ref2, ml2 = start3, ref3, ml3
            # stay in search3 with the shifted candidates

    # last literals
    last_run = n - anchor
    if len(dst) + last_run + 1 + (last_run + 255 - RUN_MASK) // 255 > dst_maxlen:
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
    dst += src[anchor:n]

    return bytes(dst)


def compress_block_hc_dict(dictionary: bytes, data: bytes,
                           dst_maxlen: int | None = None,
                           attempts: int = MAX_NB_ATTEMPTS) -> bytes:
    """HC compression with a preset dictionary (see compress_block_dict)."""
    dictionary = bytes(dictionary)
    data = bytes(data)
    if not dictionary:
        return compress_block_hc(data, dst_maxlen, attempts)
    return compress_block_hc(dictionary + data, dst_maxlen, attempts,
                             data_start=len(dictionary))
