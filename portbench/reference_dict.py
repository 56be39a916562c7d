"""The plain reference for blocks behind a preset dictionary, in scalar
Python, beside ``portbench/reference.py`` (whose rules and emitters it
takes).  It imports nothing of the program.

* ``decompress_block_dict``: the known-length decoder with the reference
  decoder's rules, the dictionary's bytes logically before the block:
  matches may reach back into them (at most 65,535 bytes back), and the
  end rules count from the block's end; it raises
  ``CorruptedBlockError`` for a block that breaks one.
* ``compress_block_dict``: a plain greedy parse against a dictionary (a
  table of each 4-byte key's last position, the dictionary's last 64 KB
  entered first; no catch-up), valid under those rules.  It is no
  program's parse: the cell's control uses it, with a window one byte
  off.
"""

from __future__ import annotations

import functools

from portbench.reference import (LASTLITERALS, MAX_DISTANCE, MFLIMIT,
                                 MINMATCH, ML_BITS, ML_MASK, RUN_MASK,
                                 COPYLENGTH, CorruptedBlockError,
                                 _copy_match, _emit_literal_run,
                                 _emit_match_length)

WINDOW = 1 << 16        # the most of a dictionary that LZ4 uses


def decompress_block_dict(src, dictionary: bytes,
                          output_length: int) -> bytes:
    """Known-output-length decode of ``src`` behind ``dictionary``:
    exactly ``output_length`` bytes, or ``CorruptedBlockError``."""
    src = bytes(src)
    dst = bytearray(dictionary)
    base = len(dst)
    dst_end = base + output_length
    dst_copylen = dst_end - COPYLENGTH
    dst_lastlits = dst_end - LASTLITERALS
    sp = 0
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
                # the terminal literal run lands exactly on the block end
                if lit_end != dst_end:
                    raise CorruptedBlockError("literal run overruns block end")
                if sp + length > len(src):
                    raise CorruptedBlockError("literal run overruns input")
                dst += src[sp:sp + length]
                break
            dst += src[sp:sp + length]
            sp += length

            offset = src[sp] | (src[sp + 1] << 8)
            sp += 2
            ref = len(dst) - offset
            if ref < 0 or offset == 0:
                raise CorruptedBlockError("match offset outside the window")
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
            _copy_match(dst, ref, mlen, True)
    except IndexError as exc:
        raise CorruptedBlockError("truncated input") from exc
    if len(dst) != dst_end:
        raise CorruptedBlockError("decoded length mismatch")
    return bytes(dst[base:])


@functools.lru_cache(maxsize=4)
def _window_table(window: bytes) -> dict:
    """Each 4-byte key's last position in ``window``."""
    return {window[i:i + 4]: i for i in range(len(window) - 3)}


def compress_block_dict(dictionary: bytes, src) -> bytes:
    """A greedy parse of ``src`` behind ``dictionary``'s last 64 KB: at
    each position the last earlier occurrence of its 4 bytes, taken
    where it is at most 65,535 bytes back and extended forward; no match
    starts in the last 12 bytes or runs into the last 5."""
    window = bytes(dictionary)[-WINDOW:]
    src = bytes(src)
    buf = window + src
    end = len(buf)
    table = dict(_window_table(window))
    mflimit = end - MFLIMIT         # the last position a match starts at
    cap = end - LASTLITERALS        # matches end at most here
    dst = bytearray()
    anchor = p = len(window)
    while p <= mflimit:
        key = buf[p:p + 4]
        ref = table.get(key)
        table[key] = p
        if ref is None or p - ref > MAX_DISTANCE:
            p += 1
            continue
        mlen = MINMATCH
        while p + mlen < cap and buf[ref + mlen] == buf[p + mlen]:
            mlen += 1
        token_pos = len(dst)
        dst.append(0)
        _emit_literal_run(dst, token_pos, p - anchor, buf, anchor)
        offset = p - ref
        dst += bytes((offset & 0xFF, offset >> 8))
        _emit_match_length(dst, token_pos, mlen - MINMATCH)
        for q in range(p + 1, min(p + mlen, mflimit + 1)):
            table[buf[q:q + 4]] = q
        p += mlen
        anchor = p
    last = end - anchor
    if last >= RUN_MASK:
        dst.append(RUN_MASK << ML_BITS)
        rem = last - RUN_MASK
        while rem > 254:
            dst.append(255)
            rem -= 255
        dst.append(rem)
    else:
        dst.append(last << ML_BITS)
    dst += buf[anchor:]
    return bytes(dst)
