"""Deterministic benchmark/test corpus.

The port's own copy of ``silesia_like`` and ``split_blocks`` from the JAX
package's ``lz4net_tpu/utils/corpus.py`` (:171, :243), with their
generators: a seeded synthetic corpus whose components imitate the
Silesia mix (English text, XML, source code, databases, binaries, noisy
sensor data) with compression ratios in the same regime.

Differences from the JAX copy: no disk cache and no ``SILESIA_DIR``
override, and the "source" component (1/6 of the corpus) is Python-like
code generated from the seed, where the JAX copy cycles its package's own
Python files; so the corpus does not move when the port's code does.
The other components are byte-identical to the JAX corpus's.
"""

from __future__ import annotations

import hashlib
import random

_WORDS = (
    "the of and a to in is was he for it with as his on be at by i this had "
    "not are but from or have an they which one you were her all she there "
    "would their we him been has when who will more no if out so said what "
    "up its about into than them can only other new some could time these "
    "two may then do first any my now such like our over man me even most "
    "made after also did many before must through back years where much "
    "your way well down should because each just those people mr how too "
    "little state good very make world still own see men work long get "
    "here between both life being under never day same another know while "
    "last might us great old year off come since against go came right "
    "used take three").split()

_TAGS = ["item", "record", "entry", "field", "value", "name", "id", "data",
         "node", "attr", "meta", "ref"]


def _vocab(rng: random.Random, n: int = 4096) -> list:
    """Pseudo-English vocabulary of a few thousand words, so literal-run
    and match-length statistics resemble real English text."""
    syll = ("a an ar as at be ca co con da de di do en er es ex fa fi "
            "ga ge ha he hi in is it la le li lo ma me mi mo mu na ne "
            "ni no nu or ou pa pe pi po pre pro ra re ri ro ru sa se "
            "si so su ta te ti to tra tri tu un ur us va ve vi vo").split()
    words = list(_WORDS)
    seen = set(words)
    while len(words) < n:
        w = "".join(rng.choice(syll) for _ in range(rng.randint(2, 4)))
        if w not in seen:
            seen.add(w)
            words.append(w)
    return words


def _text(rng: random.Random, size: int) -> bytes:
    """Dickens/webster-like English text, words drawn Zipf-like."""
    words = _vocab(rng)
    nw = len(words)
    out = []
    n = 0
    while n < size:
        sentence = []
        for _ in range(rng.randint(5, 18)):
            r = int(nw ** rng.random()) - 1
            sentence.append(words[r])
        s = " ".join(sentence).capitalize() + ". "
        out.append(s)
        n += len(s)
        if rng.random() < 0.08:
            out.append("\n")
            n += 1
    return "".join(out).encode()[:size]


def _xml(rng: random.Random, size: int) -> bytes:
    """Highly-structured XML."""
    out = ["<?xml version=\"1.0\"?>\n<root>\n"]
    n = len(out[0])
    while n < size:
        tag = rng.choice(_TAGS)
        val = rng.choice(_WORDS) if rng.random() < 0.7 else str(
            rng.randint(0, 99999))
        s = f"  <{tag} id=\"{rng.randint(0, 9999)}\">{val}</{tag}>\n"
        out.append(s)
        n += len(s)
    out.append("</root>\n")
    return "".join(out).encode()[:size]


def _source(rng: random.Random, size: int) -> bytes:
    """Python-like source code generated from a copy of ``rng``: functions
    of assignments, calls, loops, comments and returns over a few hundred
    identifiers.  The copy leaves ``rng`` where it was, so the other
    components stay those of the JAX corpus."""
    state = rng.getstate()
    rng = random.Random()
    rng.setstate(state)
    words = _vocab(rng, 1024)[len(_WORDS):]
    idents = [f"{rng.choice(_WORDS)}_{w}" for w in words[:400]]
    out = []
    n = 0
    while n < size:
        args = rng.sample(idents, rng.randint(1, 4))
        lines = [f"def {rng.choice(idents)}({', '.join(args)}):",
                 f'    """{rng.choice(_WORDS).capitalize()} '
                 f'{" ".join(rng.sample(_WORDS, 6))}."""']
        for _ in range(rng.randint(3, 12)):
            ind = "    " * rng.randint(1, 3)
            a, b, c = rng.choice(args), rng.choice(idents), rng.choice(idents)
            r = rng.random()
            if r < 0.4:
                lines.append(f"{ind}{b} = {a}.{c}({rng.choice(args)}, "
                             f"{rng.randint(0, 255)})")
            elif r < 0.55:
                lines.append(f"{ind}if {a} is not None and {b} < "
                             f"{rng.randint(0, 4096)}:")
            elif r < 0.7:
                lines.append(f"{ind}for {b} in range(len({a})):")
            elif r < 0.85:
                lines.append(f"{ind}# {' '.join(rng.sample(_WORDS, 7))}")
            else:
                lines.append(f"{ind}return {a}")
        s = "\n".join(lines) + "\n\n\n"
        out.append(s)
        n += len(s)
    return "".join(out).encode()[:size]


def _database(rng: random.Random, size: int) -> bytes:
    """Repetitive fixed-ish database rows."""
    out = []
    n = 0
    row_id = 0
    while n < size:
        row = (f"{row_id:08d}|{rng.choice(_WORDS):<12s}|"
               f"{rng.randint(0, 999):03d}|"
               f"{'ACTIVE' if row_id % 7 else 'VOID'}|"
               f"{rng.choice(_TAGS)}\n")
        out.append(row)
        n += len(row)
        row_id += 1
    return "".join(out).encode()[:size]


def _binary(rng: random.Random, size: int) -> bytes:
    """Machine-code-ish binary with embedded strings and zero runs."""
    out = bytearray()
    while len(out) < size:
        r = rng.random()
        if r < 0.35:
            out += bytes(rng.getrandbits(8) for _ in range(rng.randint(8, 64)))
        elif r < 0.55:
            out += bytes([0]) * rng.randint(4, 96)
        elif r < 0.8:
            op = bytes([rng.getrandbits(8), rng.getrandbits(8)])
            out += op * rng.randint(2, 12)
        else:
            out += rng.choice(_WORDS).encode() + b"\x00"
    return bytes(out[:size])


def _noisy(rng: random.Random, size: int) -> bytes:
    """Nearly incompressible sensor-like data."""
    h = hashlib.sha256(str(rng.random()).encode()).digest()
    out = bytearray()
    ctr = 0
    while len(out) < size:
        out += hashlib.sha256(h + ctr.to_bytes(8, "little")).digest()
        ctr += 1
    b = bytearray(out[:size])
    b[::4] = bytes(v & 0x3F for v in b[::4])
    return bytes(b)


_PROFILES = {
    "text": (_text, 4),
    "xml": (_xml, 1),
    "source": (_source, 2),
    "database": (_database, 2),
    "binary": (_binary, 2),
    "noisy": (_noisy, 1),
}


def silesia_like(total_size: int = 16 << 20, seed: int = 0) -> bytes:
    """Deterministic synthetic Silesia-like corpus of ``total_size`` bytes."""
    rng = random.Random(seed)
    weights = sum(w for _, w in _PROFILES.values())
    parts = []
    for _name, (gen, w) in sorted(_PROFILES.items()):
        parts.append(gen(rng, total_size * w // weights))
    data = b"".join(parts)[:total_size]
    if len(data) < total_size:
        data += _text(rng, total_size - len(data))
    return data


def split_blocks(data: bytes, block_size: int) -> list[bytes]:
    """Split a buffer into independent codec blocks."""
    return [data[i:i + block_size] for i in range(0, len(data), block_size)]


def strict_edge_rows(seed: int = 0) -> list:
    """Blocks and budgets that drive the strict encoder's edge cases:
    [(name, block, budget)], budget None for the worst-case bound.

    * a 64 KB run of zeros (one match to the end) and 64 KB of random
      bytes (no match; the skip step grows past 1);
    * distinct 4-byte words that all land in one slot of both hash
      tables (the multiplier is odd, so each slot's words are
      ``(slot << 19 | r) * inverse``): collisions inside every probe
      window with no match, then with matches, then in the large table;
    * blocks of 12, 13, ``LZ4_64KLIMIT - 1`` and ``LZ4_64KLIMIT`` bytes;
    * budgets at each of the three output-limit checks (the check fails,
      then the budget one byte larger): 999 random bytes and a 1 before
      3000 zeros (1006 literals, then one match) stop at the literal-run
      check and then at the match-length check, 64 KB of zeros at the
      match-length check and then at the last literals, 4096 random
      bytes (no match) at the last literals, then fit; and a block one
      byte over budget.
    """
    from ..constants import LZ4_64KLIMIT
    from ..models.reference import compress_block

    rng = random.Random(seed)
    inverse = pow(2654435761, -1, 1 << 32)
    same = b"".join((((5 << 19) | r) * inverse % (1 << 32)).to_bytes(
        4, "little") for r in rng.sample(range(1 << 19), 4096))
    text = silesia_like(LZ4_64KLIMIT, seed)
    zeros = bytes(65536)
    lits = rng.randbytes(999) + b"\x01" + bytes(3000)
    noise = rng.randbytes(4096)
    full = len(compress_block(noise))
    block = silesia_like(65536, seed + 1)
    return [
        ("zeros", zeros, None),
        ("random", rng.randbytes(65536), None),
        ("collide", same, None),
        ("collide_repeat", same[:8192] * 4, None),
        ("collide_large", (same * 5)[:LZ4_64KLIMIT + 5000], None),
        ("len_12", text[:12], None),
        ("len_13", text[:13], None),
        ("len_64klimit_m1", text[:LZ4_64KLIMIT - 1], None),
        ("len_64klimit", text, None),
        ("literals_check", lits, 1017),
        ("literals_check_passed", lits, 1018),
        ("match_check", zeros, 264),
        ("match_check_passed", zeros, 265),
        ("last_literals_check", noise, full - 1),
        ("last_literals_fit", noise, full),
        ("one_below", block, len(compress_block(block)) - 1),
    ]


def _lz4_length(n: int) -> bytes:
    """The 255-extension bytes of a length nibble of 15 (n = length - 15)."""
    return b"\xff" * (n // 255) + bytes([n % 255])


def _lz4_sequences(seqs, last: bytes) -> bytes:
    """An LZ4 block from ``seqs`` [(literals, offset, match length)], each
    match at least 4 bytes, then the literal run ``last``."""
    out = bytearray()
    for lits, offset, mlen in seqs:
        L, M = len(lits), mlen - 4
        out.append(min(L, 15) << 4 | min(M, 15))
        if L >= 15:
            out += _lz4_length(L - 15)
        out += lits + offset.to_bytes(2, "little")
        if M >= 15:
            out += _lz4_length(M - 15)
    out.append(min(len(last), 15) << 4)
    if len(last) >= 15:
        out += _lz4_length(len(last) - 15)
    return bytes(out + last)


def decode_edge_rows(seed: int = 0) -> list:
    """Compressed blocks that drive the decode kernels' edge cases:
    [(name, block, out_len)].  The first rows are well-formed (out_len is
    the decoded length), the rows named ``junk_*`` break one fault rule
    of ``ops.decode_sequencer`` each.

    * matches at every offset from 1 to 33 and at offsets equal to dp
      (the whole output so far);
    * a match of 20,000 bytes after a 4050-byte literal run, so its 78
      0xFF length bytes straddle compressed offsets 4096 and 4128;
    * literal runs of 3000, 3000 and 1900 bytes, the second across
      compressed offset 4096 (short matches between them);
    * literal-only blocks whose lengths are 1023, 1024, 1025, 4095, 4096
      and 4097 bytes, so comp_len sits on and beside multiples of 32,
      1024 and 4096;
    * an 11 KB text block (tokens and chain jumps everywhere).

    The long match's row has the longest output, so its out_len is the
    batch's D.  Every block is below 8 KB, so the decode path packs the
    rows at C = 8192.
    * junk: a truncated block (a read at comp_len); a length extension
      that runs off the end; a literal run that would end past out_len
      but not at it; a match ending inside the last five bytes; offsets
      0 and dp + 1.  (A write past D needs out_len > D: callers pass a D
      one byte short of the longest row for it.)
    """
    from ..models.reference import compress_block

    rng = random.Random(seed)

    def rand(n):
        return rng.randbytes(n)

    tail = rand(16)
    offsets = [(rand(1 + k % 3), k, 4 + (7 * k) % 40) for k in range(1, 34)]
    rows = [
        ("offsets_1_to_33", _lz4_sequences([(rand(64), 64, 4)] + offsets,
                                          tail)),
        ("offset_equals_dp", _lz4_sequences(
            [(rand(37), 37, 100), (rand(5), 142, 60)], tail)),
        ("long_match", _lz4_sequences([(rand(4050), 4050, 20000),
                                      (rand(3), 7, 19)], tail)),
        ("literals_across_4k", _lz4_sequences(
            [(rand(3000), 100, 8), (rand(3000), 3000, 12),
             (rand(1900), 7, 9)], tail)),
    ]
    for target in (1023, 1024, 1025, 4095, 4096, 4097):
        n = next(n for n in range(target, 0, -1)
                 if len(_lz4_sequences([], bytes(n))) == target)
        rows.append((f"literals_only_{target}",
                     _lz4_sequences([], rand(n))))
    rows.append(("text_11k", compress_block(silesia_like(11 * 1024,
                                                          seed + 7))))

    out = [(name, blk, len(_decoded(blk))) for name, blk in rows]
    lits = rand(40)
    out += [
        ("junk_truncated", out[-1][1][:len(out[-1][1]) // 2], out[-1][2]),
        ("junk_ext_past_end", b"\xf0" + b"\xff" * 50, 1000),
        ("junk_literals_past_end",
         _lz4_sequences([], lits), 36),          # ends at 40, not at 36
        ("junk_match_in_last_five",
         _lz4_sequences([(lits, 40, 10)], b"abc"), 53),
        ("junk_offset_0", _lz4_sequences([(lits, 0, 10)], tail), 66),
        ("junk_offset_past_dp", _lz4_sequences([(lits, 41, 10)], tail), 66),
    ]
    return out


def _decoded(block: bytes) -> bytes:
    """The bytes a well-formed block decodes to, by a plain token walk
    with no end-of-block rules (for sizing the edge rows)."""
    dst = bytearray()
    sp = 0
    while True:
        token = block[sp]
        sp += 1
        lit = token >> 4
        if lit == 15:
            while True:
                v = block[sp]
                sp += 1
                lit += v
                if v != 255:
                    break
        dst += block[sp:sp + lit]
        sp += lit
        if sp >= len(block):
            return bytes(dst)
        offset = block[sp] | block[sp + 1] << 8
        sp += 2
        mlen = token & 15
        if mlen == 15:
            while True:
                v = block[sp]
                sp += 1
                mlen += v
                if v != 255:
                    break
        for _ in range(mlen + 4):
            dst.append(dst[-offset])


def parse_edge_rows(seed: int = 0):
    """``decode_edge_rows`` packed as the decode path packs them (C the
    next multiple of 4096 above the longest block), then six junk rows
    of the same width: seeded random bytes with 0xFF runs across the
    parse kernel's 1024-position tiles, at a 4096 boundary and at the
    row's end, and an all-0xFF row, with comp_len C, C - 1, 4096, 4095, 1
    and 0.  Returns (comp [B, C] int32, comp_len [B] int32, C) as numpy
    arrays."""
    import numpy as np

    blocks = [b for _, b, _ in decode_edge_rows(seed)]
    C = -(-(max(map(len, blocks)) + 1) // 4096) * 4096
    comp = np.zeros((len(blocks) + 6, C), np.int32)
    for i, b in enumerate(blocks):
        comp[i, :len(b)] = np.frombuffer(b, np.uint8)
    junk = np.random.default_rng(seed).integers(0, 256, (6, C), np.int32)
    junk[0, 1000:3100] = 255
    junk[1, :] = 255
    junk[2, C - 600:] = 255
    junk[3, 4090:4100] = 255
    comp[len(blocks):] = junk
    comp_len = np.array([len(b) for b in blocks]
                        + [C, C - 1, 4096, 4095, 1, 0], np.int32)
    return comp, comp_len, C
