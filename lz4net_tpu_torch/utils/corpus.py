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


# strict_wide_rows' catch_up row: noise, then a stretch of CATCH_UP[1]
# random bytes at CATCH_UP[0], repeated at once
CATCH_UP = (400_000, 59_619)


def strict_wide_rows(seed: int = 0, width: int = 1 << 20) -> list:
    """Rows of ``width`` bytes (at least 1 MB), wider than the strict
    encoder stages in shared memory, that drive the edge cases of its
    wide-row kernel, which reads them from device memory: [(name, block,
    budget)], budget None for the worst-case bound.

    * silesia-like text;
    * zeros (one match to the end: an extension over the whole row);
    * noise (no match: last literals of the whole row);
    * a 65,535-byte period repeated (one match at the window's distance
      limit, whose candidates are the oldest bytes the window reaches);
    * ``catch_up``: noise with a stretch of CATCH_UP[1] bytes at
      CATCH_UP[0] repeated at once.  Until a match is found the skip
      loop's probe positions depend only on its attempt counter, and its
      first probe whose position less CATCH_UP[1] is a probed position
      lies 50,175 bytes into the copy; so the match comes after a literal
      run of CATCH_UP[0] + CATCH_UP[1] bytes, and its catch-up runs back
      50,175 bytes or more, its reference side to 109,794 or more behind
      the probe;
    * a short row (the small hash variant) and silesia-like text 5 bytes
      wider than ``width`` (a batch at that width starts its rows at each
      alignment of a word, and each but the first off a 16-byte
      boundary);
    * budgets at each of the three output-limit checks (the check fails,
      then the budget one byte larger): the catch_up row at its literal
      run, zeros at the match length, noise at the last literals.
    """
    from ..constants import LASTLITERALS
    from ..models.reference import compress_block

    rng = random.Random(seed)
    at, span = CATCH_UP
    noise = rng.randbytes(width)
    stretch = bytearray(rng.randbytes(span))
    head = bytearray(noise[:at])
    head[-1] = stretch[-1] ^ 1          # the catch-up stops at the copy
    catch_up = (bytes(head) + bytes(stretch) * 2 + noise)[:width]
    zeros = bytes(width)
    lits = at + span                     # the catch_up row's first run
    mlen = width - 2 * LASTLITERALS      # zeros: one match from byte 1
    full = len(compress_block(noise))
    return [
        ("text", silesia_like(width, seed), None),
        ("zeros", zeros, None),
        ("noise", noise, None),
        ("period", (rng.randbytes(65535) * (width // 65535 + 1))[:width],
         None),
        ("catch_up", catch_up, None),
        ("short", silesia_like(4000, seed + 2), None),
        ("odd_width", silesia_like(width + 5, seed + 1), None),
        ("literals_check", catch_up, lits + (lits >> 8) + 8),
        ("literals_check_passed", catch_up, lits + (lits >> 8) + 9),
        ("match_check", zeros, 9 + (mlen >> 8)),
        ("match_check_passed", zeros, 10 + (mlen >> 8)),
        ("last_literals_check", noise, full - 1),
        ("last_literals_fit", noise, full),
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


def _u32_words(x):
    """Little-endian 4-byte words of the byte rows ``x`` [B, D] at every
    position (zero past the row), as int32 numpy arrays."""
    import numpy as np

    w = np.zeros(x.shape, np.int64)
    for k in range(4):
        w[:, :x.shape[1] - k] |= x[:, k:].astype(np.int64) << (8 * k)
    return w.astype(np.uint32).view(np.int32)


def seq_edge_rows(D: int, seed: int = 0):
    """Per-position match state that drives ``sequence_records``' edge
    cases, for blocks of D bytes (D a multiple of 4096): (names, u32,
    matched, off, mlen, end_abs, pre_len, S_cap), the arrays [B, D] (the
    last two [B]) int32 numpy, u32 the words of each row's bytes, S_cap
    the encoder's record cap for D.

    * all literals (nothing matched);
    * one match covering the row from position 16 to its end;
    * matches up to the row's end, the last running 5000 bytes past D;
    * matched positions whose mlen is -2, -1 or 0 (each steps by one)
      among short matches;
    * sparse matches long enough to skip whole 32-position segments,
      128-position groups and 1024-position tiles of the kernel's parse;
    * every position matched with mlen 1: D tokens, past S_cap;
    * bytes of period 7 with matches at offset 7 every 13 bytes, so each
      match's catch-up runs over its whole literal run;
    * dense random matches at random offsets, and the row's data 300
      bytes short of D.
    """
    import numpy as np

    rng = np.random.default_rng(seed)
    names = ["all_literals", "one_match", "match_past_d", "mlen_le_0",
             "skips", "overflow", "catch_up", "dense"]
    B = len(names)
    x = np.zeros((B, D), np.uint8)
    text = np.frombuffer(silesia_like(D, seed), np.uint8)
    x[:] = text
    x[6] = np.resize(rng.integers(0, 256, 7, np.uint8), D)
    x[7] = rng.integers(0, 256, D, np.uint8)
    matched = np.zeros((B, D), np.int32)
    off = np.zeros((B, D), np.int32)
    mlen = np.zeros((B, D), np.int32)
    matched[1, 16], off[1, 16], mlen[1, 16] = 1, 16, D - 16
    q = np.arange(64, D - 100, 97)
    matched[2, q], off[2, q], mlen[2, q] = 1, 64, 40
    matched[2, D - 100], off[2, D - 100], mlen[2, D - 100] = 1, 200, 5000
    m = rng.random(D) < 0.5
    matched[3] = m
    off[3] = rng.integers(1, 100, D)
    mlen[3] = np.where(rng.random(D) < 0.5, rng.integers(-2, 1, D),
                       rng.integers(4, 12, D))
    q, k = 5, 0
    while q < D:                       # skips of a segment, group, tile
        matched[4, q], off[4, q] = 1, 1 + q % 500
        mlen[4, q] = (40, 200, 6, 1100, 70, 3000, 6)[k % 7]
        q += mlen[4, q] + int(rng.integers(0, 40))
        k += 1
    matched[5], off[5], mlen[5] = 1, 3, 1
    q = np.arange(13, D, 13)
    matched[6, q], off[6, q], mlen[6, q] = 1, 7, rng.integers(5, 10,
                                                              len(q))
    matched[7] = rng.random(D) < 0.9
    off[7] = rng.integers(1, 30000, D)
    mlen[7] = rng.integers(2, 20, D)
    end_abs = np.full(B, D, np.int32)
    end_abs[7] = D - 300
    S_cap = -(-(D // 4 + 2) // 128) * 128 + 128
    return (names, _u32_words(x), matched, off, mlen, end_abs,
            np.zeros(B, np.int32), S_cap)


def bucket_edge_rows(D: int, seed: int = 0):
    """Byte rows that drive ``bucket_prev``'s edge cases, for blocks of D
    bytes (D a multiple of 512): (names, x [B, D] uint8 numpy).

    * one repeated byte (every word equal: the nearest at distance 1);
    * random bytes of period 127, 128, 129, 255 and 256, across the near
      window's 128-position rows and 512-position chunks;
    * distinct 4-byte words that all land in one bucket of the 4-byte
      table (``(bucket << 19 | r) * inverse`` of the odd multiplier);
    * silesia-like text;
    * ``one_bucket``: text whose every position the caller hashes to one
      bucket of both tables (h4 = h8 = 0), so every chunk hits it more
      than once and the count guard keeps it empty.
    """
    import numpy as np

    rng = np.random.default_rng(seed)
    names = ["repeat", "period_127", "period_128", "period_129",
             "period_255", "period_256", "one_bucket_words", "text",
             "one_bucket"]
    x = np.zeros((len(names), D), np.uint8)
    x[0] = 7
    for j, p in enumerate((127, 128, 129, 255, 256)):
        x[1 + j] = np.resize(rng.integers(0, 256, p, np.uint8), D)
    inverse = pow(2654435761, -1, 1 << 32)
    words = [((5 << 19) | int(r)) * inverse % (1 << 32)
             for r in rng.choice(1 << 19, D // 4, replace=False)]
    x[6] = np.array(words, np.uint32).view(np.uint8)
    x[7] = x[8] = np.frombuffer(silesia_like(D, seed), np.uint8)
    return names, x


def token_edge_rows(C: int, seed: int = 0):
    """Token rows made directly (not parsed) that drive
    ``records_to_state``'s edge cases, at C compressed positions (C a
    multiple of 4096 and at least 8192): (names, comp, mark, ll, ml,
    comp_len, out_len), the first four [B, C] int32 numpy, the last two
    [B].  Each token's 16-bit offset sits at the position the kernel reads
    it (after its token byte, extension and literals); every output stays
    below 24,576 bytes.

    * ``tied_estart``: short tokens, and groups of three marks with
      ll = ml = 0 (three tokens with one estart, the last of which governs
      its bytes), among them groups whose estart is 0, 4096, 8192 and
      12288 (the starts of the kernel's expansion tiles);
    * ``cut_in_literal``, ``cut_in_match``: tokens of 300 literals and a
      50-byte match, out_len inside the tenth token's literals or match;
    * ``long_tokens``: 3000 literals (a 15 nibble and 12 extension bytes)
      and a 15,000-byte match at offset 2 (whole tiles governed by one
      token, the RLE remainder), then tokens at offsets 1-3.
    """
    import numpy as np

    rng = np.random.default_rng(seed)
    names = ["tied_estart", "cut_in_literal", "cut_in_match", "long_tokens"]
    B = len(names)
    comp = rng.integers(0, 240, (B, C)).astype(np.int32)
    mark = np.zeros((B, C), np.int32)
    ll = np.zeros((B, C), np.int32)
    ml = np.zeros((B, C), np.int32)
    comp_len = np.zeros(B, np.int32)
    out_len = np.zeros(B, np.int32)

    def place(row, toks):
        """Tokens [(ll, ml, offset)] from position 0; returns their output
        starts."""
        q, est, starts, offs = 0, 0, [], []
        for lit, mat, offset in toks:
            ext = 1 + (lit - 15) // 255 if lit >= 15 else 0
            comp[row, q] = min(lit, 15) << 4 | min(max(mat - 4, 0), 15)
            mark[row, q], ll[row, q], ml[row, q] = 1, lit, mat
            offs.append((q + 1 + ext + lit, offset))
            starts.append(est)
            est += lit + mat
            q += 1 + ext + lit + (2 if mat else 1)
            if lit == 0 and mat == 0:
                q -= 1                   # a tie: the next mark adjoins
        for mpos, offset in offs:        # after the tokens: kept as read
            comp[row, mpos] = offset & 0xFF
            comp[row, mpos + 1] = offset >> 8
        comp_len[row] = q
        return starts, est

    toks, est = [], 0
    for target in (4096, 8192, 12288, 20000):
        toks += [(0, 0, 0)] * 2          # a tie at the tile start
        while est < target:
            lit, mat = int(rng.integers(0, 13)), int(rng.integers(4, 31))
            if est + lit + mat > target:   # land on the target exactly
                lit, mat = 0, target - est
                if mat < 4:
                    lit, mat = mat, 0
            if len(toks) % 9 == 4:
                toks += [(0, 0, 0)] * 2
            toks.append((lit, mat, int(rng.integers(1, 65)) if mat else 0))
            est += lit + mat
    _, out_len[0] = place(0, toks + [(7, 0, 0)])
    out_len[0] += 7

    cut = [(300, 50, 60)] * 20 + [(10, 0, 0)]
    starts, _ = place(1, cut)
    out_len[1] = starts[9] + 100                  # inside the literals
    starts, _ = place(2, cut)
    out_len[2] = starts[9] + 300 + 20             # inside the match
    starts, total = place(3, [(3000, 15000, 2)] + [
        (int(rng.integers(0, 9)), int(rng.integers(4, 40)),
         int(rng.integers(1, 4))) for _ in range(120)] + [(5, 0, 0)])
    out_len[3] = total
    return names, comp, mark, ll, ml, comp_len, out_len


def emit_edge_rows(S: int, O: int, seed: int = 0):
    """Sequence records made directly that drive ``emit_bytes``' edge
    cases, three rows of S records for O output bytes (S >= 4096, O >=
    16,384): (names, s0, lit_start, lit_len, off, mlen, out_len), the
    first five [3, S] int32 numpy, out_len [3].  Each row's live records
    are a prefix with s0 the exclusive sum of their sizes (as both record
    producers give them), then dead records with s0 = BIGKEY (1 << 23)
    and zero fields.

    * ``lengths``: every pair of literal lengths 0, 14, 15, 269, 270, 525
      and match lengths 0, 4, 18, 19, 273, 274 (the edges of the length
      extensions), twice in seeded orders, then a literal-only record;
    * ``long_records``: 9000 literals from byte 50 (a record longer than
      a 4096-byte tile, covering one whole), then a 20,000-byte match
      whose 79 extension bytes cross byte 12,288;
    * ``short_records``: 2000 one-byte records (no literal, no match),
      then 3-byte ones across byte 4096, then random ones, with out_len
      inside a record's literals.
    """
    import numpy as np

    rng = np.random.default_rng(seed)
    names = ["lengths", "long_records", "short_records"]
    fields = np.zeros((5, 3, S), np.int32)
    fields[0] = 1 << 23
    out_len = np.zeros(3, np.int32)

    def size(lit, mat):
        lit_ext = 1 + (lit - 15) // 255 if lit >= 15 else 0
        m = mat - 4
        m_ext = 1 + (m - 15) // 255 if mat > 0 and m >= 15 else 0
        return 1 + lit_ext + lit + (2 + m_ext if mat > 0 else 0)

    def place(row, recs):
        """Records [(ll, ml)] from output byte 0; returns their starts."""
        s0, src, starts = 0, 0, []
        for k, (lit, mat) in enumerate(recs):
            fields[:, row, k] = (s0, src, lit,
                                 int(rng.integers(1, 65536)) if mat else 0,
                                 mat)
            starts.append(s0)
            s0 += size(lit, mat)
            src += lit + mat
        out_len[row] = s0
        return starts

    pairs = [(a, m) for a in (0, 14, 15, 269, 270, 525)
             for m in (0, 4, 18, 19, 273, 274)]
    recs = [pairs[i] for i in rng.permutation(len(pairs))] + \
        [pairs[i] for i in rng.permutation(len(pairs))] + [(40, 0)]
    place(0, recs)

    recs = [(3, 8)] * 10 + [(9000, 10)]
    at = sum(size(*r) for r in recs)
    while at < 12288 - 40:
        recs.append((5, 6))
        at += size(5, 6)
    place(1, recs + [(2, 20000)] + [(4, 9)] * 30 + [(12, 0)])

    recs = [(0, 0)] * 2000 + [(0, 4)] * 800
    recs += [(int(rng.integers(0, 21)), int(rng.choice([0, 4, 9, 30])))
             for _ in range(600)]
    starts = place(2, recs + [(25, 0)])
    k = next(k for k in range(2900, len(recs)) if recs[k][0] >= 10)
    out_len[2] = starts[k] + 6
    if int(out_len.max()) > O:
        raise ValueError(f"the rows need O >= {int(out_len.max())}")
    return names, *fields, out_len


def resolve_edge_rows(Dt: int, seed: int = 0):
    """State-word rows that drive ``resolve_wavefront``'s edge cases, Dt
    positions each (Dt a multiple of 8192): (names, t0 [B, Dt] int32
    numpy).  A state word is VFLAG | byte for a terminal, else the
    position of the byte it copies.  The rows whose name does not start
    with "junk" point backward only, as ``records_to_state``'s words do,
    so a sequential walk defines their bytes at any start_chunk:

    * ``nest_through``: offset-1 runs from position 1 to the end, a chain
      that nests through every chunk;
    * ``to_lo_minus_1``: the first positions of each chunk copy the last
      byte of the one before, and runs inside the chunk copy them;
    * ``to_zero``: every position copies position 0;
    * ``into_prefix``: every position past the first chunk copies one of
      the first chunk (a ``start_chunk`` prefix's bytes);
    * ``no_terminal``: chunks past the first hold no terminal at all;
    * ``mixed``: terminals, copies of any earlier position and deep
      offset-1 runs, as ``tests/test_torch_decode.py`` makes them.

    The junk rows break the domain, where only the plain version defines
    the bytes and ``ok`` (False where a chunk's in-chunk pointers do not
    converge in 14 rounds): ``junk_forward`` (pointers past the position,
    some past the chunk), ``junk_cycles`` (2-cycles, which converge, and
    3-cycles, which do not), ``junk_negative`` (negative words),
    ``junk_big`` (words at or above VFLAG, up to 2^31 - 1, and pointers
    at or past Dt) and ``junk_self`` (positions that copy themselves).
    """
    import numpy as np

    CH, VFLAG = 8192, 1 << 19
    if Dt <= 0 or Dt % CH:
        raise ValueError("Dt must be a positive multiple of 8192")
    rng = np.random.default_rng(seed)
    names = ["nest_through", "to_lo_minus_1", "to_zero", "into_prefix",
             "no_terminal", "mixed", "junk_forward", "junk_cycles",
             "junk_negative", "junk_big", "junk_self"]
    o = np.arange(Dt, dtype=np.int64)
    lo = o // CH * CH
    term = VFLAG | rng.integers(0, 256, Dt)
    rows = []

    r = o - 1
    r[0] = VFLAG | 7
    rows.append(r)

    r = term.copy()                           # runs inside each chunk
    off = o - lo
    r[(off >= 100) & (off < 4000)] = o[(off >= 100) & (off < 4000)] - 100
    r[(lo > 0) & (off < 100)] = lo[(lo > 0) & (off < 100)] - 1
    rows.append(r)

    r = np.zeros(Dt, np.int64)
    r[0] = VFLAG | 200
    rows.append(r)

    r = term.copy()
    r[CH:] = rng.integers(0, CH, Dt - CH)
    rows.append(r)

    r = term.copy()
    r[CH:] = np.maximum(o[CH:] - rng.integers(1, CH + 2000, Dt - CH), 0)
    rows.append(r)

    pick = rng.random(Dt)
    r = np.where(pick < 0.2, term, np.where(
        pick < 0.5, (rng.random(Dt) * o).astype(np.int64), o - 1))
    r[0] = term[0]
    deep = CH + 100 if Dt > CH else 100
    r[deep:deep + 6000] = o[deep:deep + 6000] - 1
    rows.append(r)

    valid = len(rows)
    for name in names[valid:]:
        r = np.where(rng.random(Dt) < 0.3, term,
                     (rng.random(Dt) * o).astype(np.int64))
        span = rng.random(Dt) < 0.5
        if name == "junk_forward":
            r[span] = o[span] + rng.integers(1, 12000, int(span.sum()))
        elif name == "junk_cycles":
            two = (off % 5 < 2) & (off < CH - 1)
            r[two] = np.where(off[two] % 5 == 0, o[two] + 1, o[two] - 1)
            three = (off % 5 >= 2) & (off < CH - 3)
            k = off[three] % 5 - 2                # 0, 1, 2 of a 3-cycle
            r[three] = np.where(k == 2, o[three] - 2, o[three] + 1)
        elif name == "junk_negative":
            r[span] = -rng.integers(1, 1 << 20, int(span.sum()))
        elif name == "junk_big":
            r[span] = rng.choice([VFLAG + 300, (1 << 31) - 1, Dt, Dt + 5,
                                  VFLAG - 1], int(span.sum()))
        else:
            r[span] = o[span]
        rows.append(r)
    return names, np.stack(rows).astype(np.int32)


def hc_edge_rows(D: int, seed: int = 0):
    """Operands that drive ``hc_tables``' edge cases, for blocks of D
    positions (D a multiple of 512): (wa [3, D] int32, hs, sticky,
    nrows), hs eight bucket-id streams [3, D] int32, one a table; the
    table sets of 1, 3, 7 and 8 tables are their first 1, 3, 7 and 8.
    The words wa take four values, so that most stored entries verify.

    * table 0 (8192 buckets): in each chunk, buckets hit once, twice and
      by all 512 positions; ids below 0 and at or above the table's
      size (the plain version clamps them);
    * table 1 (8192 buckets, sticky): an early entry in each bucket, then
      every chunk hits those buckets again;
    * table 2 (1024 buckets, a run table): most positions hit the
      catch-all bucket 1023, run starts hit their own;
    * table 3 (128 buckets): 100 buckets hit once a chunk, the other
      positions in four;
    * tables 4-7: 128 and 8192 buckets, sticky and not, random ids with
      some out of range.
    """
    import numpy as np

    if D <= 0 or D % 512:
        raise ValueError("D must be a positive multiple of 512")
    rng = np.random.default_rng(seed)
    B = 3
    wa = rng.integers(0, 4, (B, D)).astype(np.int32)
    i = np.arange(D)
    c = i % 512                                    # position in its chunk
    h0 = rng.integers(0, 8192, (B, D))
    h0[:, c < 32] = 5000 + c[c < 32]               # hit once a chunk
    h0[:, (c >= 32) & (c < 96)] = 6000 + (c[(c >= 32) & (c < 96)] - 32) // 2
    h0[0, (i // 512) % 3 == 1] = 77                # whole chunks: 512 hits
    h0[1, c >= 500] = rng.choice([-1, -300, 8192, 9000, 1 << 30],
                                 int((c >= 500).sum()))
    h1 = rng.integers(0, 64, (B, D))               # a few buckets, sticky
    h1[:, :64] = np.arange(64)                     # their early entries
    h2 = np.full((B, D), 1023)                     # the catch-all
    starts = rng.random((B, D)) < 0.05
    h2[starts] = rng.integers(0, 768, int(starts.sum()))
    h3 = rng.integers(100, 104, (B, D))            # four hot buckets
    h3[:, c < 100] = c[c < 100]                    # and 100 hit once
    hs = [h0, h1, h2, h3]
    nrows = [64, 64, 8, 1]
    sticky = [False, True, False, False]
    for t, (nr, st) in enumerate(((1, True), (64, False), (1, False),
                                  (64, True))):
        h = rng.integers(-20, nr * 128 + 20, (B, D))
        h[:, (i // 512) % 2 == t % 2] %= 7         # dense chunks
        hs.append(h)
        nrows.append(nr)
        sticky.append(st)
    return wa, [h.astype(np.int32) for h in hs], sticky, nrows


def chain_edge_rows(D: int, seed: int = 0):
    """Chain graphs that drive ``mark_chain``'s edge cases, D positions each
    (D a multiple of 1024): (names, g [B, D] int32 numpy).  The orbit of 0
    under g ends at a position whose step is not forward (g[i] <= i) and
    after one whose step reaches D or beyond.

    * ``step_1``: g[i] = i + 1, the whole row is the orbit;
    * ``on_32``, ``short_of_32``: the orbit at every multiple of 32, and
      one short of each, ending past D and at g = D + 5;
    * ``on_128_short_1024``, ``short_of_128_on_1024``: jumps that land
      exactly on and one short of the multiples of 128 and 1024;
    * ``tile_skips``: jumps of 1025 to 2999 that skip whole tiles of 1024,
      between runs of short steps;
    * ``ends_at_d``, ``past_d``, ``int32_max``: the orbit ends in the
      row's middle with g = D, D + 12345 and 2^31 - 1;
    * ``negative``: it ends with g = -1;
    * ``back_at_0``: g[0] = 0; ``back_in_segment``: a step back in the
      middle of a 32-position segment; ``back_at_tile_end``: a step back
      at a 1024-position tile's last position;
    * ``encoder_0`` to ``encoder_2``: graphs as the encoder builds them
      (matched positions with lengths of at least 4, each stepping to the
      first match at or after its end, any other to the first match after
      it).

    Off the orbit every row but ``step_1`` and the encoder's steps ahead
    by 1 to 39, with one position in 20 holding a value that ends a walk
    (below 0, at or past D, 2^31 - 1 and -2^31), so the exits of
    positions the orbit never visits carry those too.
    """
    import numpy as np

    if D <= 0 or D % 1024:
        raise ValueError("D must be a positive multiple of 1024")
    rng = np.random.default_rng(seed)
    i = np.arange(D, dtype=np.int64)
    big = (1 << 31) - 1
    rows, names = [], []

    def junk():
        r = i + rng.integers(1, 40, D)
        ends = rng.random(D) < 0.05
        r[ends] = rng.choice([-1, -(1 << 31), 0, D, D + 3, big],
                             int(ends.sum()))
        return r

    def orbit(name, pos, last):
        pos = np.unique(np.concatenate([[0], np.asarray(pos, np.int64)]))
        pos = pos[(pos >= 0) & (pos < D)]
        r = junk()
        r[pos[:-1]] = pos[1:]
        r[pos[-1]] = last
        names.append(name)
        rows.append(r)

    names.append("step_1")
    rows.append(i + 1)
    k32, k128, k1024 = (np.arange(1, D // m + 1) * m
                        for m in (32, 128, 1024))
    orbit("on_32", k32, D)
    orbit("short_of_32", k32 - 1, D + 5)
    orbit("on_128_short_1024", np.concatenate([k128, k1024 - 1]), big)
    orbit("short_of_128_on_1024", np.concatenate([k128 - 1, k1024]), D)
    pos, p = [], 0
    while p < D:
        for _ in range(int(rng.integers(1, 6))):
            p += int(rng.integers(1, 9))
            pos.append(p)
        p += int(rng.integers(1025, 3000))
        pos.append(p)
    orbit("tile_skips", pos, D)
    half = np.cumsum(rng.integers(1, 60, D))
    half = half[half < D // 2]
    for name, last in (("ends_at_d", D), ("past_d", D + 12345),
                       ("int32_max", big), ("negative", -1)):
        orbit(name, half, last)
    orbit("back_at_0", [], 0)
    mid = D // 64 * 32 + 17                 # inside a segment
    orbit("back_in_segment", np.append(half[half < mid], mid), mid - 3)
    t_end = D // 2048 * 1024 + 1023
    orbit("back_at_tile_end", np.concatenate([half[half < t_end], [t_end]]),
          5)
    for j in range(3):
        matched = rng.random(D) < (0.1, 0.2, 0.4)[j]
        mlen = rng.integers(4, 40, D)
        nxt = np.where(matched, i, D)
        nxt = np.minimum.accumulate(nxt[::-1])[::-1]      # first at or after
        nxt = np.append(nxt, D)
        end = i + np.where(matched, mlen, 1)
        g = np.where(matched, nxt[np.minimum(end, D)], nxt[i + 1])
        names.append(f"encoder_{j}")
        rows.append(np.maximum(np.where(end >= D, D, g), i + 1))
    return names, np.stack(rows).astype(np.int32)


def gather_edge_rows(N: int, K: int, seed: int = 0):
    """Operands that drive ``table_gather``'s edge cases: (tables, idx,
    bits), four tables [5, N] int32 numpy (N a multiple of 128), the index
    stream idx [5, K] int32 and the tables' value widths; 1-4 tables are
    the first 1-4 of them.

    The tables hold values of every sign across all 32 bits, so each
    width's byte mask shows (17 and 24 bits keep 3 bytes, 32 all 4, 1
    one).  The indices mix, in an order of their own in each row: -1,
    -128, -129 and -2^31; 0, 127, 128 and N - 1; N, N + 1, N + 127 and
    N + 128; 2^31 - 1; each side of every 128-lane row boundary; and
    random values from 3 rows below 0 to 3 rows past N.  Any K works,
    one not a multiple of 4 and one below 4 too.
    """
    import numpy as np

    if N <= 0 or N % 128 or K <= 0:
        raise ValueError("N must be a positive multiple of 128, K positive")
    rng = np.random.default_rng(seed)
    B = 5
    tables = [rng.integers(-2**31, 2**31, (B, N), np.int64).astype(np.int32)
              for _ in range(4)]
    edges = np.array([-1, -128, -129, -2**31, 0, 127, 128, N - 1, N, N + 1,
                      N + 127, N + 128, 2**31 - 1], np.int64)
    rows_at = np.arange(128, N, 128)
    edges = np.concatenate([edges, rows_at - 1, rows_at])
    idx = rng.integers(-3 * 128, N + 3 * 128, (B, K))
    for b in range(B):
        pick = rng.permutation(len(edges))[:K]
        at = rng.permutation(K)[:len(pick)]
        idx[b, at] = edges[pick]
    return tables, idx.astype(np.int32), (17, 32, 1, 24)


def dict_edge_rows(P: int, D: int, seed: int = 0) -> list:
    """Rows that drive the preset-dictionary (prefix) paths' edge cases,
    for a prefix of P positions and records of less than D bytes:
    [(name, dictionary, record, block)], ``block`` the record compressed
    against the dictionary (``compress_block_dict``) or built by hand.
    The decoders cut a dictionary to its last 64 KB; a row whose cut
    window is longer than P is left out.

    * windows of 0, 1, 5000, 8191, 8192, 8193, 65,535, 65,536 and 65,537
      bytes, each with a record whose first match starts in the window
      and runs across the seam into the record (the window ends in a
      period-7 run that the record continues), then bytes copied from
      the window's start and middle and from the record itself;
    * ``far_match``: a match at offset min(P, 65,535) from the record's
      first byte, onto the first byte of a window that long;
    * ``inside``: a record that lies wholly inside the dictionary;
    * ``empty``: an empty record (the block is one 0 token);
    * ``junk_below_window``: a match that reaches one byte before the
      window's start; every decoder must reject it (the record is the
      block's bytes as if the match were legal, for its length).
    """
    from ..constants import MAX_DISTANCE_WINDOW
    from ..models.reference import compress_block_dict

    rng = random.Random(seed)
    text = silesia_like(2 * MAX_DISTANCE_WINDOW + D, seed + 11)
    period = b"abcdefg" * 9
    rows = []
    for n in (0, 1, 5000, 8191, 8192, 8193, 65535, 65536, 65537):
        if min(n, MAX_DISTANCE_WINDOW) > P:
            continue
        at = rng.randrange(0, len(text) - n - D)
        window = (text[at:at + n - len(period)] + period)[-n:] if n else b""
        fresh = text[-D:]
        record = (period * 2 + window[:300] + window[n // 2:n // 2 + 500]
                  + fresh[:1500] + fresh[200:900])[:D - 1]
        rows.append((f"window_{n}", window, record,
                     compress_block_dict(window, record)))
    wl = min(P, MAX_DISTANCE_WINDOW - 1)
    window = text[:wl]
    tail = rng.randbytes(20)
    rows.append(("far_match", window, window[:40] + tail,
                 _lz4_sequences([(b"", wl, 40)], tail)))
    wl = min(P, 8192)
    window = text[MAX_DISTANCE_WINDOW:MAX_DISTANCE_WINDOW + wl]
    record = window[wl // 8:wl // 8 + min(wl // 2, D - 1)]
    rows.append(("inside", window, record, compress_block_dict(window,
                                                               record)))
    rows.append(("empty", window, b"", b"\x00"))
    lits = rng.randbytes(2)
    rows.append(("junk_below_window", window, lits + bytes(10) + tail,
                 _lz4_sequences([(lits, wl + 3, 10)], tail)))
    return rows


def dict_decode_inputs(P: int, D: int = 8192):
    """``dict_edge_rows(P, D)`` packed by the dictionary decoder's own
    layout (``decode_vector.pack_blocks`` and ``pack_windows``): (rows,
    [comp, comp_len, out_len, pre, pre_len] int32 CPU tensors, C, D)."""
    import torch

    from ..ops import decode_vector as dv

    rows = dict_edge_rows(P, D)
    comp, comp_len, out_len, C, Dd = dv.pack_blocks(
        [b for *_, b in rows], [len(r) for _, _, r, _ in rows])
    pre, pre_len, Pw = dv.pack_windows([w for _, w, _, _ in rows],
                                       len(rows))
    assert Pw == P
    return rows, [torch.from_numpy(a.astype("int32")) for a in (
        comp, comp_len, out_len, pre, pre_len)], C, Dd


def dict_encode_inputs(P: int, D: int = 8192):
    """``dict_edge_rows(P, D)`` laid out as the encoder's P-mode rows by
    ``encode_vector.window_rows`` (each row's window right-aligned below
    P, its record from P on): x [B, P + D] int32, data_len and pre_len
    [B] int32 CPU tensors."""
    import torch

    from ..ops import encode_vector as ev

    rows = dict_edge_rows(P, D)
    x, data_len, pre_len, Pw, *_ = ev.window_rows(
        [r for _, _, r, _ in rows], [w for _, w, _, _ in rows])
    assert Pw == P
    return (torch.from_numpy(x.astype("int32")), torch.from_numpy(data_len),
            torch.from_numpy(pre_len))


def big_edge_blocks(seed: int = 0) -> list:
    """Blocks over 96 KB that drive the big-block paths' edge cases (the
    fragment walk of ``ops/bigblock.py`` on decode, the 64 KB segments of
    ``VectorEncoder._encode_big`` on encode): [(name, data, block)],
    ``block`` a hand-made LZ4 block that decodes to ``data``.

    * ``giant_match_and_literals``: a 120,000-byte match at offset 1 (a
      run of equal bytes longer than a fragment) and a 60,000-byte
      incompressible literal run, both sequences cut into synthetic
      pieces;
    * ``match_tail_under_4``: a 49,154-byte match, whose last 48 KB slice
      would leave 2 bytes (cut 4 bytes earlier instead), and a 60,000-byte
      run at offset 3;
    * ``final_run_at_boundary``: sequences of exactly 48 KB of output
      each, so that the final literal run starts on a fragment boundary;
    * ``incompressible``: 100,000 random bytes, one literal run (over
      96 KB compressed and decoded).
    """
    rng = random.Random(seed)
    text = silesia_like(64 * 1024, seed + 13)
    rows = [
        ("giant_match_and_literals", _lz4_sequences(
            [(text[:20000], 1, 120000), (rng.randbytes(60000), 7000, 3000)],
            text[20000:40000])),
        ("match_tail_under_4", _lz4_sequences(
            [(text[:64], 64, 49154), (text[64:164], 3, 60000)],
            text[200:700])),
        ("final_run_at_boundary", _lz4_sequences(
            [(text[:16], 16, 49136), (text[16:116], 50, 49052)],
            text[1000:2000])),
        ("incompressible", _lz4_sequences([], rng.randbytes(100000))),
    ]
    from ..models.reference import decompress_block
    from ..ops.bigblock import scan

    return [(name, decompress_block(blk, scan(blk)[2]), blk)
            for name, blk in rows]


def big_bad_blocks(block: bytes) -> list:
    """Malformed variants of ``block``, a well-formed LZ4 block over 96 KB,
    that the header walk ``ops.bigblock.scan`` takes but the hardened
    unknown-length decoder (``reference.decompress_block_unknown``)
    refuses under any cap: [(name, bytes)].

    * ``final_run_cut``: ``block`` without its final literal run, so that
      it ends on a match;
    * ``empty_final_run``: the same, then an empty final literal run (one
      0x00 token: the last match ends fewer than 5 literals before the
      end);
    * ``giant_match_at_end``: the same, then the final literal run's bytes
      and a 120,000-byte match at offset 1 (a giant, cut into synthetic
      pieces by the fragment walk) end the block.
    """
    from collections import deque

    from ..models.reference import _unknown_sequences

    (lit, ll, _, _), = deque(_unknown_sequences(block, 1 << 31), maxlen=1)
    cut = block[:lit - 1 - (0 if ll < 15 else 1 + (ll - 15) // 255)]
    giant = _lz4_sequences([(block[lit:lit + ll], 1, 120000)], b"")
    return [("final_run_cut", cut), ("empty_final_run", cut + b"\x00"),
            ("giant_match_at_end", cut + giant[:-1])]


def block_end_rows(seed: int = 0) -> list:
    """Small blocks at the edges of the reference decoders' block-end
    rules, which bind on a block's last sequence with a match:
    [(name, block, n)], n the length the block's own token walk decodes
    to (what a known-length caller passes).  Each block is a 300-byte
    literal run and a 30-byte match, then the last match and the final
    literal run of the row:

    * ``final_run_<k>``, k = 0..7: an 8-byte match, then k literals (k = 0
      an empty final run): the known-length decoder wants k >= 5 (the
      match ends 5 bytes before the end at most), the hardened one too
      (its literals end 8 compressed bytes before the end at most);
    * ``short_match_<k>``, k = 5..8: a 4-byte match, then k literals: its
      literals end n - 4 - k, which the hardened decoder wants at most
      12 bytes before its cap (k = 8 under a cap of n, k >= 7 under n + 1);
    * ``ext_final_run_<k>``, k = 4..6: a 99-byte match (one length
      extension byte, 0x50), then k literals: the hardened decoder stops
      reading a match length 6 bytes before the block's end, so at k = 4
      it reads the extension byte as the final token and decodes
      another, shorter block (which it accepts);
    * ``literals_only_<n>``: one literal run of 3 and of 13 bytes.
    """
    rng = random.Random(seed)
    text = _text(rng, 600)
    head = [(text[:300], 50, 30)]
    rows = []
    for k in range(8):
        rows.append((f"final_run_{k}", _lz4_sequences(
            head + [(text[300:310], 40, 8)], text[400:400 + k])))
    for k in range(5, 9):
        rows.append((f"short_match_{k}", _lz4_sequences(
            head + [(text[300:310], 40, 4)], text[400:400 + k])))
    for k in range(4, 7):
        rows.append((f"ext_final_run_{k}", _lz4_sequences(
            head + [(text[300:310], 1, 99)], text[400:400 + k])))
    for n in (3, 13):
        rows.append((f"literals_only_{n}", _lz4_sequences([], text[:n])))
    return [(name, blk, len(_decoded(blk))) for name, blk in rows]


def short_final_run(block: bytes, k: int = 3) -> tuple:
    """``block``, a well-formed LZ4 block, with its final literal run cut
    to its first ``k`` < 5 literals, so that its last match ends fewer than
    5 bytes before the end, which every reference decoder refuses:
    (bytes, the length its token walk decodes to)."""
    from collections import deque

    from ..models.reference import _unknown_sequences

    (lit, ll, _, _), = deque(_unknown_sequences(block, 1 << 31), maxlen=1)
    head = block[:lit - 1 - (0 if ll < 15 else 1 + (ll - 15) // 255)]
    cut = _lz4_sequences([], block[lit:lit + k])
    return head + cut, len(_decoded(block)) - ll + k
