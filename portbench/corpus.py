"""The benchmark's own corpus: a seeded synthetic Silesia-like mix.

A frozen copy of ``silesia_like`` and ``split_blocks`` (with their
generators) as ``lz4net_tpu_torch/utils/corpus.py`` had them when the
benchmark was written, so the yardstick does not move when the program's
copy does.  The components imitate the Silesia corpus (English text, XML,
source code, databases, binaries, noisy sensor data) with compression
ratios in the same regime; every byte follows from the seed.
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

