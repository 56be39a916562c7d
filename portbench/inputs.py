"""What a run draws from its seed: the corpus's parts, the order of the
blocks in each request, and the sample of answers the check reads.
Nothing here imports the program.

A corpus and its frozen compression are kept per seed in
``portbench/_build/inputs/`` (a fixed directory inside the checkout), so
a second run of a seed reads them instead of making them again.  Each
file's name holds a digest of the sources that make it; a file is
written to a temporary name beside it and moved into place, so ranks
that write at once never read half a file.
"""

from __future__ import annotations

import hashlib
import os
import random
import tempfile

import numpy as np

from . import corpus

# a different stream of draws for each use of one seed
ORDERS, SAMPLE, PARTS = 0x0DE5, 0x5A3B, 0x9A27

HERE = os.path.dirname(os.path.abspath(__file__))
CACHE = os.path.join(HERE, "_build", "inputs")


def rng(seed: int, use: int) -> random.Random:
    return random.Random(f"{seed}:{use}")


def _digest(*files: str) -> str:
    h = hashlib.sha256()
    for f in files:
        with open(os.path.join(HERE, f), "rb") as fh:
            h.update(fh.read())
    return h.hexdigest()[:12]


def _cached(name: str, make) -> bytes:
    """The bytes of ``CACHE/<name>``, made by ``make()`` where absent."""
    path = os.path.join(CACHE, name)
    try:
        with open(path, "rb") as fh:
            return fh.read()
    except FileNotFoundError:
        pass
    data = make()
    os.makedirs(CACHE, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=CACHE, prefix=".part-")
    try:
        with os.fdopen(fd, "wb") as fh:
            fh.write(data)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return data


def corpus_bytes(size: int, seed: int) -> bytes:
    """``corpus.silesia_like(size, seed)``, kept per seed."""
    return _cached(f"corpus-{_digest('corpus.py')}-{size}-{seed}.bin",
                   lambda: corpus.silesia_like(size, seed))


def corpus_part(cfg: dict, seed: int, part: int, parts: int) -> bytes:
    """One of ``parts`` equal parts of the configuration's corpus: each a
    Silesia-like mix of its own from the seed (one part: the corpus)."""
    size = cfg["block_bytes"] * cfg["batch_blocks"] // parts
    if parts == 1:
        return corpus_bytes(size, seed)
    return corpus_bytes(size, rng(seed, PARTS + part).getrandbits(62))


def compressed_blocks(blocks: list[bytes], compress, key: str) -> list[bytes]:
    """``compress(blocks)`` (the frozen compressor's payloads), kept under
    ``key``, which names the blocks (the corpus and the block size)."""
    def make() -> bytes:
        comp = compress(blocks)
        lens = np.array([len(c) for c in comp], np.int32)
        return lens.tobytes() + b"".join(comp)
    name = (f"frozen-{_digest('corpus.py', 'native/lz4_frozen.cpp')}-"
            f"{key}.bin")
    data = _cached(name, make)
    n = len(blocks)
    lens = np.frombuffer(data[:4 * n], np.int32)
    offs = 4 * n + np.concatenate(([0], np.cumsum(lens, dtype=np.int64)))
    if len(lens) != n or offs[-1] != len(data):
        raise RuntimeError(f"{name} in {CACHE} does not hold {n} blocks")
    return [data[a:b] for a, b in zip(offs[:-1], offs[1:])]


def orders(n_blocks: int, mix: dict, seed: int) -> list[list[int]]:
    """The block order of each request, by request index modulo their
    number: the same blocks every time, in another order."""
    r = rng(seed, ORDERS)
    return [r.sample(range(n_blocks), n_blocks)
            for _ in range(mix["orders"])]
