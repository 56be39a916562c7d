"""What the block cells share: their inputs, and the check of decoded
blocks against the seed's corpus."""

from __future__ import annotations

from portbench import corpus, frozen, reference
from portbench import inputs as pbi


def block_inputs(cfg: dict, mix: dict, seed: int, comm=None) -> dict:
    """The configuration's corpus as blocks (each part made by its rank
    and shared, where a run has ranks), their compressed form by the
    frozen compressor, both kept per seed, and each request's order."""
    parts = comm.world if comm else cfg.get("ranks", 1)
    if comm is None:
        data = b"".join(pbi.corpus_part(cfg, seed, p, parts)
                        for p in range(parts))
    else:
        data = b"".join(comm.all_gather(
            pbi.corpus_part(cfg, seed, comm.rank, parts)))
    raw = corpus.split_blocks(data, cfg["block_bytes"])
    comp = pbi.compressed_blocks(
        raw, frozen.compress_blocks,
        f"{len(data)}-{seed}-{parts}-{cfg['block_bytes']}")
    orders = pbi.orders(len(raw), mix, seed)
    return {"raw": raw, "comp": comp, "orders": orders}


def decoded_mismatches(inp: dict, samples) -> int:
    """Blocks of the sampled requests that are not exactly the corpus's
    block at their place in the request's order (a missing block counts)."""
    bad = 0
    for i, out in samples:
        order = inp["orders"][i % len(inp["orders"])]
        out = list(out)
        bad += abs(len(out) - len(order))
        bad += sum(1 for got, j in zip(out, order) if got != inp["raw"][j])
    return bad


def control_decode(inp: dict, i: int) -> list[bytes]:
    """The control of a read: the plain decoder put in the program's
    place with a wide copy that ignores overlapping matches, the step a
    faster decoder is tempted to take; it breaks exact decoding."""
    order = inp["orders"][i % len(inp["orders"])]
    return [reference.decompress_block(inp["comp"][j], len(inp["raw"][j]),
                                       overlap=False) for j in order]
