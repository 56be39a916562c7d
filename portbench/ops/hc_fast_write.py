"""Writes of independent blocks at a fast-HC level: one
``lz4net_tpu_torch.models.cuda.compress_blocks_hc_fast`` of the
configuration's batch a request, the blocks in the request's order.
``correct`` decodes every distinct payload of the sampled requests with
the plain reference decoder, under its rules, and holds it to the seed's
block, and holds each payload within the call's cap (the worst-case
bound of its block)."""

from __future__ import annotations

from portbench import reference
from portbench.ops._blocks import block_inputs

ENTRY = ("lz4net_tpu_torch.models.cuda", "compress_blocks_hc_fast")


def inputs(cfg: dict, mix: dict, seed: int, comm=None) -> dict:
    inp = block_inputs(cfg, mix, seed, comm)
    inp["calls"] = [[inp["raw"][j] for j in o] for o in inp["orders"]]
    return inp


def prepare(inp: dict, cfg: dict, mix: dict, device, comm=None) -> dict:
    from lz4net_tpu_torch.models import cuda
    return {"cuda": cuda, "device": device, "calls": inp["calls"],
            "level": mix["level"], "bytes_in": sum(map(len, inp["raw"]))}


def request(st: dict, i: int):
    return st["cuda"].compress_blocks_hc_fast(
        st["calls"][i % len(st["calls"])], level=st["level"],
        device=st["device"])


def work(st: dict, i: int, out) -> tuple:
    """(bytes given, payload bytes, the least bytes the device moves: the
    input read once and the payloads written once)."""
    n_out = sum(map(len, out))
    return st["bytes_in"], n_out, st["bytes_in"] + n_out


def check(inp: dict, samples) -> dict:
    over_cap = wrong = missing = 0
    judged = {}     # (block, payload) -> decodes to the block
    for i, out in samples:
        order = inp["orders"][i % len(inp["orders"])]
        out = list(out)
        missing += abs(len(out) - len(order))
        for payload, j in zip(out, order):
            block = inp["raw"][j]
            if not payload:
                missing += 1
                continue
            if len(payload) > reference.maximum_output_length(len(block)):
                over_cap += 1
            key = (j, bytes(payload))
            if key not in judged:
                try:
                    judged[key] = reference.decompress_block(
                        payload, len(block)) == block
                except reference.CorruptedBlockError:
                    judged[key] = False
            wrong += not judged[key]
    return {"wrong_payloads": (wrong, 0), "over_cap_payloads": (over_cap, 0),
            "missing_payloads": (missing, 0)}


def control(inp: dict, i: int):
    """The control of a write: the plain greedy parse with matches let
    run into the last five bytes, the step a denser parse is tempted to
    take; the reference decoder refuses such blocks."""
    order = inp["orders"][i % len(inp["orders"])]
    return [reference.compress_block(inp["raw"][j], last_literals=0)
            for j in order]


def counters(st: dict) -> dict:
    from lz4net_tpu_torch.models import cuda
    return {"host_encodes": cuda.encoder(st["device"]).host_encodes}
