"""Reads of independent blocks of known length: one
``lz4net_tpu_torch.codec.decode_batch`` of the configuration's batch a
request, the blocks in the request's order.  ``correct`` holds every
block of the sampled requests to the seed's corpus, byte for byte."""

from __future__ import annotations

from portbench.ops._blocks import (block_inputs, control_decode,
                                   decoded_mismatches)

ENTRY = ("lz4net_tpu_torch.codec", "decode_batch")


def inputs(cfg: dict, mix: dict, seed: int, comm=None) -> dict:
    inp = block_inputs(cfg, mix, seed, comm)
    inp["calls"] = [([inp["comp"][j] for j in o],
                     [len(inp["raw"][j]) for j in o]) for o in inp["orders"]]
    return inp


def prepare(inp: dict, cfg: dict, mix: dict, device, comm=None) -> dict:
    from lz4net_tpu_torch import codec
    return {"codec": codec, "device": device, "calls": inp["calls"],
            "bytes_in": sum(map(len, inp["comp"]))}


def request(st: dict, i: int):
    blocks, lens = st["calls"][i % len(st["calls"])]
    return st["codec"].decode_batch(blocks, lens, device=st["device"])


def work(st: dict, i: int, out) -> tuple:
    """(bytes given, bytes returned, the least bytes the device moves:
    the compressed bytes read once and the decoded bytes written once)."""
    n_out = sum(map(len, out))
    return st["bytes_in"], n_out, st["bytes_in"] + n_out


def check(inp: dict, samples) -> dict:
    return {"mismatched_blocks": (decoded_mismatches(inp, samples), 0)}


def control(inp: dict, i: int):
    return control_decode(inp, i)


def counters(st: dict) -> dict:
    from lz4net_tpu_torch.models import cuda
    return {"host_decodes": cuda.decoder(st["device"]).host_decodes}
