"""Reads sharded over ranks, one card each: one
``lz4net_tpu_torch.parallel.pipeline.distributed_decode`` of the
configuration's batch a request on every rank, the blocks in the
request's order, gathered in input order.  Each rank makes its part of
the corpus and the parts are shared before the run.  ``correct`` holds
every block that rank 0 got back in the sampled requests to the seed's
corpus, byte for byte."""

from __future__ import annotations

from portbench.ops._blocks import (block_inputs, control_decode,
                                   decoded_mismatches)

ENTRY = ("lz4net_tpu_torch.parallel.pipeline", "distributed_decode")
EXCHANGE = ("lz4net_tpu_torch.parallel.pipeline", "gather_blocks")


def inputs(cfg: dict, mix: dict, seed: int, comm=None) -> dict:
    inp = block_inputs(cfg, mix, seed, comm)
    inp["calls"] = [([inp["comp"][j] for j in o],
                     [len(inp["raw"][j]) for j in o]) for o in inp["orders"]]
    return inp


def prepare(inp: dict, cfg: dict, mix: dict, device, comm=None) -> dict:
    from lz4net_tpu_torch.parallel import mesh, pipeline
    return {"pipeline": pipeline, "mesh": mesh.make_mesh(device=device),
            "calls": inp["calls"], "bytes_in": sum(map(len, inp["comp"]))}


def request(st: dict, i: int):
    blocks, lens = st["calls"][i % len(st["calls"])]
    return st["pipeline"].distributed_decode(blocks, lens, st["mesh"])


def work(st: dict, i: int, out) -> tuple:
    """(bytes given, bytes returned on this rank, the least bytes the
    devices move: the compressed bytes read once and the decoded bytes
    written once)."""
    n_out = sum(map(len, out))
    return st["bytes_in"], n_out, st["bytes_in"] + n_out


def check(inp: dict, samples) -> dict:
    return {"mismatched_blocks": (decoded_mismatches(inp, samples), 0)}


def control(inp: dict, i: int):
    return control_decode(inp, i)


def counters(st: dict) -> dict:
    from lz4net_tpu_torch.ops import decode_sequencer
    return {"decode_sequencer_launches": decode_sequencer.launches}
