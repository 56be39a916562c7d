"""Writes of whole files through LZ4Stream: one
``lz4net_tpu_torch.stream.compress_stream`` of the mix's file a request,
strict, in the configuration's chunks, written in one piece.
``correct`` holds every sampled stream, chunk headers and payloads, to
the plain reference's stream of the same file byte for byte: a strict
payload is the reference compressor's bytes."""

from __future__ import annotations

from portbench import inputs as pbi
from portbench import reference

ENTRY = ("lz4net_tpu_torch.stream", "compress_stream")


def inputs(cfg: dict, mix: dict, seed: int, comm=None) -> dict:
    return {"data": pbi.corpus_bytes(mix["file_bytes"], seed),
            "chunk": cfg["chunk_bytes"]}


def prepare(inp: dict, cfg: dict, mix: dict, device, comm=None) -> dict:
    from lz4net_tpu_torch import stream
    if cfg["mode"] != "strict" or cfg["flags"] != "DEFAULT":
        raise ValueError("this op writes strict streams with flags DEFAULT")
    return {"stream": stream, "device": device, "data": inp["data"],
            "chunk": inp["chunk"]}


def request(st: dict, i: int):
    return st["stream"].compress_stream(st["data"], block_size=st["chunk"],
                                        device=st["device"])


def work(st: dict, i: int, out) -> tuple:
    """(file bytes, stream bytes, the least bytes the device moves: the
    file read once and the stream written once)."""
    return len(st["data"]), len(out), len(st["data"]) + len(out)


def check(inp: dict, samples) -> dict:
    want = reference.stream_frames(inp["data"], inp["chunk"])
    wrong = sum(1 for _, out in samples if bytes(out) != want)
    return {"wrong_streams": (wrong, 0)}


def control(inp: dict, i: int):
    """The control of a strict write: a valid stream whose payloads are
    another greedy parse (a skip strength of 5, not the reference's 6),
    as a faster non-strict encoder would write; it breaks "strict"."""
    return reference.stream_frames(inp["data"], inp["chunk"],
                                   skip_strength=5)


def counters(st: dict) -> dict:
    from lz4net_tpu_torch.ops import encode_sequencer
    return {"encode_sequencer_launches": encode_sequencer.launches}
