"""Writes of small records against one preset dictionary at a fast-HC
level: one ``lz4net_tpu_torch.models.cuda.compress_blocks_fast_dict`` of
the configuration's batch a request, the records in the request's order.

The mix's corpus is cut into records of ``record_bytes``; the
dictionary is ``dictionary_bytes / record_bytes`` records spread evenly
through it (records 0, n/16, ... of n, for a 64 KB dictionary of 4 KB
records), joined; the batch is the records whose index is 1 mod 4, none
of them a dictionary record.  ``correct`` decodes every distinct payload
of the sampled requests with the plain dictionary decoder
(``portbench/reference_dict.py``), under the reference decoder's rules
and with the configuration's dictionary, holds it to its record, and
holds each payload within its cap (the record's worst-case bound)."""

from __future__ import annotations

from portbench import corpus
from portbench import inputs as pbi
from portbench import reference, reference_dict

ENTRY = ("lz4net_tpu_torch.models.cuda", "compress_blocks_fast_dict")


def inputs(cfg: dict, mix: dict, seed: int, comm=None) -> dict:
    size = cfg["record_bytes"]
    records = corpus.split_blocks(pbi.corpus_bytes(mix["file_bytes"], seed),
                                  size)
    n_dict = cfg["dictionary_bytes"] // size
    stride = len(records) // n_dict
    if mix["file_bytes"] % size or not stride or stride % 4:
        raise ValueError(f"{len(records)} records do not spread a "
                         f"dictionary of {n_dict} apart from the batch")
    dictionary = b"".join(records[::stride][:n_dict])
    raw = records[1::4]
    return {"raw": raw, "dictionary": dictionary,
            "dict_records": list(range(0, n_dict * stride, stride)),
            "orders": pbi.orders(len(raw), mix, seed)}


def prepare(inp: dict, cfg: dict, mix: dict, device, comm=None) -> dict:
    from lz4net_tpu_torch.models import cuda
    raw = inp["raw"]
    return {"cuda": cuda, "device": device, "level": mix["level"],
            "dictionary": inp["dictionary"],
            "calls": [[raw[j] for j in o] for o in inp["orders"]],
            "bytes_in": sum(map(len, raw)), "requests": 0,
            "window_bytes0": _window_bytes(cuda, device)}


def _window_bytes(cuda, device):
    """The encoder's window positions laid so far; None for a program
    without the counter."""
    return getattr(cuda.encoder(device), "window_bytes", None)


def request(st: dict, i: int):
    st["requests"] += 1
    return st["cuda"].compress_blocks_fast_dict(
        st["calls"][i % len(st["calls"])], st["dictionary"],
        level=st["level"], device=st["device"])


def work(st: dict, i: int, out) -> tuple:
    """(record bytes given, payload bytes, the least bytes the device
    moves: the records and the dictionary's last 64 KB read once, the
    payloads written once)."""
    n_out = sum(map(len, out))
    window = min(len(st["dictionary"]), reference_dict.WINDOW)
    return st["bytes_in"], n_out, st["bytes_in"] + window + n_out


def check(inp: dict, samples) -> dict:
    over_cap = wrong = missing = 0
    judged = {}     # (record, payload) -> decodes to the record
    for i, out in samples:
        order = inp["orders"][i % len(inp["orders"])]
        out = list(out)
        missing += abs(len(out) - len(order))
        for payload, j in zip(out, order):
            record = inp["raw"][j]
            if not payload:
                missing += 1
                continue
            if len(payload) > reference.maximum_output_length(len(record)):
                over_cap += 1
            key = (j, bytes(payload))
            if key not in judged:
                try:
                    judged[key] = reference_dict.decompress_block_dict(
                        payload, inp["dictionary"], len(record)) == record
                except reference.CorruptedBlockError:
                    judged[key] = False
            wrong += not judged[key]
    return {"wrong_payloads": (wrong, 0), "over_cap_payloads": (over_cap, 0),
            "missing_payloads": (missing, 0)}


def control(inp: dict, i: int):
    """The control of a dictionary write: each record compressed by the
    plain greedy parse against the dictionary with its last byte cut, a
    window one byte off, as a P-mode layout that misaligns the window
    would write; matches into the window then decode to other bytes."""
    order = inp["orders"][i % len(inp["orders"])]
    window = inp["dictionary"][:-1]
    return [reference_dict.compress_block_dict(window, inp["raw"][j])
            for j in order]


def counters(st: dict) -> dict:
    """``host_encodes``; and, where the program counts them, the window
    positions its passes laid since set-up began, over ``requests``, the
    requests made (warm-up and window)."""
    cuda = st["cuda"]
    out = {"host_encodes": cuda.encoder(st["device"]).host_encodes}
    laid = _window_bytes(cuda, st["device"])
    if laid is not None:
        out["window_bytes"] = laid - st["window_bytes0"]
        out["requests"] = st["requests"]
    return out
