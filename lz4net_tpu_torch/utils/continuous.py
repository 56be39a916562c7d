"""Continuous comparative harness: each engine's throughput and ratio,
tracked across runs (counterpart of ``lz4net_tpu/utils/continuous.py``,
the role of the reference's `LZ4.Tests.Continuous` CLI,
`Program.cs:23-250`, `Results.cs:18-85`): the corpus goes through every
engine ``registry`` registered for the device, each round trip is
verified, and the best speeds and ratios so far are kept in a JSON file
so that a regression shows.
"""

from __future__ import annotations

import json
import os
import time

from .. import registry
from ..constants import maximum_output_length
from . import corpus

MB = 1 << 20


def _bench_engine(name: str, svc, data: bytes, block_size: int) -> dict:
    blocks = corpus.split_blocks(data, block_size)
    budget = maximum_output_length(block_size)

    t0 = time.perf_counter()
    packed = [svc.encode(b, budget) for b in blocks]
    t_enc = time.perf_counter() - t0
    if not all(packed):
        raise RuntimeError(f"{name}: encode returned no bytes")

    t0 = time.perf_counter()
    out = [svc.decode(p, len(b)) for p, b in zip(packed, blocks)]
    t_dec = time.perf_counter() - t0
    verified = out == blocks

    t0 = time.perf_counter()
    packed_hc = [svc.encode_hc(b, budget) for b in blocks]
    t_hc = time.perf_counter() - t0
    hc_verified = all(svc.decode(p, len(b)) == b
                      for p, b in zip(packed_hc, blocks))

    n = len(data)
    return {
        "engine": name,
        "verified": bool(verified and hc_verified),
        "encode_MBps": round(n / t_enc / 1e6, 2),
        "decode_MBps": round(n / t_dec / 1e6, 2),
        "encode_hc_MBps": round(n / t_hc / 1e6, 2),
        "ratio": round(sum(map(len, packed)) / n, 4),
        "ratio_hc": round(sum(map(len, packed_hc)) / n, 4),
    }


def run_continuous(total_mb: float = 64, block_size: int = 64 * 1024,
                   out_path: str | None = "continuous_results.json",
                   engines: list[str] | None = None,
                   device="cuda") -> dict:
    """One pass over ``total_mb`` MB of the corpus for every engine of
    ``device``; merges the best results so far into ``out_path`` (the
    reference's XML/CSV sink, as JSON).  The slow engines take a smaller
    slice, at least 1 MB (or the whole corpus, if smaller): ``cuda``
    1/16 (a block a call; on the CPU its plain versions) and
    ``python-reference`` 1/64; ``native`` takes it all.  An engine that raises is recorded with
    its error."""
    data = corpus.silesia_like(int(total_mb * MB), seed=42)
    available = registry.available_services(device)
    if engines:
        available = {k: v for k, v in available.items() if k in engines}

    run = {"ts": time.time(), "corpus_mb": total_mb,
           "block_kb": block_size // 1024, "device": str(device),
           "engines": {}}
    for name, svc in available.items():
        share = {"python-reference": 64, "cuda": 16}.get(name, 1)
        n = min(len(data), max(MB, len(data) // share))
        try:
            run["engines"][name] = _bench_engine(name, svc, data[:n],
                                                 block_size)
            run["engines"][name]["corpus_mb"] = n / MB
        except Exception as exc:  # noqa: BLE001 - keep surveying others
            run["engines"][name] = {"engine": name,
                                    "error": f"{type(exc).__name__}: {exc}"}

    if out_path:
        history = {}
        if os.path.exists(out_path):
            try:
                with open(out_path) as fh:
                    history = json.load(fh)
            except (OSError, ValueError):
                history = {}
        best = history.get("best", {})
        for name, r in run["engines"].items():
            if "error" in r or not r.get("verified"):
                continue
            b = best.setdefault(name, {})
            for key in ("encode_MBps", "decode_MBps", "encode_hc_MBps"):
                b[key] = max(b.get(key, 0.0), r[key])
            for key in ("ratio", "ratio_hc"):
                b[key] = min(b.get(key, 9.9), r[key])
        history["best"] = best
        history.setdefault("runs", []).append(run)
        history["runs"] = history["runs"][-50:]
        with open(out_path, "w") as fh:
            json.dump(history, fh, indent=2)
    return run
