"""Command-line interface of the CUDA port: compress and decompress files
with LZ4Stream framing, and engine diagnostics (counterpart of
``lz4net_tpu/__main__.py``, the role of the reference's MiniApp,
`src/misc/LZ4.MiniApp/Program.cs:38-98`).

    python -m lz4net_tpu_torch compress   <input> <output.lz4s> [--hc] [--block KB]
    python -m lz4net_tpu_torch decompress <input.lz4s> <output>
    python -m lz4net_tpu_torch verify     <input>     # round trips + MD5
    python -m lz4net_tpu_torch info                   # engines and card
    python -m lz4net_tpu_torch continuous [--mb N] [--out results.json]
    python -m lz4net_tpu_torch select     [--kb 64] [--blocks 4]

Every verb takes ``--device`` (default ``cuda``: the card; ``cpu`` runs
the kernels' plain versions).
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys
import time


def _cmd_compress(args) -> int:
    from . import LZ4Stream, LZ4StreamFlags, LZ4StreamMode
    from .constants import DEFAULT_BLOCK_SIZE

    # the reference's 1 MB default chunk (`LZ4Stream.cs:119`); a chunk
    # over 96 KB decodes on the card as fragment waves
    block = DEFAULT_BLOCK_SIZE if args.block is None else args.block * 1024
    flags = LZ4StreamFlags.DEFAULT
    if args.hc:
        flags |= LZ4StreamFlags.HIGH_COMPRESSION
    t0 = time.time()
    with open(args.input, "rb") as src, open(args.output, "wb") as dst:
        with LZ4Stream(dst, LZ4StreamMode.COMPRESS, flags, block_size=block,
                       device=args.device) as stream:
            while chunk := src.read(1 << 20):
                stream.write(chunk)
    i, o = os.path.getsize(args.input), os.path.getsize(args.output)
    print(f"{i} -> {o} bytes (ratio {o / max(1, i):.3f}) "
          f"in {time.time() - t0:.2f}s")
    return 0


def _cmd_decompress(args) -> int:
    from . import LZ4Stream, LZ4StreamMode

    t0 = time.time()
    with open(args.input, "rb") as src, open(args.output, "wb") as dst:
        with LZ4Stream(src, LZ4StreamMode.DECOMPRESS,
                       device=args.device) as stream:
            while chunk := stream.read(1 << 20):
                dst.write(chunk)
    print(f"decompressed in {time.time() - t0:.2f}s")
    return 0


def _cmd_verify(args) -> int:
    from . import codec_name
    from .stream import compress_stream, decompress_stream

    with open(args.input, "rb") as fh:
        data = fh.read()
    print("codec:", codec_name(args.device))
    for hc in (False, True):
        framed = compress_stream(data, high_compression=hc,
                                 device=args.device)
        back = decompress_stream(framed, device=args.device)
        ok = hashlib.md5(back).hexdigest() == hashlib.md5(data).hexdigest()
        mode = "HC  " if hc else "fast"
        print(f"{mode}: {len(data)} -> {len(framed)} "
              f"(ratio {len(framed) / max(1, len(data)):.3f}) "
              f"round-trip {'OK' if ok else 'FAILED'}")
        if not ok:
            return 1
    return 0


def _cmd_info(args) -> int:
    import torch

    from . import codec_name, registry

    print("selected:", codec_name(args.device))
    for name, svc in registry.available_services(args.device).items():
        print(f"engine {name}: {type(svc).__name__}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    card = (torch.cuda.get_device_name(torch.device(args.device))
            if torch.device(args.device).type == "cuda" else "none (CPU)")
    print(f"device {args.device}: {card}")
    return 0


def _cmd_continuous(args) -> int:
    from .utils.continuous import run_continuous

    results = run_continuous(total_mb=args.mb, out_path=args.out,
                             device=args.device)
    print(json.dumps(results, indent=2))
    bad = [n for n, r in results["engines"].items()
           if "error" in r or not r.get("verified")]
    return 1 if bad else 0


def _cmd_select(args) -> int:
    from . import registry

    orders = registry.measure_preferences(args.kb, args.blocks,
                                          device=args.device)
    print(json.dumps({"orders": {k: list(v) for k, v in orders.items()},
                      "codec_name": registry.codec_name(args.device),
                      "cache": registry._select_cache_path()}))
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="lz4net_tpu_torch")
    device = argparse.ArgumentParser(add_help=False)
    device.add_argument("--device", default="cuda",
                        help="torch device to run on (default: cuda)")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("compress", parents=[device])
    p.add_argument("input")
    p.add_argument("output")
    p.add_argument("--hc", action="store_true")
    p.add_argument("--block", type=int, default=None,
                   help="chunk size in KB (default: 1024)")
    p.set_defaults(fn=_cmd_compress)

    p = sub.add_parser("decompress", parents=[device])
    p.add_argument("input")
    p.add_argument("output")
    p.set_defaults(fn=_cmd_decompress)

    p = sub.add_parser("verify", parents=[device])
    p.add_argument("input")
    p.set_defaults(fn=_cmd_verify)

    p = sub.add_parser("info", parents=[device])
    p.set_defaults(fn=_cmd_info)

    p = sub.add_parser("continuous", parents=[device])
    p.add_argument("--mb", type=float, default=64,
                   help="corpus size in MB (fractions allowed)")
    p.add_argument("--out", default="continuous_results.json")
    p.set_defaults(fn=_cmd_continuous)

    p = sub.add_parser(
        "select", parents=[device],
        help="time the engines that may serve the device per role (on "
        "a card only its own) and persist the measured orders")
    p.add_argument("--kb", type=int, default=64, help="block size in KB")
    p.add_argument("--blocks", type=int, default=4)
    p.set_defaults(fn=_cmd_select)

    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
