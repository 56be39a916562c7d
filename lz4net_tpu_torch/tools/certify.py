"""On-card certification of the CUDA port's device paths (counterpart of
``tools/certify.py``): round trips through every device path on the
card, each byte checked, with no block decoded or encoded on the host.

    python -m lz4net_tpu_torch.tools.certify [decode big encode strict]

Checks, on the 1 MB corpus (seed 42) in 64 KB blocks compressed by the
native host engine (``models.native``, the reference compressor's
bytes), which also decodes the encode checks' payloads on the host:

  decode   the vector decoder over the 16 blocks (``decode_batch``);
           unknown-length decode of 4 of them; dictionary decode of a
           30,000-byte block behind a 4 KB dictionary;
  big      the 1 MB as one block: known- and unknown-length decode
           (fragment waves) and fast encode (64 KB segments);
  encode   fast and fast-HC (level 9) encode of 8 blocks, decoded on the
           host;
  strict   the strict sequencer encoder on 4 blocks (the reference
           compressor's bytes) and the sequencer decoder on their
           payloads.

Each check needs ``host_decodes`` and ``host_encodes`` unchanged.  Prints
one PASS or FAIL line a check, then ``CERTIFIED`` and exits 0, or ``NOT
CERTIFIED`` and exits 1; exits 2 without a card.
"""

from __future__ import annotations

import sys
import time

FAILED = []


def report(name: str, ok: bool, detail: str = "") -> None:
    print(f"{'PASS' if ok else 'FAIL'} {name} {detail}".rstrip(), flush=True)
    if not ok:
        FAILED.append(name)


def main(argv=None) -> int:
    import torch
    if not torch.cuda.is_available():
        print("certify: no CUDA device; this tool certifies the card",
              file=sys.stderr)
        return 2

    from .. import _build
    from ..models import cuda, native
    from ..ops.decode_sequencer import SequencerDecoder
    from ..utils import corpus

    which = (sys.argv[1:] if argv is None else argv) or [
        "decode", "big", "encode", "strict"]
    t_all = time.time()
    _build.load()
    dev = "cuda"
    dec, enc = cuda.decoder(dev), cuda.encoder(dev)

    data = corpus.silesia_like(1 << 20, seed=42)
    blocks = corpus.split_blocks(data, 64 * 1024)
    packed = [native.compress_block(b) for b in blocks]
    lens = [len(b) for b in blocks]

    def on_card(name, call, want, detail=""):
        """``call()`` must give ``want`` with no host decode or encode."""
        hd, he = dec.host_decodes, enc.host_encodes
        got = call()
        report(name, got == want and dec.host_decodes == hd
               and enc.host_encodes == he,
               f"{detail} host_decodes={dec.host_decodes - hd} "
               f"host_encodes={enc.host_encodes - he}".strip())

    if "decode" in which:
        on_card("decode.vector", lambda: dec.decode_batch(packed, lens),
                blocks, f"{len(blocks)} x 64 KB")
        on_card("decode.unknown", lambda: dec.decode_batch_unknown(
            packed[:4], [n + 32 for n in lens[:4]]), blocks[:4])
        dictionary, body = data[:4096], data[4096:4096 + 30000]
        pk = native.compress_block_dict(dictionary, body)
        on_card("decode.dict", lambda: dec.decode_batch(
            [pk], [len(body)], dictionary=dictionary), [body])

    if "big" in which:
        pk = native.compress_block(data)
        on_card("big.decode", lambda: dec.decode_batch([pk], [len(data)]),
                [data], "1 MB")
        on_card("big.unknown", lambda: dec.decode_batch_unknown(
            [pk], [2 << 20]), [data], "1 MB, 2 MB cap")
        on_card("big.encode", lambda: [native.decompress_block(
            p, len(data)) for p in cuda.compress_blocks_fast([data],
                                                             device=dev)],
                [data], "1 MB")

    if "encode" in which:
        sub = blocks[:8]
        for level, name in ((0, "encode.fast"), (9, "encode.hc")):
            def round_trip(level=level):
                out = (cuda.compress_blocks_hc_fast(sub, level=level,
                                                    device=dev)
                       if level else cuda.compress_blocks_fast(sub,
                                                               device=dev))
                return [native.decompress_block(p, len(b))
                        for p, b in zip(out, sub)]
            on_card(name, round_trip, sub, f"{len(sub)} blocks")

    if "strict" in which:
        sub, sub_p = blocks[:4], packed[:4]
        on_card("strict.encode", lambda: cuda.compress_blocks(
            sub, device=dev), sub_p, "4 blocks, the reference's bytes")
        on_card("strict.decode", lambda: SequencerDecoder(dev).decode_batch(
            sub_p, lens[:4]), sub, "4 blocks")

    torch.cuda.synchronize()
    dt = time.time() - t_all
    if FAILED:
        print(f"NOT CERTIFIED ({dt:.0f}s): {', '.join(FAILED)}", flush=True)
        return 1
    print(f"CERTIFIED ({dt:.0f}s)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
