"""Batched known-length decode of independent LZ4 blocks on the card.

Port of the fused branch of ``lz4net_tpu/ops/decode_vector.py``
(``decode_batch_vectorized(fused=True)``, :304-374), with its preset-
dictionary prefix, and of ``VectorDecoder``'s known-length, dictionary
(``decode_batch``, :706-785) and unknown-length (``decode_batch_unknown``,
:653-703) decode, with blocks over 96 KB as fragment waves
(``_decode_big_many``, :599-651).  Four kernels carry it, each with its
plain PyTorch version beside it:

1. ``parse_kernel.parse_tokens``: compressed bytes -> token marks;
2. ``records_kernel.records_to_state``: marks -> per-byte state words and
   the hardened decoder's certificate;
3. ``fused_gather.rowbase_gather``: the literal byte of every output byte;
4. ``resolve_kernel.resolve_wavefront``: state words -> output bytes.

The kernels' gathers are exact, so the JAX decoder's sequence/event caps
and its second, dense-caps pass serve nothing here: one pass decodes
every block, and a block the device cannot certify is re-decoded by the
host oracle (``models.native``, the native host engine), which raises
``CorruptedBlockError`` for malformed input.  ``VectorDecoder.host_decodes`` counts those blocks.

A preset dictionary rides a prefix of P positions (a multiple of 8192)
in front of each row's output domain: the window, cut to its last 64 KB,
lies right-aligned below P as resolved bytes, ``records_to_state``
places the first token at P and checks every match against the window's
true start (P - pre_len), and ``resolve_wavefront`` passes the P / 8192
prefix chunks through.

A block over 96 KB, compressed or decoded, is cut on the host into
fragments of at most 96 KB of output (``bigblock.split_fragments``, a
walk over its sequence headers); fragment w of every big block of the
batch decodes in one device pass, each behind its own window, the
block's previous 64 KB of output, through the same prefix rows.

The certificate holds no rule of the reference decoders at a block's
end; ``records_to_state`` also gives the positions those rules bind on
(its ``ends``): the ends of the block's last sequence with a match
(positions only grow from one sequence to the next, so the earlier ones
keep them too).  A block is accepted only where they hold: the
known-length decoder's (``reference.decompress_block``, whose rules
``native.decompress_block`` keeps) on the known-length and dictionary
paths, the hardened decoder's (``reference._unknown_sequences``) on the
unknown-length path.  A big
block's are checked on its header walk (``bigblock.scan``), once for
the block: a mid-block fragment ends on a match by design.
"""

from __future__ import annotations

import numpy as np
import torch

from ..constants import (COPYLENGTH, LASTLITERALS, MAX_DISTANCE_WINDOW,
                         MFLIMIT)
from ..models import native, reference
from ..spans import span
from .bigblock import WINDOW, scan, split_fragments
from .fused_gather import rowbase_gather
from .host_rows import (HostRows, broadcast, fetch, lay, resolve_device,
                        upload)
from .parse_kernel import parse_tokens
from .records_kernel import records_to_state
from .resolve_kernel import resolve_wavefront

CH = 8192            # output padding / resolve chunk
BCH = 4096           # compressed-length padding
VFLAG = 1 << 19      # value-terminal flag in state words
BIASD = 1 << 18      # bound on the output domain Dt


def _cdiv(a, b):
    return -(-a // b)


def batch_from_numpy(comp, comp_len, out_len, device):
    """The port's tensors for one batch: comp [B, C] bytes (uint8, C a
    multiple of 4096) and comp_len/out_len [B] as numpy arrays, as the
    JAX ``_device_pass`` builds them.  The bytes ship as uint8 and widen
    to int32 on the device.  Returns (comp, comp_len, out_len) int32."""
    comp = np.ascontiguousarray(comp, dtype=np.uint8)
    if comp.ndim != 2 or comp.shape[1] % BCH:
        raise ValueError(f"comp must be [B, C] with C % {BCH} == 0")
    return upload(device, comp, comp_len, out_len, widen=True)


def block_widths(blocks, out_lens):
    """(C, D) of a batch as ``_device_pass`` sizes it (decode_vector.py:
    709-728 there): its longest block (at least 16 bytes) and output,
    each plus one, rounded up to multiples of 4096 and 8192."""
    return (_cdiv(max(max(map(len, blocks)), 16) + 1, BCH) * BCH,
            _cdiv(max(max(out_lens), 1) + 1, CH) * CH)


def pack_blocks(blocks, out_lens):
    """Host-side batch layout of ``_device_pass`` (decode_vector.py:
    709-728): (comp [B, C] uint8, comp_len [B], out_len [B], C, D)."""
    C, D = block_widths(blocks, out_lens)
    return (lay(np.empty((len(blocks), C), np.uint8), blocks),
            np.array([len(b) for b in blocks], np.int32),
            np.array(out_lens, np.int32), C, D)


def prefix_windows(dictionary, B: int):
    """The windows of ``pack_windows``: (one shared window, or a list of
    B, each cut to its last 64 KB; pre_len [B] int32; P, the longest
    rounded up to a multiple of 8192)."""
    if isinstance(dictionary, (bytes, bytearray, memoryview)):
        windows = bytes(dictionary)[-MAX_DISTANCE_WINDOW:]
        pre_len = np.full(B, len(windows), np.int32)
    else:
        windows = [bytes(w or b"")[-MAX_DISTANCE_WINDOW:] for w in dictionary]
        if len(windows) != B:
            raise ValueError(f"{len(windows)} windows for {B} blocks")
        pre_len = np.array([len(w) for w in windows], np.int32)
    return windows, pre_len, _cdiv(max(int(pre_len.max()), 1), CH) * CH


def lay_windows(rows, windows, P: int):
    """``prefix_windows``' windows right-aligned in the first P columns
    of ``rows``: a shared one by one broadcast.  Returns ``rows``."""
    return (broadcast if isinstance(windows, bytes) else lay)(
        rows, windows, end=P)


def pack_windows(dictionary, B: int):
    """The prefix rows of ``_device_pass`` (decode_vector.py:730-747
    there): one shared window (bytes, written into every row at once) or
    one a row (a list of B), each cut to its last 64 KB and right-aligned
    in P, the longest window rounded up to a multiple of 8192.  Returns
    (pre [B, P] uint8, pre_len [B] int32, P) as numpy arrays and an int."""
    windows, pre_len, P = prefix_windows(dictionary, B)
    return lay_windows(np.empty((B, P), np.uint8), windows, P), pre_len, P


def decode_batch_vectorized(comp, comp_len, out_len, C: int, D: int,
                            pre=None, pre_len=None):
    """Decode a batch of independent known-length blocks.

    comp: [B, C] int32 bytes (zero padded), comp_len/out_len: [B] int32,
    C % 4096 == 0, D % 8192 == 0.  ``pre`` [B, P] int32 bytes (P % 8192
    == 0) is an optional preset-dictionary prefix that precedes the
    output, each row's window right-aligned at P, and ``pre_len`` [B]
    int32 its true length.  Returns (out [B, D] int32 bytes, total_out,
    ok, strict, consumed, needed), each [B]: the certificate of
    ``lz4net_tpu.ops.decode_vector.decode_batch_vectorized``, whose
    ``needed`` is the decoded size the parse implies, independent of
    ``out_len`` (the unknown-length path's return value).
    """
    return device_pass(comp, comp_len, out_len, C, D, pre, pre_len)[:6]


def known_ends_ok(lit_end: int, match_end: int, n: int) -> bool:
    """The known-length decoder's block-end rules
    (``reference.decompress_block``, and ``decompress_block_dict`` past
    its window) on the last match of a block of ``n`` decoded bytes: its
    literals end at most 8 bytes, and it at most 5, before the end
    (element-wise on tensors)."""
    return (lit_end <= n - COPYLENGTH) & (match_end <= n - LASTLITERALS)


def known_certified(ok, total, strict, needed, ends, out_len):
    """The known-length acceptance rule, element-wise over a device
    pass's outputs (tensors or arrays): the hardened decoder's
    invariants (``ok``, ``strict``), exactly ``out_len`` bytes decoded
    and implied by the parse (the rule of decode_vector.py:769-774
    there), and the block-end rules on ``ends``; anything weaker could
    accept a block the reference decoder rejects."""
    return (ok & strict & (needed == total) & (total == out_len)
            & known_ends_ok(ends[:, 1], ends[:, 2], out_len))


def unknown_ends_ok(ends, comp_len: int, cap: int) -> bool:
    """The hardened decoder's block-end rules (``reference.
    _unknown_sequences``) on a row ``ends`` of ``records_to_state``'s
    block ends, of a block of ``comp_len`` bytes under a ``cap``: the
    last match's literals end at most 8 bytes before the compressed
    block's end and 12 before the cap, the match itself 5 before the
    cap, and its length's extension bytes lie before the last 6
    compressed bytes (where that decoder stops reading them)."""
    lit_in, lit_end, match_end, ext_end = (int(e) for e in ends)
    return (lit_in <= comp_len - (2 + 1 + LASTLITERALS)
            and lit_end <= cap - MFLIMIT
            and match_end <= cap - LASTLITERALS
            and ext_end <= comp_len - (LASTLITERALS + 1))


def device_pass(comp, comp_len, out_len, C: int, D: int, pre=None,
                pre_len=None):
    """``decode_batch_vectorized``'s six outputs, then the block ends of
    ``records_to_state`` [B, 4] (the rules' positions)."""
    P = 0 if pre is None else pre.shape[1]
    Dt = P + D
    if D % CH or P % CH or Dt > BIASD:
        raise ValueError(f"D and P must be multiples of {CH}, P + D <= "
                         f"{BIASD}")
    if pre_len is None:
        pre_len = torch.zeros_like(comp_len)
    o = torch.arange(Dt, dtype=torch.int32, device=comp.device)
    live_o = o[None, :] < P + out_len[:, None]

    mark, lit_len, mlen, pmiss = parse_tokens(comp, comp_len, C)
    ends = torch.empty((comp.shape[0], 4), dtype=torch.int32,
                       device=comp.device)
    t0m, cidx, stats = records_to_state(comp, mark, lit_len, mlen, comp_len,
                                        out_len, pre_len, C, Dt, P, ends)
    total_out = stats[:, 1]
    strict = stats[:, 2] != 0
    consumed = stats[:, 3]
    needed = stats[:, 4]
    rk_miss = stats[:, 5] != 0

    is_lit_o = cidx >= 0
    lit_idx = torch.cummax(torch.where(is_lit_o, cidx.clamp(0, C - 1), 0),
                           dim=1).values
    vals0, band_l = rowbase_gather(comp, lit_idx)
    lit_miss = (~band_l & is_lit_o & live_o).any(1)
    T0 = torch.where(is_lit_o, VFLAG | (vals0 & 0xFF), t0m)
    if P:
        T0[:, :P] = VFLAG | pre
    out, res_ok = resolve_wavefront(T0, P // CH)
    out = out[:, P:] * live_o[:, P:]
    ok = ~rk_miss & ~lit_miss & res_ok & ~pmiss
    return out, total_out, ok, strict, consumed, needed, ends


class VectorDecoder:
    """Known-length, dictionary and unknown-length batch decode through
    the four kernels, one device pass per batch; uncertified blocks go
    to the host oracle."""

    MAX_BLOCK = 96 * 1024

    def __init__(self, device="cuda"):
        self.device = resolve_device(device)
        self.host_decodes = 0
        self._comp, self._pre = HostRows(), HostRows()

    def _layout(self, blocks, out_lens, dictionary=None):
        """One device pass's rows on the host, as ``pack_blocks`` and
        ``pack_windows`` lay them, in this thread's kept buffers: (comp,
        comp_len, out_len, C, D, pre, pre_len), the last two None without
        ``dictionary``."""
        C, D = block_widths(blocks, out_lens)
        comp = lay(self._comp.empty((len(blocks), C)), blocks)
        pre = pre_len = None
        if dictionary:
            windows, pre_len, P = prefix_windows(dictionary, len(blocks))
            pre = lay_windows(self._pre.empty((len(blocks), P)), windows, P)
        return (comp, np.array([len(b) for b in blocks], np.int32),
                np.array(out_lens, np.int32), C, D, pre, pre_len)

    def _pass(self, comp, comp_len, out_len, C, D, pre, pre_len):
        """One device pass over rows from ``_layout``: (out [B, D] uint8,
        total, ok, strict, needed, block ends [B, 4]) as numpy arrays."""
        with span("lz4t.decode.upload"):
            dev = upload(self.device, comp, comp_len, out_len, widen=True)
            pre, pre_len = upload(self.device, pre, pre_len, widen=True)
        with span("lz4t.decode.pass"):
            out, total, ok, strict, _consumed, needed, ends = \
                device_pass(*dev, C, D, pre, pre_len)
        with span("lz4t.decode.fetch"):
            return fetch(out, total, ok, strict, needed, ends)

    def decode_batch(self, blocks, out_lens, dictionary=None):
        """The decoded blocks of known lengths ``out_lens``; with
        ``dictionary`` (one window shared by the batch, or a list of one
        window a block) matches may reach back into the window.  Blocks
        over 96 KB, compressed or decoded, go to ``_decode_big_many``
        where their header walk (``bigblock.scan``) gives their length
        and keeps the block-end rules, else to the host decoder."""
        with span("lz4t.decode.batch"):
            with span("lz4t.decode.layout"):
                blocks = [bytes(b) for b in blocks]
                out_lens = list(out_lens)
                if not blocks:
                    return []
                shared = None      # one window, laid by one broadcast
                if isinstance(dictionary, (bytes, bytearray, memoryview)):
                    shared = bytes(dictionary)
                    dictionary = [shared] * len(blocks) if shared else None
                big = [i for i, (b, n) in enumerate(zip(blocks, out_lens))
                       if len(b) > self.MAX_BLOCK or n > self.MAX_BLOCK]
                bigs = set(big)
                small = [i for i in range(len(blocks)) if i not in bigs]
                results = [None] * len(blocks)
                if small:
                    lens = np.array([out_lens[i] for i in small], np.int64)
                    laid = self._layout(
                        [blocks[i] for i in small], lens.tolist(),
                        shared or ([dictionary[i] for i in small]
                                   if dictionary else None))

            def host(i):
                self.host_decodes += 1
                return (native.decompress_block_dict(
                    blocks[i], dictionary[i], out_lens[i]) if dictionary
                    else native.decompress_block(blocks[i], out_lens[i]))

            if small:
                out, total, ok, strict, needed, ends = self._pass(*laid)
                with span("lz4t.decode.unpack"):
                    accepted = known_certified(ok, total, strict, needed,
                                               ends, lens)
                    for j, i in enumerate(small):
                        if accepted[j]:
                            results[i] = out[j, :lens[j]].tobytes()
                        else:
                            results[i] = host(i)
            if not big:
                return results
            with span("lz4t.decode.layout"):
                walked = []
                for i in big:
                    s = scan(blocks[i])
                    if (s is not None and s[2] == out_lens[i]
                            and (s[4] is None
                                 or known_ends_ok(*s[4], out_lens[i]))):
                        walked.append((i, s))
                    else:
                        results[i] = host(i)
            if walked:
                self._decode_big_many(
                    [i for i, _ in walked], blocks, out_lens, results, host,
                    by_fragment=True, dictionary=dictionary,
                    scans=[s for _, s in walked])
            return results

    def _decode_big_many(self, idx, blocks, out_lens, results, host,
                         by_fragment, dictionary=None, scans=None):
        """Decode ``blocks[i]`` for i in ``idx`` (blocks over 96 KB)
        into ``results[i]`` as fragment waves (decode_vector.py:599-651
        there; ``bigblock.split_fragments``): wave w decodes fragment w
        of every block that has one in one device pass, each row behind
        its own window, the block's last 64 KB of output (the dictionary's
        tail, per block, before that).  A block the header walk refuses
        goes whole to ``host(i)``, the host decoder of its path, which
        raises the reference's error and counts in ``host_decodes``.  So
        does a block with a fragment the card cannot certify, unless
        ``by_fragment``: then (the known-length paths) that fragment alone
        is re-decoded on the host by ``native.decompress_fragment``, as
        the JAX package's ``native.decompress_fragment`` (counted), and
        the block goes to ``host(i)`` only where that refuses too.
        ``scans`` carries each block's ``bigblock.scan``, already walked
        by the caller, who has checked its path's block-end rules on it:
        fragments are not held to them."""
        frags, outs, heads = {}, {}, {}
        with span("lz4t.decode.layout"):
            for k, i in enumerate(idx):
                f = split_fragments(blocks[i], out_lens[i], scans[k])
                if f is None:
                    results[i] = host(i)
                    continue
                frags[i] = f
                outs[i] = bytearray()
                heads[i] = (bytes(dictionary[i] or b"")[-WINDOW:]
                            if dictionary else b"")
        for w in range(max(map(len, frags.values()), default=0)):
            live = [i for i in frags if w < len(frags[i])]
            if not live:
                break
            with span("lz4t.decode.layout"):
                fr = [frags[i][w][0] for i in live]
                sizes = [frags[i][w][2] for i in live]
                windows = []
                for i in live:
                    o0 = frags[i][w][1]
                    windows.append((heads[i] + bytes(outs[i]))[-WINDOW:]
                                   if o0 < WINDOW
                                   else bytes(outs[i][o0 - WINDOW:o0]))
                laid = self._layout(fr, sizes,
                                    windows if any(windows) else None)
            out, total, ok, strict, needed, _ends = self._pass(*laid)
            with span("lz4t.decode.unpack"):
                for j, i in enumerate(live):
                    n = sizes[j]
                    if (bool(ok[j]) and int(total[j]) == n
                            and bool(strict[j]) and int(needed[j]) == n):
                        outs[i] += out[j, :n].tobytes()
                        continue
                    piece = None
                    if by_fragment:
                        try:
                            piece = native.decompress_fragment(
                                fr[j], windows[j], n)
                        except reference.CorruptedBlockError:
                            pass
                    if piece is None:
                        results[i] = host(i)
                        del frags[i]
                    else:
                        self.host_decodes += 1
                        outs[i] += piece
        with span("lz4t.decode.unpack"):
            for i in frags:
                results[i] = bytes(outs[i])

    def decode_batch_unknown(self, blocks, max_out_lens):
        """Unknown-output-length decode: each block's decoded bytes, at
        most its ``max_out_lens`` entry.  One device pass with each cap,
        cut to 96 KB, as the output length; a block is accepted only when
        the hardened decoder's invariants hold and the exact size the
        parse implies (``needed``, which does not depend on the output
        length) was decoded whole within its cap (decode_vector.py:
        694-700 there) and the hardened decoder's block-end rules hold
        (``unknown_ends_ok``).  A block over 96 KB, or one whose parse implies
        more than 96 KB under a cap above that, is walked on the host
        twice: the hardened decoder's walk over its headers
        (``native.unknown_output_length``, every block-end and cap
        rule of that decoder) gives the length n it decodes to, and
        ``bigblock.scan`` must find the same n; then it decodes as a
        known-length big block of n bytes, every fragment certified on
        the card (the JAX package decodes these on its host).  Every
        other block, an empty one, one either walk refuses and one with
        a fragment the card cannot certify, is decoded by the host's
        hardened decoder, which raises the reference's errors for
        malformed input."""
        with span("lz4t.decode.batch"):
            with span("lz4t.decode.layout"):
                blocks = [bytes(b) for b in blocks]
                caps = list(max_out_lens)
                results = [None] * len(blocks)
                big = [i for i, b in enumerate(blocks)
                       if len(b) > self.MAX_BLOCK]
                live = [i for i, b in enumerate(blocks)
                        if b and len(b) <= self.MAX_BLOCK]
                if live:
                    laid = self._layout(
                        [blocks[i] for i in live],
                        [min(caps[i], self.MAX_BLOCK) for i in live])

            def host(i):
                self.host_decodes += 1
                return native.decompress_block_unknown(blocks[i], caps[i])

            if live:
                out, total, ok, strict, needed, ends = self._pass(*laid)
                with span("lz4t.decode.unpack"):
                    for j, i in enumerate(live):
                        n = int(needed[j])
                        if (bool(ok[j]) and bool(strict[j])
                                and n == int(total[j]) and n <= caps[i]
                                and unknown_ends_ok(ends[j], len(blocks[i]),
                                                    caps[i])):
                            results[i] = out[j, :n].tobytes()
                        elif n > self.MAX_BLOCK and caps[i] > self.MAX_BLOCK:
                            big.append(i)
            walked = []
            if big:
                with span("lz4t.decode.layout"):
                    for i in big:
                        try:
                            n = native.unknown_output_length(blocks[i],
                                                             caps[i])
                        except reference.CorruptedBlockError:
                            continue         # the host decoder raises it
                        # the walks part only where the hardened one stops
                        # reading a match length 6 bytes before the end;
                        # scan then refuses the block or finds it longer:
                        # equal lengths, equal parses
                        s = scan(blocks[i])
                        if s is not None and s[2] == n:
                            walked.append((i, s))
            if walked:
                self._decode_big_many(
                    [i for i, _ in walked], blocks,
                    {i: s[2] for i, s in walked}, results, host,
                    by_fragment=False, scans=[s for _, s in walked])
            with span("lz4t.decode.unpack"):
                for i, r in enumerate(results):
                    if r is None:
                        results[i] = host(i)
            return results
