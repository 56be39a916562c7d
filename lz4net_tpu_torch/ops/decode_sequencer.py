"""Sequencer decode on the card: one serial token walk per block.

Port of the TPU kernel ``lz4net_tpu/ops/decode_pallas.py``
(``build_decode_call``, ``_decode_kernel`` :167), which walks each block's
tokens and reports ``(bytes read, bytes written)`` for the host to check.
The CUDA kernel is ``csrc/decode_sequencer.cu``: output rows up to
``row_max`` bytes (167,072 on the H100) are decoded in shared memory, the
tokens found by segment exits as ``parse_tokens`` finds them and their
copies made a token a lane; wider rows (or compressed rows past LZ4's
worst case for them) by one warp in device memory, chosen by the row
widths in one launch (its header says what bounds it on the H100 and what
the design does about that);
``decode_sequencer_reference`` is its plain version, used for CPU tensors
and as the kernel's yardstick on the card.

The walk is the TPU kernel's: token, literal run with 255-extensions,
16-bit offset, a match of ``mlen + 4`` bytes with LZ4's overlapping-copy
semantics, looping while ``dp < out_len``; status ``(sp, dp)``.  The TPU
kernel trusts its input (``decode_pallas.py:23-27``); on the card a read
or write out of bounds from junk would kill the CUDA context, so the walk
here stops at the first *fault* and reports status ``(-1, dp)``, which
never equals ``(comp_len, out_len)``.  A fault is:

* a read of ``comp`` at or past ``comp_len`` (or ``C``);
* a literal run or match that would write past ``D``;
* a match with ``offset == 0`` or ``offset > dp`` (outside the window);
* the reference decoder's end-of-block rules
  (``models.reference.decompress_block``): a literal run ending past
  ``out_len - COPYLENGTH`` must end exactly at ``out_len`` (the last
  run), and a match must end at or before ``out_len - LASTLITERALS``.

So the port rejects every block the TPU kernel rejects, and more: a block
it accepts (status ``(comp_len, out_len)``) is one the reference decoder
accepts, with the same bytes.  Rows are zero past the bytes written.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import _build
from ..constants import COPYLENGTH, LASTLITERALS
from ..models.reference import CorruptedBlockError
from .decode_vector import resolve_device

MAX_COLS = (1 << 31) // 256   # C and D: 255-extended lengths stay in int32

launches = 0


def _check(comp, comp_len, out_len, D):
    if comp.dtype != torch.uint8 or comp.dim() != 2:
        raise TypeError("comp must be [B, C] uint8")
    for name, t in (("comp_len", comp_len), ("out_len", out_len)):
        if t.dtype != torch.int32 or t.shape != (comp.shape[0],) \
                or t.device != comp.device:
            raise ValueError(f"{name} must be [B] int32 on comp's device")
    if not 0 < D < MAX_COLS or comp.shape[1] >= MAX_COLS:
        raise ValueError(f"C and D must be below {MAX_COLS}, D positive")


def row_max(device="cuda") -> int:
    """The widest output row (D) that the kernel decodes in shared memory
    on ``device``, a CUDA device, with a compressed row (C) up to LZ4's
    worst case for it, ``D + D // 255 + 16``; wider rows go to its one-warp
    kernel."""
    n = ctypes.c_int(0)
    _build.launch("lz4t_decode_sequencer_row_max", torch.device(device),
                  ctypes.addressof(n))
    return n.value


def decode_sequencer(comp, comp_len, out_len, D: int):
    """comp: [B, C] uint8 (row b holds its block in ``comp[b,
    :comp_len[b]]``), comp_len/out_len: [B] int32.  Returns (out [B, D]
    uint8, status [B, 2] int32): the bytes written, zero past them, and
    ``(bytes read, bytes written)``, or ``(-1, bytes written)`` after a
    fault (module docstring)."""
    global launches
    _check(comp, comp_len, out_len, D)
    if comp.device.type == "cpu":
        return decode_sequencer_reference(comp, comp_len, out_len, D)
    if comp.device.type != "cuda":
        raise ValueError(f"unsupported device {comp.device}")
    comp, comp_len = comp.contiguous(), comp_len.contiguous()
    out_len = out_len.contiguous()
    B, C = comp.shape
    out = torch.empty((B, D), dtype=torch.uint8, device=comp.device)
    status = torch.empty((B, 2), dtype=torch.int32, device=comp.device)
    _build.launch("lz4t_decode_sequencer", comp.device, comp.data_ptr(),
                  comp_len.data_ptr(), out_len.data_ptr(), out.data_ptr(),
                  status.data_ptr(), B, C, D)
    launches += 1
    return out, status


def _walk(comp: bytes, lim: int, out_len: int, D: int):
    """One block's walk: (decoded bytearray, sp or -1 after a fault, dp)."""
    dst = bytearray()
    sp = dp = 0

    def ext(sp, n):              # 255-extension bytes; None past lim
        while True:
            if sp >= lim:
                return None, n
            v = comp[sp]
            sp += 1
            n += v
            if v != 255:
                return sp, n

    while dp < out_len:
        if sp >= lim:
            return dst, -1, dp
        token = comp[sp]
        sp += 1
        lit = token >> 4
        if lit == 15:
            sp, lit = ext(sp, lit)
            if sp is None:
                return dst, -1, dp
        end = dp + lit
        if sp + lit > lim or end > D or \
                (end > out_len - COPYLENGTH and end != out_len):
            return dst, -1, dp
        dst += comp[sp:sp + lit]
        sp += lit
        dp = end
        if dp >= out_len:
            break
        if sp + 2 > lim:
            return dst, -1, dp
        offset = comp[sp] | (comp[sp + 1] << 8)
        sp += 2
        mlen = token & 15
        if mlen == 15:
            sp, mlen = ext(sp, mlen)
            if sp is None:
                return dst, -1, dp
        mlen += 4
        if offset == 0 or offset > dp or dp + mlen > D or \
                dp + mlen > out_len - LASTLITERALS:
            return dst, -1, dp
        period = dst[dp - offset:dp]
        dst += (period * (mlen // offset + 1))[:mlen]
        dp += mlen
    return dst, sp, dp


def decode_sequencer_reference(comp, comp_len, out_len, D: int):
    """Plain version of ``decode_sequencer`` on CPU tensors: the same walk
    and the same status rules, one Python loop per block."""
    B, C = comp.shape
    rows = comp.numpy()
    out = np.zeros((B, D), np.uint8)
    status = np.zeros((B, 2), np.int32)
    for b in range(B):
        lim = min(max(int(comp_len[b]), 0), C)
        dst, sp, dp = _walk(rows[b, :lim].tobytes(), lim, int(out_len[b]), D)
        out[b, :len(dst)] = np.frombuffer(bytes(dst), np.uint8)
        status[b] = (sp, dp)
    return torch.from_numpy(out), torch.from_numpy(status)


class SequencerDecoder:
    """Known-length batch decode through ``decode_sequencer``, one launch
    per batch (counterpart of ``decode_pallas.PallasDecoder``, :291-338).
    A block whose status is not ``(len(block), out_len)`` raises
    ``CorruptedBlockError``; there is no host re-decode."""

    def __init__(self, device="cuda"):
        self.device = resolve_device(device)

    def decode_batch(self, blocks, out_lens) -> list[bytes]:
        blocks = [bytes(b) for b in blocks]
        out_lens = list(out_lens)
        if not blocks:
            return []
        C = max(max(map(len, blocks)), 1)
        D = max(max(out_lens), 1)
        comp = np.zeros((len(blocks), C), np.uint8)
        for i, b in enumerate(blocks):
            comp[i, :len(b)] = np.frombuffer(b, np.uint8)
        dev = self.device
        out, status = decode_sequencer(
            torch.from_numpy(comp).to(dev),
            torch.tensor([len(b) for b in blocks], dtype=torch.int32,
                         device=dev),
            torch.tensor(out_lens, dtype=torch.int32, device=dev), D)
        status = status.cpu().numpy()
        for i, (b, n) in enumerate(zip(blocks, out_lens)):
            if int(status[i, 0]) != len(b) or int(status[i, 1]) != n:
                raise CorruptedBlockError(
                    f"sequencer decode status mismatch on block {i}: "
                    f"read {int(status[i, 0])}/{len(b)}, "
                    f"wrote {int(status[i, 1])}/{n}")
        out = out.cpu().numpy()
        return [out[i, :n].tobytes() for i, n in enumerate(out_lens)]
