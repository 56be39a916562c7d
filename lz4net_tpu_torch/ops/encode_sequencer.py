"""Strict greedy block encode on the card: the reference parse, one block
per CTA.

Port of the TPU kernel ``lz4net_tpu/ops/encode_pallas.py``
(``build_encode_call``, ``_encode_kernel`` :51), the JAX package's
"sequencer" encoder and the default encode of its facade.  The CUDA
kernel is ``csrc/encode_sequencer.cu``: one warp a block runs the parse,
on the row staged whole in shared memory where it fits (``row_max``:
183,232 bytes on the H100), else on the row where it lies in device
memory, through the L1 cache (``device_rows`` counts those rows), chosen
by the row width in one launch.  What bounds it on the H100 is the
parse's chain of dependent warp steps, about 0.5 us a token, so a batch
takes as long as its densest row; a wide row's parse reads within about
64 KB behind its position, which L1 holds, at about 1.1 times the staged
row's time (the header says what the design does about each bound).
``encode_sequencer_reference`` is its plain version, used for CPU tensors
and as the kernel's yardstick on the card.

The payloads are bit-identical to the reference compressor's
(``models.reference.compress_block``) for every block size: the kernel
keeps both of its hash variants (8192 entries below ``LZ4_64KLIMIT``,
4096 entries and the 64 KB window check at or above it), so there is no
48 KB cap (``encode_pallas.py:11-14``, a TPU SMEM budget).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import _build
from ..constants import maximum_output_length
from ..models import reference
from ..spans import span
from .host_rows import HostRows, fetch, kept, lay, resolve_device, upload

MAX_COLS = (1 << 31) // 256   # S and O: block offsets stay inside int32

launches = 0
# rows the kernel parsed from device memory (rows wider than row_max)
device_rows = 0


def _check(src, src_len, dst_maxlen, O):
    if src.dtype != torch.uint8 or src.dim() != 2:
        raise TypeError("src must be [B, S] uint8")
    for name, t in (("src_len", src_len), ("dst_maxlen", dst_maxlen)):
        if t.dtype != torch.int32 or t.shape != (src.shape[0],) \
                or t.device != src.device:
            raise ValueError(f"{name} must be [B] int32 on src's device")
    if not 0 < O < MAX_COLS or src.shape[1] >= MAX_COLS:
        raise ValueError(f"S and O must be below {MAX_COLS}, O positive")


def row_max(device="cuda") -> int:
    """The widest row (S) that the kernel stages in shared memory on
    ``device``, a CUDA device; wider rows it reads from device memory."""
    n = ctypes.c_int(0)
    _build.launch("lz4t_encode_sequencer_row_max", torch.device(device),
                  ctypes.addressof(n))
    return n.value


def encode_sequencer(src, src_len, dst_maxlen, O: int):
    """src: [B, S] uint8 (row b holds its block in ``src[b, :src_len[b]]``),
    src_len/dst_maxlen: [B] int32.  Returns (out [B, O] uint8, written [B]
    int32): ``out[b, :written[b]]`` is the compressed block and the rest
    of the row is undefined (the plain version leaves it 0); ``written[b]``
    is -1 when the block would exceed ``dst_maxlen[b]`` or ``O``
    (``status[:, 0]`` of ``encode_pallas.py:305``; the JAX caller sizes O
    to fit)."""
    global launches, device_rows
    _check(src, src_len, dst_maxlen, O)
    if src.device.type == "cpu":
        return encode_sequencer_reference(src, src_len, dst_maxlen, O)
    if src.device.type != "cuda":
        raise ValueError(f"unsupported device {src.device}")
    src, src_len = src.contiguous(), src_len.contiguous()
    dst_maxlen = dst_maxlen.contiguous()
    B, S = src.shape
    out = torch.empty((B, O), dtype=torch.uint8, device=src.device)
    written = torch.empty(B, dtype=torch.int32, device=src.device)
    _build.launch("lz4t_encode_sequencer", src.device, src.data_ptr(),
                  src_len.data_ptr(), dst_maxlen.data_ptr(), out.data_ptr(),
                  written.data_ptr(), B, S, O)
    launches += 1
    if S > row_max(src.device):
        device_rows += B
    return out, written


def encode_sequencer_reference(src, src_len, dst_maxlen, O: int):
    """Plain version of ``encode_sequencer`` on CPU tensors.

    The parse is one serial walk per block: written with PyTorch
    operators it would be one scalar operator per byte and would not
    finish on a 16 MB batch.  So this applies the port's own reference
    parse, ``models.reference.compress_block`` (bit-identical to the
    reference compressor and to the JAX kernel), to each row, behind the
    kernel's exact tensor interface; an empty row gives the kernel's lone
    last-literals token.
    """
    B, S = src.shape
    rows = src.numpy()
    out = np.zeros((B, O), np.uint8)
    written = np.full(B, -1, np.int32)
    for b in range(B):
        n = min(max(int(src_len[b]), 0), S)
        cap = int(dst_maxlen[b])
        blk = (reference.compress_block(rows[b, :n].tobytes(), cap) if n
               else b"\x00" * (cap >= 1))
        if blk and len(blk) <= O:
            out[b, :len(blk)] = np.frombuffer(blk, np.uint8)
            written[b] = len(blk)
    return torch.from_numpy(out), torch.from_numpy(written)


class SequencerEncoder:
    """Batched strict encode through ``encode_sequencer``, one launch per
    batch (counterpart of ``encode_pallas.PallasEncoder``, :345-384,
    without its 48 KB cap)."""

    def __init__(self, device="cuda"):
        self.device = resolve_device(device)
        self._rows = HostRows()

    def encode_batch(self, blocks, dst_maxlens=None) -> list[bytes]:
        """Payloads byte-identical to the reference compressor's; b"" for
        a block whose payload would not fit its ``dst_maxlens`` entry
        (default: the worst-case bound)."""
        with span("lz4t.encode.batch"):
            with span("lz4t.encode.layout"):
                blocks = [bytes(b) for b in blocks]
                if not blocks:
                    return []
                if dst_maxlens is None:
                    dst_maxlens = [maximum_output_length(len(b))
                                   for b in blocks]
                S = max(max(map(len, blocks)), 1)
                # no payload exceeds the bound, whatever a block's own cap
                O = max(min(max(dst_maxlens), maximum_output_length(S)), 1)
                src = lay(self._rows.empty((len(blocks), S)), blocks)
            with span("lz4t.encode.upload"):
                src, src_len, caps = upload(
                    self.device, src, [len(b) for b in blocks], dst_maxlens)
            with span("lz4t.encode.pass"):
                out, written = encode_sequencer(src, src_len, caps, O)
            with span("lz4t.encode.fetch"):
                written = written.cpu().numpy()
                # only the columns a payload reaches
                out, = fetch(out[:, :max(int(written.max()), 1)])
            with span("lz4t.encode.unpack"):
                return [out[i, :n].tobytes() if n > 0 else b""
                        for i, n in enumerate(written)]


def compress_block(src: bytes, dst_maxlen: int | None = None,
                   device="cuda") -> bytes:
    """One block through the strict encoder (``encode_pallas.compress_block``,
    :390-399), the one kept for ``device``; b"" for empty input or a
    payload over ``dst_maxlen``."""
    src = bytes(src)
    enc = kept(SequencerEncoder, device)  # raises for CUDA without a card
    if not src:
        return b""
    if dst_maxlen is None:
        dst_maxlen = maximum_output_length(len(src))
    return enc.encode_batch([src], [dst_maxlen])[0]
