"""Data-parallel codec pipeline over a mesh of ranks.

Port of ``lz4net_tpu/parallel/pipeline.py``.  Blocks shard over the
mesh's ``blocks`` axis: each rank decodes its contiguous shard with the
sequencer decoder (``ops.decode_sequencer``) or encodes it with the
strict encoder (``ops.encode_sequencer``), one launch a step, and the
bytes written are summed over the ranks by ``dist.all_reduce`` (the
``psum`` there).  ``dist.all_gather`` brings outputs back to every rank
in block order.  The dictionary form runs the vector decoder's device
pass (``ops.decode_vector.device_pass``) behind a window that rank 0
broadcasts once.  Every rank passes the same global lists (the SPMD
contract), and every rank returns the whole result.

Each step launches on the device's current stream
(``_build.launch``), the stream NCCL orders its work after.

What a sequencer row is worth (``unpack_blocks``): a real row is
returned only when its status shows no fault (read >= 0), its bytes
written equal its ``out_len`` and ``out_len > 0``.  That is exactly
where the reference decoder (``models.reference.decompress_block``)
returns bytes, and they are the same bytes: the kernel's walk holds the
reference decoder's rules and stops once the output is full, so trailing
input bytes are accepted as that decoder accepts them.  A real row with
``out_len == 0``, where the walk never starts, goes to the host's
known-length decoder (``models.native.decompress_block``, which keeps
that decoder's rules).  Every other real row raises ``CorruptedBlockError`` (the JAX
pipeline checks only the bytes written, and returns blocks the kernel
there accepts but the reference rejects: one that ends in a match, a
match of offset 0).  The decision is made after the gather, on every
rank, so the ranks raise together and none waits in a collective.  Pad
rows, which make the batch divide over the ranks, are dropped before any
row is judged or decoded on the host.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ..models import native, reference
from ..ops.decode_sequencer import decode_sequencer
from ..ops.decode_vector import (device_pass, known_certified,
                                 pack_blocks as pack_vector_blocks,
                                 pack_windows)
from ..ops.encode_sequencer import encode_sequencer
from ..ops.host_rows import lay
from .mesh import block_sharding, make_mesh, replicated

PAD_BLOCK = b"\x00"     # token 0x00: an empty literal run

host_decodes = 0        # uncertified rows of distributed_decode_dict


def _local_blocks(mesh, n_blocks: int) -> int:
    world = mesh.size()
    if n_blocks % world:
        raise ValueError(f"n_blocks ({n_blocks}) must divide evenly over "
                         f"{world} ranks; pad the batch")
    return n_blocks // world


def gather_blocks(mesh, x: torch.Tensor) -> np.ndarray:
    """The ordered gather: every rank's shard ``x`` (equal shapes),
    concatenated in rank order, so in block order, on the host."""
    parts = [torch.empty_like(x) for _ in range(mesh.size())]
    dist.all_gather(parts, x.contiguous(), group=mesh.get_group())
    return torch.cat(parts).cpu().numpy()


def _all_reduced(mesh, x: torch.Tensor) -> torch.Tensor:
    total = x.sum(dtype=torch.int64)
    dist.all_reduce(total, group=mesh.get_group())
    return total


def pack_blocks(blocks, out_lens, pad_to_multiple_of: int = 1):
    """Host-side packing: (comp [B, C] uint8, lens [B, 2] int32 of
    (len(block), out_len), C, D, n_real).  C is the longest block and D
    the longest output, each at least 1; the batch is padded to a
    multiple of ``pad_to_multiple_of`` with ``(b"\\x00", 0)`` rows.  Also
    the strict encoder's input, with the caps as ``out_lens`` (a pad
    row's cap of 0 makes it write nothing)."""
    n = len(blocks)
    n_pad = (-n) % pad_to_multiple_of
    blocks = [bytes(b) for b in blocks] + [PAD_BLOCK] * n_pad
    out_lens = list(out_lens) + [0] * n_pad
    C = max(max(map(len, blocks)), 1)
    D = max(max(out_lens), 1)
    lens = np.array([(len(b), m) for b, m in zip(blocks, out_lens)],
                    np.int32)
    return lay(np.empty((len(blocks), C), np.uint8), blocks), lens, C, D, n


def make_distributed_decode(mesh, n_blocks: int, C: int, D: int):
    """A sharded sequencer decode step: ``step(comp [local, C] uint8,
    lens [local, 2] int32)``, this rank's shard on its device, returns
    (out [local, D] uint8, status [local, 2] int32 of (read, written),
    total), ``total`` the bytes written on every rank (an int64 scalar
    tensor, all-reduced)."""
    local = _local_blocks(mesh, n_blocks)

    def step(comp, lens):
        if comp.shape != (local, C) or lens.shape != (local, 2):
            raise ValueError(f"a shard is comp [{local}, {C}] and lens "
                             f"[{local}, 2]")
        out, status = decode_sequencer(comp, lens[:, 0], lens[:, 1], D)
        return out, status, _all_reduced(mesh, status[:, 1])
    return step


def make_distributed_encode(mesh, n_blocks: int, S: int, O: int):
    """A sharded strict encode step: ``step(src [local, S] uint8, lens
    [local, 2] int32 of (len, cap))`` returns (out [local, O] uint8,
    written [local] int32, total), ``out[b, :written[b]]`` the reference
    compressor's payload (``written`` -1 where it does not fit the cap)
    and ``total`` the payload bytes on every rank, all-reduced.
    ``pack_blocks(blocks, caps, world)`` lays out its input."""
    local = _local_blocks(mesh, n_blocks)

    def step(src, lens):
        if src.shape != (local, S) or lens.shape != (local, 2):
            raise ValueError(f"a shard is src [{local}, {S}] and lens "
                             f"[{local}, 2]")
        out, written = encode_sequencer(src, lens[:, 0], lens[:, 1], O)
        return out, written, _all_reduced(mesh, written.clamp(min=0))
    return step


def unpack_blocks(out, status, lens, n_real: int, comp) -> list[bytes]:
    """The real rows' bytes in input order under the module docstring's
    rule: ``out`` [B, D] and ``status`` [B, 2] gathered from every rank
    (``gather_blocks``), and pack's ``lens`` and ``comp`` (whose bytes a
    row with ``out_len == 0`` hands to the host decoder), all numpy."""
    results = []
    for i in range(n_real):
        comp_len, n = (int(v) for v in lens[i])
        read, wrote = (int(v) for v in status[i])
        if read >= 0 and wrote == n and n > 0:
            results.append(out[i, :n].tobytes())
        elif n == 0:
            results.append(native.decompress_block(
                comp[i, :comp_len].tobytes(), 0))
        else:
            raise reference.CorruptedBlockError(
                f"block {i}: read {read}/{comp_len}, wrote {wrote}/{n}")
    return results


def distributed_decode(blocks, out_lens, mesh=None,
                       device="cuda") -> list[bytes]:
    """Shard independent blocks over the mesh (a world of one on
    ``device`` if none is given), decode, gather in input order."""
    if mesh is None:
        mesh = make_mesh(device=device)
    comp, lens, C, D, n_real = pack_blocks(blocks, out_lens, mesh.size())
    step = make_distributed_decode(mesh, comp.shape[0], C, D)
    shard = block_sharding(mesh)
    out, status, _total = step(shard(comp), shard(lens))
    return unpack_blocks(gather_blocks(mesh, out),
                         gather_blocks(mesh, status), lens, n_real, comp)


def make_distributed_vector_decode_dict(mesh, n_blocks: int, C: int,
                                        D: int, P: int):
    """A sharded vector decode behind a replicated preset dictionary:
    ``step(comp [local, C] int32, comp_len, out_len [local] int32, pre
    [P] int32, pre_len [] int32)``, ``pre`` the window right-aligned in P
    and the same on every rank, returns (out [local, D] int32, ok [local]
    bool, total [local] int32, certified), ``certified`` the certified
    rows on every rank, all-reduced.  A row is certified only under the
    vector decoder's rule (``known_certified``: the strict certificate,
    ``needed == total == out_len`` and the known-length decoder's
    block-end rules).  ``device_pass`` raises ``ValueError`` where
    ``P + D`` passes 2**18."""
    local = _local_blocks(mesh, n_blocks)

    def step(comp, comp_len, out_len, pre, pre_len):
        out, total, ok, strict, _consumed, needed, ends = device_pass(
            comp, comp_len, out_len, C, D, pre[None].expand(local, P),
            pre_len.reshape(1).expand(local))
        ok = known_certified(ok, total, strict, needed, ends, out_len)
        return out, ok, total, _all_reduced(mesh, ok)
    return step


def distributed_decode_dict(blocks, out_lens, dictionary, mesh=None,
                            device="cuda") -> list[bytes]:
    """Decode dictionary-compressed blocks sharded over the mesh, the
    window (the dictionary's last 64 KB) broadcast once from rank 0.
    Every rank re-decodes the real rows that no rank certified with the
    host decoder (``native.decompress_block_dict``, counted in
    ``host_decodes``), which raises for malformed input."""
    global host_decodes
    if mesh is None:
        mesh = make_mesh(device=device)
    n = len(blocks)
    blocks, out_lens = [bytes(b) for b in blocks], list(out_lens)
    n_pad = (-n) % mesh.size()
    comp, comp_len, out_len, C, D = pack_vector_blocks(
        blocks + [PAD_BLOCK] * n_pad, out_lens + [0] * n_pad)
    pre, pre_len, P = pack_windows(bytes(dictionary), 1)
    step = make_distributed_vector_decode_dict(mesh, comp.shape[0], C, D, P)
    shard, put = block_sharding(mesh), replicated(mesh)
    out, ok, _total, _certified = step(
        shard(comp).to(torch.int32), shard(comp_len), shard(out_len),
        put(pre[0]).to(torch.int32), put(pre_len[0]))
    # bytes, not words; ok as uint8, which every backend gathers
    out = gather_blocks(mesh, out.to(torch.uint8))
    ok = gather_blocks(mesh, ok.to(torch.uint8))
    results = []
    for i in range(n):
        if ok[i]:
            results.append(out[i, :out_lens[i]].tobytes())
        else:
            host_decodes += 1
            results.append(native.decompress_block_dict(
                blocks[i], dictionary, out_lens[i]))
    return results
