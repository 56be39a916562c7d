"""The port's decode slice on the CPU (plain PyTorch versions of the four
kernels), held against the JAX package and the oracles.

* ``resolve_wavefront`` against a sequential numpy resolver of the same
  state words, on random words and on ``corpus.resolve_edge_rows``;
* ``decode_batch_vectorized`` against the JAX package's XLA branch
  (``decode_batch_vectorized(..., fused=False)``): out, total_out, ok,
  strict, consumed and needed equal, tolerance 0, with the decoded
  lengths and, for the unknown-length path, with caps as ``out_len``;
* ``VectorDecoder.decode_batch_unknown`` against the hardened decoders
  of both packages, and with caps over 96 KB on the device (blocks
  that decode to more as big blocks);
* ``VectorDecoder`` and the codec against the native oracle.
"""

import random
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # the test workers share the cores: one intra-op
                           # thread each, or they spin against each other

import jax.numpy as jnp  # noqa: E402

from lz4net_tpu.models import native  # noqa: E402
from lz4net_tpu.models import reference as jref  # noqa: E402
from lz4net_tpu.ops import decode_vector as jdv  # noqa: E402
from lz4net_tpu_torch import codec  # noqa: E402
from lz4net_tpu_torch.models import cuda as cuda_engine  # noqa: E402
from lz4net_tpu_torch.models import reference  # noqa: E402
from lz4net_tpu_torch.ops import decode_vector as dv  # noqa: E402
from lz4net_tpu_torch.ops import resolve_kernel  # noqa: E402
from lz4net_tpu_torch.utils import corpus  # noqa: E402

CASES = {
    "text": (b"the quick brown fox jumps over the lazy dog. " * 100)[:3000],
    "rle1": b"\x01" * 5000,
    "period7": b"abcdefg" * 700,
    "incompressible": bytes(map(random.Random(4).randrange, [256] * 2500)),
    "tiny": b"x" * 13,
    "lit15": b"A" * 15,
    "lit270": b"A" * 270 + b"XYZWV",
    "token0": (b"ab" * 40 + b"Q") * 300,
}
VFLAG = 1 << 19
CH = 8192


def _oracle(block, n):
    if native.is_available():
        return native.decompress_block(block, n)
    return reference.decompress_block(block, n)


def _sequential_resolve(t0, start_chunk):
    out = np.zeros_like(t0)
    for b in range(t0.shape[0]):
        for o in range(t0.shape[1]):
            t = int(t0[b, o])
            if o < start_chunk * CH or t >= VFLAG:
                out[b, o] = t & 0xFF
            else:
                out[b, o] = out[b, t]
    return out


def _states(rng, B, Dt, start_chunk):
    """Random state words: terminals, pointers to any earlier position,
    and runs of o-1 pointers that nest deeper than 2^12."""
    t0 = np.empty((B, Dt), np.int64)
    for b in range(B):
        for o in range(Dt):
            r = rng.random()
            if o < max(1, start_chunk * CH) or r < 0.2:
                t0[b, o] = VFLAG | int(rng.integers(0, 256))
            elif r < 0.5:
                t0[b, o] = int(rng.integers(0, o))
            else:
                t0[b, o] = o - 1
        lo = start_chunk * CH + 100
        t0[b, lo:lo + 6000] = np.arange(lo - 1, lo + 5999)   # deep chain
    return t0.astype(np.int32)


@pytest.mark.parametrize("start_chunk", [0, 1])
def test_resolve_wavefront_matches_sequential(start_chunk):
    rng = np.random.default_rng(11 + start_chunk)
    t0 = _states(rng, 2, 3 * CH, start_chunk)
    out, ok = resolve_kernel.resolve_wavefront(torch.from_numpy(t0),
                                               start_chunk)
    assert ok.all()
    np.testing.assert_array_equal(out.numpy(),
                                  _sequential_resolve(t0, start_chunk))


@pytest.mark.parametrize("start_chunk", [0, 1, 2])
def test_resolve_wavefront_edge_rows_match_sequential(start_chunk):
    """``corpus.resolve_edge_rows``' in-domain rows (chains through every
    chunk, pointers to lo - 1, to 0 and into the prefix, chunks with no
    terminal) through the plain version, held against the sequential
    walk; their ``ok`` is True."""
    names, t0 = corpus.resolve_edge_rows(3 * CH)
    t0 = t0[[not n.startswith("junk") for n in names]]
    out, ok = resolve_kernel.resolve_wavefront(torch.from_numpy(t0),
                                               start_chunk)
    assert ok.all()
    np.testing.assert_array_equal(out.numpy(),
                                  _sequential_resolve(t0, start_chunk))


@pytest.fixture(scope="module")
def slice_batch():
    """The decode slice's batch (the cases, two 16 KB silesia blocks and
    a truncated block) and the JAX XLA branch's outputs for it, with the
    decoded lengths and with caps as ``out_len`` (the unknown-length
    path's pass): one compile, as ``out_len`` is traced."""
    sil = corpus.split_blocks(corpus.silesia_like(1 << 20, seed=5), 16384)
    datas = list(CASES.values()) + [sil[3], sil[40]]
    packed = [reference.compress_block(d) for d in datas]
    packed.append(packed[0][:len(packed[0]) // 2])        # truncated
    datas.append(datas[0])
    comp, comp_len, out_len, C, D = dv.pack_blocks(
        packed, [len(d) for d in datas])
    # caps: exact, above (up to D - 1, so D stays), and one byte short
    caps = np.array([(n, D - 1, n - 1)[j % 3] for j, n in enumerate(out_len)],
                    np.int32)
    S_cap = -(-(C // 3 + 2) // 128) * 128

    def jax_pass(lens):
        return [np.asarray(w) for w in jdv.decode_batch_vectorized(
            jnp.asarray(comp.astype(np.int32)), jnp.asarray(comp_len),
            jnp.asarray(lens), C, D, S_cap, 2 * S_cap, 8192, fused=False)]

    return dict(datas=datas, packed=packed, comp=comp, comp_len=comp_len,
                out_len=out_len, caps=caps, C=C, D=D,
                want=jax_pass(out_len), want_caps=jax_pass(caps))


def test_decode_slice_matches_jax_xla_branch(slice_batch):
    b = slice_batch
    want = b["want"]
    got = dv.decode_batch_vectorized(
        *dv.batch_from_numpy(b["comp"], b["comp_len"], b["out_len"], "cpu"),
        b["C"], b["D"])
    for name, w, g in zip(("out", "total_out", "ok", "strict", "consumed",
                           "needed"), want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), name)
    strict = got[3].numpy()
    assert strict[:-1].all() and not strict[-1]


def test_unknown_length_certificate_matches_jax_xla_branch(slice_batch):
    """With caps as ``out_len``, ``needed``, ``strict`` and the rest of
    the certificate equal the JAX XLA branch's; ``needed`` is the decoded
    length wherever the block is whole."""
    b = slice_batch
    got = dv.decode_batch_vectorized(
        *dv.batch_from_numpy(b["comp"], b["comp_len"], b["caps"], "cpu"),
        b["C"], b["D"])
    for name, w, g in zip(("total_out", "ok", "strict", "consumed",
                           "needed"), b["want_caps"][1:], got[1:]):
        np.testing.assert_array_equal(g.numpy(), w, name)
    needed = got[5].numpy()
    np.testing.assert_array_equal(needed[:-1], b["out_len"][:-1])
    assert got[3].numpy()[:-1].all() and not got[3].numpy()[-1]


def test_decode_batch_unknown_matches_the_hardened_decoders(slice_batch):
    """``VectorDecoder.decode_batch_unknown`` returns the port's
    ``reference.decompress_block_unknown`` bytes (the JAX package's too)
    or raises as it does; the device serves every whole block within its
    cap, the host every other."""
    b = slice_batch
    blocks, caps = b["packed"], [int(c) for c in b["caps"]]
    dec = dv.VectorDecoder("cpu")
    whole = [j for j in range(len(blocks) - 1)
             if caps[j] >= len(b["datas"][j])]
    got = dec.decode_batch_unknown([blocks[j] for j in whole],
                                   [caps[j] for j in whole])
    assert got == [b["datas"][j] for j in whole]
    assert dec.host_decodes == 0
    for j, (blk, cap) in enumerate(zip(blocks, caps)):
        try:
            want = jref.decompress_block_unknown(blk, cap)
        except jref.CorruptedBlockError as exc:
            msg = re.escape(str(exc))
            with pytest.raises(reference.CorruptedBlockError, match=msg):
                reference.decompress_block_unknown(blk, cap)
            with pytest.raises(reference.CorruptedBlockError, match=msg):
                dec.decode_batch_unknown([blk], [cap])
        else:
            assert reference.decompress_block_unknown(blk, cap) == want
            assert dec.decode_batch_unknown([blk], [cap]) == [want]
    assert dec.host_decodes == len(blocks) - len(whole)


def test_decode_batch_unknown_keeps_caps_over_96_kb_on_the_device(
        slice_batch):
    """A cap above 96 KB cuts the device pass's output length to 96 KB
    and changes nothing else: every whole block decodes on the device,
    through ``codec.decode(max_output_length=)`` too.  A block whose
    parse implies more than 96 KB under such a cap, or one compressed to
    more, is walked for its decoded length and decodes as a big block on
    the device (fragment waves); one whose fragments the device and the
    host's fragment decoder both refuse raises the reference's error, as
    does such a block under a cap of 96 KB (the host's)."""
    b = slice_batch
    blocks, datas = b["packed"][:-1], b["datas"][:-1]
    big_cap, MAX = 1 << 20, dv.VectorDecoder.MAX_BLOCK
    dec = dv.VectorDecoder("cpu")
    assert dec.decode_batch_unknown(blocks, [big_cap] * len(blocks)) \
        == datas
    assert dec.host_decodes == 0
    facade = cuda_engine.decoder("cpu")
    before = facade.host_decodes
    assert codec.decode(blocks[-1], max_output_length=big_cap,
                        device="cpu") == datas[-1]
    assert facade.host_decodes == before
    big = reference.compress_block(bytes(128 * 1024))
    assert dec.decode_batch_unknown([blocks[0], big], [big_cap] * 2) \
        == [datas[0], bytes(128 * 1024)]
    assert dec.host_decodes == 0
    # zeros: 32,768 sequences of offset 0 and a final empty run
    junk = bytes(MAX + 1)
    for blk, cap in ((big, MAX), (junk, big_cap)):
        with pytest.raises(jref.CorruptedBlockError) as want:
            jref.decompress_block_unknown(blk, cap)
        with pytest.raises(reference.CorruptedBlockError,
                           match=re.escape(str(want.value))):
            dec.decode_batch_unknown([blk], [cap])
    assert dec.host_decodes == 2


def test_vector_decoder_matches_native_oracle():
    datas = list(CASES.values()) + corpus.split_blocks(
        corpus.silesia_like(1 << 18, seed=2), 1 << 16)
    packed = [reference.compress_block(d) for d in datas]
    dec = dv.VectorDecoder(device="cpu")
    got = dec.decode_batch(packed, [len(d) for d in datas])
    assert got == [_oracle(p, len(d)) for p, d in zip(packed, datas)]
    assert got == datas
    assert dec.host_decodes == 0


def test_vector_decoder_rejects_truncation():
    data = CASES["text"]
    packed = reference.compress_block(data)
    dec = dv.VectorDecoder(device="cpu")
    with pytest.raises(reference.CorruptedBlockError):
        dec.decode_batch([packed[:len(packed) // 2]], [len(data)])
    assert dec.host_decodes == 1


def test_vector_decoder_refuses_blocks_over_96k():
    """A block over 96 KB is no longer refused: it decodes as fragment
    waves on the device, to the oracle's bytes."""
    data = corpus.silesia_like(100 * 1024, seed=1)
    packed = reference.compress_block(data)
    dec = dv.VectorDecoder(device="cpu")
    assert dec.decode_batch([packed], [len(data)]) \
        == [_oracle(packed, len(data))] == [data]
    assert dec.host_decodes == 0


def test_codec_decode_batch_on_cpu():
    datas = [CASES["text"], b"", CASES["token0"], CASES["tiny"]]
    packed = [reference.compress_block(d) if d else b"" for d in datas]
    assert codec.decode_batch(packed, [len(d) for d in datas],
                              device="cpu") == datas
    assert codec.decode(packed[2], len(datas[2]), device="cpu") == datas[2]
