"""The port's fast encode slice on the CPU, held byte for byte against the
JAX package's vector encoder.

``VectorEncoder(device="cpu")`` runs the four encode kernels' plain
PyTorch versions; its payloads must equal those of
``lz4net_tpu.ops.encode_vector.VectorEncoder`` (the JAX XLA path on the
CPU, which the JAX tests hold equal to its Pallas kernels) exactly, and
decode to their sources through the port's reference decoder.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # the test workers share the cores: one intra-op
                           # thread each, or they spin against each other

from lz4net_tpu.ops import encode_vector as jev  # noqa: E402
from lz4net_tpu.utils import corpus  # noqa: E402
from lz4net_tpu_torch import codec  # noqa: E402
from lz4net_tpu_torch.models import cuda as cuda_engine  # noqa: E402
from lz4net_tpu_torch.models import reference  # noqa: E402
from lz4net_tpu_torch.ops import encode_vector as ev  # noqa: E402


def _small_blocks():
    """Four 8000-byte blocks of silesia-like data, a run-heavy block, a
    block of random bytes, one under 13 bytes and an empty one."""
    rng = np.random.default_rng(5)
    texts = corpus.silesia_like(4 * 8000, seed=6)
    blocks = [texts[j * 8000:(j + 1) * 8000] for j in range(4)]
    blocks.append(((b"x" * 500 + b"lz4seq" * 120) * 10)[:8000])
    blocks.append(rng.integers(0, 256, 7000, np.uint8).tobytes())
    blocks += [b"hello world!", b""]
    return blocks


def _round_trips(blocks, payloads):
    for b, p in zip(blocks, payloads):
        assert (reference.decompress_block(p, len(b)) if b else p) == b


def test_vector_encoder_matches_jax_bytes():
    blocks = _small_blocks()
    enc = ev.VectorEncoder(device="cpu")
    got = enc.encode_batch(blocks)
    assert got == jev.VectorEncoder().encode_batch(blocks)
    assert enc.host_encodes == 0
    _round_trips(blocks, got)
    assert len(got[0]) < 0.8 * len(blocks[0])    # it does compress


def test_full_width_block_matches_jax_bytes():
    """A 64 KB silesia block and a short one: the main path's shapes."""
    data = corpus.silesia_like(1 << 17, seed=0)
    blocks = [data[:1 << 16], data[1 << 16:(1 << 16) + 3000]]
    assert ev.batch_shapes(1 << 16) == (73728, 81920, 18688)
    enc = ev.VectorEncoder(device="cpu")
    got = enc.encode_batch(blocks)
    assert got == jev.VectorEncoder().encode_batch(blocks)
    assert enc.host_encodes == 0
    _round_trips(blocks, got)


def test_dst_maxlen_too_small_gives_empty():
    blocks = _small_blocks()
    full = ev.VectorEncoder(device="cpu").encode_batch(blocks)
    limits = [len(p) - 1 if j % 2 else len(p) for j, p in enumerate(full)]
    got = ev.VectorEncoder(device="cpu").encode_batch(blocks, limits)
    assert got == jev.VectorEncoder().encode_batch(blocks, limits)
    for j, (g, p) in enumerate(zip(got, full)):
        assert g == (b"" if j % 2 and p else p)


def test_entry_points_on_cpu():
    data = corpus.silesia_like(20000, seed=8)
    blocks = [data[:12000], data[12000:]]
    want = ev.VectorEncoder(device="cpu").encode_batch(blocks)
    assert cuda_engine.compress_blocks_fast(blocks, device="cpu") == want
    assert codec.encode(blocks[0], mode="fast", device="cpu") == want[0]
    assert codec.encode(blocks[0], 10, mode="fast", device="cpu") == b""
    assert codec.encode(b"", mode="fast", device="cpu") == b""
    assert cuda_engine.encoder("cpu").host_encodes == 0


def test_unported_requests_raise():
    """Big blocks and P-mode rows wider than 106,496 positions (ROADMAP
    A7b) no longer raise: they encode on the device and round-trip;
    only a bad mode raises.  Preset-dictionary encode is held against
    JAX in tests/test_torch_dictionary.py, big blocks in
    tests/test_torch_bigblock.py."""
    enc = ev.VectorEncoder(device="cpu")
    data = b"x" * (96 * 1024 + 1)
    assert reference.decompress_block(enc.encode_batch([data])[0],
                                      len(data)) == data
    window = b"abc" * 20000
    data = b"abc" * 20000
    for packed in (enc.encode_batch([data], dictionary=window)[0],
                   codec.encode(data, dictionary=window, mode="fast",
                                device="cpu")):
        assert reference.decompress_block_dict(packed, window,
                                               len(data)) == data
    assert enc.host_encodes == 0
    with pytest.raises(ValueError, match="mode"):
        codec.encode(b"abc", mode="hc", device="cpu")
