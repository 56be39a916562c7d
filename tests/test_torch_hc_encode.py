"""The port's fast-HC encode slice on the CPU, held byte for byte against
the JAX package's vector encoder: levels 5 (suffix tiers) and 9 (sort
tiers) on 8000-byte blocks, the entry points, and what still raises.

``VectorEncoder(device="cpu")`` runs the kernels' plain PyTorch
versions; its payloads must equal those of
``lz4net_tpu.ops.encode_vector.VectorEncoder`` (the JAX XLA path on the
CPU) exactly, with no block left to the host compressor, and decode to
their sources.  The hash tiers and the full-width block are in
``test_torch_hc_encode_wide.py``.
"""

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # the test workers share the cores: one intra-op
                           # thread each, or they spin against each other

from lz4net_tpu.ops import encode_vector as jev  # noqa: E402
from lz4net_tpu_torch import codec  # noqa: E402
from lz4net_tpu_torch.models import cuda as cuda_engine  # noqa: E402
from lz4net_tpu_torch.models import reference  # noqa: E402
from lz4net_tpu_torch.ops import encode_vector as ev  # noqa: E402

from test_torch_encode import _round_trips, _small_blocks  # noqa: E402


@pytest.fixture(scope="module")
def blocks():
    return _small_blocks()


@pytest.mark.parametrize("level", [5, 9])
def test_hc_levels_match_jax_bytes(blocks, level):
    enc = ev.VectorEncoder(device="cpu")
    got = enc.encode_batch(blocks, hc_level=level)
    assert got == jev.VectorEncoder().encode_batch(blocks, hc_level=level)
    assert enc.host_encodes == 0
    _round_trips(blocks, got)
    fast = ev.VectorEncoder(device="cpu").encode_batch(blocks)
    assert sum(map(len, got)) < sum(map(len, fast))


def test_hc_dst_maxlen_too_small_gives_empty(blocks):
    full = ev.VectorEncoder(device="cpu").encode_batch(blocks, hc_level=5)
    limits = [len(p) - 1 if j % 2 else len(p) for j, p in enumerate(full)]
    got = ev.VectorEncoder(device="cpu").encode_batch(blocks, limits,
                                                      hc_level=5)
    assert got == jev.VectorEncoder().encode_batch(blocks, limits,
                                                   hc_level=5)
    for j, (g, p) in enumerate(zip(got, full)):
        assert g == (b"" if j % 2 and p else p)


def test_hc_entry_points_on_cpu(blocks):
    want9 = ev.VectorEncoder(device="cpu").encode_batch(blocks, hc_level=9)
    assert cuda_engine.compress_blocks_hc_fast(blocks, device="cpu") == want9
    # levels clamp: 0 runs as 1, above 9 as 9
    assert cuda_engine.compress_blocks_hc_fast(blocks[:2], level=12,
                                               device="cpu") == want9[:2]
    assert cuda_engine.compress_blocks_hc_fast(
        blocks[:2], level=0, device="cpu") == ev.VectorEncoder(
        device="cpu").encode_batch(blocks[:2], hc_level=1)
    one = codec.encode_hc(blocks[0], mode="fast", device="cpu")
    assert one == want9[0]
    assert reference.decompress_block(one, len(blocks[0])) == blocks[0]
    assert codec.encode_hc(blocks[0], 100, mode="fast", device="cpu") == b""
    assert codec.encode_hc(b"", mode="fast", device="cpu") == b""
    assert cuda_engine.encoder("cpu").host_encodes == 0


def test_hc_unported_requests_raise():
    """Big blocks and P-mode rows wider than 106,496 positions (ROADMAP
    A7b) no longer raise: fast-HC encodes them on the device and they
    round-trip; strict HC and preset-dictionary HC are ported
    (tests/test_torch_dictionary.py)."""
    enc = ev.VectorEncoder(device="cpu")
    data = b"x" * (96 * 1024 + 1)
    assert reference.decompress_block(
        enc.encode_batch([data], hc_level=9)[0], len(data)) == data
    assert enc.host_encodes == 0
    assert codec.encode_hc(b"abc" * 100, device="cpu") \
        == reference.compress_block_hc(b"abc" * 100)
    window = data = b"abc" * 20000
    assert reference.decompress_block_dict(codec.encode_hc(
        data, dictionary=window, mode="fast", device="cpu"), window,
        len(data)) == data
    with pytest.raises(ValueError, match="mode"):
        codec.encode_hc(b"abc", mode="hc", device="cpu")
    with pytest.raises(ValueError, match="hc_tiers"):
        enc.encode_batch([b"abc" * 100], hc_level=5, hc_tiers="chain")
