"""The port's fast-HC encode slice on the CPU, held byte for byte against
the JAX package's vector encoder: the hash tiers at level 5, and a
full-width 64 KB block with a short one at level 5 (the main path's
shapes).  The JAX side selects the hash tiers with its
``LZ4NET_HC_TIERS`` variable, the port with ``hc_tiers``.
"""

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # the test workers share the cores: one intra-op
                           # thread each, or they spin against each other

from lz4net_tpu.ops import encode_vector as jev  # noqa: E402
from lz4net_tpu.utils import corpus  # noqa: E402
from lz4net_tpu_torch.ops import encode_vector as ev  # noqa: E402
from lz4net_tpu_torch.ops import hash_kernel  # noqa: E402

from test_torch_encode import _round_trips, _small_blocks  # noqa: E402


def test_hash_tiers_match_jax_bytes(monkeypatch):
    blocks = _small_blocks()
    enc = ev.VectorEncoder(device="cpu")
    got = enc.encode_batch(blocks, hc_level=5, hc_tiers="hash")
    monkeypatch.setenv("LZ4NET_HC_TIERS", "hash")
    assert got == jev.VectorEncoder().encode_batch(blocks, hc_level=5)
    assert enc.host_encodes == 0
    _round_trips(blocks, got)
    assert got != ev.VectorEncoder(device="cpu").encode_batch(blocks,
                                                              hc_level=5)


def test_full_width_block_at_level_5_matches_jax_bytes():
    data = corpus.silesia_like(1 << 17, seed=0)
    blocks = [data[:1 << 16], data[1 << 16:(1 << 16) + 3000]]
    D, _, _ = ev.batch_shapes(1 << 16)
    assert ev.hc_rcap(5, D) == 9216 and ev.hc_rcap(9, D) == 18432
    enc = ev.VectorEncoder(device="cpu")
    got = enc.encode_batch(blocks, hc_level=5)
    assert got == jev.VectorEncoder().encode_batch(blocks, hc_level=5)
    assert enc.host_encodes == 0
    _round_trips(blocks, got)
    fast = ev.VectorEncoder(device="cpu").encode_batch(blocks)
    assert len(got[0]) < len(fast[0])
    assert hash_kernel.hc_launches == 0          # the CPU runs no kernel
