"""Port kernels 1-3 (plain PyTorch versions) held bit-exactly against the
JAX package's Pallas kernels, run in interpret mode on the CPU.

Integer outputs, tolerance 0.  The JAX kernels fetch through bounded
windows and flag a miss where a window did not reach; the port reads
exactly, so rows are compared where the JAX kernel reported no miss.
"""

import random

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # the test workers share the cores: one intra-op
                           # thread each, or they spin against each other

import jax.numpy as jnp  # noqa: E402

from lz4net_tpu.ops import fused_gather as jfg  # noqa: E402
from lz4net_tpu.ops import parse_kernel as jpk  # noqa: E402
from lz4net_tpu.ops import records_kernel as jrk  # noqa: E402
from lz4net_tpu_torch.models import reference  # noqa: E402
from lz4net_tpu_torch.ops import decode_vector as dv  # noqa: E402
from lz4net_tpu_torch.ops import fused_gather  # noqa: E402
from lz4net_tpu_torch.ops import parse_kernel  # noqa: E402
from lz4net_tpu_torch.ops import records_kernel  # noqa: E402
from lz4net_tpu_torch.utils import corpus  # noqa: E402

C = 4096


@pytest.fixture(scope="module")
def batch():
    """Four well-formed blocks (C = 4096) and one block of seeded random
    bytes that is not LZ4 at all (the junk-safe clipping paths)."""
    datas = [
        (b"the quick brown fox jumps over the lazy dog. " * 100)[:3000],
        b"\x01" * 5000,                               # long match extension
        bytes(map(random.Random(4).randrange, [256] * 2500)),
        corpus.silesia_like(1 << 16, seed=3)[9000:12000],
    ]
    packed = [reference.compress_block(d) for d in datas]
    junk = np.random.default_rng(7).integers(0, 256, 4000, np.uint8)
    packed.append(junk.tobytes())
    comp, comp_len, out_len, c, d = dv.pack_blocks(
        packed, [len(x) for x in datas] + [6000])
    assert c == C
    return comp, comp_len, out_len, d


@pytest.fixture(scope="module")
def jax_parse(batch):
    comp, comp_len, _, _ = batch
    outs = jpk.parse_tokens(jnp.asarray(comp.astype(np.int32)),
                            jnp.asarray(comp_len), C)
    return [np.asarray(x) for x in outs]


def test_parse_tokens_matches_jax_interpret(batch, jax_parse):
    comp, comp_len, _, _ = batch
    jmark, jll, jml, jmiss = jax_parse
    assert not jmiss[:4].any()
    mark, ll, ml, miss = parse_kernel.parse_tokens(
        torch.from_numpy(comp.astype(np.int32)),
        torch.from_numpy(comp_len), C)
    assert not miss.any()
    rows = ~jmiss
    np.testing.assert_array_equal(mark.numpy()[rows], jmark[rows])
    sel = (jmark == 1) & rows[:, None]
    assert sel[:4].sum() > 100
    np.testing.assert_array_equal(ll.numpy()[sel], jll[sel])
    np.testing.assert_array_equal(ml.numpy()[sel], jml[sel])


@pytest.fixture(scope="module")
def both_records(batch, jax_parse):
    """records_to_state of both packages, fed the same JAX parse."""
    comp, comp_len, out_len, Dt = batch
    jmark, jll, jml, _ = jax_parse
    B = comp.shape[0]
    jout = jrk.records_to_state(
        jnp.asarray(comp.astype(np.int32)), jnp.asarray(jmark),
        jnp.asarray(jll), jnp.asarray(jml), jnp.asarray(comp_len),
        jnp.asarray(out_len), jnp.zeros(B, jnp.int32), C, Dt, 0)
    tout = records_kernel.records_to_state(
        torch.from_numpy(comp.astype(np.int32)),
        torch.from_numpy(jmark.copy()), torch.from_numpy(jll.copy()),
        torch.from_numpy(jml.copy()), torch.from_numpy(comp_len),
        torch.from_numpy(out_len), torch.zeros(B, dtype=torch.int32),
        C, Dt, 0)
    return [np.asarray(x) for x in jout], [x.numpy() for x in tout]


def test_records_to_state_matches_jax_interpret(jax_parse, both_records):
    (jt0m, jcidx, jstats), (t0m, cidx, stats) = both_records
    rows = ~jax_parse[3] & (jstats[:, 5] == 0)
    assert rows[:4].all()
    np.testing.assert_array_equal(t0m[rows], jt0m[rows])
    np.testing.assert_array_equal(cidx[rows], jcidx[rows])
    np.testing.assert_array_equal(stats[rows, :5], jstats[rows, :5])
    np.testing.assert_array_equal(stats[:, 5:], 0)
    # the well-formed rows certify: strict, and total == needed == out_len
    assert stats[:4, 2].all()


def test_rowbase_gather_matches_jax_interpret(batch, both_records):
    comp = batch[0].astype(np.int32)
    (_, jcidx, _), _ = both_records
    lit_idx = np.maximum.accumulate(
        np.where(jcidx >= 0, np.clip(jcidx, 0, C - 1), 0), axis=1
    ).astype(np.int32)
    (jvals,), jband = jfg.rowbase_gather(
        (jnp.asarray(comp),), jnp.asarray(lit_idx), 8, (8,))
    jvals, jband = np.asarray(jvals), np.asarray(jband)
    assert jband.mean() > 0.9
    vals, band = fused_gather.rowbase_gather(
        torch.from_numpy(comp), torch.from_numpy(lit_idx))
    assert band.all()
    np.testing.assert_array_equal(vals.numpy()[jband], jvals[jband])


def test_rowbase_gather_flags_out_of_range_indices():
    table = torch.arange(256, dtype=torch.int32).reshape(2, 128)
    idx = torch.tensor([[0, 127, 128, -1], [5, 64, 200, 3]],
                       dtype=torch.int32)
    vals, band = fused_gather.rowbase_gather(table, idx)
    assert vals.tolist() == [[0, 127, 127, 0], [133, 192, 255, 131]]
    assert band.tolist() == [[True, True, False, False],
                             [True, True, False, True]]
