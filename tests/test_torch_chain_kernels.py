"""The chain record path's kernels (plain PyTorch versions) held against
the JAX package's Pallas kernels, run in interpret mode on the CPU:
``mark_chain`` and the three gathers ``table_gather``, ``lane_lookup``
and ``diag_gather``.

Inputs are made from a seed with numpy and go through both; every
output is an integer and must be equal (tolerance 0), the gathers'
included on indices outside the table.  ``mark_chain`` marks the exact
orbit, which the JAX kernel does on the encoder's graphs only.

The edge rows of ``corpus.chain_edge_rows`` and ``corpus.gather_edge_rows``
go through the plain versions against a plain walk and the TPU kernel's
formula at several shapes, and through the JAX kernels only at the
shapes the tests above already compile (B = 3, D = 1024; B = 2,
N = 2048, K = 512).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # the test workers share the cores: one intra-op
                           # thread each, or they spin against each other

import jax.numpy as jnp  # noqa: E402

from lz4net_tpu.ops import chain_kernel as jchain  # noqa: E402
from lz4net_tpu.ops import fused_gather as jfg  # noqa: E402
from lz4net_tpu_torch.ops import chain_kernel  # noqa: E402
from lz4net_tpu_torch.ops import fused_gather  # noqa: E402
from lz4net_tpu_torch.utils import corpus  # noqa: E402


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


def _encoder_graphs(rng, D, B):
    """Chain graphs as the encoder builds them (``tests/test_hash_kernel
    .py``): matched positions with lengths of at least 4; a matched
    position steps to the first match at or after its end, any other to
    the first match after it."""
    rows = []
    for _ in range(B):
        matched = rng.random(D) < 0.2
        mlen = rng.integers(4, 40, D)
        nxt = np.full(D + 1, D, np.int64)
        for i in range(D - 1, -1, -1):
            nxt[i] = i if matched[i] else nxt[i + 1]
        g = np.empty(D, np.int64)
        for i in range(D):
            t = i + (mlen[i] if matched[i] else 1)
            g[i] = D if t >= D else (nxt[t] if matched[i] else nxt[i + 1])
        rows.append(np.maximum(g, np.arange(D) + 1).astype(np.int32))
    return np.stack(rows)


def _orbit_np(g, D):
    """The orbit of 0 under each row of g, by a plain walk; a step that
    does not go forward ends it."""
    mark = np.zeros(g.shape, np.int32)
    for b, row in enumerate(g):
        pos = 0
        while pos < D:
            mark[b, pos] = 1
            if row[pos] <= pos:
                break
            pos = int(row[pos])
    return mark


def test_mark_chain_matches_jax_on_encoder_graphs():
    D, B = 1024, 3
    g = _encoder_graphs(np.random.default_rng(11), D, B)
    want = np.asarray(jchain.mark_chain(jnp.asarray(g), D))
    got = chain_kernel.mark_chain(_t(g), D)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(want, _orbit_np(g, D))
    assert 30 < want.sum() < B * D // 2


def test_mark_chain_marks_the_exact_orbit():
    """g[i] = i + 1 visits every position: the JAX kernel's 44 marking
    rounds a segment leave most of each segment unmarked, the port marks
    them all.  Junk rows: steps past D, and a step back that ends the
    walk."""
    D = 1024
    step1 = np.arange(1, D + 1, dtype=np.int32)
    jump = np.arange(D, dtype=np.int32) + 5000
    jump[0] = 7
    back = np.arange(1, D + 1, dtype=np.int32)
    back[300] = 12
    g = np.stack([step1, jump, back])
    got = chain_kernel.mark_chain(_t(g), D).numpy()
    np.testing.assert_array_equal(got, _orbit_np(g, D))
    assert got[0].sum() == D and got[1].sum() == 2 and got[2].sum() == 301
    under = np.asarray(jchain.mark_chain(jnp.asarray(step1[None]), D))
    assert under.sum() < D


def _check_gather(got, want):
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("bits", [(17, 17), (32,), (21,)])
def test_table_gather_matches_jax_on_every_index(bits):
    """Values of every sign and width (a 17-bit table keeps 3 bytes,
    a 32-bit one all 4), indices below 0, inside and at or above N."""
    rng = np.random.default_rng(len(bits) * 100 + bits[0])
    B, N, K = 2, 2048, 512
    tables = [rng.integers(-2**31, 2**31, (B, N), np.int64).astype(np.int32)
              for _ in bits]
    idx = rng.integers(-3 * 128, N + 3 * 128, (B, K)).astype(np.int32)
    idx[:, :4] = [-1, 0, N - 1, N]
    want = jfg.table_gather(tuple(jnp.asarray(t) for t in tables),
                            jnp.asarray(idx), bits)
    got = fused_gather.table_gather([_t(t) for t in tables], _t(idx), bits)
    _check_gather(got, want)
    inside = (idx >= 0) & (idx < N)
    mask = -1 if bits[0] > 24 else (1 << 24) - 1
    np.testing.assert_array_equal(
        got[0].numpy()[inside],
        (np.take_along_axis(tables[0], np.clip(idx, 0, N - 1), 1)
         & mask)[inside])


def test_lane_lookup_matches_jax():
    rng = np.random.default_rng(7)
    t = rng.integers(-2**31, 2**31, (2, 24, 128), np.int64).astype(np.int32)
    idx = rng.integers(-300, 300, (2, 24, 128)).astype(np.int32)
    want = jfg.lane_lookup(jnp.asarray(t), jnp.asarray(idx))
    got = fused_gather.lane_lookup(_t(t), _t(idx))
    assert got.shape == (2, 24, 128)
    _check_gather([got], [want])


def test_diag_gather_matches_jax_out_of_band_too():
    """back_rows 1, w_rows 16: indices in the band, past it on both
    sides, below 0 and at or above N; values and band flags equal
    everywhere (the JAX kernel returns 0 out of the band)."""
    rng = np.random.default_rng(3)
    B, N = 2, 4096
    tbl = rng.integers(-2**31, 2**31, (B, N), np.int64).astype(np.int32)
    q = np.arange(N, dtype=np.int32)[None, :]
    idx = (q + rng.integers(-3 * 128, 18 * 128, (B, N))).astype(np.int32)
    idx[:, :8] = [-1, -200, 0, 5, N, N + 300, -129, 127]
    vals, band = jfg.diag_gather(jnp.asarray(tbl), jnp.asarray(idx), 1, 16)
    got_vals, got_band = fused_gather.diag_gather(_t(tbl), _t(idx), 1, 16)
    _check_gather([got_vals], [vals])
    assert got_band.dtype == torch.bool
    np.testing.assert_array_equal(got_band.numpy(), np.asarray(band))
    band = np.asarray(band)
    assert 0 < band.sum() < band.size and (idx < 0).any() and (idx >= N).any()


def test_gathers_refuse_bad_arguments():
    t = torch.zeros((2, 256), dtype=torch.int32)
    with pytest.raises(ValueError):
        fused_gather.table_gather([t] * 5, t, (8,) * 5)
    with pytest.raises(ValueError):
        fused_gather.table_gather([t], t, (33,))
    with pytest.raises(ValueError):
        fused_gather.table_gather([t[:, :200]], t, (8,))
    with pytest.raises(TypeError):
        fused_gather.table_gather([t.long()], t, (8,))
    with pytest.raises(ValueError):
        fused_gather.lane_lookup(t, t)
    with pytest.raises(ValueError):
        fused_gather.diag_gather(t, t, -1, 4)
    with pytest.raises(TypeError):
        chain_kernel.mark_chain(t.long(), 256)


@pytest.mark.parametrize("D, cut", [(1024, 0), (4096, 0), (4096, 3),
                                    (2048, 1000)])
def test_mark_chain_edge_rows_match_the_walk(D, cut):
    """Every row of ``corpus.chain_edge_rows``, also cut to a width that
    is not a multiple of 32 or 1024 (its steps to the cut positions and
    past them then end the walk)."""
    names, g = corpus.chain_edge_rows(D)
    g = np.ascontiguousarray(g[:, :D - cut])
    got = chain_kernel.mark_chain(_t(g), D - cut).numpy()
    want = _orbit_np(g, D - cut)
    np.testing.assert_array_equal(got, want)
    sums = dict(zip(names, want.sum(1)))
    if not cut:
        assert sums["step_1"] == D and sums["back_at_0"] == 1
        assert sums["on_32"] == D // 32 and sums["short_of_32"] == D // 32 + 1
    assert sums["tile_skips"] > 2 and sums["ends_at_d"] == sums["negative"]


def test_mark_chain_encoder_edge_rows_match_jax():
    names, g = corpus.chain_edge_rows(1024)
    g = g[[names.index(f"encoder_{j}") for j in range(3)]]
    want = np.asarray(jchain.mark_chain(jnp.asarray(g), 1024))
    np.testing.assert_array_equal(
        chain_kernel.mark_chain(_t(g), 1024).numpy(), want)
    np.testing.assert_array_equal(want, _orbit_np(g, 1024))


def _tpu_formula(tables, idx, bits):
    """The TPU kernel's value at each index: row clamp(idx >> 7, 0,
    N / 128 - 1), lane idx & 127, the low ceil(bits / 8) bytes."""
    N = tables[0].shape[1]
    j = np.clip(idx >> 7, 0, N // 128 - 1) * 128 + (idx & 127)
    return [np.take_along_axis(t, j, 1).astype(np.int64)
            & ((1 << 8 * -(-b // 8)) - 1) for t, b in zip(tables, bits)]


@pytest.mark.parametrize("N, K", [(128, 1), (128, 3), (128, 5), (256, 7),
                                  (2048, 513), (18688, 4096)])
@pytest.mark.parametrize("nt", [1, 2, 3, 4])
def test_table_gather_edge_rows_match_the_tpu_formula(N, K, nt):
    tables, idx, bits = corpus.gather_edge_rows(N, K)
    got = fused_gather.table_gather([_t(t) for t in tables[:nt]], _t(idx),
                                    bits[:nt])
    for g, w in zip(got, _tpu_formula(tables[:nt], idx, bits[:nt])):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy().astype(np.int64) & 0xFFFFFFFF,
                                      w & 0xFFFFFFFF)


def test_table_gather_edge_rows_match_jax():
    """At the shapes and widths the test above compiles."""
    tables, idx, _ = corpus.gather_edge_rows(2048, 512)
    tables, idx = [t[:2] for t in tables], idx[:2]
    assert (idx < 0).any() and (idx >= 2048).any()
    for tabs, bits in ((tables[:2], (17, 17)), (tables[1:2], (32,))):
        want = jfg.table_gather(tuple(jnp.asarray(t) for t in tabs),
                                jnp.asarray(idx), bits)
        got = fused_gather.table_gather([_t(t) for t in tabs], _t(idx),
                                        bits)
        _check_gather(got, want)
