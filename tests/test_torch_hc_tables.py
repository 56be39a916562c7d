"""The fast-HC encoder's pieces (plain PyTorch versions) held against the
JAX package's functions on the CPU.

Same inputs, made from a seed, go through both; every output is an
integer and must be equal (tolerance 0).  The HC tables are also held
against the NumPy replay of ``tests/test_hc_tables.py``; the JAX side's
``hc_tables`` runs its XLA scan on the CPU.  ``match_lengths`` at 24
dominant offsets and ``sequence_records`` at 8 catch-up rounds are in
``test_torch_hc_kernels.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # the test workers share the cores: one intra-op
                           # thread each, or they spin against each other

import jax.numpy as jnp  # noqa: E402

from lz4net_tpu.ops import encode_vector as jev  # noqa: E402
from lz4net_tpu.ops import hash_kernel as jhash  # noqa: E402
from lz4net_tpu.utils import corpus  # noqa: E402
from lz4net_tpu_torch.ops import encode_vector as ev  # noqa: E402
from lz4net_tpu_torch.ops import hash_kernel  # noqa: E402
from lz4net_tpu_torch.utils import corpus as corpus_t  # noqa: E402


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


def _j(t):
    return jnp.asarray(t.numpy())


def _eq(got, want, name=""):
    np.testing.assert_array_equal(got.numpy(), np.asarray(want), name)


def _periodic(n, rng):
    """Runs of a random 3-40-byte pattern at 30 periods each, with short
    random gaps: more than 8 frequent far offsets."""
    out = bytearray()
    periods = rng.permutation(np.arange(5, 300))[:30]
    while len(out) < n:
        for p in periods:
            pat = rng.integers(0, 256, int(p), np.uint8).tobytes()
            out += pat * (1 + 120 // int(p)) + rng.integers(
                0, 256, 3, np.uint8).tobytes()
    return bytes(out[:n])


def _rows(D, seed):
    """Three blocks: silesia-like text, periodic data, and long runs of
    bytes >= 0x80 (u32 words with the sign bit) among random bytes."""
    rng = np.random.default_rng(seed)
    text = corpus.silesia_like(D - 192, seed=seed)
    per = _periodic(D - 100, rng)
    runs = bytearray(rng.integers(0, 256, D - 7, np.uint8).tobytes())
    for k, at in enumerate(range(100, D - 600, 700)):
        runs[at:at + 20 + 37 * k % 400] = bytes([0x80 + k % 3]) * (
            20 + 37 * k % 400)
    blocks = [text, per, bytes(runs[:D - 7])]
    x = np.zeros((3, D), np.int32)
    for j, b in enumerate(blocks):
        x[j, :len(b)] = np.frombuffer(b, np.uint8)
    return x, np.array([len(b) for b in blocks], np.int32)


def _words(x):
    u32 = ev._u32(_t(x))
    return u32, ev._shift_left(u32, 4)


def _wide(u32, us4):
    return (u32, us4) + tuple(ev._shift_left(u32, 4 * k)
                              for k in range(2, 8))


# ---- hc_tables -------------------------------------------------------------

def _replay(wa, hs, sticky, nrows, chunk=512, lane=128):
    """The NumPy replay of tests/test_hc_tables.py: every table probed
    with its state as of the chunk start, then the count-guarded
    update (sticky tables keep a committed entry)."""
    n = len(wa)
    tabs = [np.zeros(r * lane, np.int64) for r in nrows]
    words = [np.zeros(r * lane, np.int64) for r in nrows]
    cands = [np.full(n, -1, np.int32) for _ in hs]
    for cs in range(0, n, chunk):
        for t, h in enumerate(hs):
            for i in range(cs, cs + chunk):
                if tabs[t][h[i]] > 0 and words[t][h[i]] == wa[i]:
                    cands[t][i] = tabs[t][h[i]] - 1
            cnt = np.bincount(h[cs:cs + chunk], minlength=nrows[t] * lane)
            for i in range(cs, cs + chunk):
                if cnt[h[i]] == 1 and (not sticky[t] or tabs[t][h[i]] == 0):
                    tabs[t][h[i]] = i + 1
                    words[t][h[i]] = wa[i]
    return cands


@pytest.mark.parametrize("D", [2048, 8192])
def test_hc_tables_match_jax_and_replay(D):
    """A wide-prefix table, a sticky table and the three run tables, whose
    catch-all bucket 1023 takes the writes of every non-run position."""
    rng = np.random.default_rng(D)
    x = rng.integers(0, 7, size=(2, D)).astype(np.int32)
    for lo, hi in ((500, 700), (1500, 1580), (1700, 1790)):
        x[:, lo:hi] = 3                    # runs for every minimum tier
    x[1, 900:1400] = 200
    u32, us4 = _words(x)
    run_fwd, is_rs = ev._byte_runs(_t(x))
    dump = hash_kernel.RUN_ROWS * hash_kernel.LANE - 1
    hs = [hash_kernel.hash_fold((u32, us4, u32), hash_kernel.MIX12),
          hash_kernel.hash_bucket8(u32, us4)]
    hs += [torch.where(is_rs & (run_fwd >= mr), _t(x) + 256 * k, dump)
           for k, mr in enumerate((4, 16, 64))]
    sticky = (False, True, False, False, False)
    nrows = (hash_kernel.NBROWS, hash_kernel.NBROWS) + (
        hash_kernel.RUN_ROWS,) * 3
    got = hash_kernel.hc_tables(u32, hs, sticky, nrows, D)
    want = jhash.hc_tables(_j(u32), tuple(_j(h) for h in hs), sticky,
                           nrows, D)
    wa = u32.numpy().astype(np.int64)
    for t in range(len(hs)):
        _eq(got[t], want[t], f"table {t}")
        assert (got[t] >= 0).any(), t
    for b in range(2):
        replay = _replay(wa[b], [h[b].numpy() for h in hs], sticky, nrows)
        for t in range(len(hs)):
            np.testing.assert_array_equal(got[t][b].numpy(), replay[t])
    # a sticky table keeps its first entry: its hits are never nearer
    assert ((got[1] < 0) | (got[0] < 0) | (got[1] <= got[0])).all()


def test_hc_tables_edge_rows_match_jax_and_replay():
    """``corpus.hc_edge_rows``: buckets hit once, twice and 512 times a
    chunk, sticky early entries, the catch-all, 128- and 8192-bucket
    tables and ids outside [0, nb).  All eight tables against JAX (its
    XLA scan clamps the ids as the plain version does); the sets of 1, 3,
    7 and 8 tables against the replay, on clamped ids."""
    D = 2048
    wa, hs, sticky, nrows = corpus_t.hc_edge_rows(D)
    wa_t, hs_t = _t(wa), [_t(h) for h in hs]
    got = hash_kernel.hc_tables(wa_t, hs_t, sticky, nrows, D)
    want = jhash.hc_tables(_j(wa_t), tuple(_j(h) for h in hs_t),
                           tuple(sticky), tuple(nrows), D)
    for t in range(len(hs)):
        _eq(got[t], want[t], f"table {t}")
        assert (got[t] >= 0).any(), t
    for nt in (1, 3, 7, 8):
        sub = hash_kernel.hc_tables(wa_t, hs_t[:nt], sticky[:nt],
                                    nrows[:nt], D)
        for b in range(wa.shape[0]):
            clamped = [np.clip(h[b], 0, r * 128 - 1)
                       for h, r in zip(hs[:nt], nrows[:nt])]
            replay = _replay(wa[b].astype(np.int64), clamped, sticky[:nt],
                             nrows[:nt])
            for t in range(nt):
                np.testing.assert_array_equal(sub[t][b].numpy(), replay[t])


def test_hash_fold_wraps_like_jax():
    x, _ = _rows(2048, 3)
    u32, us4 = _words(x)
    ws = _wide(u32, us4)
    assert (u32 < 0).any()
    for keys, mix in ((ws[:3], hash_kernel.MIX12), (ws[:4], hash_kernel.MIX16),
                      (ws, hash_kernel.MIX32)):
        got = hash_kernel.hash_fold(keys, mix)
        _eq(got, jhash.hash_fold(tuple(_j(k) for k in keys), mix))
        assert int(got.min()) >= 0 and int(got.max()) < hash_kernel.NB


@pytest.mark.parametrize("tables", [None, "runs"])
def test_hc_candidates_match_jax(tables):
    D = 8192
    x, _ = _rows(D, 4)
    u32, us4 = _words(x)
    run_fwd, is_rs = ev._byte_runs(_t(x))
    deep, first, runs = hash_kernel.hc_candidates(_t(x), u32, us4, is_rs,
                                                  run_fwd, D, tables)
    jd, jf, jr = jhash.hc_candidates(jnp.asarray(x), _j(u32), _j(us4),
                                     _j(is_rs), _j(run_fwd), D, tables)
    _eq(deep, jd, "deep")
    _eq(first, jf, "first")
    for k in range(3):
        _eq(runs[k], jr[k], f"run tier {k}")
    assert (runs[0] >= 0).any()
    assert (deep >= 0).any() == (tables is None)


# ---- the sort tiers --------------------------------------------------------

def test_byte_runs_match_jax_formula():
    x, _ = _rows(2048, 5)
    run_fwd, is_rs = ev._byte_runs(_t(x))
    jx = jnp.asarray(x)
    eq_next = jnp.concatenate([jx[:, :-1] == jx[:, 1:],
                               jnp.zeros((3, 1), bool)], axis=1)
    want = 1 + jev._run_lengths(eq_next)
    _eq(run_fwd, want)
    prev_byte = jnp.concatenate([jnp.full((3, 1), -1, jnp.int32),
                                 jx[:, :-1]], axis=1)
    _eq(is_rs, (want >= 4) & (jx != prev_byte))
    assert int(run_fwd.max()) >= 64


@pytest.mark.parametrize("nkeys", [1, 2, 3, 8])
def test_prev_and_first_occurrence_match_jax(nkeys):
    """Signed order matters only for the neighbours, but the groups must
    come out the same, with words >= 0x80000000 among them."""
    x, _ = _rows(2048, 6)
    u32, us4 = _words(x)
    keys = _wide(u32, us4)[:nkeys]
    jkeys = tuple(_j(k) for k in keys)
    prev = ev._prev_occurrence(keys)
    _eq(prev, jev._prev_occurrence(jkeys), "prev")
    _eq(ev._first_occurrence(keys), jev._first_occurrence(jkeys), "first")
    assert (prev >= 0).any() and (prev < 0).any()


def test_sort_order_is_signed_lexicographic():
    keys = (_t(np.array([[5, -1, 5, -2, 5, -1]], np.int32)),
            _t(np.array([[-7, 3, 2, 9, -7, -(2**31)]], np.int32)))
    order = ev._sort_order(keys)
    assert order.tolist() == [[3, 5, 1, 0, 4, 2]]


@pytest.mark.parametrize("D", [2048, 8192])
def test_suffix_candidates_match_jax(D):
    x, _ = _rows(D, 7)
    u32, us4 = _words(x)
    ws = _wide(u32, us4)
    cand, lcp4 = ev._suffix_candidates(ws)
    jc, jl = jev._suffix_candidates(tuple(_j(w) for w in ws))
    _eq(cand, jc, "cand")
    _eq(lcp4, jl, "lcp4")
    assert int(lcp4.max()) == 8 and (cand < 0).any()


def test_chain_hop_keeps_missing_candidates():
    """p[p[i]]; a -1 must not come back as p[0] through the gather (p[0]
    is set here to show it)."""
    p = _t(np.array([[2, 0, -1, 1, 3, -1]], np.int32))
    assert ev._chain_hop(p).tolist() == [[-1, 2, -1, 0, 1, -1]]
