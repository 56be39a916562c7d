"""The fast encoder's four kernels (plain PyTorch versions) held against
the JAX package's functions on the CPU.

Same inputs, made from a seed, go through both; every output is an
integer and must be equal (tolerance 0).  The JAX side runs its Pallas
kernels in interpret mode where it has one, and its XLA formulation
(``_bucket_prev_scan``, ``_match_lengths``) beside it.  ``emit_bytes``
is compared on the rows where the JAX kernel reported no window miss;
the port's search cannot miss.  ``sequence_records`` is also held against
the JAX kernel on three rows of ``corpus.seq_edge_rows`` (a match past D,
matches that skip segments and tiles, catch-up over whole literal runs),
at the shapes of the first comparison, so its compile serves both;
``emit_bytes`` likewise on ``corpus.emit_edge_rows`` (every literal and
match length at the edges of the length extensions, records longer than
the kernel's 4096-byte tiles, one-byte records, dead records, out_len
inside a record), made at the B, S and O of the ``stages`` rows.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # the test workers share the cores: one intra-op
                           # thread each, or they spin against each other

import jax.numpy as jnp  # noqa: E402

from lz4net_tpu.ops import emit_kernel as jemit  # noqa: E402
from lz4net_tpu.ops import encode_vector as jev  # noqa: E402
from lz4net_tpu.ops import hash_kernel as jhash  # noqa: E402
from lz4net_tpu.ops import mlen_kernel as jmlen  # noqa: E402
from lz4net_tpu.ops import seq_kernel as jseq  # noqa: E402
from lz4net_tpu.utils import corpus  # noqa: E402
from lz4net_tpu_torch.utils import corpus as tcorpus  # noqa: E402
from lz4net_tpu_torch.ops import emit_kernel  # noqa: E402
from lz4net_tpu_torch.ops import encode_vector as ev  # noqa: E402
from lz4net_tpu_torch.ops import hash_kernel  # noqa: E402
from lz4net_tpu_torch.ops import mlen_kernel  # noqa: E402
from lz4net_tpu_torch.ops import seq_kernel  # noqa: E402

D = 8192


def _rows(D, seed):
    """Three blocks of D - 192 bytes at most: silesia-like text, random
    bytes, and runs of a few symbols with short random gaps."""
    rng = np.random.default_rng(seed)
    text = corpus.silesia_like(D - 192, seed=seed)
    rnd = rng.integers(0, 256, D // 2, np.uint8).tobytes()
    runs = (b"A" * 700 + b"BC" * 400 + rnd[:64] + b"A" * 900
            + rng.integers(0, 256, 512, np.uint8).tobytes()) * 8
    blocks = [text, rnd, runs[:D - 7]]
    x = np.zeros((3, D), np.int32)
    for j, b in enumerate(blocks):
        x[j, :len(b)] = np.frombuffer(b, np.uint8)
    return x, np.array([len(b) for b in blocks], np.int32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


def _words(x):
    """(u32, u32 at i + 4, h4, h8) of the port, as torch tensors."""
    u32 = ev._u32(_t(x))
    us4 = ev._shift_left(u32, 4)
    return u32, us4, hash_kernel.hash_bucket(u32), \
        hash_kernel.hash_bucket8(u32, us4)


@pytest.fixture(scope="module")
def stages():
    """The port's plain E1-E4 on the D = 8192 rows: every kernel's input
    for the tests below."""
    x, dl = _rows(D, 1)
    u32, us4, h4, h8 = _words(x)
    prev = hash_kernel.bucket_prev(u32, us4, h4, h8, D)
    i = torch.arange(D, dtype=torch.int32)
    off = i - prev
    far = (prev >= 0) & (off <= 65535) & (off > 4)
    dks = ev._top_offsets_select(off, far)
    xt, dlt = _t(x), _t(dl)
    m8 = torch.zeros_like(prev)
    mlen = mlen_kernel.match_lengths_fused(xt, u32, prev, m8, dks, dlt, dlt,
                                           D, 512)
    D_, O, S_cap = ev.batch_shapes(int(dl.max()))
    assert D_ == D
    seq = seq_kernel.sequence_records(u32, *mlen, dlt, torch.zeros_like(dlt),
                                      D, S_cap)
    return dict(x=x, dl=dl, u32=u32, prev=prev, dks=dks, mlen=mlen,
                seq=seq, O=O, S_cap=S_cap)


def test_u32_and_hashes_match_jax():
    """int32 wraparound: the port computes in int64 and masks."""
    rng = np.random.default_rng(3)
    x = rng.integers(0, 256, (2, 4096)).astype(np.int32)
    x[0, :64] = 255                               # words with the sign bit
    u32, us4, h4, h8 = _words(x)
    ju = jev._u32(jnp.asarray(x))
    jus4 = jnp.concatenate([ju[:, 4:], jnp.zeros_like(ju[:, :4])], axis=1)
    np.testing.assert_array_equal(u32.numpy(), np.asarray(ju))
    np.testing.assert_array_equal(h4.numpy(), np.asarray(
        jhash.hash_bucket(ju)))
    np.testing.assert_array_equal(h8.numpy(), np.asarray(
        jhash.hash_bucket8(ju, jus4)))
    assert int(h4.min()) >= 0 and int(h4.max()) < hash_kernel.NB


def test_top_offsets_select_breaks_ties_like_top_k():
    """Equal counts go to the smaller offset, as jax.lax.top_k keeps the
    lower index first; fewer offsets than slots leave zeros."""
    off = np.zeros((3, 1024), np.int32)
    off[0, ::16] = np.repeat([9, 7, 300, 12, 5, 40, 41, 42, 43, 44,
                              45, 46, 47, 48, 49, 50], 4)
    off[1, ::16] = np.tile([60, 6, 600, 66], 16)
    off[2, :] = 0
    far = off > 4
    got = ev._top_offsets_select(_t(off), _t(far))
    want = jev._top_offsets_select(jnp.asarray(off), jnp.asarray(far), 8,
                                   16)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("D", [2048, 8192])
def test_bucket_prev_matches_jax(D):
    x, _ = _rows(D, 2)
    u32, us4, h4, h8 = _words(x)
    got = hash_kernel.bucket_prev(u32, us4, h4, h8, D)
    ju = jnp.asarray(u32.numpy())
    jus4 = jnp.asarray(us4.numpy())
    want = jhash.bucket_prev_impl(ju, jus4, jhash.hash_bucket(ju),
                                  jhash.hash_bucket8(ju, jus4), D)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got >= 0).any() and (got < 0).any()


def _jax_mlen_inputs(st):
    x, dl = st["x"], st["dl"]
    return (jnp.asarray(x), jnp.asarray(st["u32"].numpy()),
            jnp.asarray(st["prev"].numpy()), jnp.asarray(dl))


def test_match_lengths_matches_jax_interpret_kernel(stages):
    """rcap = 512 truncates the extension of the text and run rows."""
    st = stages
    x, u32, prev, dl = _jax_mlen_inputs(st)
    want = jmlen.match_lengths_fused(
        x, u32, prev, jnp.zeros_like(prev), jnp.asarray(st["dks"].numpy()),
        dl, dl, D, 512)
    for name, g, w in zip(("matched", "off", "mlen"), st["mlen"], want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w).astype(
            np.int32), name)
    alive = (st["mlen"][2] > 8).sum(1)
    assert int(alive.max()) > 0


@pytest.mark.parametrize("rcap", [256, 512])
def test_match_lengths_matches_jax_xla(stages, rcap):
    st = stages
    x, u32, prev, dl = _jax_mlen_inputs(st)
    want = jev._match_lengths(x, u32, prev, jnp.zeros(prev.shape, bool),
                              dl, dl, D, rcap)
    xt, dlt = _t(st["x"]), _t(st["dl"])
    got = mlen_kernel.match_lengths_fused(
        xt, st["u32"], st["prev"], torch.zeros_like(st["prev"]), st["dks"],
        dlt, dlt, D, rcap)
    for name, g, w in zip(("matched", "off", "mlen"), got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w).astype(
            np.int32), name)


def test_rcap_truncation_changes_lengths(stages):
    """The first rcap survivors extend and the rest stay at 8 bytes, so a
    smaller cap gives shorter (never longer) far matches."""
    st = stages
    xt, dlt = _t(st["x"]), _t(st["dl"])
    args = (xt, st["u32"], st["prev"], torch.zeros_like(st["prev"]),
            st["dks"], dlt, dlt, D)
    short = mlen_kernel.match_lengths_fused(*args, 16)[2]
    full = mlen_kernel.match_lengths_fused(*args, D)[2]
    assert (short <= full).all() and (short < full).any()


def test_sequence_records_matches_jax_interpret_kernel(stages):
    st = stages
    matched, off, mlen = (jnp.asarray(t.numpy()) for t in st["mlen"])
    dl = jnp.asarray(st["dl"])
    want = jseq.sequence_records(
        jnp.asarray(st["u32"].numpy()), matched, off, mlen, dl,
        jnp.zeros_like(dl), D, st["S_cap"], P=0, cu_rounds=2)
    got = st["seq"]
    names = ("s0k", "lit_src", "lit_len", "off", "mlen")
    for name, g, w in zip(names, got[:5], want[:5]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), name)
    np.testing.assert_array_equal(got[5][:, :6].numpy(),
                                  np.asarray(want[5])[:, :6])
    assert (got[5][:, 0] > 0).any()             # tokens in some rows


# rows inside the JAX kernel's domain: its chain threading under-marks a
# step of one position (mlen <= 1 at a matched position, which the
# encoder never makes), as the JAX mark_chain kernel does
SEQ_EDGE_ROWS = ("match_past_d", "skips", "catch_up")


def test_sequence_records_edge_rows_match_jax_interpret_kernel(stages):
    names, *rows, S_cap = tcorpus.seq_edge_rows(D)
    assert S_cap == stages["S_cap"]             # one compile for both
    sel = [names.index(n) for n in SEQ_EDGE_ROWS]
    u32, matched, off, mlen, end_abs, pre_len = (a[sel] for a in rows)
    got = seq_kernel.sequence_records(
        *(torch.from_numpy(a) for a in (u32, matched, off, mlen, end_abs,
                                        pre_len)), D, S_cap)
    want = jseq.sequence_records(
        jnp.asarray(u32), jnp.asarray(matched), jnp.asarray(off),
        jnp.asarray(mlen), jnp.asarray(end_abs), jnp.asarray(pre_len), D,
        S_cap, P=0, cu_rounds=2)
    names = ("s0k", "lit_src", "lit_len", "off", "mlen")
    for name, g, w in zip(names, got[:5], want[:5]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), name)
    np.testing.assert_array_equal(got[5][:, :6].numpy(),
                                  np.asarray(want[5])[:, :6])


def test_emit_bytes_matches_jax_interpret_kernel(stages):
    st = stages
    s0k, ls, ll, off, ml, stats = st["seq"]
    out_len = stats[:, 2].contiguous()
    direct, cidx, miss = emit_kernel.emit_bytes(s0k, ls, ll, off, ml,
                                                out_len, st["O"])
    jd, jc, jmiss = jemit.emit_bytes(
        *(jnp.asarray(t.numpy()) for t in (s0k, ls, ll, off, ml, out_len)),
        st["O"])
    rows = np.asarray(jmiss) == 0
    assert rows.any() and not miss.any()
    np.testing.assert_array_equal(direct.numpy()[rows], np.asarray(jd)[rows])
    np.testing.assert_array_equal(cidx.numpy()[rows], np.asarray(jc)[rows])


def test_emit_bytes_edge_rows_match_jax_interpret_kernel(stages):
    S = stages["seq"][0].shape[1]
    _, *fields, out_len = tcorpus.emit_edge_rows(S, stages["O"])
    assert len(out_len) == len(stages["dl"])    # one compile for both
    direct, cidx, miss = emit_kernel.emit_bytes(
        *(torch.from_numpy(a) for a in (*fields, out_len)), stages["O"])
    jd, jc, jmiss = jemit.emit_bytes(
        *(jnp.asarray(a) for a in (*fields, out_len)), stages["O"])
    assert not np.asarray(jmiss).any() and not miss.any()
    np.testing.assert_array_equal(direct.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(cidx.numpy(), np.asarray(jc))
    live = np.arange(stages["O"])[None, :] < out_len[:, None]
    assert ((cidx.numpy() >= 0) <= live).all()
    assert (cidx.numpy()[live] >= 0).mean() > 0.5   # mostly literals
