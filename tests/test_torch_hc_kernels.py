"""``match_lengths`` and ``sequence_records`` (plain PyTorch versions) at
the settings of the fast-HC tiers, held against the JAX package's
functions on the CPU: 24 dominant offsets sampled every 8 bytes, and 8
catch-up rounds.  Every output is an integer and must be equal
(tolerance 0); the JAX side runs ``_match_lengths`` (its XLA path) and
its ``sequence_records`` Pallas kernel in interpret mode.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # the test workers share the cores: one intra-op
                           # thread each, or they spin against each other

import jax.numpy as jnp  # noqa: E402

from lz4net_tpu.ops import encode_vector as jev  # noqa: E402
from lz4net_tpu.ops import seq_kernel as jseq  # noqa: E402
from lz4net_tpu_torch.ops import encode_vector as ev  # noqa: E402
from lz4net_tpu_torch.ops import mlen_kernel  # noqa: E402
from lz4net_tpu_torch.ops import seq_kernel  # noqa: E402

from test_torch_hc_tables import _eq, _j, _rows, _t, _wide, _words  # noqa


@pytest.fixture(scope="module")
def hc_tier():
    """A suffix-tier candidate set of the D = 8192 rows, claimed as HC's
    per-tier dispatch claims it, with the port's match lengths."""
    D = 8192
    x, dl = _rows(D, 8)
    u32, us4 = _words(x)
    prev = ev._prev_occurrence((u32,))
    cand, _ = ev._suffix_candidates(_wide(u32, us4))
    i = torch.arange(D, dtype=torch.int32)
    ok = (cand >= 0) & (i - cand <= 65535)
    prev_t = torch.where(ok, cand, prev)
    claim = ~ok & (torch.arange(D) % 3 == 0)       # some 8-byte claims
    return dict(x=x, dl=dl, u32=u32, prev=prev_t, claim=claim, D=D)


def test_top_offsets_at_24_break_ties_like_top_k():
    off = np.zeros((2, 2048), np.int32)
    vals = np.repeat(np.arange(5, 45) * 7, 3)               # 40 tied offsets
    off[0, ::8][:len(vals)] = vals
    off[1, ::8][:60] = np.tile([600, 6, 90, 66, 7000], 12)  # 5 offsets
    far = off > 4
    got = ev._top_offsets_select(_t(off), _t(far), 24, 8)
    want = jev._top_offsets_select(jnp.asarray(off), jnp.asarray(far), 24, 8)
    _eq(got, want)
    assert (got[0] > 0).sum() == 24 and (got[1] > 0).sum() == 5


@pytest.mark.parametrize("rcap", [512, 1024])
def test_match_lengths_at_24_offsets_match_jax_xla(hc_tier, rcap):
    st = hc_tier
    D = st["D"]
    xt, dlt = _t(st["x"]), _t(st["dl"])
    got = ev._match_lengths_dispatch(xt, st["u32"], st["prev"], st["claim"],
                                     dlt, dlt, D, rcap, 24, 8)
    want = jev._match_lengths(
        jnp.asarray(st["x"]), _j(st["u32"]), _j(st["prev"]),
        _j(st["claim"]), jnp.asarray(st["dl"]), jnp.asarray(st["dl"]), D,
        rcap, top_offsets=24, sub_step=8)
    for name, g, w in zip(("matched", "off", "mlen"), got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w).astype(
            g.numpy().dtype), name)
    # the slots past the fast path's 8 set lengths here
    off = torch.arange(D, dtype=torch.int32) - st["prev"]
    far = (st["prev"] >= 0) & (off <= 65535) & (off > 4)
    dks = ev._top_offsets_select(off, far, 24, 8)
    assert int((dks > 0).sum(1).max()) > 8
    args = (xt, st["u32"], st["prev"], st["claim"].to(torch.int32))
    k8 = mlen_kernel.match_lengths_reference(*args, dks[:, :8], dlt, dlt,
                                             D, rcap)
    assert not torch.equal(k8[2], got[2])


def test_sequence_records_hc_catch_up_matches_jax_interpret_kernel(hc_tier):
    st = hc_tier
    D = st["D"]
    dlt = _t(st["dl"])
    matched, off, mlen = ev._match_lengths_dispatch(
        _t(st["x"]), st["u32"], st["prev"], st["claim"], dlt, dlt, D, 1024,
        24, 8)
    # matches found up to 20 bytes late leave catch-up work past 8 bytes
    late = torch.arange(D) % 32 >= 20
    _, _, S_cap = ev.batch_shapes(int(st["dl"].max()))
    args = (st["u32"][:2], (matched & late)[:2].to(torch.int32), off[:2],
            mlen[:2], dlt[:2], torch.zeros_like(dlt[:2]), D, S_cap)
    got = seq_kernel.sequence_records(*args, P=0, cu_rounds=8)
    want = jseq.sequence_records(*(_j(a) for a in args[:6]), D, S_cap, P=0,
                                 cu_rounds=8)
    names = ("s0k", "lit_src", "lit_len", "off", "mlen")
    for name, g, w in zip(names, got[:5], want[:5]):
        _eq(g, w, name)
    np.testing.assert_array_equal(got[5][:, :6].numpy(),
                                  np.asarray(want[5])[:, :6])
    fast = seq_kernel.sequence_records(*args, P=0, cu_rounds=2)
    assert not torch.equal(fast[2], got[2])     # 8 rounds reach further
