"""The chain record path of the port's fast encoder on the CPU.

``encode_batch_chain`` (``chain_records``: the parse chain's orbit from
``mark_chain``, every token and record field through ``table_gather``,
here their plain PyTorch versions) must give the JAX vector encoder's
bytes exactly, and ``chain_records`` the same six tensors as
``sequence_records`` on the same match state.  Tolerance 0 throughout.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # the test workers share the cores: one intra-op
                           # thread each, or they spin against each other

from lz4net_tpu.ops import encode_vector as jev  # noqa: E402
from lz4net_tpu_torch.models import reference  # noqa: E402
from lz4net_tpu_torch.ops import encode_vector as ev  # noqa: E402
from lz4net_tpu_torch.ops import seq_kernel  # noqa: E402
from lz4net_tpu_torch.utils import corpus  # noqa: E402

D = 8192


@pytest.fixture(scope="module")
def batch():
    """A silesia-like block and a run-heavy one, at D = 8192."""
    rng = np.random.default_rng(12)
    runs = (b"x" * 500 + b"lz4seq" * 120
            + rng.integers(0, 256, 300, np.uint8).tobytes()) * 5
    blocks = [corpus.silesia_like(D - 60, seed=11), runs[:D - 7]]
    shapes = ev.batch_shapes(max(map(len, blocks)))
    assert shapes[0] == D
    x = np.zeros((len(blocks), D), np.int32)
    for j, b in enumerate(blocks):
        x[j, :len(b)] = np.frombuffer(b, np.uint8)
    dl = np.array([len(b) for b in blocks], np.int32)
    return blocks, x, dl, shapes


def _payloads(out, out_len):
    return [out[j, :int(n)].to(torch.uint8).numpy().tobytes()
            for j, n in enumerate(out_len)]


def _count_calls(monkeypatch):
    """Count the chain path's calls of its two kernels' wrappers."""
    calls = {"table_gather": 0, "mark_chain": 0}

    def counted(name, fn):
        def wrapper(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapper

    for name in calls:
        monkeypatch.setattr(ev, name, counted(name, getattr(ev, name)))
    return calls


def test_chain_path_matches_jax_bytes(batch, monkeypatch):
    """Fast mode against the JAX encoder's XLA branch (``fused=False``),
    which its tests hold equal to its kernels.  The path gathers through
    ``table_gather`` 1 + 2 x 2 + 1 + 1 times and marks the chain once."""
    blocks, x, dl, (_, O, S_cap) = batch
    calls = _count_calls(monkeypatch)
    out, out_len, ok, aux = ev.encode_batch_chain(torch.from_numpy(x),
                                                  torch.from_numpy(dl), D, O,
                                                  S_cap)
    assert calls == {"table_gather": 7, "mark_chain": 1}
    jout, jlen, jok, jaux = jev.encode_batch_vectorized(x, dl, D, O, S_cap,
                                                        fused=False)
    np.testing.assert_array_equal(out_len.numpy(), np.asarray(jlen))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(jok))
    np.testing.assert_array_equal(aux.numpy(), np.asarray(jaux))
    np.testing.assert_array_equal(out.numpy(), np.asarray(jout))
    assert ok.all()
    for b, p in zip(blocks, _payloads(out, out_len)):
        assert reference.decompress_block(p, len(b)) == b


def test_chain_records_equal_sequence_records_at_hc_level_5(batch,
                                                            monkeypatch):
    """Eight catch-up rounds on the level-5 match state: all six outputs
    equal, and so are the payloads.  The path gathers through
    ``table_gather`` 1 + 2 x 8 + 1 + 1 times and marks the chain once."""
    blocks, x, dl, (_, O, S_cap) = batch
    xt, dlt = torch.from_numpy(x), torch.from_numpy(dl)
    state = ev._match_stage(xt, dlt, D, ev.hc_rcap(5, D), 5, None)
    args = (*state, dlt, torch.zeros_like(dlt), D, S_cap, 0,
            ev.HC_CU_ROUNDS)
    calls = _count_calls(monkeypatch)
    chain = ev.chain_records(*args)
    assert calls == {"table_gather": 19, "mark_chain": 1}
    seq = seq_kernel.sequence_records(*args)
    for got, want in zip(chain, seq):
        assert got.dtype == torch.int32 and torch.equal(got, want)
    assert seq[5][0, 0] > 100        # the text block has many tokens
    got = ev._emit_stage(xt, chain, O, S_cap)
    want = ev._emit_stage(xt, seq, O, S_cap)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    for b, p in zip(blocks, _payloads(got[0], got[1])):
        assert reference.decompress_block(p, len(b)) == b


def test_chain_path_matches_vectorized_at_hc_level_9(batch):
    """The public entry at level 9 (the sort tiers) gives the sequence
    path's bytes."""
    _, x, dl, (_, O, S_cap) = batch
    xt, dlt = torch.from_numpy(x), torch.from_numpy(dl)
    got = ev.encode_batch_chain(xt, dlt, D, O, S_cap, ev.hc_rcap(9, D), 9)
    want = ev.encode_batch_vectorized(xt, dlt, D, O, S_cap,
                                      ev.hc_rcap(9, D), 9)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
