"""The edge-case rows of the two encode kernels redesigned for the card,
``sequence_records`` and ``bucket_prev``, held between the port's plain
versions and the JAX package on the CPU (tolerance 0: every output is an
integer), and the fact the new ``sequence_records`` kernel rests on.

* ``corpus.seq_edge_rows`` at D = 4096 (all literals, one match to the
  row's end, a match past D, matched positions with mlen <= 0, matches
  that skip segments and tiles, a row past S_cap, catch-up over whole
  literal runs, dense random matches) through the plain
  ``sequence_records``: every row's token count against a walk of the
  greedy parse.  The JAX kernel takes D >= 8192 and one interpret-mode
  compile of it takes about 25 s here, so the rows inside its domain
  are held against it in ``tests/test_torch_encode_kernels.py``, at the
  shapes whose compile that file makes anyway;
* ``corpus.bucket_edge_rows`` at D = 4096 (one repeated byte, periods
  127-256, distinct words in one bucket, text, and every position in one
  bucket) through the plain ``bucket_prev`` against JAX
  ``hash_kernel.bucket_prev_impl``;
* the local step of the kernel's parse, g(q) = min(q + max(matched[q] ?
  clamp(mlen[q], 0, D) : 1, 1), D): the matched positions on the orbit
  of 0 under it are those under ``seq_kernel.chain_graph``'s step (to
  the first match at or after), over match densities and mlen ranges.

The same rows hold the kernels against these plain versions on the card
(``tests/test_torch_edge_cases_gpu.py``).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # the test workers share the cores: one intra-op
                           # thread each, or they spin against each other

import jax.numpy as jnp  # noqa: E402

from lz4net_tpu.ops import hash_kernel as jhash  # noqa: E402
from lz4net_tpu_torch.ops import hash_kernel, seq_kernel  # noqa: E402
from lz4net_tpu_torch.utils import corpus  # noqa: E402

from test_torch_edge_cases_gpu import bucket_inputs  # noqa: E402

D = 4096


def _greedy_tokens(matched, mlen, D):
    """Token count of the greedy parse, by a plain walk from position 0."""
    n, pos = 0, 0
    while pos < D:
        if matched[pos]:
            n += 1
            pos += max(min(max(int(mlen[pos]), 0), D), 1)
        else:
            pos += 1
    return n


def test_sequence_records_edge_rows_count_the_greedy_tokens():
    names, *rows, S_cap = corpus.seq_edge_rows(D)
    got = seq_kernel.sequence_records(*(torch.from_numpy(a) for a in rows),
                                      D, S_cap, 0, 2)
    matched, mlen = rows[1], rows[3]
    assert got[5][:, 0].tolist() == [_greedy_tokens(matched[j], mlen[j], D)
                                     for j in range(len(names))]
    # the rows reach what they were made for
    n_seqs = dict(zip(names, got[5][:, 0].tolist()))
    assert n_seqs["all_literals"] == 0 and n_seqs["one_match"] == 1
    assert n_seqs["overflow"] == D > S_cap
    assert got[5][names.index("catch_up"), 1] == 1   # all merged
    assert (got[5][:, 4] < 0).any()                  # a match past D


def test_bucket_prev_edge_rows_match_jax():
    names, x = corpus.bucket_edge_rows(D)
    wa, wb, h4, h8 = bucket_inputs(names, x)
    got = hash_kernel.bucket_prev(wa, wb, h4, h8, D)
    want = jhash.bucket_prev_impl(*(jnp.asarray(t.numpy())
                                    for t in (wa, wb, h4, h8)), D)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    i = torch.arange(D)
    prev = dict(zip(names, got))
    # one repeated word: the nearest, at 1, inside each chunk (the last
    # words reach past the row); a chunk's first position finds nothing,
    # as every chunk hits its bucket more than once and the count guard
    # keeps the bucket empty
    rep, inner = prev["repeat"][:D - 7], (i % 512 != 0)[:D - 7]
    assert (rep[inner] == i[:D - 7][inner] - 1).all()
    assert (rep[~inner] == -1).all()
    # a period inside the window (the row before, within the chunk) is
    # found there; 256 lies past every window
    li = i % 512
    lo = torch.where(li < 128, 0, (li // 128 - 1) * 128)
    for p in (127, 128, 129, 255):
        near = (li - p >= lo) & (i < D - 8)
        assert near.any()
        assert (prev[f"period_{p}"][near] == i[near] - p).all()
    assert (prev["one_bucket"] < 0).sum() > (prev["text"] < 0).sum()


def _local_step(m, mlen, D):
    i = torch.arange(D, dtype=torch.int32)
    step = torch.where(m, mlen.clamp(0, D), 1).clamp(min=1)
    return torch.minimum(i + step, torch.tensor(D, dtype=torch.int32))


@pytest.mark.parametrize("density", [0.02, 0.3, 0.7, 0.98])
@pytest.mark.parametrize("lo, hi", [(-2, 3), (4, 20), (-2, 5000)])
def test_local_step_marks_the_same_tokens(density, lo, hi):
    rng = np.random.default_rng(int(density * 100) + hi)
    B, n = 4, 4096
    m = torch.from_numpy(rng.random((B, n)) < density)
    mlen = torch.from_numpy(rng.integers(lo, hi, (B, n), np.int32))
    want = (seq_kernel._orbit(seq_kernel.chain_graph(m, mlen, n)) == 1) & m
    got = (seq_kernel._orbit(_local_step(m, mlen, n)) == 1) & m
    assert torch.equal(got, want)
    assert want.any()
