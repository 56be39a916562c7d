"""The edge-case rows of the redesigned kernels, held between the port's
plain versions and the JAX package on the CPU (tolerance 0: every output
is an integer or a byte):

* ``match_lengths``: ``tests/test_torch_edge_cases_gpu.mlen_edge_rows``
  through ``encode_vector._match_lengths_dispatch`` (the plain version,
  with the dominant offsets chosen as the encoder chooses them) against
  the JAX XLA ``_match_lengths``, at K = 0, 8 and 24 dominant offsets
  (D = 8192; the card's tests add D = 106496, one more JAX compile of
  some 16 s here);
* ``encode_sequencer``: ``corpus.strict_edge_rows`` through
  ``SequencerEncoder("cpu")`` (``encode_sequencer_reference``) against
  the JAX ``PallasEncoder(interpret=True)`` for the rows below its 48 KB
  cap, in one batch, and against the JAX package's oracle above it.

The same rows hold the kernels against these plain versions on the card
(``tests/test_torch_edge_cases_gpu.py``).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # the test workers share the cores: one intra-op
                           # thread each, or they spin against each other

import jax.numpy as jnp  # noqa: E402

from lz4net_tpu.models import native  # noqa: E402
from lz4net_tpu.models import reference as jreference  # noqa: E402
from lz4net_tpu.ops import encode_vector as jev  # noqa: E402
from lz4net_tpu.ops.encode_pallas import PallasEncoder  # noqa: E402
from lz4net_tpu_torch.ops import encode_sequencer as es  # noqa: E402
from lz4net_tpu_torch.ops import encode_vector as ev  # noqa: E402
from lz4net_tpu_torch.utils import corpus  # noqa: E402

from test_torch_edge_cases_gpu import (MLEN_CASES, mlen_edge_rows,  # noqa
                                       mlen_inputs)

PALLAS_CAP = 48 * 1024       # the JAX kernel's widest block
ROWS = corpus.strict_edge_rows(0)


def _oracle(data, budget):
    if native.is_available():
        return native.compress_block(data, budget)
    return jreference.compress_block(data, budget)


@pytest.mark.parametrize("K, sub_step, D, rcap",
                         [c for c in MLEN_CASES if c[2] == 8192])
def test_match_lengths_edge_rows_match_jax_xla(K, sub_step, D, rcap):
    x, dl = mlen_edge_rows(D)
    xt, dlt, u32, prev, m8 = mlen_inputs(x, dl)
    got = ev._match_lengths_dispatch(xt, u32, prev, m8, dlt, dlt, D, rcap,
                                     K, sub_step)
    want = jev._match_lengths(
        jnp.asarray(x), jnp.asarray(u32.numpy()), jnp.asarray(prev.numpy()),
        jnp.asarray(m8.numpy()), jnp.asarray(dl), jnp.asarray(dl), D, rcap,
        top_offsets=K, sub_step=sub_step)
    for name, g, w in zip(("matched", "off", "mlen"), got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w).astype(
            g.numpy().dtype), name)
    # the rows reach what they were made for: runs to the block's end at
    # offset 1 and at the far period, offsets 1-4 set, and the periods
    # past the dominant offsets left at their far lengths
    off, mlen = got[1], got[2]
    assert int(mlen[0, 1]) == D - 6 and int(mlen[2, D - 12]) == 7
    assert set(off[1].unique().tolist()) >= {0, 1, 2, 3, 4}
    # period 777 from 5040 breaks where the flip at 4999 comes round: an
    # exact run at a dominant offset, at most 8 + 4 x 10 bytes without
    assert int(mlen[2, 5040]) == 736 if K else int(mlen[2, 5040]) <= 48
    if K == 24:
        assert int(((off[3] > 4) & (mlen[3] > 48)).sum()) > 0


def test_strict_edge_rows_below_48_kb_match_pallas_interpret():
    rows = [r for r in ROWS if len(r[1]) <= PALLAS_CAP]
    assert len(rows) == 8
    datas = [d for _, d, _ in rows]
    caps = [b if b is not None else len(d) + len(d) // 255 + 16
            for _, d, b in rows]
    want = PallasEncoder(interpret=True).encode_batch(datas, caps)
    got = es.SequencerEncoder("cpu").encode_batch(datas, caps)
    for (name, _, _), g, w in zip(rows, got, want):
        assert g == w, name
    assert [g == b"" for g in got] == [b is not None and b < 1100 or
                                       n == "last_literals_check"
                                       for n, _, b in rows]


@pytest.mark.parametrize("name", [n for n, d, _ in ROWS
                                  if len(d) > PALLAS_CAP])
def test_strict_edge_rows_above_48_kb_match_oracle(name):
    _, data, budget = next(r for r in ROWS if r[0] == name)
    cap = budget if budget is not None else len(data) + len(data) // 255 + 16
    got = es.SequencerEncoder("cpu").encode_batch([data], [cap])[0]
    assert got == _oracle(data, cap)
    assert (got == b"") == (budget is not None)
