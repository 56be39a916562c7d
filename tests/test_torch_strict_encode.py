"""The port's strict encode on the CPU (``encode_sequencer``'s plain
version), held byte for byte against the JAX package:

* ``PallasEncoder(interpret=True)`` on one mixed batch of the small cases
  of ``tests/test_tpu_encode.py``, with a budget overflow in it;
* the JAX package's oracle, which its tests hold bit-identical to that
  kernel, at full width: a 64 KB block, blocks of ``LZ4_64KLIMIT`` - 1,
  ``LZ4_64KLIMIT`` and + 1 bytes (the two hash variants) and 128 KB;
* the facade: ``codec.encode`` against the JAX ``codec.encode`` (strict);
* the JAX package's oracle on ``corpus.strict_wide_rows``, the 1 MB
  rows and budgets that drive the card's kernel for rows it reads from
  device memory (the port's copy of the oracle, ``models.native``, on
  the two budgets at the match-length check, where the JAX package's
  library writes past its buffer);
* the places of ``tools/parse_clocks.py``'s marks in the kernel's source.
"""

import random

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # the test workers share the cores: one intra-op
                           # thread each, or they spin against each other

from lz4net_tpu import codec as jcodec  # noqa: E402
from lz4net_tpu.models import native  # noqa: E402
from lz4net_tpu.models import reference as jreference  # noqa: E402
from lz4net_tpu.ops.encode_pallas import PallasEncoder  # noqa: E402
from lz4net_tpu_torch import codec  # noqa: E402
from lz4net_tpu_torch.constants import LZ4_64KLIMIT  # noqa: E402
from lz4net_tpu_torch.models import cuda as cuda_engine  # noqa: E402
from lz4net_tpu_torch.models import native as port_native  # noqa: E402
from lz4net_tpu_torch.models.service_adapters import CudaService  # noqa
from lz4net_tpu_torch.ops import encode_sequencer as es  # noqa: E402
from lz4net_tpu_torch.utils import corpus  # noqa: E402

CASES = {
    "text": (b"the quick brown fox jumps over the lazy dog. " * 120)[:4000],
    "rle": b"\x05" * 3000,
    "period2": b"ab" * 1500,
    "incompressible": bytes(map(random.Random(1).randrange, [256] * 2000)),
    "tiny_literal": b"x" * 12,
    "min_match_len": b"x" * 13,
    "long_runs": b"z" * 300 + bytes(range(256)) + b"z" * 300,
}


def _oracle(data, maxlen=None):
    if native.is_available():
        return native.compress_block(data, maxlen)
    return jreference.compress_block(data, maxlen)


def _sil(n, seed):
    return corpus.silesia_like(n, seed=seed)


def test_plain_matches_pallas_encoder_on_small_cases():
    datas = list(CASES.values())
    rng = random.Random(2)
    overflow = bytes(rng.getrandbits(8) for _ in range(1500))
    datas.append(overflow)
    maxlens = [len(d) + len(d) // 255 + 16 for d in datas[:-1]]
    maxlens.append(len(overflow))                 # does not fit: b""
    want = PallasEncoder(interpret=True).encode_batch(datas, maxlens)
    assert want[-1] == b""
    assert es.SequencerEncoder("cpu").encode_batch(datas, maxlens) == want
    assert want[:-1] == [_oracle(d) for d in datas[:-1]]


@pytest.mark.parametrize("size", [1 << 16, LZ4_64KLIMIT - 1, LZ4_64KLIMIT,
                                  LZ4_64KLIMIT + 1, 1 << 17])
def test_plain_matches_oracle_at_full_width(size):
    data = _sil(size, seed=size % 7)
    assert cuda_engine.compress_block(data, device="cpu") == _oracle(data)


def test_tensor_interface():
    """written is the payload length or -1, the plain version leaves the
    row 0 past it (the kernel leaves it undefined), and an O too small
    for the payload gives -1 like an overflow."""
    datas = [CASES["text"], CASES["incompressible"], b"", b"abc" * 10]
    S = max(map(len, datas))
    src = np.zeros((len(datas), S), np.uint8)
    for i, d in enumerate(datas):
        src[i, :len(d)] = np.frombuffer(d, np.uint8)
    src = torch.from_numpy(src)
    lens = torch.tensor([len(d) for d in datas], dtype=torch.int32)
    maxlens = torch.tensor([5000, 1000, 16, 0], dtype=torch.int32)
    out, written = es.encode_sequencer(src, lens, maxlens, 5000)
    want = _oracle(datas[0])
    assert written.tolist() == [len(want), -1, 1, -1]
    assert out[0, :len(want)].numpy().tobytes() == want
    assert not out[0, len(want):].any() and not out[1:].any()
    _, written = es.encode_sequencer(src, lens, maxlens, len(want) - 1)
    assert written[0] == -1
    with pytest.raises(TypeError):
        es.encode_sequencer(src.to(torch.int32), lens, maxlens, 64)


def test_codec_encode_strict_matches_jax_codec():
    data = _sil(50000, seed=1)
    want = jcodec.encode(data)
    assert codec.encode(data, device="cpu") == want
    assert codec.encode(data, mode="strict", device="cpu") == want
    assert codec.encode(data, 1000, device="cpu") == jcodec.encode(data, 1000)
    assert codec.encode(b"", device="cpu") == b""
    assert CudaService("cpu").encode(data, len(want)) == want
    blocks = [data[:30000], data[30000:], CASES["rle"]]
    assert cuda_engine.compress_blocks(blocks, device="cpu") \
        == [_oracle(b) for b in blocks]


def test_output_cap_of_8_mib_or_more():
    """A cap past the kernel's widest row sizes the output by the
    worst-case bound: the payload is the default cap's and the JAX
    facade's, and a cap one byte short of it still gives b""."""
    data = b"abcdefgh" * 1000
    want = codec.encode(data, device="cpu")
    assert len(want) == 49
    assert codec.encode(data, 9_000_000, device="cpu") == want \
        == jcodec.encode(data, 9_000_000)
    assert codec.encode(data, len(want) - 1, device="cpu") == b""
    assert es.SequencerEncoder("cpu").encode_batch(
        [data, data], [9_000_000, len(want) - 1]) == [want, b""]


def _probes(end):
    """The skip loop's probe positions below ``end`` while no match is
    found: they depend only on its attempt counter."""
    out, p, attempts = [], 1, 67
    while p < end:
        out.append(p)
        p += attempts >> 6
        attempts += 1
    return out


def test_plain_matches_oracle_on_wide_rows():
    """``corpus.strict_wide_rows`` in one batch through the plain version
    (``odd_width`` makes the batch 1 MB + 5 bytes wide): every payload
    and the -1 of each budget row equal to the JAX package's oracle's,
    save the two budgets at the match-length check of 1 MB of zeros,
    held against the port's copy of the oracle: the JAX package's library
    writes there past the buffer it sizes from the budget (about 16
    bytes; ``test_torch_native.py``); the catch_up row matches only after
    its literal run, at the stretch's offset, and its first probe that
    can hit lies 50,175 bytes into the copy."""
    rows = corpus.strict_wide_rows(0)
    S = max(len(d) for _, d, _ in rows)
    src = np.zeros((len(rows), S), np.uint8)
    for i, (_, d, _) in enumerate(rows):
        src[i, :len(d)] = np.frombuffer(d, np.uint8)
    caps = [b if b is not None else len(d) + len(d) // 255 + 16
            for _, d, b in rows]
    lens = torch.tensor([len(d) for _, d, _ in rows], dtype=torch.int32)
    out, written = es.encode_sequencer(
        torch.from_numpy(src), lens, torch.tensor(caps, dtype=torch.int32),
        max(caps))
    for (name, d, b), row, n in zip(rows, out.numpy(), written.tolist()):
        oracle = port_native if name.startswith("match_check") else native
        want = oracle.compress_block(d, b)
        assert (row[:n].tobytes() if n >= 0 else b"") == want, name
        assert (n < 0) == (want == b""), name
    assert (written < 0).sum() == 5
    at, span = corpus.CATCH_UP
    catch_up = out[[name for name, _, _ in rows].index("catch_up")].numpy()
    run = at + span                      # the first token's literals
    k = (run - 15) // 255
    assert catch_up[0] >> 4 == 15
    assert bytes(catch_up[1:2 + k]) == b"\xff" * k + bytes([(run - 15) % 255])
    offset = catch_up[2 + k + run:4 + k + run]
    assert int(offset[0]) | int(offset[1]) << 8 == span
    probes = _probes(at + 2 * span)
    seen = set(probes)
    first = min(q for q in probes if q >= at + span and q - span in seen)
    assert first - (at + span) == 50_175


def test_parse_clocks_finds_each_of_its_marks_once():
    """``tools/parse_clocks.py`` puts its clock marks into a copy of
    ``csrc/encode_sequencer.cu`` by text: each mark's place, in the warp
    parse and both kernels, occurs once in the source (the tool stops
    otherwise, and only on the card)."""
    from lz4net_tpu_torch import _build
    from lz4net_tpu_torch.tools import _clocks, parse_clocks

    with open(f"{_build.CSRC}/encode_sequencer.cu") as fh:
        text = fh.read()
    marked = _clocks.marked(text, parse_clocks.MARKS, "encode_sequencer.cu",
                            _clocks.counters())
    assert marked.count("CLK(0)") == 2 and marked.count("CLK(7)") == 2
