"""Package rules of the CUDA port, and its kernels against their plain
versions on the card.

The card tests carry the ``gpu`` marker and skip without a CUDA device;
on a machine with one (no JAX needed) run them with

    python -m pytest --noconftest -m gpu tests/test_torch_package.py
"""

import ast
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from lz4net_tpu_torch import codec  # noqa: E402
from lz4net_tpu_torch.models import cuda as cuda_engine  # noqa: E402
from lz4net_tpu_torch.models import reference  # noqa: E402
from lz4net_tpu_torch.models.service_adapters import CudaService  # noqa
from lz4net_tpu_torch.ops import decode_vector as dv  # noqa: E402
from lz4net_tpu_torch.ops import (fused_gather, parse_kernel,  # noqa: E402
                                  records_kernel, resolve_kernel)
from lz4net_tpu_torch.utils import corpus  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
KERNELS = (parse_kernel, records_kernel, fused_gather, resolve_kernel)


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_imports_neither_jax_nor_the_jax_package():
    files = sorted((ROOT / "lz4net_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) >= 16
    for path in files:
        for mod in _imported_modules(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "lz4net_tpu"), (path, mod)


def test_every_kernel_has_its_source_and_entry():
    from lz4net_tpu_torch import _build
    names = {p.stem for p in (ROOT / "lz4net_tpu_torch" / "csrc").glob("*.cu")}
    assert names == {"parse_kernel", "records_kernel", "fused_gather",
                     "resolve_kernel"}
    assert set(_build.SIGNATURES) == {
        "lz4t_parse_tokens", "lz4t_records_to_state",
        "lz4t_rowbase_gather", "lz4t_resolve_wavefront"}
    for mod in KERNELS:
        assert mod.launches >= 0


def test_default_device_is_cuda_and_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        dv.VectorDecoder()
    with pytest.raises(RuntimeError, match="cuda"):
        CudaService()
    with pytest.raises(RuntimeError, match="cuda"):
        codec.decode(b"\x10x", 1)
    with pytest.raises(RuntimeError, match="cuda"):
        cuda_engine.decompress_blocks([b"\x10x"], [1])
    with pytest.raises(RuntimeError, match="cuda"):
        dv.batch_from_numpy(np.zeros((1, 4096), np.uint8), [1], [1], "cuda")


def test_wrappers_refuse_other_devices():
    """A tensor that is neither on the CPU nor on a card is refused, never
    served by the plain version."""
    meta = torch.zeros((1, 4096), dtype=torch.int32, device="meta")
    lens = torch.zeros(1, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="device"):
        parse_kernel.parse_tokens(meta, lens, 4096)
    with pytest.raises(ValueError, match="device"):
        records_kernel.records_to_state(meta, meta, meta, meta, lens, lens,
                                        lens, 4096, 8192)
    with pytest.raises(ValueError, match="device"):
        fused_gather.rowbase_gather(meta, meta)
    with pytest.raises(ValueError, match="device"):
        resolve_kernel.resolve_wavefront(
            torch.zeros((1, 8192), dtype=torch.int32, device="meta"))


def test_corpus_matches_jax_apart_from_its_generated_source_part():
    """The port's corpus is the JAX corpus except for the "source" part,
    which is generated from the seed and leaves the seed's stream where
    the JAX part (which reads files) leaves it."""
    import random

    from lz4net_tpu.utils import corpus as jcorpus
    n, seed = 30000, 4
    rng_port, rng_jax = random.Random(seed), random.Random(seed)
    for name, (gen, _w) in sorted(corpus._PROFILES.items()):
        ours, theirs = gen(rng_port, n), jcorpus._PROFILES[name][0](rng_jax, n)
        assert len(ours) == n
        assert (ours == theirs) == (name != "source"), name
        assert rng_port.getstate() == rng_jax.getstate(), name
    assert corpus.silesia_like(n, seed) == corpus.silesia_like(n, seed)
    src = corpus._source(random.Random(seed), n)
    assert 0.3 < len(reference.compress_block(src)) / n < 0.6


def test_cpu_path_launches_no_kernel():
    before = [m.launches for m in KERNELS]
    data = b"abcdefgh" * 500
    got = codec.decode_batch([reference.compress_block(data)], [len(data)],
                             device="cpu")
    assert got == [data]
    assert [m.launches for m in KERNELS] == before


# ---- on the card --------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def blocks():
    data = corpus.silesia_like(1 << 19, seed=9)
    blocks = corpus.split_blocks(data, 1 << 16)
    return blocks, [reference.compress_block(b) for b in blocks]


def _equal(got, want):
    for g, w in zip(got, want):
        if isinstance(g, (list, tuple)):
            _equal(g, w)
        else:
            assert g.dtype == w.dtype and torch.equal(g.cpu(), w.cpu())


@pytest.mark.gpu
def test_kernels_match_plain_versions_on_the_card(cuda, blocks):
    plain, packed = blocks
    comp_np, cl, ol, C, D = dv.pack_blocks(packed, [len(b) for b in plain])
    comp, comp_len, out_len = dv.batch_from_numpy(comp_np, cl, ol, cuda)
    pre = torch.zeros_like(comp_len)
    parsed = parse_kernel.parse_tokens(comp, comp_len, C)
    _equal(parsed, parse_kernel.parse_tokens_reference(comp, comp_len, C))
    mark, ll, ml, _ = parsed
    rec = records_kernel.records_to_state(comp, mark, ll, ml, comp_len,
                                          out_len, pre, C, D)
    _equal(rec, records_kernel.records_to_state_reference(
        comp, mark, ll, ml, comp_len, out_len, pre, C, D))
    cidx = rec[1]
    idx = torch.cummax(torch.where(cidx >= 0, cidx.clamp(0, C - 1), 0),
                       dim=1).values
    gathered = fused_gather.rowbase_gather(comp, idx)
    _equal(gathered, fused_gather.rowbase_gather_reference(comp, idx))
    T0 = torch.where(cidx >= 0, dv.VFLAG | (gathered[0] & 0xFF), rec[0])
    _equal(resolve_kernel.resolve_wavefront(T0),
           resolve_kernel.resolve_wavefront_reference(T0))


@pytest.mark.gpu
def test_kernels_match_plain_versions_on_junk(cuda):
    """Seeded random bytes that are not LZ4 (plus a truncated block): the
    junk-safe clips must agree between kernel and plain version."""
    rng = np.random.default_rng(5)
    rows = [rng.integers(0, 256, 4000, np.uint8).tobytes(),
            rng.integers(0, 256, 9000, np.uint8).tobytes(),
            b"\xff" * 3000,                        # one long 0xFF run
            reference.compress_block(b"abc" * 3000)[:50]]
    comp_np, cl, ol, C, D = dv.pack_blocks(rows, [9000, 20000, 4000, 9000])
    comp, comp_len, out_len = dv.batch_from_numpy(comp_np, cl, ol, cuda)
    pre = torch.zeros_like(comp_len)
    parsed = parse_kernel.parse_tokens(comp, comp_len, C)
    _equal(parsed, parse_kernel.parse_tokens_reference(comp, comp_len, C))
    mark, ll, ml, _ = parsed
    _equal(records_kernel.records_to_state(comp, mark, ll, ml, comp_len,
                                           out_len, pre, C, D),
           records_kernel.records_to_state_reference(
               comp, mark, ll, ml, comp_len, out_len, pre, C, D))
    got = dv.decode_batch_vectorized(comp, comp_len, out_len, C, D)
    want = dv.decode_batch_vectorized(comp.cpu(), comp_len.cpu(),
                                      out_len.cpu(), C, D)
    _equal(got, want)
    # marks outside {0, 1} give unspecified outputs but no memory fault
    records_kernel.records_to_state(comp, 3 * mark - 1, ll, ml, comp_len,
                                    out_len, pre, C, D)
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_decode_batch_on_the_card(cuda, blocks):
    plain, packed = blocks
    before = [m.launches for m in KERNELS]
    dec = cuda_engine.decoder(cuda)
    hosted = dec.host_decodes
    assert codec.decode_batch(packed, [len(b) for b in plain]) == plain
    assert dec.host_decodes == hosted
    assert all(m.launches > n for m, n in zip(KERNELS, before))
    with pytest.raises(reference.CorruptedBlockError):
        codec.decode(packed[0][:100], len(plain[0]))
