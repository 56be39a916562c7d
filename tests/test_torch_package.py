"""Package rules of the CUDA port, and its kernels against their plain
versions on the card.

The card tests carry the ``gpu`` marker and skip without a CUDA device;
on a machine with one (no JAX needed) run them with

    python -m pytest --noconftest -m gpu tests/test_torch_package.py
"""

import ast
import io
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from lz4net_tpu_torch import __main__ as cli  # noqa: E402
from lz4net_tpu_torch import codec, registry, stream  # noqa: E402
from lz4net_tpu_torch.models import cuda as cuda_engine  # noqa: E402
from lz4net_tpu_torch.models import native, reference  # noqa: E402
from lz4net_tpu_torch.models.service_adapters import CudaService  # noqa
from lz4net_tpu_torch.ops import decode_vector as dv  # noqa: E402
from lz4net_tpu_torch.ops import encode_vector as ev  # noqa: E402
from lz4net_tpu_torch.ops import decode_sequencer as ds  # noqa: E402
from lz4net_tpu_torch.ops import encode_sequencer as es  # noqa: E402
from lz4net_tpu_torch.ops import (chain_kernel, emit_kernel,  # noqa: E402
                                  fused_gather, hash_kernel, mlen_kernel,
                                  parse_kernel, records_kernel,
                                  resolve_kernel, seq_kernel)
from lz4net_tpu_torch.utils import corpus  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
DECODE_KERNELS = (parse_kernel, records_kernel, fused_gather, resolve_kernel)
# the encode path's four kernels, and the gather it shares with decode
ENCODE_KERNELS = (hash_kernel, mlen_kernel, seq_kernel, emit_kernel,
                  fused_gather)
KERNELS = DECODE_KERNELS + ENCODE_KERNELS[:4] + (es, ds, chain_kernel)


def _counts():
    """Every kernel's launch count (a module with several kernels keeps
    one counter each)."""
    return [m.launches for m in KERNELS] + [
        hash_kernel.hc_launches, fused_gather.table_launches,
        fused_gather.lane_launches, fused_gather.diag_launches]


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
    assert len(files) >= 17
    assert {ROOT / "lz4net_tpu_torch" / "parallel" / f"{n}.py" for n in (
        "__init__", "distributed", "mesh", "pipeline")} <= set(files)
    assert ROOT / "lz4net_tpu_torch" / "models" / "native.py" in files
    for path in files:
        for mod in _imported_modules(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "lz4net_tpu"), (path, mod)


def test_every_kernel_has_its_source_and_entry():
    from lz4net_tpu_torch import _build
    names = {p.stem for p in (ROOT / "lz4net_tpu_torch" / "csrc").glob("*.cu")}
    assert names == {"parse_kernel", "records_kernel", "fused_gather",
                     "resolve_kernel", "hash_kernel", "mlen_kernel",
                     "seq_kernel", "emit_kernel", "hc_kernel",
                     "encode_sequencer", "decode_sequencer", "chain_kernel"}
    assert set(_build.SIGNATURES) == {
        "lz4t_parse_tokens", "lz4t_records_to_state",
        "lz4t_rowbase_gather", "lz4t_resolve_wavefront",
        "lz4t_bucket_prev", "lz4t_match_lengths", "lz4t_sequence_records",
        "lz4t_emit_bytes", "lz4t_hc_tables", "lz4t_encode_sequencer",
        "lz4t_encode_sequencer_row_max", "lz4t_decode_sequencer",
        "lz4t_decode_sequencer_row_max", "lz4t_mark_chain",
        "lz4t_table_gather", "lz4t_lane_lookup", "lz4t_diag_gather"}
    assert all(n >= 0 for n in _counts())


def test_the_host_library_is_the_ports_own():
    """The native engine loads the library built from the port's copy of
    the C++ oracle under ``lz4net_tpu_torch/_build/host-<digest>/``, never
    the JAX package's ``lz4net_tpu/native/liblz4tpu.so``, and exports
    only ``lz4h_`` symbols."""
    from lz4net_tpu_torch.models import native
    lib = native._load()
    path = pathlib.Path(lib._name).resolve()
    assert path.parent.parent == ROOT / "lz4net_tpu_torch" / "_build"
    assert path.parent.name.startswith("host-")
    assert path.name == "liblz4h.so"
    assert ROOT / "lz4net_tpu" not in path.parents
    assert pathlib.Path(native.SOURCE).resolve() == \
        ROOT / "lz4net_tpu_torch" / "native" / "lz4_oracle.cpp"
    assert all(n.startswith("lz4h_") for n in native.SIGNATURES)
    for name in native.SIGNATURES:
        getattr(lib, name)
    with pytest.raises(AttributeError):
        lib.lz4tpu_compress
    assert "liblz4tpu" not in (ROOT / "lz4net_tpu_torch" / "models"
                               / "native.py").read_text()


def test_a_failed_host_build_raises(monkeypatch, tmp_path):
    """No compiler, or a source it refuses: ``build`` raises
    RuntimeError with the cause, and nothing is built."""
    from lz4net_tpu_torch.models import native
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    with pytest.raises(RuntimeError, match="no-such-compiler"):
        native.build()
    monkeypatch.delenv("CXX")
    bad = tmp_path / "lz4_oracle.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", str(bad))
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "_build"))
    with pytest.raises(RuntimeError, match="(?s)cannot be built.*error: "):
        native.build()
    assert not list((tmp_path / "_build").rglob("*.so"))


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
    with pytest.raises(RuntimeError, match="cuda"):
        ev.VectorEncoder()
    with pytest.raises(RuntimeError, match="cuda"):
        cuda_engine.compress_blocks_fast([b"abc" * 10])
    with pytest.raises(RuntimeError, match="cuda"):
        codec.encode(b"abc" * 10, mode="fast")
    with pytest.raises(RuntimeError, match="cuda"):
        codec.encode(b"abc" * 10)
    with pytest.raises(RuntimeError, match="cuda"):
        CudaService().encode(b"abc" * 10, 100)
    with pytest.raises(RuntimeError, match="cuda"):
        cuda_engine.compress_blocks([b"abc" * 10])
    with pytest.raises(RuntimeError, match="cuda"):
        ds.SequencerDecoder()
    # the dictionary, unknown-length, strict HC and envelope entry points
    with pytest.raises(RuntimeError, match="cuda"):
        codec.decode(b"\x10x", max_output_length=5)
    with pytest.raises(RuntimeError, match="cuda"):
        codec.decode(b"\x10x", 1, dictionary=b"ab")
    with pytest.raises(RuntimeError, match="cuda"):
        codec.encode(b"abc" * 10, dictionary=b"abc")
    with pytest.raises(RuntimeError, match="cuda"):
        codec.encode_hc(b"abc" * 10)
    with pytest.raises(RuntimeError, match="cuda"):
        codec.encode_hc(b"abc" * 10, dictionary=b"abc", mode="fast")
    with pytest.raises(RuntimeError, match="cuda"):
        codec.wrap(b"abc" * 10)
    with pytest.raises(RuntimeError, match="cuda"):
        codec.unwrap(codec.wrap(b"abc" * 10, device="cpu"))
    with pytest.raises(RuntimeError, match="cuda"):
        cuda_engine.compress_blocks_fast_dict([b"abc" * 10], b"abc")
    with pytest.raises(RuntimeError, match="cuda"):
        cuda_engine.decompress_blocks_dict([b"\x10x"], [1], b"ab")
    # the stream, the engine selection and the command line
    with pytest.raises(RuntimeError, match="cuda"):
        registry.initialize()
    with pytest.raises(RuntimeError, match="cuda"):
        codec.codec_name()
    with pytest.raises(RuntimeError, match="cuda"):
        stream.compress_stream(b"abc" * 10)
    with pytest.raises(RuntimeError, match="cuda"):
        stream.decompress_stream(stream.compress_stream(b"abc" * 10,
                                                        device="cpu"))
    with pytest.raises(RuntimeError, match="cuda"):
        stream.LZ4Stream(io.BytesIO(), stream.LZ4StreamMode.COMPRESS).write(
            b"abc" * 10 ** 6)
    with pytest.raises(RuntimeError, match="cuda"):
        cli.main(["info"])


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
    with pytest.raises(ValueError, match="device"):
        hash_kernel.bucket_prev(meta, meta, meta, meta, 4096)
    dks = torch.zeros((1, 8), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="device"):
        mlen_kernel.match_lengths_fused(meta, meta, meta, meta, dks, lens,
                                        lens, 4096, 512)
    with pytest.raises(ValueError, match="device"):
        seq_kernel.sequence_records(meta, meta, meta, meta, lens, lens, 4096,
                                    1152)
    with pytest.raises(ValueError, match="device"):
        emit_kernel.emit_bytes(meta, meta, meta, meta, meta, lens, 8192)
    with pytest.raises(ValueError, match="device"):
        hash_kernel.hc_tables(meta, [meta], [False], [8], 4096)
    meta8 = meta.to(torch.uint8)
    with pytest.raises(ValueError, match="device"):
        es.encode_sequencer(meta8, lens, lens, 64)
    with pytest.raises(ValueError, match="device"):
        ds.decode_sequencer(meta8, lens, lens, 64)
    with pytest.raises(ValueError, match="device"):
        chain_kernel.mark_chain(meta, 4096)
    with pytest.raises(ValueError, match="device"):
        fused_gather.table_gather([meta], meta, (17,))
    with pytest.raises(ValueError, match="device"):
        fused_gather.lane_lookup(meta.reshape(32, 128), meta.reshape(32, 128))
    with pytest.raises(ValueError, match="device"):
        fused_gather.diag_gather(meta, meta, 1, 16)


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
    before = _counts()
    data = b"abcdefgh" * 500
    got = codec.decode_batch([reference.compress_block(data)], [len(data)],
                             device="cpu")
    assert got == [data]
    packed = cuda_engine.compress_blocks_fast([data], device="cpu")
    assert reference.decompress_block(packed[0], len(data)) == data
    assert codec.encode(data, mode="fast", device="cpu") == packed[0]
    for level in (5, 9):
        hc = codec.encode_hc(data, level=level, mode="fast", device="cpu")
        assert reference.decompress_block(hc, len(data)) == data
    strict = codec.encode(data, device="cpu")
    assert strict == reference.compress_block(data)
    assert ds.SequencerDecoder("cpu").decode_batch([strict], [len(data)]) \
        == [data]
    x, dl, D = _x_on("cpu", [data])
    _, O, S_cap = ev.batch_shapes(len(data))
    out, out_len, _, _ = ev.encode_batch_chain(x, dl, D, O, S_cap)
    assert out[0, :int(out_len[0])].to(torch.uint8).numpy().tobytes() \
        == packed[0]
    window = data[:1000]
    packed = cuda_engine.compress_blocks_fast_dict([data], window,
                                                   device="cpu")
    assert codec.decode(packed[0], len(data), dictionary=window,
                        device="cpu") == data
    assert codec.decode(strict, max_output_length=len(data) + 9,
                        device="cpu") == data
    assert codec.unwrap(codec.wrap(data, device="cpu"), device="cpu") \
        == data
    t = torch.zeros((2, 256), dtype=torch.int32)
    chain_kernel.mark_chain(t + 1, 256)
    fused_gather.lane_lookup(t.reshape(4, 128), t.reshape(4, 128))
    fused_gather.diag_gather(t, t, 1, 16)
    assert _counts() == before


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
    ends, want_ends = (torch.full((len(plain), 4), -7, dtype=torch.int32,
                                  device=cuda) for _ in range(2))
    rec = records_kernel.records_to_state(comp, mark, ll, ml, comp_len,
                                          out_len, pre, C, D, 0, ends)
    _equal(rec, records_kernel.records_to_state_reference(
        comp, mark, ll, ml, comp_len, out_len, pre, C, D, 0, want_ends))
    _equal([ends], [want_ends])
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
    got = dv.device_pass(comp, comp_len, out_len, C, D)
    want = dv.device_pass(comp.cpu(), comp_len.cpu(), out_len.cpu(), C, D)
    _equal(got, want)
    # marks outside {0, 1} give unspecified outputs but no memory fault
    records_kernel.records_to_state(comp, 3 * mark - 1, ll, ml, comp_len,
                                    out_len, pre, C, D)
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_decode_batch_on_the_card(cuda, blocks):
    plain, packed = blocks
    before = [m.launches for m in DECODE_KERNELS]
    dec = cuda_engine.decoder(cuda)
    hosted = dec.host_decodes
    assert codec.decode_batch(packed, [len(b) for b in plain]) == plain
    assert dec.host_decodes == hosted
    assert all(m.launches > n for m, n in zip(DECODE_KERNELS, before))
    with pytest.raises(reference.CorruptedBlockError):
        codec.decode(packed[0][:100], len(plain[0]))


def _encode_stages(x, dl, rcap=4096):
    """Every encode kernel's plain version on x [B, D] (the card's
    tensors), returning each kernel's inputs and the plain outputs."""
    B, D = x.shape
    _, O, S_cap = ev.batch_shapes(int(dl.max()))
    u32 = ev._u32(x)
    us4 = ev._shift_left(u32, 4)
    hargs = (u32, us4, hash_kernel.hash_bucket(u32),
             hash_kernel.hash_bucket8(u32, us4), D)
    prev = hash_kernel.bucket_prev_reference(*hargs)
    off = torch.arange(D, dtype=torch.int32, device=x.device) - prev
    dks = ev._top_offsets_select(off, (prev >= 0) & (off <= 65535)
                                 & (off > 4))
    margs = (x, u32, prev, torch.zeros_like(prev), dks, dl, dl, D, rcap)
    mlen = mlen_kernel.match_lengths_reference(*margs)
    sargs = (u32, *mlen, dl, torch.zeros_like(dl), D, S_cap)
    seq = seq_kernel.sequence_records_reference(*sargs)
    eargs = (*seq[:5], seq[5][:, 2].contiguous(), O)
    return [(hash_kernel.bucket_prev, hargs, prev),
            (mlen_kernel.match_lengths_fused, margs, mlen),
            (seq_kernel.sequence_records, sargs, seq),
            (emit_kernel.emit_bytes, eargs,
             emit_kernel.emit_bytes_reference(*eargs))]


@pytest.mark.gpu
def test_encode_kernels_match_plain_versions_on_the_card(cuda, blocks):
    plain, _ = blocks
    D, _, _ = ev.batch_shapes(max(map(len, plain)))
    x = np.zeros((len(plain), D), np.uint8)
    for j, b in enumerate(plain):
        x[j, :len(b)] = np.frombuffer(b, np.uint8)
    x = torch.from_numpy(x).to(cuda).to(torch.int32)
    dl = torch.tensor([len(b) for b in plain], dtype=torch.int32,
                      device=cuda)
    for kernel, args, want in _encode_stages(x, dl):
        _equal(kernel(*args), want)


@pytest.mark.gpu
def test_encode_kernels_match_plain_versions_on_junk(cuda):
    """Seeded random operands that no encoder would produce: prev
    anywhere in [-3, D), bucket ids crowded into 64 buckets, matches of
    length 0, unsorted offsets, records of random sizes."""
    rng = np.random.default_rng(9)
    B, D, S_cap = 3, 8192, 2304

    def t(a):
        return torch.from_numpy(np.asarray(a, np.int32)).to(cuda)

    x = t(rng.integers(0, 4, (B, D)))
    u32 = ev._u32(x)
    words = t(rng.integers(-2**31, 2**31, (B, D), np.int64) % 7)
    h = t(rng.integers(0, 64, (B, D)))
    args = (words, torch.roll(words, 3, 1), h, h.flip(1).contiguous(), D)
    _equal(hash_kernel.bucket_prev(*args),
           hash_kernel.bucket_prev_reference(*args))
    prev = t(rng.integers(-3, D, (B, D)))
    m8 = t(rng.integers(0, 2, (B, D)))
    dks = t(rng.integers(0, 40, (B, 8)))
    lens = t([D, D - 100, 5])
    args = (x, u32, prev, m8, dks, lens, lens, D, 64)
    _equal(mlen_kernel.match_lengths_fused(*args),
           mlen_kernel.match_lengths_reference(*args))
    matched = t(rng.integers(0, 2, (B, D)))
    args = (u32, matched, t(rng.integers(0, 300, (B, D))),
            t(rng.integers(0, 40, (B, D))), t([D, D // 2, 100]),
            t([0, 0, 0]), D, S_cap)
    _equal(seq_kernel.sequence_records(*args),
           seq_kernel.sequence_records_reference(*args))
    S = 8192
    live = [S, 3000, 0]
    size = t(rng.integers(1, 40, (B, S)))
    s0 = torch.cumsum(size, 1, dtype=torch.int32) - size
    s0 = torch.where(torch.arange(S, device=cuda)[None, :]
                     < t(live)[:, None], s0, emit_kernel.BIGKEY)
    fields = [t(rng.integers(0, hi, (B, S))) for hi in (9000, 300, 70000,
                                                        600)]
    args = (s0, *fields, t([20000, 60000, 50]), 65536)
    _equal(emit_kernel.emit_bytes(*args),
           emit_kernel.emit_bytes_reference(*args))


@pytest.mark.gpu
def test_compress_blocks_fast_on_the_card(cuda, blocks):
    plain, _ = blocks
    before = [m.launches for m in ENCODE_KERNELS]
    enc = cuda_engine.encoder(cuda)
    hosted = enc.host_encodes
    got = cuda_engine.compress_blocks_fast(plain)
    assert enc.host_encodes == hosted
    assert all(m.launches > n for m, n in zip(ENCODE_KERNELS, before))
    assert got == ev.VectorEncoder(device="cpu").encode_batch(plain)
    assert [reference.decompress_block(p, len(b))
            for p, b in zip(got, plain)] == plain
    assert codec.decode_batch(got, [len(b) for b in plain]) == plain
    assert codec.encode(plain[0], mode="fast") == got[0]


def _x_on(cuda, plain):
    D, _, _ = ev.batch_shapes(max(map(len, plain)))
    x = np.zeros((len(plain), D), np.uint8)
    for j, b in enumerate(plain):
        x[j, :len(b)] = np.frombuffer(b, np.uint8)
    dl = torch.tensor([len(b) for b in plain], dtype=torch.int32,
                      device=cuda)
    return torch.from_numpy(x).to(cuda).to(torch.int32), dl, D


@pytest.mark.gpu
def test_hc_tables_match_plain_version_on_the_card(cuda, blocks):
    """The suffix tiers' three run tables and the hash tiers' seven."""
    plain, _ = blocks
    x, _, D = _x_on(cuda, plain)
    u32 = ev._u32(x)
    us4 = ev._shift_left(u32, 4)
    run_fwd, is_rs = ev._byte_runs(x)
    for tables in ("runs", None):
        before = hash_kernel.hc_launches
        got = hash_kernel.hc_candidates(x, u32, us4, is_rs, run_fwd, D,
                                        tables)
        assert hash_kernel.hc_launches == before + 1
        cpu = [t.cpu() for t in (x, u32, us4, is_rs, run_fwd)]
        _equal(got, hash_kernel.hc_candidates(*cpu, D, tables))
    # junk: bucket ids crowded into 40 buckets, sticky and run-sized tables
    rng = np.random.default_rng(3)
    words = torch.from_numpy(rng.integers(0, 3, (3, 8192), np.int32)).to(
        cuda)
    hs = [torch.from_numpy(rng.integers(0, 40, (3, 8192), np.int32)).to(
        cuda) for _ in range(3)]
    args = (words, hs, (False, True, False), (64, 64, 8), 8192)
    _equal(hash_kernel.hc_tables(*args),
           hash_kernel.hc_tables_reference(*args))


@pytest.mark.gpu
def test_hc_match_lengths_and_catch_up_on_the_card(cuda, blocks):
    """match_lengths with 24 dominant offsets on a suffix tier's
    candidates, and sequence_records with 8 catch-up rounds."""
    plain, _ = blocks
    x, dl, D = _x_on(cuda, plain)
    u32 = ev._u32(x)
    us4 = ev._shift_left(u32, 4)
    cand, _ = ev._suffix_candidates((u32, us4) + tuple(
        ev._shift_left(u32, 4 * k) for k in range(2, 8)))
    i = torch.arange(D, dtype=torch.int32, device=cuda)
    prev = torch.where(cand >= 0, cand, ev._prev_occurrence((u32,)))
    off = i - prev
    dks = ev._top_offsets_select(off, (prev >= 0) & (off <= 65535)
                                 & (off > 4), 24, 8)
    assert dks.shape[1] == 24
    margs = (x, u32, prev, torch.zeros_like(prev), dks, dl, dl, D,
             ev.hc_rcap(9, D))
    mlen = mlen_kernel.match_lengths_fused(*margs)
    _equal(mlen, mlen_kernel.match_lengths_reference(*margs))
    _, _, S_cap = ev.batch_shapes(int(dl.max()))
    sargs = (u32, *mlen, dl, torch.zeros_like(dl), D, S_cap, 0,
             ev.HC_CU_ROUNDS)
    _equal(seq_kernel.sequence_records(*sargs),
           seq_kernel.sequence_records_reference(*sargs))


@pytest.mark.gpu
def test_compress_blocks_hc_fast_on_the_card(cuda, blocks):
    plain, _ = blocks
    enc = cuda_engine.encoder(cuda)
    for level, tiers in ((9, None), (5, None), (5, "hash")):
        hosted = enc.host_encodes
        before = hash_kernel.hc_launches
        got = enc.encode_batch(plain, hc_level=level, hc_tiers=tiers)
        assert enc.host_encodes == hosted
        assert (hash_kernel.hc_launches > before) == (level < 8)
        assert got == ev.VectorEncoder(device="cpu").encode_batch(
            plain[:2], hc_level=level, hc_tiers=tiers) + got[2:]
        assert codec.decode_batch(got, [len(b) for b in plain]) == plain
    assert codec.encode_hc(plain[0], mode="fast") \
        == cuda_engine.compress_blocks_hc_fast(plain[:1])[0]


def _rows(rows, width=None):
    """rows as a [B, width] uint8 tensor (zero padded) and their lengths."""
    width = width or max(map(len, rows))
    x = np.zeros((len(rows), width), np.uint8)
    for j, r in enumerate(rows):
        x[j, :len(r)] = np.frombuffer(r, np.uint8)
    return (torch.from_numpy(x),
            torch.tensor([len(r) for r in rows], dtype=torch.int32))


def _junk_rows():
    rng = np.random.default_rng(5)
    return [rng.integers(0, 256, 4000, np.uint8).tobytes(),
            rng.integers(0, 256, 9000, np.uint8).tobytes(),
            b"\xff" * 3000,
            reference.compress_block(b"abc" * 3000)[:50]]


@pytest.mark.gpu
def test_encode_sequencer_matches_plain_version_on_the_card(cuda, blocks):
    """The 512 KB corpus at the worst-case budget, then the junk rows as
    sources with budgets and an O that some payloads overflow."""
    plain, packed = blocks
    src, lens = _rows(plain)
    cap = torch.tensor([n + n // 255 + 16 for n in lens.tolist()],
                       dtype=torch.int32)
    for src, lens, cap, O in (
            (src, lens, cap, int(cap.max())),
            (*_rows(_junk_rows()), torch.tensor([4100, 9000, 40, 10],
                                                dtype=torch.int32), 4200)):
        before = es.launches
        out, written = es.encode_sequencer(src.to(cuda), lens.to(cuda),
                                           cap.to(cuda), O)
        assert es.launches == before + 1
        want, want_written = es.encode_sequencer_reference(src, lens, cap, O)
        _equal([written], [want_written])
        # a row is defined up to its payload's length
        for got_row, want_row, n in zip(out.cpu(), want,
                                        want_written.tolist()):
            assert torch.equal(got_row[:max(n, 0)], want_row[:max(n, 0)])
    assert cuda_engine.compress_blocks(plain) == packed
    assert codec.encode(plain[0]) == packed[0]


@pytest.mark.gpu
def test_decode_sequencer_matches_plain_version_on_the_card(cuda, blocks):
    """The 512 KB corpus compressed, then the junk rows, a block ending in
    a match and one with offset 0: status and bytes equal."""
    plain, packed = blocks
    out_lens = torch.tensor([len(b) for b in plain], dtype=torch.int32)
    off0 = bytearray(reference.compress_block(b"abcd" * 50))
    off0[5:7] = b"\x00\x00"
    for rows, n in ((packed, out_lens),
                    (_junk_rows() + [b"\x15a\x01\x00", bytes(off0)],
                     torch.tensor([9000, 20000, 4000, 9000, 10, 200],
                                  dtype=torch.int32))):
        comp, comp_len = _rows(rows)
        D = int(n.max())
        before = ds.launches
        got = ds.decode_sequencer(comp.to(cuda), comp_len.to(cuda),
                                  n.to(cuda), D)
        assert ds.launches == before + 1
        _equal(got, ds.decode_sequencer_reference(comp, comp_len, n, D))
    dec = ds.SequencerDecoder()
    assert dec.decode_batch(packed, out_lens.tolist()) == plain
    with pytest.raises(reference.CorruptedBlockError):
        dec.decode_batch([packed[0][:100]], [len(plain[0])])


@pytest.mark.gpu
def test_mark_chain_matches_plain_version_on_the_card(cuda, blocks):
    """The chain graphs of the 512 KB corpus's match state, then junk:
    g[i] = i + 1, steps past D and back, steps over 16 bits."""
    plain, _ = blocks
    x, dl, D = _x_on(cuda, plain)
    _, matched, _, mlen = ev._match_stage(x, dl, D, ev.RCAP, 0, None)
    g = seq_kernel.chain_graph(matched == 1, mlen, D)
    rng = np.random.default_rng(4)
    junk = torch.from_numpy(np.stack([
        np.arange(1, D + 1),
        np.where(np.arange(D) % 3, np.arange(D) + 70000, 5),
        rng.integers(-5, D + 9, D)]).astype(np.int32)).to(cuda)
    for graph in (g, junk):
        before = chain_kernel.launches
        got = chain_kernel.mark_chain(graph, D)
        assert chain_kernel.launches == before + 1
        _equal([got], [chain_kernel.mark_chain_reference(graph, D)])
    assert int(got[0].sum()) == D


@pytest.mark.gpu
def test_gathers_match_plain_versions_on_the_card(cuda):
    """table_gather with 1-4 tables and indices on every side of the
    table, lane_lookup, and diag_gather in and out of its band."""
    rng = np.random.default_rng(6)

    def t(a):
        return torch.from_numpy(np.asarray(a, np.int32)).to(cuda)

    B, N, K = 3, 8192, 3000
    tables = [t(rng.integers(-2**31, 2**31, (B, N), np.int64))
              for _ in range(4)]
    idx = t(rng.integers(-1000, N + 1000, (B, K)))
    for bits in ((17,), (17, 17), (32, 21, 8), (17, 17, 17, 17)):
        before = fused_gather.table_launches
        got = fused_gather.table_gather(tables[:len(bits)], idx, bits)
        assert fused_gather.table_launches == before + 1
        _equal(got, fused_gather.table_gather_reference(
            tables[:len(bits)], idx, bits))
    lt, li = t(rng.integers(-2**31, 2**31, (B, 40, 128), np.int64)), \
        t(rng.integers(-500, 500, (B, 40, 128)))
    _equal([fused_gather.lane_lookup(lt, li)],
           [fused_gather.lane_lookup_reference(lt, li)])
    q = np.arange(N)[None, :]
    didx = t(q + rng.integers(-3 * 128, 18 * 128, (B, N)))
    for back, w in ((1, 16), (0, 1), (4, 3)):
        _equal(fused_gather.diag_gather(tables[0], didx, back, w),
               fused_gather.diag_gather_reference(tables[0], didx, back, w))


@pytest.mark.gpu
def test_encode_batch_chain_on_the_card(cuda, blocks):
    """The chain record path gives the sequence path's bytes, fast and at
    HC level 9, with its kernels launched as often as the path says."""
    plain, _ = blocks
    x, dl, D = _x_on(cuda, plain)
    _, O, S_cap = ev.batch_shapes(int(dl.max()))
    for level, gathers in ((0, 7), (9, 19)):
        rcap = ev.hc_rcap(level, D)
        before = (chain_kernel.launches, fused_gather.table_launches,
                  seq_kernel.launches)
        got = ev.encode_batch_chain(x, dl, D, O, S_cap, rcap, level)
        assert (chain_kernel.launches, fused_gather.table_launches,
                seq_kernel.launches) == (before[0] + 1,
                                         before[1] + gathers, before[2])
        _equal(got, ev.encode_batch_vectorized(x, dl, D, O, S_cap, rcap,
                                               level))
        assert bool(got[2].all())


@pytest.mark.gpu
def test_stream_and_block_end_rules_on_the_card(cuda, blocks):
    """An LZ4Stream round trip through the registry's engines on the card
    (frames equal to the CPU path's, no host decode), and the block-end
    rules: ``corpus.block_end_rows`` and ``big_bad_blocks`` give the
    reference decoders' bytes or errors on each path."""
    plain, _ = blocks
    data = b"".join(plain)
    dec = cuda_engine.decoder(cuda)
    hosted = dec.host_decodes
    framed = stream.compress_stream(data, block_size=1 << 16)
    assert framed == stream.compress_stream(data, block_size=1 << 16,
                                            device="cpu")
    assert stream.decompress_stream(framed) == data
    assert dec.host_decodes == hosted

    def outcome(call):
        try:
            return call()
        except reference.CorruptedBlockError as exc:
            return str(exc)

    small = reference.compress_block(corpus.silesia_like(30000, seed=3))
    rows = corpus.block_end_rows() + [
        (name, blk, 29990) for name, blk in corpus.big_bad_blocks(small)]
    window = corpus.silesia_like(5000, seed=21)
    for name, blk, n in rows:
        assert outcome(lambda: dec.decode_batch([blk], [n])[0]) == \
            outcome(lambda: reference.decompress_block(blk, n)), name
        assert outcome(lambda: dec.decode_batch(
            [blk], [n], dictionary=window)[0]) == outcome(
            lambda: reference.decompress_block_dict(blk, window, n)), name
        for cap in (n, n + 1, 96 * 1024, 2 << 20):
            assert outcome(lambda: dec.decode_batch_unknown(
                [blk], [cap])[0]) == outcome(
                lambda: reference.decompress_block_unknown(blk, cap)), name


@pytest.mark.gpu
def test_stream_write_makes_one_launch_a_write_on_the_card(cuda):
    """An 8 MB write at 1 MB chunks encodes its 8 chunks in one
    ``encode_sequencer`` launch, and its frames hold the reference
    compressor's payloads (the native host engine's)."""
    data = corpus.silesia_like(8 << 20, seed=31)
    chunk = 1 << 20
    codec.codec_name(device=cuda)           # the AutoTest's launches first
    before = es.launches
    framed = stream.compress_stream(data, block_size=chunk, device=cuda)
    assert es.launches == before + 1
    want = io.BytesIO()
    for i in range(0, len(data), chunk):
        raw = data[i:i + chunk]
        packed = native.compress_block(raw, len(raw))
        assert 0 < len(packed) < len(raw)
        for v in (1, len(raw), len(packed)):   # flags: compressed
            stream.write_varint(want, v)
        want.write(packed)
    assert framed == want.getvalue()
    assert stream.decompress_stream(framed, device=cuda) == data


@pytest.mark.gpu
def test_parallel_pipeline_on_the_card(cuda, blocks):
    """The pipeline in a world of one on NCCL: sharded strict encode and
    sequencer decode give the plain versions' bytes, the dictionary form
    certifies every block, and a mesh on the CPU over that group raises
    (no move to gloo)."""
    import torch.distributed as dist
    from lz4net_tpu_torch import maximum_output_length
    from lz4net_tpu_torch.parallel import mesh as pmesh
    from lz4net_tpu_torch.parallel import pipeline

    plain, packed = blocks
    lens = [len(b) for b in plain]
    assert not dist.is_initialized()
    mesh = pmesh.make_mesh()
    try:
        assert (dist.get_backend(), mesh.device_type) == ("nccl", "cuda")
        with pytest.raises(ValueError, match="nccl"):
            pmesh.make_mesh(device="cpu")
        shard = pmesh.block_sharding(mesh)
        caps = [maximum_output_length(len(b)) for b in plain]
        src, elens, S, O, _ = pipeline.pack_blocks(plain, caps)
        out, written, total = pipeline.make_distributed_encode(
            mesh, len(plain), S, O)(shard(src), shard(elens))
        assert [out[i, :w].cpu().numpy().tobytes()
                for i, w in enumerate(written.tolist())] == packed
        assert int(total) == sum(map(len, packed))
        launched = ds.launches
        assert pipeline.distributed_decode(packed, lens, mesh) == plain
        assert ds.launches == launched + 1
        dictionary = plain[0][:20000]
        dpay = [reference.compress_block_dict(dictionary, b[:3000])
                for b in plain[1:]]
        hosted = pipeline.host_decodes
        assert pipeline.distributed_decode_dict(
            dpay, [3000] * len(dpay), dictionary, mesh) == \
            [b[:3000] for b in plain[1:]]
        assert pipeline.host_decodes == hosted
    finally:
        dist.destroy_process_group()
