"""The port's data-parallel pipeline (``lz4net_tpu_torch.parallel``) on the
CPU, in a world of one over gloo, held against the JAX package's
pipeline on its 8-device CPU mesh (``tests/test_parallel.py``'s shapes,
one JAX compile for each form), its reference decoder and its
compressors.

The rule for a sequencer row (``parallel.pipeline``'s docstring) is held
against the JAX package's ``reference.decompress_block`` on
``corpus.decode_edge_rows``, the junk rows of
``tests/test_torch_strict_decode.py`` and mutations of real blocks: the
pipeline returns exactly where that decoder returns, the same bytes, and
raises where it raises.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # the test workers share the cores: one intra-op
                           # thread each, or they spin against each other

import torch.distributed as dist  # noqa: E402

from lz4net_tpu.models import native  # noqa: E402
from lz4net_tpu.models import reference as jreference  # noqa: E402
from lz4net_tpu.ops import decode_pallas  # noqa: E402
from lz4net_tpu.parallel import mesh as jmesh  # noqa: E402
from lz4net_tpu.parallel import pipeline as jpipeline  # noqa: E402
import lz4net_tpu_torch as lz4t  # noqa: E402
from lz4net_tpu_torch.constants import maximum_output_length  # noqa: E402
from lz4net_tpu_torch.models import reference  # noqa: E402
from lz4net_tpu_torch.ops import decode_sequencer as ds  # noqa: E402
from lz4net_tpu_torch.ops import host_rows  # noqa: E402
from lz4net_tpu_torch.parallel import distributed  # noqa: E402
from lz4net_tpu_torch.parallel import mesh as pmesh  # noqa: E402
from lz4net_tpu_torch.parallel import pipeline  # noqa: E402
from lz4net_tpu_torch.utils import corpus  # noqa: E402
from test_torch_strict_decode import JUNK  # noqa: E402


@pytest.fixture(scope="module")
def mesh():
    """A world of one over gloo, destroyed at teardown so that the next
    test file of this worker starts without a process group."""
    assert not dist.is_initialized()
    m = pmesh.make_mesh(device="cpu")
    yield m
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def jax_mesh():
    return jmesh.make_mesh(8)


def _outcome(decode, *args):
    try:
        return decode(*args)
    except ValueError as exc:     # CorruptedBlockError of either package
        assert type(exc).__name__ == "CorruptedBlockError", exc
        return "raised"


def test_mesh_shape(mesh):
    assert mesh.size() == 1 and mesh.device_type == "cpu"
    assert mesh.mesh_dim_names == (pmesh.BLOCK_AXIS,) == ("blocks",)
    assert dist.get_backend() == "gloo"
    again = pmesh.make_mesh(1, device="cpu")      # the same group, reused
    assert again.size() == 1 and dist.get_world_size() == 1
    with pytest.raises(ValueError, match="world"):
        pmesh.make_mesh(8, device="cpu")
    assert not distributed.is_multihost()
    distributed.initialize("127.0.0.1:1", 4, 3, device="cpu")  # idempotent
    assert dist.get_world_size() == 1
    rows = np.arange(12).reshape(6, 2)
    assert pmesh.block_sharding(mesh)(rows).tolist() == rows.tolist()
    x = torch.arange(5, dtype=torch.int32)
    y = pmesh.replicated(mesh)(x)
    assert y.tolist() == x.tolist() and y.data_ptr() != x.data_ptr()


def test_initialize_arguments(monkeypatch):
    """With nothing to join it returns; a partial set of arguments
    raises; torchrun's variables fill the arguments in."""
    monkeypatch.setattr(distributed.dist, "is_initialized", lambda: False)
    calls = []
    monkeypatch.setattr(distributed.dist, "init_process_group",
                        lambda *a, **k: calls.append((a, k)))
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    distributed.initialize(device="cpu")
    assert calls == []
    with pytest.raises(ValueError, match="coordinator"):
        distributed.initialize(num_processes=2, device="cpu")
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("MASTER_PORT", "29511")
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "1")
    distributed.initialize(device="cpu", timeout_s=7)
    (args, kw), = calls
    assert args == ("gloo",)
    assert kw["init_method"] == "tcp://127.0.0.1:29511"
    assert (kw["world_size"], kw["rank"]) == (2, 1)
    assert kw["timeout"].total_seconds() == 7


def test_the_card_is_the_default_and_raises_without_one(mesh):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    blk = jreference.compress_block(b"abc" * 30)
    for call in (lambda: pmesh.make_mesh(),
                 lambda: pipeline.distributed_decode([blk], [90]),
                 lambda: pipeline.distributed_decode_dict([blk], [90], b"d"),
                 lambda: ds.decompress_block(blk, 90)):
        with pytest.raises(RuntimeError, match="cuda"):
            call()
    assert dist.get_backend() == "gloo"    # the CPU's group is untouched


def test_distributed_decode_matches_jax(mesh, jax_mesh):
    """5 ragged blocks (3 pad rows on the JAX mesh), one of them with two
    trailing bytes, which the reference decoder accepts: the JAX
    pipeline's bytes, the reference decoder's bytes."""
    data = corpus.silesia_like(5 * 1500, seed=4)
    blocks = corpus.split_blocks(data, 1500)
    packed = [native.compress_block(b) for b in blocks]
    packed[3] += b"\x00\x00"
    lens = [len(b) for b in blocks]
    want = jpipeline.distributed_decode(packed, lens, jax_mesh)
    assert pipeline.distributed_decode(packed, lens, mesh) == want == blocks
    assert want[3] == jreference.decompress_block(packed[3], lens[3])


def test_decode_step_total_and_pad_rows(mesh):
    """The step's all-reduced total, with 3 pad rows (a multiple of 8 on
    a world of one), and ``unpack_blocks`` dropping them."""
    data = corpus.silesia_like(5 * 1024, seed=5)
    blocks = corpus.split_blocks(data, 1024)
    packed = [reference.compress_block(b) for b in blocks]
    comp, lens, C, D, n_real = pipeline.pack_blocks(
        packed, [len(b) for b in blocks], 8)
    assert comp.shape == (8, C) and n_real == 5 and D == 1024
    assert lens[5:].tolist() == [[1, 0]] * 3
    step = pipeline.make_distributed_decode(mesh, 8, C, D)
    shard = pmesh.block_sharding(mesh)
    out, status, total = step(shard(comp), shard(lens))
    assert int(total) == len(data) and total.dtype == torch.int64
    assert status[5:].tolist() == [[0, 0]] * 3
    got = pipeline.unpack_blocks(pipeline.gather_blocks(mesh, out),
                                 pipeline.gather_blocks(mesh, status), lens,
                                 n_real, comp)
    assert b"".join(got) == data
    with pytest.raises(ValueError, match="shard"):
        step(shard(comp)[:4], shard(lens)[:4])


def test_distributed_decode_dict_matches_jax(mesh, jax_mesh):
    """5 dictionary blocks behind a 6000-byte window broadcast from rank
    0: the JAX pipeline's bytes, all certified; with the dictionary's
    last 1 KB as the window, the rows whose matches reach below it are
    re-decoded on the host, which raises as the reference decoder does."""
    dictionary = corpus.silesia_like(6000, seed=11)
    bodies = corpus.split_blocks(corpus.silesia_like(5 * 3000, seed=12),
                                 3000)
    packed = [native.compress_block_dict(dictionary, b, 2 * len(b) + 64)
              for b in bodies]
    lens = [len(b) for b in bodies]
    want = jpipeline.distributed_decode_dict(packed, lens, dictionary,
                                             jax_mesh)
    before = pipeline.host_decodes
    got = pipeline.distributed_decode_dict(packed, lens, dictionary, mesh)
    assert got == want == bodies
    assert pipeline.host_decodes == before
    short = dictionary[-1024:]
    outcomes = [_outcome(pipeline.distributed_decode_dict, [p], [n], short,
                         mesh) for p, n in zip(packed, lens)]
    assert outcomes == [[o] if o != "raised" else o for o in (
        _outcome(jreference.decompress_block_dict, p, short, n)
        for p, n in zip(packed, lens))]
    assert "raised" in outcomes
    assert pipeline.host_decodes > before


def test_dict_step_certifies_every_row(mesh):
    """The step's all-reduced certified count, and its refusal of a
    window and output that pass 2**18 positions."""
    from lz4net_tpu_torch.ops import decode_vector as dv
    dictionary = corpus.silesia_like(6000, seed=11)
    bodies = corpus.split_blocks(corpus.silesia_like(4 * 3000, seed=13),
                                 3000)
    packed = [reference.compress_block_dict(dictionary, b) for b in bodies]
    comp, cl, ol, C, D = dv.pack_blocks(packed, [3000] * 4)
    pre, pre_len, P = dv.pack_windows(dictionary, 1)
    step = pipeline.make_distributed_vector_decode_dict(mesh, 4, C, D, P)
    out, ok, total, certified = step(
        torch.from_numpy(comp).to(torch.int32), torch.from_numpy(cl),
        torch.from_numpy(ol), torch.from_numpy(pre[0]).to(torch.int32),
        torch.tensor(pre_len[0]))
    assert int(certified) == 4 and ok.all() and total.tolist() == [3000] * 4
    for i, b in enumerate(bodies):
        assert out[i, :3000].to(torch.uint8).numpy().tobytes() == b
    with pytest.raises(ValueError, match="P \\+ D"):
        pipeline.make_distributed_vector_decode_dict(
            mesh, 4, C, 1 << 18, P)(
            torch.from_numpy(comp).to(torch.int32), torch.from_numpy(cl),
            torch.from_numpy(ol), torch.from_numpy(pre[0]).to(torch.int32),
            torch.tensor(pre_len[0]))


def test_distributed_encode_matches_the_compressors(mesh):
    """A ragged batch padded to 8 rows: the strict encoder's payloads
    equal the JAX package's compressors' (native and reference), a block
    whose cap is one byte short writes nothing, and the total sums the
    payloads alone (the pad rows' cap of 0 adds nothing)."""
    data = corpus.silesia_like(6300, seed=7)
    sizes = [1500, 700, 3000, 64, 13, 1023]
    blocks = [data[sum(sizes[:i]):sum(sizes[:i + 1])]
              for i in range(len(sizes))]
    want = [jreference.compress_block(b) for b in blocks]
    if native.is_available():
        assert want == [native.compress_block(b) for b in blocks]
    caps = [maximum_output_length(len(b)) for b in blocks]
    caps[4] = len(want[4]) - 1
    src, lens, S, O, n_real = pipeline.pack_blocks(blocks, caps, 8)
    step = pipeline.make_distributed_encode(mesh, 8, S, O)
    shard = pmesh.block_sharding(mesh)
    out, written, total = step(shard(src), shard(lens))
    out = pipeline.gather_blocks(mesh, out)
    written = pipeline.gather_blocks(mesh, written)
    assert written[4] == -1 and (written[n_real:] == -1).all()
    got = [out[i, :w].tobytes() if w > 0 else b""
           for i, w in enumerate(written[:n_real])]
    assert got == [w if i != 4 else b"" for i, w in enumerate(want)]
    assert int(total) == sum(map(len, got))


def test_readme_distributed_decode(mesh, make_test_data):
    """The README's example (on the card it takes no ``device``; here the
    module's group serves it)."""
    data = make_test_data(8 * 4096, entropy=0.3)
    from lz4net_tpu_torch.parallel.pipeline import distributed_decode
    blocks_raw = [data[i:i + 4096] for i in range(0, 8 * 4096, 4096)]
    blocks = [lz4t.encode(b, device="cpu") for b in blocks_raw]
    out_lens = [len(b) for b in blocks_raw]
    decoded = distributed_decode(blocks, out_lens, device="cpu")
    assert decoded == blocks_raw


def test_decompress_block_matches_pallas_decoder(monkeypatch):
    """``decode_sequencer.decompress_block`` (the plain walk) against the
    JAX package's single-block entry (its kernel in interpret mode): the
    same bytes, the same refusal of a truncated block; one decoder a
    device."""
    seen = []
    decode_batch = ds.SequencerDecoder.decode_batch

    def spy(self, *args):
        seen.append(self)
        return decode_batch(self, *args)

    monkeypatch.setattr(ds.SequencerDecoder, "decode_batch", spy)
    data = corpus.silesia_like(3000, seed=9)
    packed = jreference.compress_block(data)
    cut = packed[:len(packed) // 2]
    assert ds.decompress_block(packed, 3000, device="cpu") \
        == decode_pallas.decompress_block(packed, 3000) == data
    assert _outcome(ds.decompress_block, cut, 3000, "cpu") == "raised" \
        == _outcome(decode_pallas.decompress_block, cut, 3000)
    kept = host_rows.kept(ds.SequencerDecoder, "cpu")
    assert len(seen) == 2 and all(d is kept for d in seen)
    assert kept.device.type == "cpu"
    assert kept is host_rows.kept(ds.SequencerDecoder, torch.device("cpu"))


def _mutations():
    """(block, out_len) cases from three reference-compressed blocks: bit
    flips, cuts, appended bytes and out_len one off, by family."""
    rng = np.random.default_rng(21)
    datas = [corpus.silesia_like(2000, seed=31), b"abcdefgh" * 300,
             bytes(rng.integers(0, 256, 700, np.uint8))]
    base = [(reference.compress_block(d), len(d)) for d in datas]
    fam = {"bit_flips": [], "cuts": [], "appended": [], "out_len_off": []}
    for p, n in base:
        for _ in range(12):
            b = bytearray(p)
            i = int(rng.integers(len(b)))
            b[i] ^= 1 << int(rng.integers(8))
            fam["bit_flips"].append((bytes(b), n))
        for k in rng.integers(0, len(p), 8):
            fam["cuts"].append((p[:int(k)], n))
        for k in (1, 2, 3, 17):
            fam["appended"].append(
                (p + bytes(rng.integers(0, 256, k, np.uint8)), n))
        fam["appended"].append((p + b"\x00\x00", n))
        fam["out_len_off"] += [(p, n - 1), (p, n + 1)]
    return fam


MUTATIONS = _mutations()
CASES = {
    "edge_rows": [(b, n) for _, b, n in corpus.decode_edge_rows(0)],
    "junk": list(JUNK.values()),
    # out_len 0: the walk never starts, so the host decoder judges
    "empty_outputs": [(b"\x00", 0), (b"\x05", 0), (b"\x10a", 0), (b"", 0),
                      (b"\xf0", 0), (b"", 1)],
    **MUTATIONS,
}


@pytest.mark.parametrize("family", list(CASES))
def test_rule_matches_the_reference_decoder(mesh, family):
    """Each case alone through ``distributed_decode``, then the family as
    one batch through the step, each row through ``unpack_blocks``: bytes
    exactly where the JAX reference decoder gives them, and the same."""
    cases = CASES[family]
    want = [_outcome(jreference.decompress_block, b, n) for b, n in cases]
    got = [_outcome(pipeline.distributed_decode, [b], [n], mesh)
           for b, n in cases]
    assert got == [[w] if w != "raised" else w for w in want]
    comp, lens, C, D, n_real = pipeline.pack_blocks(*zip(*cases))
    out, status, _ = pipeline.make_distributed_decode(
        mesh, n_real, C, D)(torch.from_numpy(comp), torch.from_numpy(lens))
    rows = [_outcome(pipeline.unpack_blocks, out.numpy()[i:i + 1],
                     status.numpy()[i:i + 1], lens[i:i + 1], 1,
                     comp[i:i + 1]) for i in range(n_real)]
    assert rows == got


def test_no_collective_waits_on_a_raising_rank(mesh):
    """A batch with a corrupt block raises after the gather, naming the
    block; the group still serves the next call."""
    good = reference.compress_block(b"0123456789" * 100)
    with pytest.raises(reference.CorruptedBlockError, match="block 1"):
        pipeline.distributed_decode([good, good[:len(good) // 2], good],
                                    [1000] * 3, mesh)
    assert pipeline.distributed_decode([good], [1000], mesh) == \
        [b"0123456789" * 100]
