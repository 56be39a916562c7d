"""The inputs of every cell follow from the seed alone, and are kept per
seed."""

from __future__ import annotations

import pytest

from portbench import _testcells, manifest

SEEDS = (7, 2**31 + 12345)      # a large seed too: more than 32 signed bits


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    path, traffic = _testcells.write(str(tmp_path_factory.mktemp("cells")))
    return manifest.load(path), traffic


@pytest.mark.parametrize("cell", [w["name"] for w in _testcells.with_ready(
    manifest.load())["workloads"]])
def test_inputs_are_deterministic_per_seed(small, cell):
    m, traffic = small
    w = manifest.cell(m, cell)
    cfg = manifest.config(m, w["config"])
    mix = manifest.traffic(w["traffic"], traffic)
    op = manifest.op(mix["op"])
    a, b = (op.inputs(cfg, mix, SEEDS[1]) for _ in range(2))
    assert a == b
    other = op.inputs(cfg, mix, SEEDS[0])
    assert other != a
    for inp in (a, other):      # the same work in another order
        if "orders" in inp:
            n = len(inp["raw"])
            assert all(sorted(o) == list(range(n)) for o in inp["orders"])
            assert len(inp["orders"]) == mix["orders"]


def test_blocks_have_the_configured_size(small):
    m, traffic = small
    w = manifest.cell(m, "silesia64k.read")
    cfg = manifest.config(m, w["config"])
    mix = manifest.traffic(w["traffic"], traffic)
    inp = manifest.op(mix["op"]).inputs(cfg, mix, SEEDS[0])
    assert [len(b) for b in inp["raw"]] == [cfg["block_bytes"]] * \
        cfg["batch_blocks"]


def test_inputs_are_kept_per_seed(tmp_path, monkeypatch):
    from portbench import corpus, frozen, inputs
    monkeypatch.setattr(inputs, "CACHE", str(tmp_path))
    made = inputs.corpus_bytes(200_000, SEEDS[1])
    assert made == corpus.silesia_like(200_000, SEEDS[1])
    (kept,) = [p for p in tmp_path.iterdir() if p.name.startswith("corpus-")]
    assert str(SEEDS[1]) in kept.name
    assert inputs.corpus_bytes(200_000, SEEDS[1]) == made
    blocks = corpus.split_blocks(made, 65536)
    comp = inputs.compressed_blocks(blocks, frozen.compress_blocks, "k")
    assert comp == frozen.compress_blocks(blocks)
    calls = []
    again = inputs.compressed_blocks(
        blocks, lambda b: calls.append(b) or frozen.compress_blocks(b), "k")
    assert again == comp and calls == []       # read, not made
    assert not [p for p in tmp_path.iterdir() if p.name.startswith(".part")]
