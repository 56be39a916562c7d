"""The controls: each breaks one guarantee of its cell's configuration
and the cell's check must come out not correct on it, while the plain
reference put in the program's place passes.  At a small size here; at
each cell's own size on the chip with ``python3 -m portbench.controls``."""

from __future__ import annotations

import pytest

from portbench import _testcells, controls, manifest, reference

# the write control breaks the end rule only where a block's last match
# can reach its last five bytes (about one block in twelve of the
# corpus), so that cell's batch here is 64 blocks
SIZES = {"silesia64k": 64, "silesia64k-dp4": 8}
SEED = 2**40 + 3


@pytest.fixture(scope="module")
def cells(tmp_path_factory):
    return _testcells.write(str(tmp_path_factory.mktemp("cells")), SIZES)


@pytest.mark.parametrize("cell", [w["name"] for w in _testcells.with_ready(
    manifest.load())["workloads"]])
def test_the_control_is_not_correct(cells, cell):
    path, traffic = cells
    checks = controls.readings(cell, SEED, path, traffic)
    assert any(v > limit for v, limit in checks.values()), checks


def _reference_answers(op, inp):
    """What the plain reference gives for request 0 of each op."""
    name = op.__name__.rsplit(".", 1)[-1]
    order = inp.get("orders", [[]])[0]
    if name in ("decode_batch", "sharded_decode"):
        return [reference.decompress_block(inp["comp"][j],
                                           len(inp["raw"][j]))
                for j in order]
    if name == "hc_fast_write":
        return [reference.compress_block(inp["raw"][j]) for j in order]
    return reference.stream_frames(inp["data"], inp["chunk"])


@pytest.mark.parametrize("cell", ["silesia64k.read", "stream1m.write",
                                  "silesia64k-dp4.read"])
def test_the_reference_in_the_programs_place_is_correct(cells, cell):
    path, traffic = cells
    m = manifest.load(path)
    w = manifest.cell(m, cell)
    cfg = manifest.config(m, w["config"])
    mix = manifest.traffic(w["traffic"], traffic)
    op = manifest.op(mix["op"])
    inp = op.inputs(cfg, mix, SEED)
    checks = op.check(inp, [(0, _reference_answers(op, inp))])
    assert all(v <= limit for v, limit in checks.values()), checks
