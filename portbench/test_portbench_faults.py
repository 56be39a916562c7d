"""A run of each cell on the CPU at a small size (the look for a card
skipped) is correct, and with the timed path broken underneath it is
not: the call that returns its input, half of the batch left out, the
exchange between ranks left out, and an answer altered where it is
produced; and a run whose other rank loaded a module of JAX ends
without a result."""

from __future__ import annotations

import json

import pytest

from portbench import _testcells, run

CELLS = ("silesia64k.read", "silesia64k.hc9_write", "stream1m.write",
         "silesia64k-dp4.read")
SMALL = {"silesia64k": 2, "silesia64k-dp4": 4}
FAULTS = [(c, f) for c in CELLS for f in ("unchanged", "half", "altered")]
FAULTS.append(("silesia64k-dp4.read", "exchange"))


@pytest.fixture(scope="module")
def cells(tmp_path_factory):
    return _testcells.write(str(tmp_path_factory.mktemp("cells")), SMALL)


def _run(cells, capsys, cell, fault=None, seed=2**32 + 17):
    import torch
    torch.set_num_threads(1)
    path, traffic = cells
    rc = run.main(["--workload", cell, "--seed", str(seed), "--seconds",
                   "0.3", "--trace", "0"], device="cpu", fault=fault,
                  manifest_path=path, traffic_dir=traffic)
    out, err = capsys.readouterr()
    result = json.loads(out.strip().splitlines()[-1])
    return rc, result, err


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct(cells, capsys, cell):
    rc, result, err = _run(cells, capsys, cell)
    assert rc == 0 and result["correct"], err[-3000:]
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert list(result)[-1] == "checks"
    assert err.rstrip().splitlines()[-1].startswith("check ")
    assert {"setup_s"} < set(result["metrics"])


@pytest.mark.parametrize("cell, fault", FAULTS)
def test_a_planted_fault_is_not_correct(cells, capsys, cell, fault):
    rc, result, err = _run(cells, capsys, cell, fault)
    assert rc == 1 and result["correct"] is False, result


def test_a_banned_module_in_another_rank_ends_the_run(cells, capsys):
    import torch
    torch.set_num_threads(1)
    path, traffic = cells
    rc = run.main(["--workload", "silesia64k-dp4.read", "--seed", "11",
                   "--seconds", "0.3", "--trace", "0"], device="cpu",
                  fault="jax_elsewhere", manifest_path=path,
                  traffic_dir=traffic)
    out, err = capsys.readouterr()
    assert rc == 3
    assert '"correct"' not in out
    assert "rank 1: jax" in err
