"""A run that finds no card fails and prints no result; on the card
(``gpu`` marker) a short run of each one-card cell is correct."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

from portbench import manifest

FIRST = manifest.load()["workloads"][0]["name"]


def _run(workload, seconds, env=None, timeout=900):
    return subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload", workload,
         "--seed", str(2**33 + 5), "--seconds", str(seconds), "--trace",
         "0"], cwd=manifest.ROOT, capture_output=True, text=True,
        env=env, timeout=timeout)


def test_a_run_without_a_card_fails_and_prints_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = _run(FIRST, 1, env=env, timeout=300)
    assert out.returncode == 2
    assert out.stdout.strip() == ""
    assert "no CUDA device" in out.stderr


def test_a_run_in_a_directory_of_the_benchmark_alone_fails(tmp_path):
    import shutil
    shutil.copy(manifest.MANIFEST, tmp_path / "BENCHMARK.json")
    shutil.copytree(manifest.HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    out = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload", FIRST,
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=str(tmp_path), capture_output=True, text=True, timeout=300,
        env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    assert out.returncode != 0
    assert not out.stdout.strip().startswith("{")


@pytest.mark.gpu
@pytest.mark.parametrize("cell", [w["name"] for w in manifest.load()
                                  ["workloads"] if w["chips"] == 1])
def test_a_short_run_on_the_card_is_correct(cell):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = _run(cell, 3)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu"
