"""The port's command line (``python -m lz4net_tpu_torch``) on the CPU:
its six verbs with ``--device cpu``, each as a subprocess, as
``tests/test_cli.py`` drives the JAX package's.  The stream files equal
the JAX package's, and each package reads the other's."""

import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # the test workers share the cores: one intra-op
                           # thread each, or they spin against each other

from lz4net_tpu import stream as jstream  # noqa: E402
from lz4net_tpu_torch.utils import corpus  # noqa: E402
from lz4net_tpu_torch.utils.continuous import run_continuous  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(args, cache, timeout=240):
    env = dict(os.environ, OMP_NUM_THREADS="1", LZ4NET_SELECT_CACHE=cache)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return subprocess.run(
        [sys.executable, "-m", "lz4net_tpu_torch", *args, "--device", "cpu"],
        capture_output=True, text=True, timeout=timeout, env=env, cwd=REPO)


def test_compress_decompress_and_verify(tmp_path):
    data = corpus.silesia_like(300_000, seed=23)
    src, packed, back = (tmp_path / n for n in ("in.bin", "out.lz4s",
                                                "back.bin"))
    src.write_bytes(data)
    # strict HC runs the Python reference parse: a smaller file
    for hc, block in ((False, 64), (True, 16)):
        src.write_bytes(data[:60_000] if hc else data)
        r = _run(["compress", str(src), str(packed), "--block", str(block)]
                 + (["--hc"] if hc else []), str(tmp_path))
        assert r.returncode == 0, r.stderr
        framed = packed.read_bytes()
        assert framed == jstream.compress_stream(
            src.read_bytes(), high_compression=hc, block_size=block * 1024)
        r = _run(["decompress", str(packed), str(back)], str(tmp_path))
        assert r.returncode == 0, r.stderr
        assert back.read_bytes() == src.read_bytes()
    src.write_bytes(data[:20_000])
    r = _run(["verify", str(src)], str(tmp_path))
    assert r.returncode == 0, r.stderr
    assert "codec: cuda/cuda/cudaHC" in r.stdout
    assert r.stdout.count("round-trip OK") == 2


def test_info_continuous_and_select(tmp_path):
    r = _run(["info"], str(tmp_path))
    assert r.returncode == 0, r.stderr
    assert "selected: cuda/cuda/cudaHC" in r.stdout
    assert f"torch {torch.__version__}" in r.stdout
    assert "engine python-reference" in r.stdout
    assert "engine native: NativeService" in r.stdout
    out = tmp_path / "results.json"
    r = _run(["continuous", "--mb", "0.125", "--out", str(out)],
             str(tmp_path))
    assert r.returncode == 0, r.stderr
    assert json.loads(r.stdout)["device"] == "cpu"
    # a second run merges into the history
    run_continuous(total_mb=0.125, out_path=str(out), device="cpu")
    hist = json.loads(out.read_text())
    assert len(hist["runs"]) == 2
    engines = hist["runs"][-1]["engines"]
    assert set(engines) == {"cuda", "native", "python-reference"}
    assert all(e["verified"] for e in engines.values())
    assert set(hist["best"]) == set(engines)
    r = _run(["select", "--kb", "4", "--blocks", "1"], str(tmp_path))
    assert r.returncode == 0, r.stderr
    got = json.loads(r.stdout)
    assert set(got["orders"]) == {"encode", "decode", "encode_hc"}
    assert got["cache"].startswith(str(tmp_path))
    assert json.loads(open(got["cache"]).read())["cpu"] == got["orders"]
