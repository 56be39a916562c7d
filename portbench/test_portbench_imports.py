"""Nothing the benchmark runs imports JAX or the JAX package: top-level
module names compared whole (``lz4net_tpu_torch`` is the port, and
passes), in a process that builds every cell's inputs (the ready
four-rank cell's too), readies the program and makes a request, and in a
scan of every import in the benchmark's files.  That a rank other than
0 is looked at too: ``test_portbench_faults.py``."""

from __future__ import annotations

import ast
import json
import os
import subprocess
import sys

from portbench import manifest, session

BANNED = set(session.BANNED)


def test_banned_is_compared_by_whole_top_level_name():
    assert "lz4net_tpu_torch".split(".", 1)[0] not in BANNED
    assert "lz4net_tpu.codec".split(".", 1)[0] in BANNED


def test_a_cells_process_loads_none(tmp_path):
    code = f"""
import json, sys
sys.path.insert(0, {manifest.ROOT!r})
import torch
torch.set_num_threads(1)
from portbench import _testcells, manifest, run, session
path, traffic = _testcells.write({str(tmp_path)!r})
m = manifest.load(path)
for w in m["workloads"]:
    cfg = manifest.config(m, w["config"])
    mix = manifest.traffic(w["traffic"], traffic)
    op = manifest.op(mix["op"])
    inp = op.inputs(cfg, mix, 3)
    st = op.prepare(inp, cfg, mix, "cpu")
    op.request(st, 0)
for e in m["end_to_end"] + m["per_layer"]:
    manifest.metric_reader(e["name"])
manifest.metric_reader("pipeline.nccl_share")
print(json.dumps(session.banned_modules()))
"""
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=str(tmp_path), env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def _imports(path):
    with open(path) as fh:
        tree = ast.parse(fh.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", None) == "import_module" and node.args \
                and isinstance(node.args[0], ast.Constant):
            yield node.args[0].value


def test_no_file_of_the_benchmark_imports_them():
    found = {}
    for base, _dirs, files in os.walk(manifest.HERE):
        for f in files:
            if f.endswith(".py"):
                path = os.path.join(base, f)
                bad = [m for m in _imports(path)
                       if m.split(".", 1)[0] in BANNED]
                if bad:
                    found[path] = bad
    assert found == {}


def test_the_scan_sees_a_banned_import(tmp_path):
    p = tmp_path / "x.py"
    p.write_text("import jax.numpy as jnp\nfrom lz4net_tpu import codec\n"
                 "import lz4net_tpu_torch\n")
    got = [m.split(".", 1)[0] for m in _imports(str(p))]
    assert [m for m in got if m in BANNED] == ["jax", "lz4net_tpu"]
