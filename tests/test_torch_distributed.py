"""Two processes, one gloo group: the port's pipeline
(``lz4net_tpu_torch.parallel``) over two ranks on the CPU.

The counterpart of ``tests/test_distributed.py``.  Both processes start
once and run every case: a ragged decode of 5 blocks (one pad row), the
all-reduced totals, a sharded strict encode, the dictionary form with the
window broadcast from rank 0, a corrupt block in rank 1's shard, which
must make both ranks raise, and a block with two trailing bytes.  Each
rank writes what it got; the parent holds both against the JAX package's
reference decoder and compressor.
"""

import json
import os
import socket
import subprocess
import sys

import pytest

pytest.importorskip("torch")

from lz4net_tpu.models import reference as jreference  # noqa: E402

_WORKER = r"""
import json, os, sys
sys.path.insert(0, os.environ["LZ4_REPO"])
import numpy as np
import torch
torch.set_num_threads(1)
import torch.distributed as dist
from lz4net_tpu_torch.constants import maximum_output_length
from lz4net_tpu_torch.models import reference
from lz4net_tpu_torch.parallel import distributed, pipeline
from lz4net_tpu_torch.parallel import mesh as pmesh

pid, port, out_path = int(sys.argv[1]), sys.argv[2], sys.argv[3]
distributed.initialize("127.0.0.1:" + port, 2, pid, device="cpu",
                       timeout_s=60)
assert distributed.is_multihost()
mesh = pmesh.make_mesh(2, device="cpu")
shard = pmesh.block_sharding(mesh)
hexes = lambda bs: [b.hex() for b in bs]

# identical global data on every rank (the SPMD contract)
rng = np.random.default_rng(11)
raws = [bytes(rng.integers(0, 4, 700 + 50 * i).astype(np.uint8)) * 2
        for i in range(5)]
lens = [len(r) for r in raws]
blocks = [reference.compress_block(r) for r in raws]
dictionary = bytes(rng.integers(0, 4, 5000).astype(np.uint8))
dblocks = [reference.compress_block_dict(dictionary, r) for r in raws]
res = {"rank": dist.get_rank(), "world": mesh.size(),
       "blocks": hexes(blocks), "dblocks": hexes(dblocks),
       "dictionary": dictionary.hex()}

res["decode"] = hexes(pipeline.distributed_decode(blocks, lens, mesh))

comp, plens, C, D, n_real = pipeline.pack_blocks(blocks, lens, 2)
out, status, total = pipeline.make_distributed_decode(
    mesh, comp.shape[0], C, D)(shard(comp), shard(plens))
res["local_rows"], res["total"] = out.shape[0], int(total)
try:
    pipeline.make_distributed_decode(mesh, 5, C, D)
except ValueError:
    res["uneven"] = "raised"

caps = [maximum_output_length(n) for n in lens]
src, elens, S, O, _ = pipeline.pack_blocks(raws, caps, 2)
eout, written, etotal = pipeline.make_distributed_encode(
    mesh, src.shape[0], S, O)(shard(src), shard(elens))
eout = pipeline.gather_blocks(mesh, eout)
written = pipeline.gather_blocks(mesh, written)
res["encode"] = [eout[i, :w].tobytes().hex()
                 for i, w in enumerate(written[:5])]
res["encode_pad_written"] = int(written[5])
res["encode_total"] = int(etotal)

res["window_from_rank_0"] = pmesh.replicated(mesh)(
    torch.full((4,), pid, dtype=torch.int32)).tolist()
before = pipeline.host_decodes
res["dict"] = hexes(pipeline.distributed_decode_dict(dblocks, lens,
                                                     dictionary, mesh))
res["dict_host_decodes"] = pipeline.host_decodes - before

bad = list(blocks)
bad[4] = bad[4][:len(bad[4]) // 2]        # in rank 1's shard
try:
    pipeline.distributed_decode(bad, lens, mesh)
    res["corrupt"] = "returned"
except reference.CorruptedBlockError as exc:
    res["corrupt"] = str(exc)

trailing = list(blocks)
trailing[1] += b"\x00\x00"
res["trailing"] = hexes(pipeline.distributed_decode(trailing, lens, mesh))

with open(out_path, "w") as fh:
    json.dump(res, fh)
dist.destroy_process_group()
print(f"rank {pid} OK")
"""


def test_two_process_gloo_pipeline(tmp_path):
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    script = tmp_path / "worker.py"
    script.write_text(_WORKER)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {**os.environ, "LZ4_REPO": repo, "OMP_NUM_THREADS": "1"}
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
              "LOCAL_RANK"):
        env.pop(k, None)
    outs = [tmp_path / f"rank{pid}.json" for pid in range(2)]
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(pid), str(port), str(outs[pid])],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env) for pid in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=120)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for pid, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {pid} failed:\n{log[-3000:]}"
        assert f"rank {pid} OK" in log

    results = [json.loads(o.read_text()) for o in outs]
    first = results[0]
    blocks = [bytes.fromhex(b) for b in first["blocks"]]
    dblocks = [bytes.fromhex(b) for b in first["dblocks"]]
    dictionary = bytes.fromhex(first["dictionary"])
    raws = [jreference.decompress_block(b, n) for b, n in
            zip(blocks, [1400 + 100 * i for i in range(5)])]
    lens = [len(r) for r in raws]
    for pid, res in enumerate(results):
        assert (res["rank"], res["world"]) == (pid, 2)
        assert res["blocks"] == first["blocks"]         # the same inputs
        assert [bytes.fromhex(b) for b in res["decode"]] == raws
        assert (res["local_rows"], res["total"]) == (3, sum(lens))
        assert res["uneven"] == "raised"
        assert [bytes.fromhex(b) for b in res["encode"]] == \
            [jreference.compress_block(r) for r in raws]
        assert res["encode_pad_written"] == -1
        assert res["encode_total"] == sum(len(b) for b in blocks)
        assert res["window_from_rank_0"] == [0] * 4
        assert [bytes.fromhex(b) for b in res["dict"]] == [
            jreference.decompress_block_dict(b, dictionary, n)
            for b, n in zip(dblocks, lens)] == raws
        assert res["dict_host_decodes"] == 0
        assert res["corrupt"].startswith("block 4:"), res["corrupt"]
        assert [bytes.fromhex(b) for b in res["trailing"]] == raws
    with pytest.raises(jreference.CorruptedBlockError):
        jreference.decompress_block(blocks[4][:len(blocks[4]) // 2], lens[4])
    assert jreference.decompress_block(blocks[1] + b"\x00\x00", lens[1]) \
        == raws[1]
