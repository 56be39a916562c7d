"""The controls: for each seed, the check of a cell run on answers that
break one guarantee of its configuration (each op's ``control``), at the
cell's own size.  Every control must come out not correct.

    python3 -m portbench.controls --workload <name> --seeds <n> [<n> ...]

It uses no card and nothing of the program: the control stands in the
program's place for the request with index 0.  Prints one JSON line per
seed with the numbers compared and their limits.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def readings(workload: str, seed: int, manifest_path: str | None = None,
             traffic_dir: str | None = None) -> dict:
    """The compared numbers of the control's answers to request 0."""
    from portbench import manifest
    m = manifest.load(manifest_path or manifest.MANIFEST)
    cell = manifest.cell(m, workload)
    cfg = manifest.config(m, cell["config"])
    mix = manifest.traffic(cell["traffic"], traffic_dir or manifest.TRAFFIC)
    op = manifest.op(mix["op"])
    inp = op.inputs(cfg, mix, seed)
    return op.check(inp, [(0, op.control(inp, 0))])


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m portbench.controls")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    caught = True
    for seed in args.seeds:
        checks = readings(args.workload, seed)
        failed = any(v > limit for v, limit in checks.values())
        caught &= failed
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control_failed": failed,
                          "checks": {k: {"value": v, "limit": lim}
                                     for k, (v, lim) in checks.items()}}),
              flush=True)
    return 0 if caught else 1


if __name__ == "__main__":
    sys.exit(main())
