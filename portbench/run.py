"""Run one cell of the port's benchmark once.

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The cell, its configuration, its traffic mix
and its metrics are found by name from ``BENCHMARK.json``.  The system
under test is ``lz4net_tpu_torch`` on the card: a run that finds no card,
or fewer than the cell asks for, exits with code 2 and prints no result.
A cell on several cards runs one process a card; rank 0 is this process.

Standard output: earlier lines name the device and the program's
counters; the last line is the result, one JSON object.  Standard error
ends with each number the check compared, beside its limit.  The exit
code is 0 for a correct run, 1 for an incorrect one, and 2 or 3 where no
result is printed (no card; JAX or the JAX package loaded in this
process or in any other rank's).
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse                      # noqa: E402
import json                          # noqa: E402
import os                            # noqa: E402
import socket                        # noqa: E402
import subprocess                    # noqa: E402
import sys                           # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
CACHE = os.path.join(HERE, "_build")


def _environment() -> None:
    """Fixed cache directories inside the checkout, and the program's
    engine selection by its static order (no file outside the checkout
    is read)."""
    os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE,
                                                      "torch_extensions")
    os.environ["LZ4NET_TIMED_SELECT"] = "0"
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)


def _args(argv):
    p = argparse.ArgumentParser(prog="python3 -m portbench.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired) as exc:
        return f"not read ({exc})"
    return "; ".join(out.stdout.split("\n")).strip("; ") or "not read"


def _free_address() -> str:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return f"127.0.0.1:{s.getsockname()[1]}"


def _chips(manifest_path: str, workload: str) -> int:
    from portbench import manifest
    return manifest.cell(manifest.load(manifest_path), workload)["chips"]


def _start_ranks(run, world: int):
    """Ranks 1..world-1, a process each (spawned: a fresh interpreter)."""
    import multiprocessing
    from dataclasses import replace

    from portbench import session
    ctx = multiprocessing.get_context("spawn")
    procs = []
    for rank in range(1, world):
        p = ctx.Process(target=session.rank_main,
                        args=(replace(run, rank=rank),))
        p.start()
        procs.append(p)
    return procs


def _stop_ranks(procs, timeout_s: float) -> list[int]:
    codes = []
    for p in procs:
        p.join(timeout_s)
        if p.is_alive():
            p.kill()
            p.join()
        codes.append(p.exitcode)
    return codes


def main(argv=None, *, device: str = "cuda", fault: str | None = None,
         manifest_path: str | None = None,
         traffic_dir: str | None = None) -> int:
    """The command line.  The keyword arguments serve only the tests:
    ``device="cpu"`` skips the look for a card, ``fault`` plants a fault,
    and the others point at small cells of the tests' own."""
    _environment()
    args = _args(argv)
    from portbench import manifest, session
    manifest_path = manifest_path or manifest.MANIFEST
    chips = _chips(manifest_path, args.workload)

    if device != "cpu":
        import torch
        if not torch.cuda.is_available():
            print("portbench: no CUDA device; the benchmark runs only on "
                  "the card", file=sys.stderr)
            return 2
        if torch.cuda.device_count() < chips:
            print(f"portbench: {args.workload} needs {chips} cards, "
                  f"{torch.cuda.device_count()} found", file=sys.stderr)
            return 2
        print(f"device: {torch.cuda.get_device_name(0)} x "
              f"{torch.cuda.device_count()} (this cell uses {chips}); "
              f"power limit: {power_limit()}; torch {torch.__version__}, "
              f"CUDA {torch.version.cuda}", flush=True)

    run = session.Run(workload=args.workload, seed=args.seed,
                      seconds=args.seconds, traced=bool(args.trace), t0=T0,
                      device=device, fault=fault,
                      manifest_path=manifest_path,
                      traffic_dir=traffic_dir or manifest.TRAFFIC, world=chips,
                      address=_free_address() if chips > 1 else None)
    if chips > 1:
        from portbench import frozen
        frozen.build()          # once, before the ranks load it
    procs = _start_ranks(run, chips) if chips > 1 else []
    try:
        result, checks, counters, elsewhere = session.run_cell(run)
    finally:
        if chips > 1:
            import torch.distributed as dist
            if dist.is_initialized():
                dist.destroy_process_group()
        codes = _stop_ranks(procs, 120)
    if any(codes):
        print(f"portbench: ranks exited with {codes}", file=sys.stderr)
        result["correct"] = False
        checks["failed_ranks"] = (sum(1 for c in codes if c), 0)

    banned = session.banned_modules() + elsewhere
    if banned:
        print(f"portbench: JAX or the JAX package was loaded: {banned}",
              file=sys.stderr)
        return 3
    print("counters: " + json.dumps(counters), flush=True)
    result["checks"] = {name: {"value": v, "limit": limit}
                        for name, (v, limit) in checks.items()}
    for name, (v, limit) in checks.items():
        print(f"check {name}: {v} (limit {limit})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0 if result["correct"] else 1


if __name__ == "__main__":
    sys.exit(main())
