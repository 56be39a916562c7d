"""One run of one cell, in one process or in each rank of several.

Set-up (made from the seed, then the cell's shapes warmed), a closed
loop of requests for the measured window, then, once the window has
closed, the device's peak memory, the program's state freed and the
check of the sampled answers against the plain reference.  Where a run
has ranks, every rank checks the same sampled requests' answers that it
got back, and reports them and the modules it loaded to rank 0.  Rank 0
returns the result; the other ranks return None.
"""

from __future__ import annotations

import gc
import os
import resource
import sys
import time
import traceback
from contextlib import nullcontext
from dataclasses import dataclass

from portbench import faults, inputs, manifest, metrics_ctx, trace

BANNED = ("jax", "jaxlib", "flax", "lz4net_tpu")


@dataclass
class Run:
    workload: str
    seed: int
    seconds: float
    traced: bool
    t0: float                       # the process's start, perf_counter
    device: str = "cuda"            # "cpu" only in the tests
    fault: str | None = None
    manifest_path: str = manifest.MANIFEST
    traffic_dir: str = manifest.TRAFFIC
    rank: int = 0
    world: int = 1
    address: str | None = None      # host:port of rank 0's store


class Comm:
    """The harness's own exchanges between ranks, on a gloo group of
    their own: the corpus's parts, the decision to go on, and the
    readings that rank 0 reports."""

    def __init__(self, rank: int, world: int):
        import torch.distributed as dist
        self.dist, self.rank, self.world = dist, rank, world
        self.group = dist.new_group(backend="gloo")

    def all_gather(self, obj) -> list:
        """Every rank's ``obj`` (picklable), in rank order."""
        got = [None] * self.world
        self.dist.all_gather_object(got, obj, group=self.group)
        return got

    def _reduce(self, value: float, op) -> float:
        import torch
        t = torch.tensor([value], dtype=torch.float64)
        self.dist.all_reduce(t, op=op, group=self.group)
        return float(t[0])

    def all_true(self, flag: bool) -> bool:
        return self._reduce(1.0 if flag else 0.0,
                            self.dist.ReduceOp.MIN) > 0.5

    def max(self, value: float) -> float:
        return self._reduce(value, self.dist.ReduceOp.MAX)

    def mean(self, value: float) -> float:
        return self._reduce(value, self.dist.ReduceOp.SUM) / self.world

    def barrier(self) -> None:
        self.dist.barrier(group=self.group)


def banned_modules() -> list[str]:
    """Modules of JAX or the JAX package loaded in this process, by whole
    top-level name (``lz4net_tpu_torch`` is not ``lz4net_tpu``)."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".", 1)[0] in BANNED)


def _device_kind(device: str) -> tuple[str, str]:
    if device == "cpu":
        return "cpu", "cpu"
    import torch
    return "gpu", torch.cuda.get_device_name(0)


def _memory_peak(device: str) -> int:
    if device == "cpu":
        return 0
    import torch
    return int(torch.cuda.max_memory_allocated())


def _init_ranks(run: Run):
    """Join the run's process group through the program's own wiring
    (NCCL on the cards, gloo on the CPU) and make the harness's group.
    Each rank takes an equal share of the cores for PyTorch's threads,
    as torchrun's one thread a process would, so that the ranks do not
    crowd each other's host work."""
    if run.world == 1:
        return None
    import torch
    torch.set_num_threads(max(1, len(os.sched_getaffinity(0)) // run.world))
    from lz4net_tpu_torch.parallel import distributed
    dev = "cpu" if run.device == "cpu" else f"cuda:{run.rank}"
    distributed.initialize(run.address, run.world, run.rank, device=dev)
    return Comm(run.rank, run.world)


def _window(op, st, run: Run, comm, mix: dict, profiler):
    """The closed loop: one client, each request sent when the last has
    returned, until ``run.seconds`` have passed on rank 0's clock (every
    rank makes the same requests).  Returns the latencies, each request's
    work, a reservoir sample of (index, answer) drawn from the seed, the
    host-clock window, the number of failed requests, the trace and the
    seconds this rank waited for the ranks to agree to go on."""
    sampler = inputs.rng(run.seed, inputs.SAMPLE)
    k = mix["sample_requests"]     # every rank keeps the same requests
    lat, work, kept = [], [], []
    failed = 0
    agree_s = 0.0       # this rank's time waiting for the others to agree
    span = trace.span if profiler else (lambda name: nullcontext())
    if profiler:
        profiler.start()
    if comm:
        comm.barrier()
    t_start = time.perf_counter()
    i = 0
    with span(trace.WINDOW_SPAN):
        while True:
            go = time.perf_counter() - t_start < run.seconds and not failed
            if comm:
                t = time.perf_counter()
                go = comm.all_true(go)
                agree_s += time.perf_counter() - t
            if not go:
                break
            t = time.perf_counter()
            try:
                with span(trace.REQUEST_SPAN):
                    out = op.request(st, i)
            except Exception:   # a failed request: counted, then the run ends
                failed += 1
                traceback.print_exc(file=sys.stderr)
                continue
            lat.append(time.perf_counter() - t)
            work.append(op.work(st, i, out))
            if i < k:
                kept.append((i, out))
            else:
                j = sampler.randrange(i + 1)
                if j < k:
                    kept[j] = (i, out)
            i += 1
            out = None
    window_s = time.perf_counter() - t_start
    got = profiler.stop() if profiler else None
    return lat, work, kept, window_s, failed, got, agree_s


def _warm(op, st, mix: dict) -> bool:
    """The mix's first requests, untimed: every shape the window uses is
    built and warmed.  False where one failed."""
    try:
        for i in range(mix["warm_requests"]):
            op.request(st, i)
    except Exception:   # counted as a failed request; the run ends
        traceback.print_exc(file=sys.stderr)
        return False
    return True


def run_cell(run: Run):
    """One run of ``run.workload``; rank 0 returns the result's fields,
    the compared numbers (every rank's, summed), the counters and the
    modules of JAX or the JAX package that the other ranks loaded; the
    other ranks return None."""
    comm = _init_ranks(run)
    m = manifest.load(run.manifest_path)
    cell = manifest.cell(m, run.workload)
    cfg = manifest.config(m, cell["config"])
    mix = manifest.traffic(cell["traffic"], run.traffic_dir)
    op = manifest.op(mix["op"])
    with faults.planted(run.fault, op, run.rank):
        inp = op.inputs(cfg, mix, run.seed, comm)
        st = op.prepare(inp, cfg, mix, run.device, comm)
        warmed = _warm(op, st, mix)
        profiler = trace.Profiler(run.device != "cpu") if run.traced else None
        gc.collect()
        gc.freeze()     # set-up's objects: no collection rescans them
        setup_s = time.perf_counter() - run.t0
        use0 = resource.getrusage(resource.RUSAGE_SELF)
        if warmed:
            lat, work, kept, window_s, failed, got, agree_s = _window(
                op, st, run, comm, mix, profiler)
        else:       # a request failed in set-up: no window
            lat, work, kept, window_s, failed, got, agree_s = (
                [], [], [], 0.0, 1, None, 0.0)
        cpu_s = _cpu_s(use0, resource.getrusage(resource.RUSAGE_SELF))
        gc.unfreeze()
        peak = _memory_peak(run.device)
        counters = op.counters(st)
    counters["window_cpu_s"] = cpu_s
    busy_s = got.busy_s() if got else None
    if comm:
        peak = int(comm.max(peak))
        counters["ranks"] = comm.all_gather({
            "request_ms_mean": 1e3 * sum(lat) / len(lat) if lat else None,
            "agree_s": agree_s, "busy_s": busy_s, "cpu_s": cpu_s,
            "cpus": len(os.sched_getaffinity(0))})
        if got:
            busy_s = comm.mean(busy_s)
    st = None
    gc.collect()
    if run.device != "cpu":
        import torch
        torch.cuda.empty_cache()

    checks = op.check(inp, kept) if kept else {}
    checks["failed_requests"] = (failed, 0)
    checks["unchecked_run"] = (0 if kept else 1, 0)
    banned_elsewhere = []   # modules of JAX loaded by the other ranks
    if comm:
        got_back = comm.all_gather((checks, banned_modules()))
        if run.rank != 0:
            return None
        checks = _merged([c for c, _ in got_back])
        banned_elsewhere = [f"rank {r}: {m}" for r, (_, b)
                            in enumerate(got_back) if r for m in b]
    platform, kind = _device_kind(run.device)
    ctx = metrics_ctx.Context(
        setup_s=setup_s, window_s=window_s, latencies=lat, work=work,
        trace=got, busy_s=busy_s, device_kind=kind)
    values = {}
    for entry in manifest.metrics(m, run.workload, run.traced) if lat else []:
        value = manifest.metric_reader(entry["name"]).read(ctx)
        if value is not None:
            values[entry["name"]] = {"value": value, "unit": entry["unit"]}
    device = {"platform": platform, "kind": kind, "count": run.world,
              "memory_peak_bytes": peak}
    if got:
        device["busy_s"] = busy_s
        device["window_s"] = got.window_s
    correct = all(v <= limit for v, limit in checks.values())
    result = {"correct": correct, "attempted": len(lat) + failed,
              "failed": failed, "metrics": values, "device": device}
    if got:
        result["breakdown"] = {"device_ops": got.device_ops(),
                               "idle_gaps": got.idle_gaps()}
    return result, checks, counters, banned_elsewhere


def _cpu_s(a, b) -> float:
    """The CPU seconds this process used between two getrusage readings:
    beside the window's length, it tells host work from waiting."""
    return (b.ru_utime + b.ru_stime) - (a.ru_utime + a.ru_stime)


def _merged(per_rank: list[dict]) -> dict:
    """Every rank's compared numbers, summed by name (one limit each)."""
    out = {}
    for checks in per_rank:
        for name, (value, limit) in checks.items():
            out[name] = (out.get(name, (0, limit))[0] + value, limit)
    return out


def rank_main(run: Run) -> None:
    """A rank other than 0, in a process of its own."""
    import torch.distributed as dist
    try:
        run_cell(run)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
