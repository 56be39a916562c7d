"""The readers' arithmetic on hand-made traces and hand-counted bytes."""

from __future__ import annotations

import json

import pytest

from portbench import manifest, metrics_ctx, trace

H100 = "NVIDIA H100 80GB HBM3"


def _ev(cat, name, ts_us, dur_us):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts_us, "dur": dur_us}


def _trace():
    """A 100 ms window with two requests of 40 ms; the device busy
    10 + 5 ms in the first (two kernels overlapping by 2 ms, and a copy),
    20 ms in the second; host ops around."""
    ev = [
        _ev("user_annotation", trace.WINDOW_SPAN, 0, 100_000),
        _ev("user_annotation", trace.REQUEST_SPAN, 0, 40_000),
        _ev("user_annotation", trace.REQUEST_SPAN, 50_000, 40_000),
        _ev("kernel", "k1", 5_000, 6_000),
        _ev("kernel", "k2", 9_000, 6_000),      # 5-15 ms: 10 ms busy
        _ev("gpu_memcpy", "Memcpy HtoD", 30_000, 5_000),
        _ev("kernel", "k1", 60_000, 20_000),
        _ev("cpu_op", "aten::copy_", 15_500, 10_000),
        _ev("cpu_op", "c10d::allgather_", 50_000, 8_000),
        _ev("cpu_op", "c10d::allgather_", 52_000, 2_000),   # nested
        _ev("cuda_runtime", "cudaLaunchKernel", 80_500, 100),
        {"ph": "s", "cat": "ac2g", "name": "flow", "ts": 1},
    ]
    return trace.Trace.from_events(ev)


def test_merge_and_covered():
    merged = trace.merge([(5, 11), (9, 15), (30, 35), (0, 1)])
    assert merged == [(0, 1), (5, 15), (30, 35)]
    c = trace.Covered(merged)
    assert c.within(0, 100) == pytest.approx(16)
    assert c.within(10, 32) == pytest.approx(7)
    assert c.within(6, 7) == pytest.approx(1)
    assert c.within(16, 29) == 0
    assert c.within(40, 30) == 0


def test_busy_idle_and_host_time():
    t = _trace()
    assert t.window_s == pytest.approx(0.1)
    assert t.busy_s() == pytest.approx(0.035)
    ctx = metrics_ctx.Context(setup_s=1.0, window_s=0.1, latencies=[0.04] * 2,
                              work=[(10, 20, 30)] * 2, trace=t,
                              busy_s=t.busy_s(), device_kind=H100)
    assert metrics_ctx.device_idle(ctx) == pytest.approx(65.0)
    # request 1: 40 - 15 = 25 ms idle; request 2: 40 - 20 = 20 ms
    assert metrics_ctx.host_ms(ctx) == pytest.approx(22.5)
    # no collective's kernel in this trace: nothing to read
    assert manifest.metric_reader("pipeline.nccl_share").read(ctx) is None


def test_nccl_share_reads_the_collectives_kernels():
    nccl = "ncclDevKernel_AllGather_RING_LL(ncclDevComm*, unsigned long)"
    t = trace.Trace.from_events([
        _ev("user_annotation", trace.WINDOW_SPAN, 0, 100_000),
        _ev("user_annotation", trace.REQUEST_SPAN, 0, 40_000),
        _ev("user_annotation", trace.REQUEST_SPAN, 50_000, 40_000),
        _ev("kernel", nccl, 10_000, 6_000),
        _ev("kernel", "ncclDevKernel_AllReduce_Sum_i64", 14_000, 4_000),
        _ev("kernel", "decode_smem_kernel", 60_000, 10_000),
        _ev("kernel", nccl, 88_000, 7_000),     # 2 ms inside request 2
        _ev("cpu_op", "c10d::allgather_", 9_000, 1_000),
    ])
    ctx = metrics_ctx.Context(setup_s=1.0, window_s=0.1, latencies=[0.04] * 2,
                              work=[(10, 20, 30)] * 2, trace=t,
                              busy_s=t.busy_s(), device_kind=H100)
    share = manifest.metric_reader("pipeline.nccl_share").read(ctx)
    # 10-18 ms (two kernels overlapping) and 88-90 ms of 80 ms of requests
    assert share == pytest.approx(100 * (8 + 2) / 80)


def test_breakdown():
    t = _trace()
    ops = dict(t.device_ops())
    assert ops["k1"] == pytest.approx(0.026)
    assert ops["Memcpy HtoD"] == pytest.approx(0.005)
    gaps = dict(t.idle_gaps())
    assert gaps["aten::copy_"] == pytest.approx(0.015)      # 15-30 ms
    assert gaps["between requests"] == pytest.approx(0.015 + 0.010)
    assert gaps["host code before the first operation"] == \
        pytest.approx(0.005)
    assert sum(gaps.values()) == pytest.approx(0.065)


def test_roofline_on_hand_counted_bytes():
    # 9,743,788 compressed bytes read once and 16,777,216 decoded bytes
    # written once, at 3.35 TB/s, against 1.6 ms of device time
    least = 9_743_788 + 16_777_216
    share = metrics_ctx.roofline_share(least, 1.6e-3, 3.35e12)
    assert share == pytest.approx(100 * least / 3.35e12 / 1.6e-3)
    assert 0.49 < share < 0.50
    assert metrics_ctx.peak_bytes_per_s(H100) == 3.35e12
    assert metrics_ctx.peak_bytes_per_s("cpu") is None


def test_window_roofline_needs_a_device_trace():
    t = _trace()
    work = [(8_388_608, 4_843_869, 8_388_608 + 4_843_869)] * 2
    ctx = metrics_ctx.Context(setup_s=1.0, window_s=0.1, latencies=[0.9],
                              work=work, trace=t, busy_s=t.busy_s(),
                              device_kind=H100)
    share = metrics_ctx.window_roofline(ctx)
    assert share == pytest.approx(100 * 2 * 13_232_477 / 3.35e12 / 0.035)
    ctx.device_kind = "cpu"
    assert metrics_ctx.window_roofline(ctx) is None
    ctx.device_kind, ctx.busy_s = H100, 0.0
    assert metrics_ctx.window_roofline(ctx) is None


def test_small_share_prints_unrounded():
    share = metrics_ctx.roofline_share(13_232_477, 0.9, 3.35e12)
    assert 4e-4 < share < 5e-4
    line = json.dumps({"metrics": {"pass_roofline.write": {
        "value": share, "unit": "%"}}})
    assert json.loads(line)["metrics"]["pass_roofline.write"]["value"] \
        == share
    assert "0.0004" in line and repr(share) in line


def test_end_to_end_readers():
    ctx = metrics_ctx.Context(
        setup_s=12.5, window_s=2.0,
        latencies=[i / 1000 for i in range(1, 101)],
        work=[(100, 40, 140)] * 100)
    read = {n: manifest.metric_reader(n).read(ctx) for n in
            ("setup_s", "read_mb_s", "write_mb_s", "p95_ms", "size_ratio")}
    assert read["setup_s"] == 12.5
    assert read["read_mb_s"] == pytest.approx(4000 / 2.0 / 1e6)
    assert read["write_mb_s"] == pytest.approx(10000 / 2.0 / 1e6)
    assert read["p95_ms"] == pytest.approx(95.05)
    assert read["size_ratio"] == pytest.approx(0.4)
