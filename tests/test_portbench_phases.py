"""The benchmark's readers of the program's phase spans
(``portbench/phases.py`` and ``portbench/metrics/{layout_ms,copy_ms,
unpack_ms,passes,named_idle}.py``) on hand-made traces, and the
program's spans as the harness's profiler records them."""

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # the test workers share the cores: one intra-op
                           # thread each, or they spin against each other

from portbench import manifest, metrics_ctx, phases, trace  # noqa: E402

H100 = "NVIDIA H100 80GB HBM3"
READERS = ("layout_ms.write", "copy_ms.write", "unpack_ms.write",
           "passes.write", "named_idle.write")


def _ev(cat, name, ts_us, dur_us):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts_us, "dur": dur_us}


def _span(name, a_ms, b_ms):
    return _ev("user_annotation", name, a_ms * 1000, (b_ms - a_ms) * 1000)


def _events(program=True):
    """A 100 ms window with two requests of 40 ms.  Request 1 (0-40 ms)
    is a batch write: the device busy 8-20 ms.  Request 2 (50-90 ms) is a
    stream chunk: the device busy 60-80 ms, framing on either side, two
    passes.  Device-idle ms inside each phase span in the comments."""
    ev = [
        _span(trace.WINDOW_SPAN, 0, 100),
        _span(trace.REQUEST_SPAN, 0, 40),
        _span(trace.REQUEST_SPAN, 50, 90),
        _ev("kernel", "k1", 8_000, 12_000),
        _ev("kernel", "k2", 60_000, 20_000),
        _ev("cpu_op", "aten::copy_", 8_000, 500),
    ]
    if program:
        ev += [
            _span("lz4t.encode.batch", 1, 25),
            _span("lz4t.encode.layout", 1, 5),       # 4
            _span("lz4t.encode.upload", 5, 9),       # 3 (8-9 busy)
            _span("lz4t.encode.pass", 9, 12),        # 0
            _span("lz4t.encode.fetch", 12, 22),      # 2 (20-22)
            _span("lz4t.encode.unpack", 22, 25),     # 3
            _span("lz4t.encode.layout", 44, 46),     # between requests
            _span("lz4t.stream.frame", 51, 52),      # 1
            _span("lz4t.stream.chunk", 52, 86),
            _span("lz4t.encode.batch", 52.5, 84),
            _span("lz4t.encode.layout", 53, 57),     # 4
            _span("lz4t.encode.upload", 57, 61),     # 3 (60-61 busy)
            _span("lz4t.encode.pass", 61, 62),       # 0
            _span("lz4t.encode.fetch", 62, 81),      # 1 (80-81)
            _span("lz4t.encode.pass", 81.5, 82.5),   # 1
            _span("lz4t.encode.unpack", 82.5, 83.5),  # 1
            _span("lz4t.stream.frame", 84.5, 86),    # 1.5
        ]
    return ev


def _ctx(events):
    t = trace.Trace.from_events(events)
    return metrics_ctx.Context(setup_s=1.0, window_s=0.1,
                               latencies=[0.04] * 2, work=[(10, 20, 30)] * 2,
                               trace=t, busy_s=t.busy_s(), device_kind=H100)


def _read(ctx):
    return {n: manifest.metric_reader(n).read(ctx) for n in READERS}


def test_the_readers_on_known_intervals():
    ctx = _ctx(_events())
    got = _read(ctx)
    assert got["layout_ms.write"] == pytest.approx((4 + 4) / 2)
    assert got["copy_ms.write"] == pytest.approx(((3 + 2) + (3 + 1)) / 2)
    assert got["unpack_ms.write"] == pytest.approx((3 + (1 + 1 + 1.5)) / 2)
    assert got["passes.write"] == pytest.approx((1 + 2) / 2)
    # idle: 40 - 12 = 28 ms and 40 - 20 = 20 ms; named 12 and 12.5 ms
    assert metrics_ctx.host_ms(ctx) == pytest.approx(24.0)
    assert got["named_idle.write"] == pytest.approx(100 * 24.5 / 48)


def test_the_phases_split_no_more_than_host_ms():
    ctx = _ctx(_events())
    got = _read(ctx)
    split = (got["layout_ms.write"] + got["copy_ms.write"]
             + got["unpack_ms.write"])
    assert split <= metrics_ctx.host_ms(ctx)
    assert 0 < got["named_idle.write"] <= 100


def test_overlapping_spans_count_once_and_are_cut_to_the_request():
    ev = _events(program=False) + [
        _span("lz4t.encode.layout", 1, 5),
        _span("lz4t.decode.layout", 3, 7),       # union 1-7 ms: 6 ms idle
        _span("lz4t.encode.layout", 38, 45),     # 2 ms inside request 1
    ]
    got = _read(_ctx(ev))
    assert got["layout_ms.write"] == pytest.approx((6 + 2 + 0) / 2)
    assert got["passes.write"] == 0


def test_none_without_a_program_span():
    ctx = _ctx(_events(program=False))
    assert metrics_ctx.host_ms(ctx) == pytest.approx(24.0)
    assert all(v is None for v in _read(ctx).values())
    untraced = metrics_ctx.Context(setup_s=1.0, window_s=0.1,
                                   latencies=[0.04], work=[(10, 20, 30)])
    assert all(v is None for v in _read(untraced).values())
    no_device = _ctx(_events())
    no_device.busy_s = 0.0
    assert all(v is None for v in _read(no_device).values())


def test_phase_names():
    assert phases.phase("lz4t.encode.layout") == "layout"
    assert phases.phase("lz4t.stream.frame") == "frame"
    assert phases.phase("lz4t.decode.fetch") == "fetch"
    for root in ("lz4t.encode.batch", "lz4t.stream.chunk",
                 trace.REQUEST_SPAN, "aten::copy_"):
        assert phases.phase(root) is None


def test_the_manifest_lists_the_readers():
    m = manifest.load()
    entries = {e["name"]: e for e in m["per_layer"]}
    for name in READERS:
        e = entries[name]
        assert e["source"] == "device_trace" and e["moves"] == "write_mb_s"
        assert e["workloads"] == ["silesia64k.hc9_write", "stream1m.write",
                                  "records4k-dict.hc9_write"]
        assert callable(manifest.metric_reader(name).read)
    assert entries["passes.write"]["layer"] == "device pass and kernels"
    assert entries["layout_ms.write"]["layer"] == \
        entries["host_ms.write"]["layer"]


def test_the_harness_profiler_files_the_program_spans():
    from lz4net_tpu_torch.ops.encode_sequencer import SequencerEncoder
    enc = SequencerEncoder("cpu")
    prof = trace.Profiler(cuda=False)
    prof.start()
    with trace.span(trace.WINDOW_SPAN):
        with trace.span(trace.REQUEST_SPAN):
            enc.encode_batch([b"abcd" * 300, b"xyz" * 500])
    t = prof.stop()
    assert len(t.requests) == 1
    names = [n for n, _a, _b in t.host if n.startswith(phases.PREFIX)]
    assert names == ["lz4t.encode.batch"] + [
        f"lz4t.encode.{p}" for p in
        ("layout", "upload", "pass", "fetch", "unpack")]
    ra, rb = t.requests[0]
    assert all(ra <= a and b <= rb for n, a, b in t.host
               if n.startswith(phases.PREFIX))
