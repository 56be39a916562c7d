"""The benchmark's dictionary-records cell (``records4k-dict.hc9_write``,
``portbench/ops/dict_hc_write.py``) on the CPU at the tests' cut size (a
1 MiB corpus: 256 records of 4 KB, a batch of 64 behind a 64 KB
dictionary): its inputs, its plain reference (``portbench/
reference_dict.py``), its control and its check, and the
``window_ms.write`` reader on hand-made traces.  Nothing here runs the
program's encoder."""

import pytest

from portbench import (_testcells, manifest, metrics_ctx, reference,
                       reference_dict, trace)

CELL = "records4k-dict.hc9_write"
SEEDS = (7, 2**31 + 12345, 2**40 + 3)
H100 = "NVIDIA H100 80GB HBM3"


@pytest.fixture(scope="module")
def cell(tmp_path_factory):
    path, traffic = _testcells.write(str(tmp_path_factory.mktemp("cells")))
    m = manifest.load(path)
    w = manifest.cell(m, CELL)
    cfg = manifest.config(m, w["config"])
    mix = manifest.traffic(w["traffic"], traffic)
    return cfg, mix, manifest.op(mix["op"])


@pytest.fixture(scope="module")
def inputs(cell):
    cfg, mix, op = cell
    return {seed: op.inputs(cfg, mix, seed) for seed in SEEDS}


def _reference_answers(inp, i=0):
    order = inp["orders"][i % len(inp["orders"])]
    return [reference_dict.compress_block_dict(inp["dictionary"],
                                               inp["raw"][j])
            for j in order]


@pytest.mark.parametrize("seed", SEEDS)
def test_the_inputs_follow_from_the_seed(cell, inputs, seed):
    cfg, mix, op = cell
    assert op.inputs(cfg, mix, seed) == inputs[seed]
    assert all(inputs[other] != inputs[seed] for other in SEEDS
               if other != seed)


def test_the_cut_size(cell, inputs):
    cfg, mix, _op = cell
    assert mix["file_bytes"] == 1 << 20 and mix["level"] == 9
    inp = inputs[SEEDS[0]]
    assert [len(r) for r in inp["raw"]] == [cfg["record_bytes"]] * 64
    assert len(inp["dictionary"]) == cfg["dictionary_bytes"] == 65536
    assert inp["dict_records"] == list(range(0, 256, 16))
    assert len(inp["orders"]) == mix["orders"]
    assert all(sorted(o) == list(range(64)) for o in inp["orders"])


@pytest.mark.parametrize("seed", SEEDS)
def test_the_dictionary_holds_no_record_of_the_batch(inputs, seed):
    inp = inputs[seed]
    batch_records = range(1, 4 * len(inp["raw"]), 4)
    assert not set(inp["dict_records"]) & set(batch_records)
    size = len(inp["raw"][0])
    in_dict = {inp["dictionary"][k:k + size]
               for k in range(0, len(inp["dictionary"]), size)}
    assert not in_dict & set(inp["raw"])


@pytest.mark.parametrize("seed", SEEDS)
def test_the_reference_compressors_answers_are_correct(cell, inputs, seed):
    _cfg, _mix, op = cell
    inp = inputs[seed]
    answers = _reference_answers(inp)
    # the dictionary does its work: matches reach into the window
    assert sum(map(len, answers)) < sum(
        len(reference.compress_block(inp["raw"][j]))
        for j in inp["orders"][0])
    checks = op.check(inp, [(0, answers), (5, _reference_answers(inp, 5))])
    assert all(v <= limit for v, limit in checks.values()), checks


def _broken(inp, how):
    answers = _reference_answers(inp)
    if how == "altered":
        # the payload's last byte is its record's last byte, a literal
        answers[3] = answers[3][:-1] + bytes([answers[3][-1] ^ 0x5A])
    elif how == "missing":
        answers.pop()
    elif how == "emptied":
        answers[0] = b""
    return answers


@pytest.mark.parametrize("how, name", [
    ("altered", "wrong_payloads"), ("missing", "missing_payloads"),
    ("emptied", "missing_payloads")])
def test_a_broken_answer_is_not_correct(cell, inputs, how, name):
    _cfg, _mix, op = cell
    checks = op.check(inputs[SEEDS[1]],
                      [(0, _broken(inputs[SEEDS[1]], how))])
    assert checks[name] == (1, 0)
    assert sum(v for v, _limit in checks.values()) == 1


@pytest.mark.parametrize("seed", SEEDS)
def test_the_control_is_not_correct(cell, inputs, seed):
    _cfg, _mix, op = cell
    checks = op.check(inputs[seed], [(0, op.control(inputs[seed], 0))])
    assert checks["wrong_payloads"][0] > 0
    assert checks["over_cap_payloads"] == checks["missing_payloads"] \
        == (0, 0)


def test_the_plain_decoder_keeps_the_end_and_window_rules():
    window = bytes(range(256)) * 4
    record = window[100:200] + bytes(20)
    packed = reference_dict.compress_block_dict(window, record)
    assert packed[0] >> 4 == 0          # a match into the window first
    assert reference_dict.decompress_block_dict(packed, window,
                                                len(record)) == record
    for bad in (lambda: reference_dict.decompress_block_dict(
                    packed, window[-100:], len(record)),     # below it
                lambda: reference_dict.decompress_block_dict(
                    packed, window, len(record) + 1),
                lambda: reference_dict.decompress_block_dict(
                    packed[:-3], window, len(record)),
                lambda: reference_dict.decompress_block_dict(
                    b"\x00\x01\x00" + bytes(9), window, 12)):  # offset 0
        with pytest.raises(reference.CorruptedBlockError):
            bad()


def test_the_plain_decoder_reads_the_program_hosts_dictionary_payloads(
        inputs):
    native = pytest.importorskip("lz4net_tpu_torch.models.native")
    inp = inputs[SEEDS[2]]
    for record in inp["raw"][:16]:
        packed = native.compress_block_dict(inp["dictionary"], record)
        assert reference_dict.decompress_block_dict(
            packed, inp["dictionary"], len(record)) == record


def _span(name, a_ms, b_ms):
    return {"ph": "X", "cat": "user_annotation", "name": name,
            "ts": a_ms * 1000, "dur": (b_ms - a_ms) * 1000}


def _ctx(windows):
    """Two requests of 40 ms in a 100 ms window, the device busy 8-20 and
    60-80 ms; a layout span in each, with the window spans given."""
    ev = [_span(trace.WINDOW_SPAN, 0, 100), _span(trace.REQUEST_SPAN, 0, 40),
          _span(trace.REQUEST_SPAN, 50, 90),
          {"ph": "X", "cat": "kernel", "name": "k", "ts": 8_000,
           "dur": 12_000},
          {"ph": "X", "cat": "kernel", "name": "k", "ts": 60_000,
           "dur": 20_000},
          _span("lz4t.encode.layout", 1, 9), _span("lz4t.encode.layout",
                                                     51, 59)]
    ev += [_span("lz4t.encode.window", a, b) for a, b in windows]
    t = trace.Trace.from_events(ev)
    return metrics_ctx.Context(setup_s=1.0, window_s=0.1,
                               latencies=[0.04] * 2, work=[(10, 20, 30)] * 2,
                               trace=t, busy_s=t.busy_s(), device_kind=H100)


def test_window_ms_reads_the_idle_device_inside_the_window_spans():
    read = manifest.metric_reader("window_ms.write").read
    # request 1: 2-6 ms idle (4), and 7-10 ms with 8-10 busy (1);
    # request 2: 52-61 ms with 60-61 busy (8); 95-99 is outside both
    got = read(_ctx([(2, 6), (7, 10), (52, 61), (95, 99)]))
    assert got == pytest.approx((4 + 1 + 8) / 2)
    assert read(_ctx([(2, 6), (3, 5)])) == pytest.approx(4 / 2)


def test_window_ms_is_none_without_the_span():
    read = manifest.metric_reader("window_ms.write").read
    assert read(_ctx([])) is None
    untraced = metrics_ctx.Context(setup_s=1.0, window_s=0.1,
                                   latencies=[0.04], work=[(10, 20, 30)])
    assert read(untraced) is None
    no_device = _ctx([(2, 6)])
    no_device.busy_s = 0.0
    assert read(no_device) is None
