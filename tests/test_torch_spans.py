"""The port's phase spans (``lz4net_tpu_torch.spans``) on the CPU.

* under ``torch.profiler.profile(activities=[CPU])`` the encode engines,
  the decode engines and LZ4Stream's write and read paths mark their
  phases: a root a call (``lz4t.encode.batch``, ``lz4t.decode.batch``,
  ``lz4t.stream.chunk``) and, inside it, layout < upload < pass < fetch <
  unpack, each a leaf; one pass a batch, one chunk span a batch of
  chunks written, at most 8 spans a batch;
* a pass with a dictionary (and a big block's segment pass) lays its
  window rows inside one ``lz4t.encode.window`` span within its layout,
  the one span that a phase span holds; a pass without one opens none;
  ``VectorEncoder.window_bytes`` grows by B x P a pass;
* the bytes are the same with the profiler on and off;
* with no profiler running the spans never reach ``record_function``:
  with it made to raise, every entry point returns the same bytes.
"""

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # the test workers share the cores: one intra-op
                           # thread each, or they spin against each other

from torch.profiler import ProfilerActivity, profile  # noqa: E402

from lz4net_tpu_torch import spans, stream  # noqa: E402
from lz4net_tpu_torch.models import native  # noqa: E402
from lz4net_tpu_torch.ops import decode_sequencer  # noqa: E402
from lz4net_tpu_torch.ops import decode_vector  # noqa: E402
from lz4net_tpu_torch.ops import encode_sequencer  # noqa: E402
from lz4net_tpu_torch.ops import encode_vector  # noqa: E402
from lz4net_tpu_torch.utils import corpus  # noqa: E402

VectorEncoder = encode_vector.VectorEncoder
SequencerEncoder = encode_sequencer.SequencerEncoder
VectorDecoder = decode_vector.VectorDecoder
SequencerDecoder = decode_sequencer.SequencerDecoder
DATA = corpus.silesia_like(160_000, seed=20)
BLOCKS = [DATA[:5000], DATA[5000:12000], DATA[12000:15000]]
PACKED = [native.compress_block(b) for b in BLOCKS]
LENS = [len(b) for b in BLOCKS]
BIG = DATA[:140_000]                  # over 96 KB: segments, fragments
CHUNK = 4096
FILE = DATA[20_000:30_000]            # 3 chunks of CHUNK bytes
WINDOW = DATA[100_000:120_000]        # a preset dictionary: P = 24,576
ORDER = ["layout", "upload", "pass", "fetch", "unpack"]
ROOTS = ("lz4t.encode.batch", "lz4t.decode.batch", "lz4t.stream.chunk")
WINDOW_SPAN = "lz4t.encode.window"

CALLS = {
    "hc9": lambda: VectorEncoder("cpu").encode_batch(BLOCKS, hc_level=9),
    "fast": lambda: VectorEncoder("cpu").encode_batch(BLOCKS),
    "dict": lambda: VectorEncoder("cpu").encode_batch(BLOCKS,
                                                      dictionary=WINDOW),
    "strict": lambda: SequencerEncoder("cpu").encode_batch(BLOCKS),
    "stream": lambda: stream.compress_stream(FILE, block_size=CHUNK,
                                             device="cpu"),
    "decode": lambda: VectorDecoder("cpu").decode_batch(PACKED, LENS),
    "unknown": lambda: VectorDecoder("cpu").decode_batch_unknown(
        PACKED, [20_000] * len(PACKED)),
    "seq_decode": lambda: SequencerDecoder("cpu").decode_batch(PACKED, LENS),
    "read": lambda: stream.decompress_stream(
        stream.compress_stream(FILE, block_size=CHUNK, device="cpu"),
        device="cpu"),
}
BIG_CALLS = {
    "big_fast": lambda: VectorEncoder("cpu").encode_batch([BIG]),
    "big_decode": lambda: VectorDecoder("cpu").decode_batch(
        [native.compress_block(BIG)], [len(BIG)]),
}


def _traced(call):
    """The call's result and its ``lz4t.`` spans, (name, start, end) in
    microseconds, by start (an enclosing span before the spans in it)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        got = call()
    found = [(e.name, e.time_range.start, e.time_range.end)
             for e in prof.events() if e.name.startswith("lz4t.")]
    return got, sorted(found, key=lambda s: (s[1], -s[2]))


def _inside(s, p):
    return s is not p and p[1] <= s[1] and s[2] <= p[2]


def _phase(s):
    return s[0].rsplit(".", 1)[1]


def _batches(found, root):
    """Each root span with the spans inside it, in order."""
    return [(r, [s for s in found if _inside(s, r)])
            for r in found if r[0] == root]


@pytest.fixture(scope="module")
def traced():
    return {name: _traced(call) for name, call in
            {**CALLS, **BIG_CALLS}.items()}


@pytest.mark.parametrize("name,side", [
    ("hc9", "encode"), ("fast", "encode"), ("strict", "encode"),
    ("decode", "decode"), ("seq_decode", "decode")])
def test_phases_in_order_inside_each_batch(traced, name, side):
    _got, found = traced[name]
    batches = _batches(found, f"lz4t.{side}.batch")
    assert len(batches) == 1
    _root, inner = batches[0]
    assert [s[0] for s in inner] == [f"lz4t.{side}.{p}" for p in ORDER]
    assert all(a[2] <= b[1] for a, b in zip(inner, inner[1:]))
    assert len(inner) + 1 <= 8


@pytest.mark.parametrize("name", sorted({**CALLS, **BIG_CALLS}))
def test_phase_spans_are_leaves(traced, name):
    _got, found = traced[name]
    assert found
    phases = [s for s in found if s[0] not in ROOTS + (WINDOW_SPAN,)]
    for s in phases:
        assert _phase(s) in ORDER + ["frame"], s
        # a layout may hold its window span, and nothing else
        assert not any(_inside(o, s) for o in found if not (
            o[0] == WINDOW_SPAN and s[0] == "lz4t.encode.layout")), s
    for w in (s for s in found if s[0] == WINDOW_SPAN):
        assert not any(_inside(o, w) for o in found), w
    # every encode or decode phase lies inside its call's root
    for s in phases:
        side = s[0].split(".")[1]
        if side != "stream":
            assert any(_inside(s, r) for r in found
                       if r[0] == f"lz4t.{side}.batch"), s


@pytest.mark.parametrize("name", sorted({**CALLS, **BIG_CALLS}))
def test_at_most_eight_spans_a_small_batch_and_one_pass_a_pass(traced,
                                                               name):
    _got, found = traced[name]
    for side in ("encode", "decode"):
        for root, inner in _batches(found, f"lz4t.{side}.batch"):
            passes = [s for s in inner if _phase(s) == "pass"]
            assert passes
            # one pass, and its upload and fetch, a device pass
            for p in ("upload", "fetch"):
                assert sum(_phase(s) == p for s in inner) == len(passes)
            if not name.startswith("big"):
                assert len(passes) == 1 and len(inner) + 1 <= 8


def test_one_chunk_span_a_chunk_written(traced):
    got, found = traced["stream"]
    chunks = _batches(found, "lz4t.stream.chunk")
    # a chunk span a batch written: the write's two whole chunks in one,
    # the pending tail at close() in the other
    assert len(FILE) // CHUNK == 2 and len(chunks) == 2
    for _root, inner in chunks:
        names = [s[0] for s in inner]
        assert names[0] == names[-1] == "lz4t.stream.frame"
        assert names.count("lz4t.encode.batch") == 1
        assert names.count("lz4t.encode.pass") == 1
    # write()'s copies and getvalue() are framing outside the chunks
    outside = [s for s in found
               if not any(_inside(s, r) for r, _ in chunks)
               and s[0] != "lz4t.stream.chunk"]
    assert outside and {s[0] for s in outside} == {"lz4t.stream.frame"}
    assert got == stream.compress_stream(FILE, block_size=CHUNK,
                                         device="cpu")


def test_read_ahead_marks_its_chunks_and_the_decode(traced):
    got, found = traced["read"]
    assert got == FILE
    reads = [(r, inner) for r, inner in
             _batches(found, "lz4t.stream.chunk")
             if any(s[0] == "lz4t.decode.batch" for s in inner)]
    assert len(reads) == 1          # a read-all: one read-ahead, one batch
    _root, inner = reads[0]
    names = [s[0] for s in inner]
    assert names[0] == names[-1] == "lz4t.stream.frame"
    decode = [n for n in names if n.startswith("lz4t.decode.")]
    assert decode == ["lz4t.decode.batch"] + [f"lz4t.decode.{p}"
                                              for p in ORDER]


@pytest.mark.parametrize("name", sorted({**CALLS, **BIG_CALLS}))
def test_bytes_equal_with_the_profiler_on_and_off(traced, name):
    got, _found = traced[name]
    assert got == {**CALLS, **BIG_CALLS}[name]()


def test_the_off_path_never_enters_record_function(traced, monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) with tracing off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert not torch._C._autograd._profiler_enabled()
    with spans.span("lz4t.encode.batch") as inner:
        assert inner is None
    for name, call in {**CALLS, **BIG_CALLS}.items():
        assert call() == traced[name][0], name


@pytest.mark.parametrize("name", ["dict", "big_fast"])
def test_a_window_pass_opens_one_window_span_inside_its_layout(traced,
                                                               name):
    _got, found = traced[name]
    windows = [s for s in found if s[0] == WINDOW_SPAN]
    layouts = [s for s in found if s[0] == "lz4t.encode.layout"]
    passes = [s for s in found if s[0] == "lz4t.encode.pass"]
    assert len(windows) == len(passes) == 1
    assert [lay for lay in layouts if _inside(windows[0], lay)]


@pytest.mark.parametrize("name", sorted(
    n for n in {**CALLS, **BIG_CALLS} if n not in ("dict", "big_fast")))
def test_a_pass_without_a_dictionary_opens_no_window_span(traced, name):
    _got, found = traced[name]
    assert found and not [s for s in found if s[0] == WINDOW_SPAN]


def test_window_bytes_counts_the_window_positions_laid():
    enc = VectorEncoder("cpu")
    assert enc.window_bytes == 0
    enc.encode_batch(BLOCKS)
    assert enc.window_bytes == 0
    enc.encode_batch(BLOCKS, dictionary=WINDOW)
    p = decode_vector.pack_windows(WINDOW, 1)[2]
    assert p == 24_576 and enc.window_bytes == len(BLOCKS) * p
    # a big block's three 64 KB segments, each behind a 64 KB window
    enc.encode_batch([BIG])
    assert enc.window_bytes == len(BLOCKS) * p + 3 * 65_536
