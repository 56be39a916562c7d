"""The host side of the port's device passes (``ops.host_rows``) on the
CPU, without the JAX package.

* one ``VectorEncoder`` and one ``VectorDecoder`` take a batch of small
  and big blocks twice in a row, with and without a dictionary, and give
  the bytes of the same blocks sent one call each: the segment rows of
  the big blocks never share a kept buffer with the small rows waiting
  for their pass, and no batch sees another's bytes;
* ``models.cuda`` and ``encode_sequencer.compress_block`` encode through
  one kept strict encoder a device, and ``decode_sequencer`` decodes
  through one kept sequencer decoder;
* every layout of a device pass's rows (decode's ``pack_blocks`` and
  ``pack_windows`` and the vector decoder's own rows, ``window_rows``
  from fresh memory and from a kept buffer, ``segment_rows``, the
  pipeline's ``pack_blocks`` with pad rows, the sequencer engines' own
  rows) equals rows laid a byte string at a time into zeros, from fresh
  memory and over stale bytes, through batches that grow and shrink;
* a thread keeps at most ``HostRows.KEEP`` bytes a buffer;
* ``upload`` never hands back a tensor over a kept buffer on the CPU,
  and ``fetch`` brings back bytes, not words.
"""

from types import SimpleNamespace


import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # the test workers share the cores: one intra-op
                           # thread each, or they spin against each other

from lz4net_tpu_torch.models import cuda  # noqa: E402
from lz4net_tpu_torch.models import native  # noqa: E402
from lz4net_tpu_torch.ops import decode_sequencer as ds  # noqa: E402
from lz4net_tpu_torch.ops import decode_vector as dv  # noqa: E402
from lz4net_tpu_torch.ops import encode_sequencer as es  # noqa: E402
from lz4net_tpu_torch.ops import encode_vector as ev  # noqa: E402
from lz4net_tpu_torch.ops import host_rows  # noqa: E402
from lz4net_tpu_torch.parallel import pipeline  # noqa: E402
from lz4net_tpu_torch.utils import corpus  # noqa: E402

DATA = corpus.silesia_like(300_000, seed=24)
# small rows around a block of three 64 KB segments, then a shorter batch
MIXED = [DATA[:5000], DATA[10_000:150_000], b"", DATA[150_000:153_000]]
SHORT = [DATA[200_000:201_000], DATA[160_000:260_000]]
WINDOW = DATA[260_000:300_000]


@pytest.mark.parametrize("dictionary", [None, WINDOW],
                         ids=["plain", "window"])
def test_mixed_batches_twice_equal_one_call_a_block(dictionary):
    enc, dec = ev.VectorEncoder("cpu"), dv.VectorDecoder("cpu")
    got = [enc.encode_batch(MIXED, dictionary=dictionary),
           enc.encode_batch(SHORT, dictionary=dictionary),
           enc.encode_batch(MIXED, dictionary=dictionary)]
    one = [enc.encode_batch([b], dictionary=dictionary)[0] for b in MIXED]
    assert got[0] == got[2] == one
    assert got[1] == [enc.encode_batch([b], dictionary=dictionary)[0]
                      for b in SHORT]
    assert enc.host_encodes == 0
    live = [(p, len(b)) for p, b in zip(one, MIXED) if b]
    payloads, lens = [p for p, _ in live], [n for _, n in live]
    twice = [dec.decode_batch(payloads, lens, dictionary),
             dec.decode_batch(payloads[::-1], lens[::-1], dictionary),
             dec.decode_batch(payloads, lens, dictionary)]
    assert twice[0] == twice[2] == [b for b in MIXED if b] \
        == twice[1][::-1]
    assert dec.host_decodes == 0


def test_one_strict_encoder_and_sequencer_decoder_a_device(monkeypatch):
    seen = []
    encode_batch = es.SequencerEncoder.encode_batch

    def spy(self, *args):
        seen.append(self)
        return encode_batch(self, *args)

    monkeypatch.setattr(es.SequencerEncoder, "encode_batch", spy)
    blocks = [DATA[:3000], DATA[3000:4000]]
    want = [native.compress_block(b) for b in blocks]
    assert cuda.compress_blocks(blocks, device="cpu") == want
    assert cuda.compress_blocks(blocks[::-1], device="cpu") == want[::-1]
    assert cuda.compress_block(blocks[0], device="cpu") == want[0]
    assert es.compress_block(blocks[1], device=torch.device("cpu")) \
        == want[1]
    kept = host_rows.kept(es.SequencerEncoder, "cpu")
    assert len(seen) == 4 and all(e is kept for e in seen)
    assert kept.device == torch.device("cpu")
    assert ds.decompress_block(want[0], 3000, device="cpu") == blocks[0]
    assert host_rows.kept(ds.SequencerDecoder, "cpu") \
        is host_rows.kept(ds.SequencerDecoder, torch.device("cpu"))
    # the vector engines are kept by the same rule
    assert cuda.encoder("cpu") is host_rows.kept(ev.VectorEncoder, "cpu")
    assert cuda.decoder("cpu") is host_rows.kept(dv.VectorDecoder, "cpu")


def _plain(x, bufs, at=0, end=None):
    """``bufs`` into zero rows ``x`` a byte string at a time, each from
    column ``at`` or ending at column ``end``: what every layout gives."""
    for j, b in enumerate(bufs):
        lo = at if end is None else end - len(b)
        x[j, lo:lo + len(b)] = np.frombuffer(bytes(b), np.uint8)
    return x


def _zeros(blocks, width):
    return np.zeros((len(blocks), width), np.uint8)


def _windows(d, B):
    return [w[-65536:] for w in ([d] * B if isinstance(d, bytes) else d)]


def _lens(blocks):
    return [len(b) + 3 for b in blocks]


def _pack_blocks(blocks, d, e):
    x = dv.pack_blocks(blocks, _lens(blocks))[0]
    want = _plain(_zeros(blocks, x.shape[1]), blocks)
    return [(x, want), (e.dec._layout(blocks, _lens(blocks))[0], want)]


def _pack_windows(blocks, d, e):
    d = d or [b[:7000] for b in blocks]     # a window a row
    x = dv.pack_windows(d, len(blocks))[0]
    P = x.shape[1]
    want = _plain(_zeros(blocks, P), _windows(d, len(blocks)), end=P)
    return [(x, want), (e.dec._layout(blocks, _lens(blocks), d)[5], want)]


def _window_rows(blocks, d, e):
    x, _dl, _pl, P, D, *_ = ev.window_rows(blocks, d)
    want = _plain(_zeros(blocks, D), _windows(d, len(blocks)) if d else [],
                  end=P)
    want = _plain(want, blocks, at=P)
    return [(x, want), (ev.window_rows(blocks, d, e.rows.empty)[0], want)]


def _segment_rows(blocks, d, e):
    segs = ev.big_segments(blocks)
    x, _l, _pl, P, D, *_ = ev.segment_rows(blocks, segs, d)
    head = (d or b"")[-P:]
    want = _plain(_zeros(segs, D),
                  [(head + blocks[i][:s])[-P:] if s < P
                   else blocks[i][s - P:s] for i, s, _ in segs], end=P)
    return [(x, _plain(want, [blocks[i][s:s + n] for i, s, n in segs],
                       at=P))]


def _pipeline_rows(blocks, d, e):
    x = pipeline.pack_blocks(blocks, _lens(blocks), 4)[0]   # pad rows
    padded = blocks + [pipeline.PAD_BLOCK] * (-len(blocks) % 4)
    return [(x, _plain(_zeros(padded, x.shape[1]), padded))]


def _sequencer_rows(blocks, d, e, monkeypatch):
    got = []

    def enc(src, src_len, caps, O):
        got.append(src.numpy().copy())
        return (torch.zeros((src.shape[0], O), dtype=torch.uint8),
                torch.full_like(src_len, -1))

    def dec(comp, comp_len, out_len, D):
        got.append(comp.numpy().copy())
        return (torch.zeros((comp.shape[0], D), dtype=torch.uint8),
                torch.stack([comp_len, out_len], 1))

    monkeypatch.setattr(es, "encode_sequencer", enc)
    monkeypatch.setattr(ds, "decode_sequencer", dec)
    e.enc.encode_batch(blocks)
    e.sdec.decode_batch(blocks, [len(b) for b in blocks])
    want = _plain(_zeros(blocks, max(max(map(len, blocks)), 1)), blocks)
    return [(g, want) for g in got]


LAYOUTS = {f.__name__[1:]: f for f in (
    _pack_blocks, _pack_windows, _window_rows, _segment_rows,
    _pipeline_rows, _sequencer_rows)}


def _engines():
    return SimpleNamespace(
        dec=dv.VectorDecoder("cpu"), rows=host_rows.HostRows(),
        enc=es.SequencerEncoder("cpu"), sdec=ds.SequencerDecoder("cpu"))


@pytest.mark.parametrize("memory", ["fresh", "kept"])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_every_layout_equals_plain_rows(layout, memory, monkeypatch):
    """Fresh: new engines and buffers for every batch.  Kept: one set
    for every batch, so each lays over the bytes of the batches before
    it, and ``np.empty`` hands out memory filled with 0xA5, so the
    public routines' rows start stale too."""
    if memory == "kept":
        empty = np.empty

        def stale(shape, dtype=float, **kw):
            x = empty(shape, dtype, **kw)
            x.reshape(-1).view(np.uint8).fill(0xA5)
            return x

        monkeypatch.setattr(np, "empty", stale)
        engines = _engines()
    window = corpus.silesia_like(70000, seed=3)          # cut to 64 KB
    big = [corpus.silesia_like(9000, seed=s) for s in (1, 2)]
    small = [b"abc" * 10, b"", b"z"]
    huge = [corpus.silesia_like(140_000, seed=5), b"q" * 70_000]
    case = LAYOUTS[layout]
    for blocks, d in ((big, window), (small, None), (huge, window[:5]),
                      (small, window[:30000]), (big, None), (small, window)):
        e = engines if memory == "kept" else _engines()
        args = (monkeypatch,) if layout == "sequencer_rows" else ()
        for got, want in case(blocks, d, e, *args):
            np.testing.assert_array_equal(got, want)


def test_a_thread_keeps_at_most_keep_bytes():
    rows = host_rows.HostRows()
    rows.KEEP = 100
    a = rows.empty((2, 40))
    assert rows.buf.size == 80 and np.shares_memory(a, rows.buf)
    b = rows.empty((3, 40))              # over KEEP: fresh, not kept
    assert b.shape == (3, 40) and rows.buf.size == 80
    assert not np.shares_memory(b, rows.buf)
    c = rows.empty((5, 20))              # within KEEP: the buffer grows
    assert rows.buf.size == 100 and np.shares_memory(c, rows.buf)


def test_upload_copies_kept_rows_and_fetch_brings_bytes():
    rows = host_rows.HostRows()
    x = host_rows.broadcast(rows.empty((3, 8)), b"w", 2)
    x = host_rows.lay(x, [b"abc", b"", b"de"], at=2)
    raw, lens, none = host_rows.upload("cpu", x, [3, 0, 2], None)
    wide, = host_rows.upload("cpu", x, widen=True)
    assert raw.dtype == torch.uint8 and wide.dtype == torch.int32
    assert none is None and lens.dtype == torch.int32
    host_rows.lay(rows.empty((3, 8)), [b"zzzzzzzz"] * 3)   # reuse it
    assert torch.equal(raw, wide.to(torch.uint8))
    assert bytes(raw[0].numpy()) == b"\0wabc\0\0\0"
    out, got_lens, ok = host_rows.fetch(wide, lens,
                                        torch.tensor([True, False, True]))
    assert out.dtype == np.uint8 and out.shape == (3, 8)
    assert out[2].tobytes() == b"\0wde\0\0\0\0"
    assert got_lens.tolist() == [3, 0, 2] and ok.tolist() == [True, False,
                                                              True]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            host_rows.upload("cuda", x)
