"""Blocks over 96 KB: the host-side segmentation of big-block decode and
the literal pieces of big-block encode.

Port of ``lz4net_tpu/ops/bigblock.py``.  The device passes take blocks
of at most 96 KB (decoded and compressed), but the block format takes
blocks of any size and the stream's default chunk is 1 MB
(``src/LZ4/LZ4Stream.cs:119`` of the reference).  A big block decodes as
a sequence of fragments of at most 96 KB of output:

* a walk over the sequence headers (``scan``; literal bytes are skipped
  by length, never read) places a boundary at the first sequence that
  starts at or past every ``OUT_TARGET`` output bytes;
* a fragment is the compressed bytes between two boundaries with a
  ``0x00`` token (an empty final literal run) appended, so every
  fragment is a self-contained block whose matches may reach up to 64 KB
  before its output start: the decoder's prefix window holds the block's
  previous 64 KB of output;
* a sequence whose output spans more than ``OUT_TARGET`` bytes (a
  giant: a long run of equal bytes, or a long incompressible literal
  run; the same walk lists them) is cut into synthetic pieces, pure
  literal runs copied verbatim and pure matches of the same offset,
  which the same decoder reads.

The JAX package walks twice in its native C++ library
(``lz4_oracle.cpp``: ``lz4tpu_segment_index``, ``lz4tpu_giant_seqs``);
the port walks once, in its own copy of that library
(``models/native.scan``, ``lz4h_scan``), with the same results, ``None``
included, on every input.  ``scan_reference`` is the same walk in
Python, its plain version, which the tests hold it against; no card
path calls it.  It is host work in the JAX package too; a walk on the
card over ``parse_tokens``' marks could replace it.
"""

from __future__ import annotations

from ..models import native

OUT_TARGET = 48 * 1024          # boundary spacing; a segment is < 2x this
MAX_SEG_OUT = 96 * 1024         # the device passes' cap
WINDOW = 65536


def _synth_literals(data: bytes) -> bytes:
    """A pure-literal sequence encoding ``data`` verbatim (a valid
    standalone block: it ends with literals)."""
    n = len(data)
    if n < 15:
        return bytes([n << 4]) + data
    e = n - 15
    ext = b"\xff" * (e // 255) + bytes([e % 255])
    return b"\xf0" + ext + data


def _synth_match(off: int, ml: int) -> bytes:
    """A zero-literal match sequence (token|offset|extension); the
    caller appends the 0x00 terminator to make a valid fragment."""
    m = ml - 4
    if m < 15:
        return bytes([m]) + off.to_bytes(2, "little")
    e = m - 15
    ext = b"\xff" * (e // 255) + bytes([e % 255])
    return bytes([15]) + off.to_bytes(2, "little") + ext


def scan(block: bytes):
    """The header walk of ``block`` on the native host engine
    (``models/native.scan``): ``scan_reference``'s result on every
    input."""
    return native.scan(block, OUT_TARGET)


def scan_reference(block: bytes):
    """One walk over the sequence headers of ``block`` (literal bytes are
    skipped by length, never read): (comp_offs, out_offs, out_len,
    giants, last), or None for malformed input.

    * comp_offs, out_offs: the compressed and output offsets of the first
      sequence at or past each ``OUT_TARGET`` mark, the first (0, 0);
      out_len: the block's decoded length (the JAX package's
      ``lz4tpu_segment_index``; None beyond ``len(block) // 16 + 2``
      boundaries, the arrays ``models/native.scan`` sizes);
    * giants: the sequences whose output spans more than ``OUT_TARGET``
      bytes, each (comp_off, out_off, lit_len, lit_src, match_off,
      match_len) (its ``lz4tpu_giant_seqs``), or None beyond
      ``len(block) // OUT_TARGET + 8`` of them;
    * last: the output offsets where the block's last sequence with a
      match ends its literals and its match, which the block-end rules
      of the known-length decoders bind on; None without a match.

    The JAX package's native library walks twice; on every input where
    its first walk succeeds the second walks the same headers, so one
    walk gives both.  The plain version of ``scan``.
    """
    n = len(block)
    if n <= 0:
        return None
    max_segs = max(2, n // 16 + 2)
    max_g = max(2, n // OUT_TARGET + 8)
    comp_offs, out_offs, giants = [], [], []
    last = None
    p = o = next_mark = 0
    while p < n:
        if o >= next_mark:
            if len(comp_offs) >= max_segs:
                return None
            comp_offs.append(p)
            out_offs.append(o)
            next_mark = o + OUT_TARGET
        seq_c = p
        token = block[p]
        p += 1
        ll = token >> 4
        if ll == 15:
            while p < n and block[p] == 255:
                ll += 255
                p += 1
            if p >= n:
                return None
            ll += block[p]
            p += 1
        lsrc = p
        p += ll
        if p >= n:
            if p > n:
                return None
            ml = off = 0                # the final literal run
        else:
            off = block[p] | (block[p + 1] << 8 if p + 1 < n else 0)
            p += 2
            ml = token & 15
            if ml == 15:
                while p < n and block[p] == 255:
                    ml += 255
                    p += 1
                if p >= n:
                    return None
                ml += block[p]
                p += 1
            ml += 4
        if ll + ml > OUT_TARGET and giants is not None:
            if len(giants) >= max_g:
                giants = None
            else:
                giants.append((seq_c, o, ll, lsrc, off, ml))
        o += ll + ml
        if not ml:
            break
        last = (o - ml, o)
    if p != n:
        return None
    return comp_offs, out_offs, o, giants, last


def split_fragments(block: bytes, out_len: int, walk=None):
    """Split one compressed block into device-sized fragments.

    Returns a list of (fragment_bytes, out_start, out_span) where each
    fragment is a self-contained LZ4 block decoding ``out_span`` bytes
    at output offset ``out_start``, with matches reaching at most 64 KB
    before ``out_start``.  Returns None where the stream is malformed
    (the host path).  ``walk`` is the block's ``scan``, if the caller
    has walked it already."""
    s = scan(block) if walk is None else walk
    if s is None or s[3] is None:
        return None
    comp_offs, out_offs, giants = s[0], s[1], s[3]

    bounds = list(zip(comp_offs, out_offs))
    bounds.append((len(block), out_len))
    frags = []
    gi = 0
    for k in range(len(comp_offs)):
        c0, o0 = bounds[k]
        c1, o1 = bounds[k + 1]
        # the giants inside this segment
        seg_giants = []
        while gi < len(giants) and giants[gi][0] < c1:
            if giants[gi][0] >= c0:
                seg_giants.append(giants[gi])
            gi += 1
        if not seg_giants:
            if o1 - o0 > MAX_SEG_OUT:
                return None              # the walk's bound broken
            frag = block[c0:c1] + (b"\x00" if c1 < len(block) else b"")
            frags.append((frag, o0, o1 - o0))
            continue
        # split around each giant sequence
        cur_c, cur_o = c0, o0
        for (g_c, g_o, g_ll, g_lsrc, g_off, g_ml) in seg_giants:
            if g_c > cur_c:              # the whole sequences before it
                frags.append((block[cur_c:g_c] + b"\x00", cur_o,
                              g_o - cur_o))
            # the literal part, in OUT_TARGET slices
            pos = 0
            while pos < g_ll:
                take = min(OUT_TARGET, g_ll - pos)
                data = block[g_lsrc + pos:g_lsrc + pos + take]
                frags.append((_synth_literals(data), g_o + pos, take))
                pos += take
            # the match part, in OUT_TARGET slices of >= 4 bytes each
            mpos = 0
            while mpos < g_ml:
                take = min(OUT_TARGET, g_ml - mpos)
                if g_ml - (mpos + take) in (1, 2, 3):
                    take = g_ml - mpos - 4     # keep the tail >= 4
                frags.append((_synth_match(g_off, take) + b"\x00",
                              g_o + g_ll + mpos, take))
                mpos += take
            # on after the giant sequence
            cur_c, cur_o = _seq_end(block, g_c), g_o + g_ll + g_ml
        if c1 > cur_c:
            frag = block[cur_c:c1] + (b"\x00" if c1 < len(block) else b"")
            frags.append((frag, cur_o, o1 - cur_o))
        elif c1 == cur_c and o1 != cur_o:
            return None
    return frags


def _seq_end(block: bytes, p: int) -> int:
    """Compressed end offset of the sequence starting at ``p``."""
    token = block[p]
    p += 1
    ll = token >> 4
    if ll == 15:
        while block[p] == 255:
            ll += 255
            p += 1
        ll += block[p]
        p += 1
    p += ll
    if p >= len(block):
        return p
    p += 2
    if (token & 15) == 15:
        while block[p] == 255:
            p += 1
        p += 1
    return p
