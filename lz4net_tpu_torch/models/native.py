"""ctypes bindings to the port's native host engine (``native/
lz4_oracle.cpp``), the counterpart of ``lz4net_tpu/models/native.py``.

The library is the port's own copy of the JAX package's C++ oracle, the
role the reference's mixed-mode native engine plays: strict HC and
strict dictionary encode, the host re-decodes and re-encodes of the
card's paths, the header walks of big-block decode (``scan``,
``unknown_output_length``) and the certify tool run on it.  It needs no
card: ``build()`` compiles it at first use with the host C++ compiler
(``$CXX``, default ``g++``; ``CXX_FLAGS``) into
``lz4net_tpu_torch/_build/host-<digest>/``, the digest taken over the
source, the flags, the compiler's version and what ``-march=native``
means on this CPU, so a library built for another CPU is never loaded.
A missing compiler or a failed build raises ``RuntimeError`` with the
compiler's log; nothing falls back to the Python codecs.

The decoders raise ``CorruptedBlockError`` with the messages of the
matching Python decoders of ``models.reference``, whose rules they keep.
``bytes`` inputs cross the boundary zero-copy through ``c_char_p``;
each call writes its output into a buffer of its own.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import platform
import shutil
import subprocess
import tempfile
import threading

import numpy as np

from ..constants import MAX_NB_ATTEMPTS, maximum_output_length
from .reference import CorruptedBlockError

HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(os.path.dirname(HERE), "native", "lz4_oracle.cpp")
BUILD_DIR = os.path.join(os.path.dirname(HERE), "_build")
CXX_FLAGS = ["-O3", "-march=native", "-fPIC", "-std=c++17", "-pthread"]
LIB_NAME = "liblz4h.so"

# each Fault of lz4_oracle.cpp as the message of the Python decoder that
# breaks on the same rule (models/reference.py)
_KNOWN = {1: "truncated input", 2: "literal run overruns block end",
          3: "literal run overruns input", 4: "match offset outside block",
          5: "match extends into last-5-literals zone"}
_DICT = {**_KNOWN, 4: "match offset outside window",
         5: "match extends into last-5 zone"}
_UNKNOWN = {1: "truncated input", 2: "output overflow",
            3: "input not fully consumed at terminal run",
            4: "match offset outside block",
            5: "match extends into last-5-literals zone", 6: "empty input"}
_FRAGMENT = {4: "match offset outside window",
             7: "truncated literal length", 8: "truncated match offset",
             9: "truncated match length",
             10: "literal run overruns the fragment",
             11: "match overruns the fragment"}

_lib = None
_lock = threading.Lock()

_i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
_i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_bp = ctypes.c_char_p                  # zero-copy view of bytes inputs
_op = ctypes.POINTER(ctypes.c_char)    # output buffer
_I, _L = ctypes.c_int, ctypes.c_int64
SIGNATURES = {                         # name: (restype, argtypes)
    "lz4h_compress": (_I, [_bp, _I, _op, _I]),
    "lz4h_compress_hc": (_I, [_bp, _I, _op, _I, _I]),
    "lz4h_decompress": (_I, [_bp, _I, _op, _I]),
    "lz4h_decompress_unknown": (_L, [_bp, _I, _op, _L, _L]),
    "lz4h_unknown_output_length": (_L, [_bp, _I, _L]),
    "lz4h_compress_dict": (_I, [_bp, _I, _I, _op, _I]),
    "lz4h_compress_hc_dict": (_I, [_bp, _I, _I, _op, _I, _I]),
    "lz4h_decompress_dict": (_I, [_bp, _I, _op, _I, _I]),
    "lz4h_decompress_fragment": (_L, [_bp, _I, _op, _I, _I]),
    "lz4h_scan": (_I, [_bp, _L, _L, _i64p, _i64p, _L, _i64p, _L, _i64p]),
    "lz4h_compress_batch": (None, [_bp, _i64p, _i32p, _op, _i64p,
                                   ctypes.c_int32, _i32p, ctypes.c_int32,
                                   ctypes.c_int32]),
    "lz4h_decompress_batch": (None, [_bp, _i64p, _i32p, _op, _i64p, _i32p,
                                     _i32p, ctypes.c_int32]),
}


def _compiler() -> str:
    return os.environ.get("CXX") or "g++"


def _ask(cmd) -> str:
    """``cmd``'s output; RuntimeError where the compiler cannot run."""
    try:
        r = subprocess.run(cmd, capture_output=True, text=True, timeout=120,
                           stdin=subprocess.DEVNULL)
    except (OSError, subprocess.SubprocessError) as exc:
        raise RuntimeError(f"the native engine cannot be built: "
                           f"{' '.join(cmd)}: {exc}") from exc
    if r.returncode != 0:
        raise RuntimeError(f"the native engine cannot be built: "
                           f"{' '.join(cmd)} exited {r.returncode}:\n"
                           f"{r.stdout}{r.stderr}")
    return r.stdout


@functools.lru_cache(maxsize=None)
def _digest(cxx: str, source: str) -> str:
    """The build's key: the source, the flags, the compiler's version,
    the machine and the target macros ``-march=native`` sets here (once
    a process for each compiler and source)."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    with open(source, "rb") as fh:
        h.update(fh.read())
    h.update(platform.machine().encode())
    h.update(_ask([cxx, "--version"]).encode())
    h.update(_ask([cxx, "-march=native", "-dM", "-E", "-x", "c++",
                   os.devnull]).encode())
    return h.hexdigest()[:16]


def build() -> str:
    """The path of the host library, compiled first if this compiler and
    CPU have none yet (in a temporary directory, then moved into place,
    so concurrent builds never see a partial file).  Raises
    ``RuntimeError`` with the compiler's log where it cannot be built."""
    cxx = _compiler()
    lib_path = os.path.join(BUILD_DIR, f"host-{_digest(cxx, SOURCE)}",
                            LIB_NAME)
    if os.path.exists(lib_path):
        return lib_path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = tempfile.mkdtemp(dir=BUILD_DIR)
    try:
        out = os.path.join(tmp, LIB_NAME)
        _ask([cxx, *CXX_FLAGS, "-shared", "-o", out, SOURCE])
        os.makedirs(os.path.dirname(lib_path), exist_ok=True)
        os.replace(out, lib_path)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return lib_path


def _load() -> ctypes.CDLL:
    """The host library, built and bound on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            for name, (restype, argtypes) in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.restype, fn.argtypes = restype, argtypes
            _lib = lib
    return _lib


def _out_buffer(size: int):
    """A zeroed output buffer of ``size`` bytes for one call."""
    return ctypes.create_string_buffer(max(1, size))


def _read(buf, start: int, n: int) -> bytes:
    """``n`` bytes of ``buf`` from ``start``."""
    return ctypes.string_at(ctypes.addressof(buf) + start, n)


def _sizes(*ns: int) -> None:
    """Refuse lengths that the library's C ints cannot hold: the block
    format's limit is below 2 GB."""
    if max(ns) > 2**31 - 1:
        raise ValueError(f"{max(ns)} bytes pass the block format's 2 GB "
                         f"limit")


def _raise(fault: int, messages: dict) -> None:
    raise CorruptedBlockError(messages.get(-fault,
                                           f"native fault {-fault}"))


# --- block encode -----------------------------------------------------------

def _encode(entry, n: int, dst_maxlen) -> bytes:
    """The payload ``entry(out, cap)`` writes, b"" where it does not fit
    ``dst_maxlen``.  A budget over the worst case for ``n`` input bytes
    (or None) is the worst case: the parse never reaches it.  The buffer
    holds the worst case whatever the budget: the reference's checks
    before a literal run and a match length count its 255-bytes as
    length >> 8, so a parse that passes them can write up to length /
    65,280 bytes past the budget before its last check refuses it (about
    65 bytes for a 4 MB run of zeros)."""
    worst = maximum_output_length(n)
    dst_maxlen = worst if dst_maxlen is None else min(dst_maxlen, worst)
    _sizes(worst)
    buf = _out_buffer(worst)
    written = entry(buf, dst_maxlen)
    return _read(buf, 0, written) if written > 0 else b""


def compress_block(src: bytes, dst_maxlen: int | None = None) -> bytes:
    """The reference compressor's greedy parse; b"" when longer than
    ``dst_maxlen``."""
    lib, src = _load(), bytes(src)
    if not src:
        return b""
    return _encode(lambda out, cap: lib.lz4h_compress(src, len(src), out,
                                                      cap),
                   len(src), dst_maxlen)


def compress_block_hc(src: bytes, dst_maxlen: int | None = None,
                      attempts: int = MAX_NB_ATTEMPTS) -> bytes:
    """The reference HC parse with ``attempts`` chain steps (256: the
    reference's); b"" when longer than ``dst_maxlen``."""
    lib, src = _load(), bytes(src)
    if not src:
        return b""
    return _encode(lambda out, cap: lib.lz4h_compress_hc(
        src, len(src), out, cap, attempts), len(src), dst_maxlen)


def compress_block_dict(dictionary: bytes, data: bytes,
                        dst_maxlen: int | None = None) -> bytes:
    """Greedy parse of ``data`` behind a preset dictionary."""
    lib = _load()
    dictionary, data = bytes(dictionary), bytes(data)
    if not data:
        return b""
    src = dictionary + data
    _sizes(len(src))
    return _encode(lambda out, cap: lib.lz4h_compress_dict(
        src, len(dictionary), len(src), out, cap), len(data), dst_maxlen)


def compress_block_hc_dict(dictionary: bytes, data: bytes,
                           dst_maxlen: int | None = None,
                           attempts: int = MAX_NB_ATTEMPTS) -> bytes:
    """HC parse of ``data`` behind a preset dictionary."""
    lib = _load()
    dictionary, data = bytes(dictionary), bytes(data)
    if not data:
        return b""
    src = dictionary + data
    _sizes(len(src))
    return _encode(lambda out, cap: lib.lz4h_compress_hc_dict(
        src, len(dictionary), len(src), out, cap, attempts), len(data),
        dst_maxlen)


# --- block decode -----------------------------------------------------------

def decompress_block(src: bytes, output_length: int) -> bytes:
    """Known-length decode of exactly ``output_length`` bytes
    (``reference.decompress_block``); raises CorruptedBlockError."""
    lib, src = _load(), bytes(src)
    _sizes(len(src), output_length)
    buf = _out_buffer(output_length)
    got = lib.lz4h_decompress(src, len(src), buf, output_length)
    if got < 0:
        _raise(got, _KNOWN)
    return _read(buf, 0, output_length)


def decompress_block_dict(src: bytes, dictionary: bytes,
                          output_length: int) -> bytes:
    """Known-length decode behind a preset dictionary
    (``reference.decompress_block_dict``)."""
    dictionary = bytes(dictionary)
    if not dictionary:
        return decompress_block(src, output_length)
    lib, src = _load(), bytes(src)
    dict_len = len(dictionary)
    _sizes(len(src), dict_len + output_length)
    buf = _out_buffer(dict_len + max(output_length, 0))
    ctypes.memmove(buf, dictionary, dict_len)
    got = lib.lz4h_decompress_dict(src, len(src), buf, dict_len,
                                   output_length)
    if got < 0:
        _raise(got, _DICT)
    return _read(buf, dict_len, output_length)


def unknown_output_length(src: bytes, max_output_length: int) -> int:
    """The length ``decompress_block_unknown`` decodes ``src`` to, from
    the hardened decoder's header walk alone
    (``reference.unknown_output_length``); raises its error."""
    src = bytes(src)
    _sizes(len(src))
    n = _load().lz4h_unknown_output_length(src, len(src), max_output_length)
    if n < 0:
        _raise(n, _UNKNOWN)
    return n


def decompress_block_unknown(src: bytes, max_output_length: int) -> bytes:
    """The hardened unknown-output-length decoder
    (``reference.decompress_block_unknown``): the block's bytes, at most
    ``max_output_length``; raises CorruptedBlockError."""
    lib, src = _load(), bytes(src)
    n = unknown_output_length(src, max_output_length)
    buf = _out_buffer(n)
    got = lib.lz4h_decompress_unknown(src, len(src), buf, max_output_length,
                                      n)
    if got < 0:
        _raise(got, _UNKNOWN)
    return _read(buf, 0, n)


def decompress_fragment(src: bytes, window: bytes, out_len: int) -> bytes:
    """Decode a mid-block fragment (``ops/bigblock.py``) of exactly
    ``out_len`` bytes behind ``window``, without the block-end rules
    (``reference.decompress_fragment``)."""
    lib = _load()
    src, window = bytes(src), bytes(window)
    if out_len == 0:
        return b""
    dict_len = len(window)
    _sizes(len(src), dict_len + out_len)
    buf = _out_buffer(dict_len + max(out_len, 0))
    ctypes.memmove(buf, window, dict_len)
    got = lib.lz4h_decompress_fragment(src, len(src), buf, dict_len,
                                       out_len)
    if got < 0:
        _raise(got, _FRAGMENT)
    if got != out_len:
        raise CorruptedBlockError(f"fragment decode: {got} != {out_len}")
    return _read(buf, dict_len, out_len)


# --- header walks -----------------------------------------------------------

def scan(block: bytes, out_target: int):
    """The big-block header walk (``ops.bigblock.scan``; its plain version
    is ``bigblock.scan_reference``): (comp_offs, out_offs, out_len,
    giants, last) for boundaries every ``out_target`` output bytes, or
    None for malformed input, beyond ``len(block) // 16 + 2`` boundaries;
    giants None beyond ``len(block) // out_target + 8`` of them."""
    lib, block = _load(), bytes(block)
    n = len(block)
    max_segs = max(2, n // 16 + 2)
    max_g = max(2, n // out_target + 8)
    comp = np.empty(max_segs, np.int64)
    out = np.empty(max_segs, np.int64)
    giants = np.empty((max_g, 6), np.int64)
    res = np.zeros(6, np.int64)
    if lib.lz4h_scan(block, n, out_target, comp, out, max_segs, giants,
                     max_g, res) < 0:
        return None
    k, g = int(res[1]), int(res[2])
    return (comp[:k].tolist(), out[:k].tolist(), int(res[0]),
            None if g < 0 else [tuple(r) for r in giants[:g].tolist()],
            (int(res[4]), int(res[5])) if res[3] else None)


# --- batched (multithreaded) paths -----------------------------------------

def compress_blocks(src: bytes, offsets, lengths, *,
                    hc_attempts: int = 0) -> tuple[bytes, np.ndarray]:
    """Compress many independent blocks of one contiguous buffer on a
    pool of threads, one for each hardware thread (``hc_attempts`` > 0: the HC parse).  Returns the
    payloads concatenated and their sizes.  Each block has the worst-case
    budget, so every block compresses."""
    lib, src = _load(), bytes(src)
    offsets = np.ascontiguousarray(offsets, dtype=np.int64)
    lengths = np.ascontiguousarray(lengths, dtype=np.int32)
    n_blocks = len(offsets)
    if n_blocks == 0:
        return b"", np.zeros(0, np.int32)
    budget = maximum_output_length(int(lengths.max()))
    dst_offsets = np.arange(n_blocks, dtype=np.int64) * budget
    buf = _out_buffer(n_blocks * budget)
    results = np.zeros(n_blocks, np.int32)
    lib.lz4h_compress_batch(src, offsets, lengths, buf, dst_offsets, budget,
                            results, n_blocks, hc_attempts)
    return b"".join(_read(buf, i * budget, max(0, int(r)))
                    for i, r in enumerate(results)), results


def decompress_blocks(src: bytes, offsets, lengths,
                      out_lengths) -> tuple[bytes, np.ndarray]:
    """Decode many independent blocks of known lengths on a pool of
    threads, one for each hardware thread; returns the decoded bytes concatenated in input order and
    each block's bytes read.  Raises the first bad block's error."""
    lib, src = _load(), bytes(src)
    offsets = np.ascontiguousarray(offsets, dtype=np.int64)
    lengths = np.ascontiguousarray(lengths, dtype=np.int32)
    out_lengths = np.ascontiguousarray(out_lengths, dtype=np.int32)
    n_blocks = len(offsets)
    if n_blocks == 0:
        return b"", np.zeros(0, np.int32)
    dst_offsets = np.zeros(n_blocks, np.int64)
    np.cumsum(out_lengths[:-1], out=dst_offsets[1:])
    total = int(out_lengths.sum())
    buf = _out_buffer(total)
    results = np.zeros(n_blocks, np.int32)
    lib.lz4h_decompress_batch(src, offsets, lengths, buf, dst_offsets,
                              out_lengths, results, n_blocks)
    if (results < 0).any():
        _raise(int(results[np.argmax(results < 0)]), _KNOWN)
    return _read(buf, 0, total), results
