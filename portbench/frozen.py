"""The benchmark's frozen compressor (``native/lz4_frozen.cpp``) over ctypes.

It makes the compressed inputs of the read cells: the reference
compressor's greedy parse of each block, never the program's output.  The
library is built with the host's C++ compiler (``$CXX``, default ``g++``)
at first use into ``portbench/_build/frozen-<digest>/``, the digest taken
over the source, the flags and the compiler's version; a build goes to a
temporary directory beside it and is moved into place, so ranks that build
at once never load a half-written file.  A later run of the same checkout
loads it from there.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading

import numpy as np

from portbench.reference import maximum_output_length

HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(HERE, "native", "lz4_frozen.cpp")
BUILD_DIR = os.path.join(HERE, "_build")
CXX_FLAGS = ["-O2", "-fPIC", "-std=c++17", "-pthread", "-shared"]

_lib = None
_lock = threading.Lock()


def _cxx() -> str:
    cxx = os.environ.get("CXX", "g++")
    if shutil.which(cxx) is None:
        raise RuntimeError(f"C++ compiler {cxx!r} not found: the frozen "
                           f"compressor cannot be built")
    return cxx


def _digest(cxx: str) -> str:
    version = subprocess.run([cxx, "--version"], capture_output=True,
                             text=True, check=True).stdout
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode() + version.encode())
    with open(SOURCE, "rb") as fh:
        h.update(fh.read())
    return h.hexdigest()[:16]


def build() -> str:
    """Build the library unless this checkout has it; returns its path."""
    path = os.path.join(BUILD_DIR, f"frozen-{_digest(_cxx())}",
                        "libpbfrozen.so")
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = tempfile.mkdtemp(dir=BUILD_DIR)
    try:
        out = os.path.join(tmp, "libpbfrozen.so")
        proc = subprocess.run([_cxx(), *CXX_FLAGS, SOURCE, "-o", out],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"building {SOURCE} failed:\n{proc.stderr}")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        os.replace(out, path)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return path


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            p, i32 = ctypes.c_void_p, ctypes.c_int32
            lib.pb_compress_batch.argtypes = [p, p, p, p, p, p, p, i32]
            lib.pb_compress_batch.restype = None
            _lib = lib
    return _lib


def compress_blocks(blocks) -> list[bytes]:
    """The reference compressor's payload of every block (each within its
    worst-case bound, so none is refused)."""
    lib = _load()
    lens = np.array([len(b) for b in blocks], np.int32)
    src = np.frombuffer(b"".join(blocks), np.uint8)
    src_off = np.zeros(len(blocks), np.int64)
    src_off[1:] = np.cumsum(lens[:-1], dtype=np.int64)
    caps = np.array([maximum_output_length(n) for n in lens], np.int32)
    dst_off = np.zeros(len(blocks), np.int64)
    dst_off[1:] = np.cumsum(caps[:-1], dtype=np.int64)
    dst = np.zeros(int(caps.sum()), np.uint8)
    written = np.zeros(len(blocks), np.int32)
    lib.pb_compress_batch(src.ctypes.data, src_off.ctypes.data,
                          lens.ctypes.data, dst.ctypes.data,
                          dst_off.ctypes.data, caps.ctypes.data,
                          written.ctypes.data, len(blocks))
    if len(blocks) and (written <= 0).any():
        raise RuntimeError("the frozen compressor refused a block")
    return [dst[o:o + n].tobytes() for o, n in zip(dst_off, written)]
