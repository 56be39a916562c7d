"""Build the port's CUDA kernels at first use and load them with ctypes.

Every ``csrc/*.cu`` is compiled by ``nvcc`` for ``sm_90a`` (one process
per source, all started together) and linked into one shared library
with a plain C interface, kept under ``_build/<hash of the sources>/``
beside this file.  Nothing here includes PyTorch's headers, so a build
takes seconds.  There is no fallback: without ``nvcc`` or a card,
``load()`` raises.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(HERE, "csrc")
BUILD_DIR = os.path.join(HERE, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC"]

_P, _I = ctypes.c_void_p, ctypes.c_int
# C entry points: argument types, the stream last (csrc/*.cu)
SIGNATURES = {
    "lz4t_parse_tokens": [_P] * 6 + [_I, _I, _P],
    "lz4t_records_to_state": [_P] * 12 + [_I, _I, _I, _I, _P],
    "lz4t_rowbase_gather": [_P] * 4 + [_I, _I, _I, _P],
    "lz4t_resolve_wavefront": [_P] * 4 + [_I, _I, _I, _P],
    "lz4t_bucket_prev": [_P] * 6 + [_I, _I, _P],
    "lz4t_match_lengths": [_P] * 11 + [_I] * 5 + [_P],
    "lz4t_sequence_records": [_P] * 13 + [_I] * 6 + [_P],
    "lz4t_emit_bytes": [_P] * 8 + [_I, _I, _I, _P],
    "lz4t_hc_tables": [_P] * 4 + [_I] * 3 + [_P],
    "lz4t_encode_sequencer": [_P] * 5 + [_I] * 3 + [_P],
    "lz4t_encode_sequencer_row_max": [_P, _P],
    "lz4t_decode_sequencer": [_P] * 5 + [_I] * 3 + [_P],
    "lz4t_decode_sequencer_row_max": [_P, _P],
    "lz4t_mark_chain": [_P] * 2 + [_I] * 2 + [_P],
    "lz4t_table_gather": [_P] * 9 + [_I] * 8 + [_P],
    "lz4t_lane_lookup": [_P] * 3 + [_I, _P],
    "lz4t_diag_gather": [_P] * 4 + [_I] * 4 + [_P],
}

_lib = None
_lock = threading.Lock()


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(glob.glob(os.path.join(CSRC, "*"))):
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as fh:
            h.update(fh.read())
    return h.hexdigest()[:16]


def _compile(lib_path: str) -> None:
    nvcc = _nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = tempfile.mkdtemp(dir=BUILD_DIR)
    try:
        objs, procs = [], []
        for src in sorted(glob.glob(os.path.join(CSRC, "*.cu"))):
            obj = os.path.join(tmp, os.path.basename(src) + ".o")
            objs.append(obj)
            procs.append((src, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-I", CSRC, "-c", src, "-o", obj],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
        failed = []
        for src, proc in procs:
            log, _ = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"{src}:\n{log.decode(errors='replace')}")
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        out = os.path.join(tmp, "liblz4t.so")
        subprocess.run([nvcc, *NVCC_FLAGS, "-shared", "-o", out, *objs],
                       check=True, capture_output=True)
        os.makedirs(os.path.dirname(lib_path), exist_ok=True)
        os.replace(out, lib_path)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def load() -> ctypes.CDLL:
    """The kernels' shared library, built on first use in this checkout."""
    global _lib
    with _lock:
        if _lib is None:
            if not torch.cuda.is_available():
                raise RuntimeError("the CUDA kernels need a CUDA device")
            lib_path = os.path.join(BUILD_DIR, _digest(), "liblz4t.so")
            if not os.path.exists(lib_path):
                _compile(lib_path)
            lib = ctypes.CDLL(lib_path)
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
    return _lib


def launch(name: str, device: torch.device, *args) -> None:
    """Call C entry ``name`` on ``device``'s current stream, with that
    device current; raise on a CUDA error."""
    fn = getattr(load(), name)
    with torch.cuda.device(device):
        rc = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc}")
