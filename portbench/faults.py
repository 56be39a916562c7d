"""Faults planted under the timed path, for the tests that show the
check catches them (``test_portbench_faults.py``).  ``planted`` wraps the
op's entry point (``ENTRY``), or for ``exchange`` the gather between
ranks (``EXCHANGE``), in this process; nothing in a real run calls it.

* ``unchanged``: the call returns its input as its output;
* ``half``: the call is made on the first half of its input, and the
  rest of the answer left out (empty blocks, or a shorter stream);
* ``exchange``: each rank keeps only its own shard of a gather;
* ``altered``: one byte of each answer changed where it is produced;
* ``jax_elsewhere``: a rank other than 0 holds a stand-in module named
  ``jax`` (an empty module, never JAX itself), which the run must find.
"""

from __future__ import annotations

import contextlib
import functools
import importlib
import sys
import types

FAULTS = ("unchanged", "half", "exchange", "altered", "jax_elsewhere")


def _flip(b: bytes) -> bytes:
    if not b:
        return b"\x01"
    m = len(b) // 2
    return b[:m] + bytes([b[m] ^ 0x01]) + b[m + 1:]


def _halved(real, args, kwargs):
    first = args[0]
    half = len(first) // 2
    args = tuple(a[:half] if isinstance(a, (list, bytes)) and
                 len(a) == len(first) else a for a in args)
    out = real(*args, **kwargs)
    if isinstance(out, list):
        return out + [b""] * (len(first) - half)
    return out


def _wrapped(fault: str, real):
    @functools.wraps(real)
    def call(*args, **kwargs):
        if fault == "unchanged":
            first = args[0]
            return list(first) if isinstance(first, list) else bytes(first)
        if fault == "half":
            return _halved(real, args, kwargs)
        out = real(*args, **kwargs)
        return [_flip(b) for b in out] if isinstance(out, list) else _flip(out)
    return call


def _own_shard_only(real):
    @functools.wraps(real)
    def gather(mesh, x):
        full = real(mesh, x)
        n = x.shape[0]
        r = mesh.get_local_rank()
        mine = full[r * n:(r + 1) * n].copy()
        full[:] = 0
        full[r * n:(r + 1) * n] = mine
        return full
    return gather


@contextlib.contextmanager
def planted(fault: str | None, op, rank: int = 0):
    """Plant ``fault`` under ``op``'s entry point in the process of rank
    ``rank`` for the duration of the block (none: nothing)."""
    if fault is None:
        yield
        return
    if fault not in FAULTS:
        raise ValueError(f"unknown fault {fault!r}")
    if fault == "jax_elsewhere":
        if rank:
            sys.modules.setdefault("jax", types.ModuleType("jax"))
        yield
        return
    if fault == "exchange":
        if not hasattr(op, "EXCHANGE"):
            raise ValueError(f"{op.__name__} has no exchange between ranks")
        module, attr = op.EXCHANGE
        wrap = _own_shard_only
    else:
        module, attr = op.ENTRY
        wrap = functools.partial(_wrapped, fault)
    mod = importlib.import_module(module)
    real = getattr(mod, attr)
    setattr(mod, attr, wrap(real))
    try:
        yield
    finally:
        setattr(mod, attr, real)
