"""Engine selection of the CUDA port (counterpart of
``lz4net_tpu/registry.py``, lz4net's ILZ4Service seam).

Three engines serve each device:

* ``cuda``             -- ``CudaService(device)``: the port's kernels on the
                          card (their plain versions for ``device="cpu"``);
* ``native``           -- ``NativeService``: the native host engine
                          (``models.native``, C++ built with the host
                          compiler);
* ``python-reference`` -- ``PythonReferenceService``: the host codecs of
                          ``models.reference``.

Each engine passes a round-trip AutoTest before it is registered, and
the encoder, decoder and HC encoder are chosen from a preference order
per role: ``cuda`` first, unless ``measure_preferences`` timed the
engines on this host and persisted another order.  There is one
selection per device; the default device is the card.  Only an engine
that runs on the card serves the card's roles: ``native`` and
``python-reference`` are registered there (the continuous harness and
``info`` survey them) but no order, static or measured, selects them,
so the card's main path never moves to the host.  On the CPU ``cuda``
(the plain versions) leads the static order too, so the CPU runs the
plain versions unless a measured order puts a host engine first.

Unlike the JAX package, no probe failure is swallowed for the ``cuda``
and ``native`` engines: if one cannot be built, fails its AutoTest or
does not finish it within ``AUTOTEST_TIMEOUT_S``, ``initialize`` raises
``RuntimeError`` with the cause, and no other engine takes its place
unnoticed.
``device=`` (the CLI's ``--device``) replaces the JAX package's
``LZ4NET_DISABLE_ENGINES``.  The knobs kept are ``LZ4NET_SELECT_CACHE``
(where the measured orders live; the port's own file, never the JAX
package's ``selectcodec.json``) and ``LZ4NET_TIMED_SELECT=0`` (ignore
them).
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Optional, Protocol

from .constants import HC_LEVEL_DEFAULT, maximum_output_length

_log = logging.getLogger("lz4net_tpu_torch")

ROLES = ("encode", "decode", "encode_hc")
# the static order (the reference hard-codes benchmark-derived orders,
# `LZ4Codec.cs:103-167`): the card's engine leads every role
ENGINES = ("cuda", "native", "python-reference")
STATIC_ORDER = {role: ENGINES for role in ROLES}
CARD_ENGINES = ("cuda",)        # the engines that may serve a CUDA device
AUTOTEST_TIMEOUT_S = 120.0      # after the kernels are built
CACHE_FILE = "selectcodec_torch.json"


class Lz4Service(Protocol):
    """The codec engine protocol (reference `ILZ4Service.cs:30-36`)."""

    codec_name: str

    def encode(self, src: bytes, dst_maxlen: int) -> bytes:
        """Greedy LZ4; returns b"" when output would exceed dst_maxlen."""

    def encode_hc(self, src: bytes, dst_maxlen: int,
                  level: int = HC_LEVEL_DEFAULT) -> bytes:
        """LZ4HC; returns b"" when output would exceed dst_maxlen."""

    def decode(self, src: bytes, output_length: int) -> bytes:
        """Known-output-length decode; raises on corrupt input."""

    def decode_unknown(self, src: bytes, max_output_length: int) -> bytes:
        """Unknown-output-length (hardened) decode; raises on corrupt
        input."""

    def decode_dict(self, src: bytes, dictionary: bytes,
                    output_length: int) -> bytes:
        """Preset-dictionary decode; raises on corrupt input."""

    def decode_batch(self, blocks, output_lengths) -> list:
        """Known-output-length decode of independent blocks."""

    def encode_batch(self, blocks, dst_maxlens) -> list:
        """Greedy LZ4 of independent non-empty blocks, each payload what
        ``encode`` returns for it under its ``dst_maxlens`` entry."""


@dataclass
class _Registry:
    services: dict = field(default_factory=dict)
    encoder: Optional[Lz4Service] = None
    decoder: Optional[Lz4Service] = None
    encoder_hc: Optional[Lz4Service] = None
    initialized: bool = False


_registries: dict[str, _Registry] = {}       # one selection per device
_init_lock = threading.Lock()                # one initialize at a time


def _key(device) -> str:
    import torch
    return str(torch.device(device))


def _registry(device) -> _Registry:
    return _registries.setdefault(_key(device), _Registry())


# AutoTest corpus: compressible text (the reference uses 5x Lorem Ipsum,
# `LZ4Codec.cs:173-239`) plus a short incompressible tail.
_AUTOTEST_TEXT = (
    b"Lorem ipsum dolor sit amet, consectetur adipiscing elit, sed do "
    b"eiusmod tempor incididunt ut labore et dolore magna aliqua. Ut enim "
    b"ad minim veniam, quis nostrud exercitation ullamco laboris nisi ut "
    b"aliquip ex ea commodo consequat. "
) * 5
_AUTOTEST_RANDOM = bytes((i * 2654435761) >> 23 & 0xFF for i in range(997))


def _round_trips(service: Lz4Service) -> None:
    """LZ4 and LZ4HC round trips with known- and unknown-length decodes
    (`LZ4Codec.AutoTest`, `LZ4Codec.cs:173-239`); raises on the first
    that fails."""
    for data in (_AUTOTEST_TEXT, _AUTOTEST_RANDOM):
        budget = maximum_output_length(len(data))
        for enc in (service.encode, service.encode_hc):
            packed = enc(data, budget)
            if not packed:
                raise RuntimeError(f"{enc.__name__} gave no bytes")
            if service.decode(packed, len(data)) != data:
                raise RuntimeError(f"{enc.__name__}: decode differs")
            if service.decode_unknown(packed, len(data)) != data:
                raise RuntimeError(f"{enc.__name__}: decode_unknown "
                                   f"differs")


def auto_test(service: Lz4Service) -> bool:
    """The round-trip self-test each engine must pass to be registered."""
    return _auto_test_error(service, AUTOTEST_TIMEOUT_S) is None


def _auto_test_error(service: Lz4Service, timeout_s: float):
    """The AutoTest's exception, a TimeoutError when it does not finish
    within ``timeout_s`` (it runs in a daemon thread, so a wedged card
    cannot hang the caller), or None when it passes."""
    box = []

    def run():
        try:
            _round_trips(service)
            box.append(None)
        except Exception as exc:  # noqa: BLE001 - handed to the caller
            box.append(exc)

    worker = threading.Thread(target=run, daemon=True,
                              name="lz4t-autotest")
    worker.start()
    worker.join(timeout_s)
    if not box:
        return TimeoutError(f"AutoTest did not finish in {timeout_s} s")
    return box[0]


def register(name: str, service: Lz4Service, *, required: bool = False,
             device="cuda") -> bool:
    """Register an engine for ``device`` after its AutoTest.  An engine
    that fails it is left out with a warning, or, if ``required``, raises
    ``RuntimeError`` with the cause."""
    err = _auto_test_error(service, AUTOTEST_TIMEOUT_S)
    if err is not None:
        if required:
            raise RuntimeError(f"engine {name} on {_key(device)} failed "
                               f"its AutoTest: {err!r}") from err
        _log.warning("engine %s failed AutoTest; not registered: %r",
                     name, err)
        return False
    _registry(device).services[name] = service
    return True


def _select(reg: _Registry, preference) -> Optional[Lz4Service]:
    for name in preference:
        svc = reg.services.get(name)
        if svc is not None:
            return svc
    return None


# ---- measured selection -------------------------------------------------
# `measure_preferences()` times the engines that may serve a device per
# role and persists the winning order, which `initialize()` then uses
# instead of the static one (the reference measured its orders offline).

def _eligible(dev) -> tuple[str, ...]:
    """The engines that may serve ``dev``'s roles: on a CUDA device only
    the card's, so that no order moves the card's path to the host."""
    return CARD_ENGINES if _key(dev).startswith("cuda") else ENGINES

def _select_cache_path() -> str:
    base = os.environ.get("LZ4NET_SELECT_CACHE") or os.path.join(
        os.path.expanduser("~"), ".cache", "lz4net_tpu_torch")
    return os.path.join(base, CACHE_FILE)


def _bench_role(svc: Lz4Service, role: str, blocks, packed) -> float:
    """Best-of-3 wall time of one engine on one role's workload: decode
    as one batch call, as the stream's read-ahead makes it."""

    def run() -> None:
        if role == "decode":
            svc.decode_batch(packed, [len(b) for b in blocks])
        elif role == "encode":
            for b in blocks:
                svc.encode(b, maximum_output_length(len(b)))
        else:
            for b in blocks:
                svc.encode_hc(b, maximum_output_length(len(b)))

    run()                                   # warm-up
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        run()
        best = min(best, time.perf_counter() - t0)
    return best


def measure_preferences(block_kb: int = 64, n_blocks: int = 4,
                        persist: bool = True,
                        device="cuda") -> dict[str, tuple[str, ...]]:
    """Time the engines that may serve ``device`` (on a CUDA device only
    the card's) per role on ``n_blocks`` blocks of ``block_kb`` KB and
    return (and persist) the measured orders, fastest first.  An engine
    that raises here raises to the caller."""
    from .models import native
    from .utils import corpus

    initialize(device=device)
    data = corpus.silesia_like(block_kb * 1024 * n_blocks, seed=7)
    blocks = corpus.split_blocks(data, block_kb * 1024)
    packed = [native.compress_block(b) for b in blocks]
    orders = {}
    for role in ROLES:
        timed = sorted((_bench_role(svc, role, blocks, packed), name)
                       for name, svc in _registry(device).services.items()
                       if name in _eligible(device))
        orders[role] = tuple(name for _, name in timed)
        _log.info("timed select %s: %s", role,
                  [(n, f"{t * 1e3:.1f}ms") for t, n in timed])
    if persist:
        path = _select_cache_path()
        os.makedirs(os.path.dirname(path), exist_ok=True)
        try:
            with open(path) as fh:
                cache = json.load(fh)
        except (OSError, ValueError):
            cache = {}
        cache[_key(device)] = {k: list(v) for k, v in orders.items()}
        with open(path, "w") as fh:
            json.dump(cache, fh)
    initialize(force=True, device=device)   # select with the new orders
    return orders


def _preferences(dev) -> dict[str, tuple[str, ...]]:
    """Each role's order for ``dev``: the static one, overridden by a
    persisted measured one unless ``LZ4NET_TIMED_SELECT=0``, and cut to
    the engines that may serve ``dev``."""
    prefs = dict(STATIC_ORDER)
    if os.environ.get("LZ4NET_TIMED_SELECT", "1") != "0":
        prefs.update(_measured_preferences(dev) or {})
    return {role: tuple(n for n in order if n in _eligible(dev))
            for role, order in prefs.items()}


def _measured_preferences(device) -> Optional[dict]:
    """The orders ``measure_preferences`` persisted for ``device``."""
    try:
        with open(_select_cache_path()) as fh:
            got = json.load(fh)[_key(device)]
        return {role: tuple(got[role]) for role in ROLES if role in got}
    except (OSError, ValueError, KeyError, TypeError):
        return None


def initialize(force: bool = False, device="cuda") -> None:
    """Build, probe and AutoTest the engines of ``device`` and select its
    encoder, decoder and HC encoder.  The ``cuda`` and ``native`` engines
    must pass (they raise otherwise); the kernels and the host library are
    built before the AutoTest's clock starts, so a cold build is never
    taken for a hang."""
    from . import _build
    from .models.service_adapters import (CudaService, NativeService,
                                          PythonReferenceService)
    from .ops.host_rows import resolve_device

    with _init_lock:
        reg = _registry(device)
        if reg.initialized and not force:
            return
        reg.initialized = False
        reg.services.clear()
        dev = resolve_device(device)    # raises for CUDA without a card
        if dev.type == "cuda":
            _build.load()
        register("cuda", CudaService(dev), required=True, device=dev)
        register("native", NativeService(), required=True, device=dev)
        register("python-reference", PythonReferenceService(), device=dev)

        prefs = _preferences(dev)
        reg.encoder = _select(reg, prefs["encode"])
        reg.decoder = _select(reg, prefs["decode"])
        reg.encoder_hc = _select(reg, prefs["encode_hc"])
        if None in (reg.encoder, reg.decoder, reg.encoder_hc):
            raise RuntimeError(f"no LZ4 engine serves every role on "
                               f"{_key(dev)}: orders {prefs}")
        reg.initialized = True


def encoder(device="cuda") -> Lz4Service:
    initialize(device=device)
    return _registry(device).encoder


def decoder(device="cuda") -> Lz4Service:
    initialize(device=device)
    return _registry(device).decoder


def encoder_hc(device="cuda") -> Lz4Service:
    initialize(device=device)
    return _registry(device).encoder_hc


def service(name: str, device="cuda") -> Lz4Service:
    """A specific engine of ``device`` by name."""
    initialize(device=device)
    return _registry(device).services[name]


def available_services(device="cuda") -> dict:
    initialize(device=device)
    return dict(_registry(device).services)


def codec_name(device="cuda") -> str:
    """"enc/dec/hcHC" triple, like the reference `LZ4Codec.CodecName`
    (`LZ4Codec.cs:298-308`)."""
    initialize(device=device)
    reg = _registry(device)
    return (f"{reg.encoder.codec_name}/{reg.decoder.codec_name}/"
            f"{reg.encoder_hc.codec_name}HC")
