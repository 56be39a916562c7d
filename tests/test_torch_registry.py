"""The port's engine selection (``lz4net_tpu_torch.registry``) on the
CPU: the static order, a measured order that overrides it and the kill
switch that restores it, no order that moves a CUDA device's roles to
the host engine, a cache of the port's own (the JAX package's
``selectcodec.json`` is never read or written), a ``cuda`` engine that
fails its probe or AutoTest raising instead of being replaced, and the
``codec_name`` format of ``lz4net_tpu.registry`` (its formatter run on
a stub selection: its ``initialize`` is never called)."""

import json
import os
import re
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # the test workers share the cores: one intra-op
                           # thread each, or they spin against each other

from lz4net_tpu import registry as jregistry  # noqa: E402
from lz4net_tpu_torch import codec, registry  # noqa: E402
from lz4net_tpu_torch.models import reference, service_adapters  # noqa
from lz4net_tpu_torch.utils import corpus  # noqa: E402

CPU = "cpu"
TEXT = corpus.silesia_like(6000, seed=17)


@pytest.fixture(autouse=True)
def _restore_registry(tmp_path, monkeypatch):
    """Each test selects with a cache in its own directory; the CPU
    selection is made again, without it, afterwards."""
    monkeypatch.setenv("LZ4NET_SELECT_CACHE", str(tmp_path))
    monkeypatch.delenv("LZ4NET_TIMED_SELECT", raising=False)
    yield
    monkeypatch.undo()
    registry.initialize(force=True, device=CPU)


def _write_cache(orders, key=CPU):
    path = registry._select_cache_path()
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as fh:
        json.dump({key: orders}, fh)


def test_static_order_puts_the_card_engine_first():
    registry.initialize(force=True, device=CPU)
    assert set(registry.available_services(CPU)) == {
        "cuda", "native", "python-reference"}
    for role in (registry.encoder, registry.decoder, registry.encoder_hc):
        assert role(CPU) is registry.service("cuda", CPU)
    assert registry.service("cuda", CPU).device == torch.device(CPU)
    assert codec.codec_name(device=CPU) == "cuda/cuda/cudaHC"


@pytest.mark.parametrize("name", registry.ENGINES)
def test_encode_batch_gives_encode_payloads_on_every_engine(name):
    """Each CPU engine's ``encode_batch`` gives its ``encode`` payloads
    block by block, and ``codec.encode_batch`` through that engine gives
    ``codec.encode``'s: b"" for an empty block and for a block whose
    payload overflows its cap."""
    noise = np.random.default_rng(5).integers(0, 256, 3000,
                                              np.uint8).tobytes()
    blocks = [TEXT[:2500], noise, TEXT[2500:], TEXT[:400], b"z" * 30]
    caps = [2500, len(noise), 6000, 10, 64]   # the noise and 400 B overflow
    _write_cache({role: [name] for role in registry.ROLES})
    registry.initialize(force=True, device=CPU)
    svc = registry.service(name, CPU)
    assert registry.encoder(CPU) is svc
    got = svc.encode_batch(blocks, caps)
    assert got == [svc.encode(b, c) for b, c in zip(blocks, caps)]
    assert [bool(p) for p in got] == [True, False, True, False, True]
    assert got[0] == reference.compress_block(blocks[0], caps[0])
    assert svc.encode_batch([], []) == []
    blocks.insert(2, b"")
    caps.insert(2, 16)
    want = [codec.encode(b, c, device=CPU) for b, c in zip(blocks, caps)]
    assert codec.encode_batch(blocks, caps, device=CPU) == want
    assert want[2] == b"" and want[:2] + want[3:] == got


def test_measured_cache_overrides_the_static_order(monkeypatch):
    _write_cache({"decode": ["python-reference", "cuda"],
                  "encode": ["cuda", "python-reference"],
                  "encode_hc": ["python-reference", "cuda"]})
    registry.initialize(force=True, device=CPU)
    ref = registry.service("python-reference", CPU)
    assert registry.decoder(CPU) is ref and registry.encoder_hc(CPU) is ref
    assert registry.encoder(CPU) is registry.service("cuda", CPU)
    assert codec.codec_name(device=CPU) == \
        "cuda/python-reference/python-referenceHC"
    # the facade follows the selection: the host engine's batch loop
    packed = codec.encode(TEXT, device=CPU)
    assert codec.decode_batch([packed, packed], [len(TEXT)] * 2,
                              device=CPU) == [TEXT, TEXT]
    assert codec.decode(packed, max_output_length=len(TEXT),
                        device=CPU) == TEXT
    # the kill switch restores the static order
    monkeypatch.setenv("LZ4NET_TIMED_SELECT", "0")
    registry.initialize(force=True, device=CPU)
    assert codec.codec_name(device=CPU) == "cuda/cuda/cudaHC"


def test_no_order_moves_a_cuda_device_to_the_host_engine(monkeypatch):
    host_first = {r: ["python-reference", "cuda"] for r in registry.ROLES}
    for key in ("cuda", "cuda:0"):
        _write_cache(host_first, key)
        want = {r: ("cuda",) for r in registry.ROLES}
        assert registry._measured_preferences(torch.device(key)) == {
            r: ("python-reference", "cuda") for r in registry.ROLES}
        assert registry._preferences(torch.device(key)) == want
        monkeypatch.setenv("LZ4NET_TIMED_SELECT", "0")
        assert registry._preferences(torch.device(key)) == want
        monkeypatch.delenv("LZ4NET_TIMED_SELECT")
    # the CPU keeps both engines in the order
    _write_cache(host_first)
    assert registry._preferences(torch.device(CPU)) == {
        r: ("python-reference", "cuda") for r in registry.ROLES}


def test_the_jax_cache_is_never_read_or_written():
    jpath = jregistry._select_cache_path()   # the same directory here
    os.makedirs(os.path.dirname(jpath), exist_ok=True)
    jax_cache = json.dumps({CPU: {r: ["python-reference", "native"]
                                  for r in ("encode", "decode",
                                            "encode_hc")}})
    with open(jpath, "w") as fh:
        fh.write(jax_cache)
    assert registry._select_cache_path() != jpath
    registry.initialize(force=True, device=CPU)
    assert codec.codec_name(device=CPU) == "cuda/cuda/cudaHC"
    registry.measure_preferences(block_kb=4, n_blocks=1, device=CPU)
    with open(jpath) as fh:
        assert fh.read() == jax_cache
    with open(registry._select_cache_path()) as fh:
        assert set(json.load(fh)[CPU]) == set(registry.ROLES)


def test_native_engine_serves_the_cpu_only_when_measured_first():
    """``native`` is registered on every device after its AutoTest; the
    static order and the CPU's selection are unchanged, a CUDA device's
    roles stay ``cuda`` whatever the order, and a measured order may put
    ``native`` first on the CPU."""
    registry.initialize(force=True, device=CPU)
    svc = registry.available_services(CPU)["native"]
    assert isinstance(svc, service_adapters.NativeService)
    assert registry.auto_test(svc)
    assert registry.ENGINES == ("cuda", "native", "python-reference")
    assert registry.STATIC_ORDER == {r: registry.ENGINES
                                     for r in registry.ROLES}
    assert registry.CARD_ENGINES == ("cuda",)
    assert codec.codec_name(device=CPU) == "cuda/cuda/cudaHC"
    for key in ("cuda", "cuda:0"):
        assert registry._eligible(torch.device(key)) == ("cuda",)
    assert registry._eligible(torch.device(CPU)) == registry.ENGINES
    native_first = {r: ["native", "cuda", "python-reference"]
                    for r in registry.ROLES}
    _write_cache(native_first, "cuda")
    assert registry._preferences(torch.device("cuda")) == {
        r: ("cuda",) for r in registry.ROLES}
    _write_cache(native_first)
    registry.initialize(force=True, device=CPU)
    assert codec.codec_name(device=CPU) == "native/native/nativeHC"
    packed = codec.encode(TEXT, device=CPU)
    assert packed == reference.compress_block(TEXT)
    assert codec.decode_batch([packed, packed], [len(TEXT)] * 2,
                              device=CPU) == [TEXT, TEXT]
    assert codec.encode_hc(TEXT, device=CPU) == \
        reference.compress_block_hc(TEXT)
    with pytest.raises(reference.CorruptedBlockError,
                       match="^truncated input$"):
        codec.decode_batch([packed, packed[:-9]], [len(TEXT)] * 2,
                           device=CPU)


def test_a_failing_native_engine_raises_instead_of_being_left_out(
        monkeypatch):
    monkeypatch.setattr(service_adapters.NativeService, "decode_unknown",
                        lambda self, src, n: b"")
    with pytest.raises(RuntimeError, match="native.*AutoTest.*differs"):
        registry.initialize(force=True, device=CPU)
    monkeypatch.undo()

    def broken(self):
        raise RuntimeError("the native engine cannot be built: g++ failed")
    monkeypatch.setattr(service_adapters.NativeService, "__init__", broken)
    with pytest.raises(RuntimeError, match="cannot be built"):
        registry.initialize(force=True, device=CPU)


class _Stub:
    """A timing stub: correct for nothing, slow by ``delay``."""

    def __init__(self, name, delay):
        self.codec_name, self.delay = name, delay

    def _work(self, *_args):
        time.sleep(self.delay)
        return b"x"

    encode = encode_hc = decode = decode_unknown = _work

    def decode_batch(self, blocks, _lengths):
        time.sleep(self.delay)
        return [b"x"] * len(blocks)


def test_measure_preferences_ranks_by_speed():
    registry.initialize(force=True, device=CPU)
    registry._registry(CPU).services = {
        "cuda": _Stub("cuda", 0.005),
        "python-reference": _Stub("python-reference", 0.0)}
    orders = registry.measure_preferences(block_kb=4, n_blocks=2,
                                          device=CPU)
    assert all(o == ("python-reference", "cuda") for o in orders.values())
    # persisted, then used by the selection with the real engines
    assert codec.codec_name(device=CPU) == \
        "python-reference/python-reference/python-referenceHC"


def test_a_failing_cuda_engine_raises_instead_of_being_replaced(
        monkeypatch):
    monkeypatch.setattr(service_adapters.CudaService, "decode",
                        lambda self, src, n: b"\0" * n)
    with pytest.raises(RuntimeError, match="cuda.*AutoTest.*differs"):
        registry.initialize(force=True, device=CPU)
    # nothing was selected: the facade raises too, it does not fall back
    with pytest.raises(RuntimeError, match="cuda"):
        codec.encode(TEXT, device=CPU)
    monkeypatch.undo()

    def wedged(self, src, n):
        time.sleep(2)
        return src
    monkeypatch.setattr(service_adapters.CudaService, "decode_unknown",
                        wedged)
    monkeypatch.setattr(registry, "AUTOTEST_TIMEOUT_S", 0.2)
    with pytest.raises(RuntimeError, match="did not finish"):
        registry.initialize(force=True, device=CPU)

    def broken(self, device="cuda"):
        raise RuntimeError("nvcc failed: the kernels cannot be built")
    monkeypatch.setattr(service_adapters.CudaService, "__init__", broken)
    with pytest.raises(RuntimeError, match="cannot be built"):
        registry.initialize(force=True, device=CPU)


def test_codec_name_has_the_jax_format(monkeypatch):
    form = re.compile(r"^([\w-]+)/([\w-]+)/([\w-]+)HC$")
    got = form.match(codec.codec_name(device=CPU))
    assert got.groups() == ("cuda", "cuda", "cuda")
    # the JAX formatter on the same names, over a stub selection that
    # monkeypatch takes away again: no JAX engine is probed
    reg = registry._registry(CPU)
    monkeypatch.setattr(jregistry, "_registry", jregistry._Registry(
        encoder=reg.encoder, decoder=reg.decoder,
        encoder_hc=reg.encoder_hc, initialized=True))
    assert jregistry.codec_name() == codec.codec_name(device=CPU)
    assert registry.auto_test(registry.service("python-reference", CPU))
