"""BENCHMARK.json against the benchmark's contract, and every file it
names found by name."""

from __future__ import annotations

import json
import os

import pytest

from portbench import _testcells, manifest

M = manifest.load()
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"},
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_keys_and_counts():
    assert set(M) == KEYS["top"]
    assert 1 <= len(M["configs"]) <= 24
    assert 1 <= len(M["workloads"]) <= 24
    assert 1 <= len(M["end_to_end"]) <= 16
    assert 1 <= len(M["per_layer"]) <= 128
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in M[kind]:
            extra = {"workloads"} if kind in ("end_to_end",
                                              "per_layer") else set()
            assert KEYS[kind] <= set(entry) <= KEYS[kind] | extra, entry
    assert os.path.getsize(manifest.MANIFEST) <= 64 << 10


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end",
                                  "per_layer"])
def test_names_and_units_use_allowed_characters(kind):
    names = [e["name"] for e in M[kind]]
    assert len(set(names)) == len(names)
    for entry in M[kind]:
        assert manifest.NAME.fullmatch(entry["name"]), entry["name"]
        for key in ("config", "traffic"):
            if key in entry:
                assert manifest.NAME.fullmatch(entry[key])
        for key in entry.get("reduced", []):
            assert manifest.NAME.fullmatch(key)
        if "unit" in entry:
            assert manifest.UNIT.fullmatch(entry["unit"]), entry["unit"]
            assert entry["better"] in ("lower", "higher")
        for key in ("why", "layer", "source"):
            if key in entry:
                assert _line(entry[key]), entry[key]


def test_command_and_paths():
    assert 1 <= len(M["command"]) <= 32
    assert all(_line(w) for w in M["command"])
    assert 1 <= len(M["paths"]) <= 16
    for p in M["paths"]:
        assert not p.startswith("/") and ".." not in p.split("/")
        assert os.path.isdir(os.path.join(manifest.ROOT, p))
    assert 1 <= M["run_seconds"] <= 51 and isinstance(M["run_seconds"], int)


def test_bounds():
    for m in M["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    (setup,) = [m for m in M["end_to_end"] if m["name"] == "setup_s"]
    assert "workloads" not in setup


def test_four_card_cells_are_few():
    four = [w for w in M["workloads"] if w["chips"] == 4]
    assert all(w["chips"] in (1, 4) for w in M["workloads"])
    assert len(four) <= max(1, len(M["workloads"]) // 4)


def test_check_fits_the_time_limit():
    n = len(M["workloads"])
    for cells in (n, 24):
        assert (2 + 14 * cells) * (M["run_seconds"] + 60) \
            + cells * 2 * 90 + 1200 <= 43200


READY = _testcells.with_ready(M)


@pytest.mark.parametrize("cell", [w["name"] for w in READY["workloads"]])
def test_every_cells_files_are_found_by_name(cell):
    w = manifest.cell(READY, cell)
    entry = manifest.config_entry(READY, w["config"])
    assert entry["file"].startswith(M["paths"][0] + "/")
    cfg = manifest.config(READY, w["config"])
    assert cfg["reduced"] == entry["reduced"]
    assert cfg["ranks"] == w["chips"]
    mix = manifest.traffic(w["traffic"])
    op = manifest.op(mix["op"])
    for fn in ("inputs", "prepare", "request", "work", "check", "counters",
               "control"):
        assert callable(getattr(op, fn)), fn
    e2e = manifest.metrics(READY, cell, traced=False)
    layer = manifest.metrics(READY, cell, traced=True)
    names = {m["name"] for m in e2e}
    assert "setup_s" in names and len(names) >= 2
    assert layer
    for m in e2e + layer:
        assert callable(manifest.metric_reader(m["name"]).read)
    for m in layer:
        assert m["moves"] in names


def test_each_config_is_used_and_has_its_own_file():
    files = [c["file"] for c in M["configs"]]
    assert len(set(files)) == len(files)
    used = {w["config"] for w in M["workloads"]}
    assert used == {c["name"] for c in M["configs"]}


def test_layers_named_alike():
    by_layer = {}
    for m in M["per_layer"]:
        by_layer.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in by_layer.values())


def test_roofline_metrics_are_percent():
    for m in M["per_layer"]:
        if "roofline" in m["name"] or "mfu" in m["name"]:
            quantity = m["name"].rsplit(".", 1)[0]
            assert m["unit"] == "%" and quantity.endswith("_roofline")


def test_a_split_quantity_shares_its_reader():
    path = manifest.metric_file("host_ms.write")
    assert os.path.basename(path) == "host_ms.py"
    assert manifest.metric_reader("host_ms.read") is \
        manifest.metric_reader("host_ms.write")
    assert os.path.basename(manifest.metric_file("pipeline.nccl_share")) \
        == "pipeline.nccl_share.py"
    with pytest.raises(FileNotFoundError):
        manifest.metric_file("no_such.metric")


def test_manifest_is_plain_json():
    with open(manifest.MANIFEST) as fh:
        assert json.load(fh) == M
