"""``BENCHMARK.json`` and the files it names.

Everything that belongs to one configuration, one traffic mix or one
metric sits in a file of its own, found by the name the manifest gives:

* a configuration: the ``file`` of its ``configs`` entry (``configs/``);
* a traffic mix: ``traffic/<traffic>.json``, whose ``op`` names the
  caller of the entry point, ``ops/<op>.py``;
* a metric: ``metrics/<name>.py``, a reader with ``read(ctx)``; a
  quantity split by kind of cell, ``<quantity>.<kind>`` (``host_ms.read``,
  ``host_ms.write``), shares ``metrics/<quantity>.py`` unless a file of
  its full name is there.

So a later change adds a cell, a mix or a metric by adding files and
manifest entries, and edits none.
"""

from __future__ import annotations

import importlib.util
import json
import os
import re
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
MANIFEST = os.path.join(ROOT, "BENCHMARK.json")

NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")


def load(path: str = MANIFEST) -> dict:
    with open(path) as fh:
        return json.load(fh)


def cell(manifest: dict, name: str) -> dict:
    for entry in manifest["workloads"]:
        if entry["name"] == name:
            return entry
    raise KeyError(f"no workload {name!r} in the manifest")


def config_entry(manifest: dict, name: str) -> dict:
    for entry in manifest["configs"]:
        if entry["name"] == name:
            return entry
    raise KeyError(f"no config {name!r} in the manifest")


def _json(path: str) -> dict:
    with open(path) as fh:
        return json.load(fh)


def config(manifest: dict, name: str) -> dict:
    """A configuration's file (its path relative to the repository root)."""
    return _json(os.path.join(ROOT, config_entry(manifest, name)["file"]))


TRAFFIC = os.path.join(HERE, "traffic")


def traffic(name: str, directory: str = TRAFFIC) -> dict:
    """A traffic mix's file, ``traffic/<name>.json``."""
    return _json(os.path.join(directory, f"{name}.json"))


def metric_file(name: str) -> str:
    """The reader's file of a metric: ``metrics/<name>.py``, else for
    ``<quantity>.<kind>`` the quantity's ``metrics/<quantity>.py``."""
    for base in (name, name.rsplit(".", 1)[0]):
        path = os.path.join(HERE, "metrics", f"{base}.py")
        if os.path.exists(path):
            return path
    raise FileNotFoundError(f"no metric file for {name!r} in "
                            f"{os.path.join(HERE, 'metrics')}")


def metric_reader(name: str):
    """The reader of a metric (loaded from its file: a metric's name may
    hold dots)."""
    path = metric_file(name)
    key = "portbench.metrics." + re.sub(
        r"[^A-Za-z0-9_]", "_", os.path.basename(path)[:-3])
    if key not in sys.modules:
        spec = importlib.util.spec_from_file_location(key, path)
        module = importlib.util.module_from_spec(spec)
        sys.modules[key] = module
        spec.loader.exec_module(module)
    return sys.modules[key]


def op(name: str):
    """The caller of an entry point, ``ops/<name>.py``."""
    if not NAME.fullmatch(name) or not os.path.exists(
            os.path.join(HERE, "ops", f"{name}.py")):
        raise FileNotFoundError(f"no op file for {name!r}")
    return importlib.import_module(f"portbench.ops.{name}")


def metrics(manifest: dict, workload: str, traced: bool) -> list[dict]:
    """The metrics a run of ``workload`` reports: with tracing off its
    end-to-end metrics, with tracing on its per-layer metrics.  A metric
    without ``workloads`` belongs to every cell that reports the
    end-to-end metric it moves (or, end to end, to every cell)."""
    e2e = [m for m in manifest["end_to_end"]
           if workload in m.get("workloads", [workload])]
    if not traced:
        return e2e
    reported = {m["name"] for m in e2e}
    return [m for m in manifest["per_layer"]
            if (workload in m["workloads"] if "workloads" in m
                else m["moves"] in reported)]
