"""``BENCHMARK.json`` and the files it names.

Every part of a cell is found by name: its configuration in
``wafbench/configs/<config>.json``, its traffic mix in
``wafbench/traffic/<traffic>.json`` (read by :mod:`wafbench.gen`), and
each per-layer metric's reader in ``wafbench/metrics/<name>.py``.  A new
cell, configuration, mix or metric is new files and new entries, with no
edit to a file that is there."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import Callable, List

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
MANIFEST = ROOT / "BENCHMARK.json"


def load_manifest() -> dict:
    return json.loads(MANIFEST.read_text())


def cell(manifest: dict, name: str) -> dict:
    for w in manifest["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError("no workload %r in BENCHMARK.json" % name)


def config(manifest: dict, name: str) -> dict:
    for c in manifest["configs"]:
        if c["name"] == name:
            return json.loads((ROOT / c["file"]).read_text())
    raise KeyError("no configuration %r in BENCHMARK.json" % name)


def _reports(metric: dict, cell_name: str) -> bool:
    return cell_name in metric.get("workloads", [cell_name])


def end_to_end(manifest: dict, cell_name: str) -> List[dict]:
    """The end-to-end metrics this cell reports."""
    return [m for m in manifest["end_to_end"] if _reports(m, cell_name)]


def per_layer(manifest: dict, cell_name: str) -> List[dict]:
    """The per-layer metrics this cell reports: those listing it, and
    those without a list that move an end-to-end metric it reports."""
    e2e = {m["name"] for m in end_to_end(manifest, cell_name)}
    return [m for m in manifest["per_layer"]
            if (cell_name in m["workloads"] if "workloads" in m
                else m["moves"] in e2e)]


def reader(name: str) -> Callable:
    """The ``read(ctx)`` function of ``wafbench/metrics/<name>.py``."""
    path = HERE / "metrics" / (name + ".py")
    spec = importlib.util.spec_from_file_location(
        "wafbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
