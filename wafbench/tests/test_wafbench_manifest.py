"""BENCHMARK.json and the files it names: every cell, configuration,
mix and metric is found by name, and the manifest keeps the contract's
shapes."""

from __future__ import annotations

import json
import re

import pytest

from wafbench import gen, manifest

MAN = manifest.load_manifest()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert MAN["paths"] == ["wafbench"]
    assert MAN["command"][1:] == ["-m", "wafbench.run"]
    assert 1 <= MAN["run_seconds"] <= 51


@pytest.mark.parametrize("cfg", MAN["configs"], ids=lambda c: c["name"])
def test_config_files(cfg):
    assert set(cfg) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(cfg["name"])
    data = json.loads((manifest.ROOT / cfg["file"]).read_text())
    assert data["name"] == cfg["name"]
    assert data["reduced"] == cfg["reduced"]
    for key in cfg["reduced"]:
        assert key in data
    assert (manifest.ROOT / (data["pack"] + ".npz")).is_file()
    assert data["guarantees"] and data["assumed"]


@pytest.mark.parametrize("cell", MAN["workloads"], ids=lambda c: c["name"])
def test_cells_resolve_by_name(cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(cell["name"]) and NAME.match(cell["traffic"])
    assert cell["chips"] == 1
    assert len(cell["why"]) <= 200
    assert manifest.config(MAN, cell["config"])["serve_flags"]
    mix = gen.load_mix(cell["traffic"])
    assert mix["kind"] in ("web", "upload")
    e2e = manifest.end_to_end(MAN, cell["name"])
    assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
    assert manifest.per_layer(MAN, cell["name"])
    for m in e2e + manifest.per_layer(MAN, cell["name"]):
        assert callable(manifest.reader(m["name"]))


@pytest.mark.parametrize("metric", MAN["end_to_end"] + MAN["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_entries(metric):
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    assert (manifest.HERE / "metrics" / (metric["name"] + ".py")).is_file()
    if "bound" in metric:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        assert metric["moves"] in {m["name"] for m in MAN["end_to_end"]}
        e2e_cells = {c["name"] for c in MAN["workloads"]
                     if metric["moves"] in {
                         m["name"] for m in manifest.end_to_end(MAN, c["name"])}}
        assert set(metric["workloads"]) <= e2e_cells
        if "_roofline" in metric["name"]:
            assert metric["unit"] == "%"


def test_layers_are_perf_md_layers():
    perf = (manifest.ROOT / "PERF.md").read_text()
    for m in MAN["per_layer"]:
        assert "\n" not in m["layer"] and len(m["layer"]) <= 200
        assert m["layer"] in perf


def test_a_new_cell_is_new_files_only(tmp_path, monkeypatch):
    """A mix and a metric added as files are found without an edit."""
    monkeypatch.setattr(gen, "TRAFFIC_DIR", tmp_path)
    (tmp_path / "web-mix.tiny.json").write_text(json.dumps(
        {"kind": "web", "attack_fraction": 0.5,
         "load": {"loop": "closed", "connections": 1, "in_flight": 1},
         "warmup": {"seconds": 1}}))
    assert gen.load_mix("web-mix.tiny")["attack_fraction"] == 0.5
    monkeypatch.setattr(manifest, "HERE", tmp_path)
    (tmp_path / "metrics").mkdir()
    (tmp_path / "metrics" / "extra.metric.py").write_text(
        "def read(ctx):\n    return 7.0\n")
    assert manifest.reader("extra.metric")(None) == 7.0
