"""BENCHMARK.json against the contract's shape, and every name it gives
found as a file of its own."""

import json
import os
import re

import pytest

from portbench import run

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"}


@pytest.fixture(scope="module")
def manifest():
    return run.load_manifest()


def test_top_level_keys(manifest):
    assert set(manifest) == TOP_KEYS
    assert 1 <= manifest["run_seconds"] <= 51
    assert manifest["paths"] == ["portbench"]
    assert all(not w.startswith("/") and ".." not in w
               for w in manifest["command"])
    assert os.path.getsize(os.path.join(run.ROOT, "BENCHMARK.json")) < 65536


def test_names_and_units(manifest):
    names = [c["name"] for c in manifest["configs"]]
    cells = [w["name"] for w in manifest["workloads"]]
    metrics = [m["name"] for m in manifest["end_to_end"] + manifest[
        "per_layer"]]
    for group in (names, cells, metrics):
        assert len(group) == len(set(group))
        assert all(NAME.match(n) for n in group)
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for m in manifest["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in manifest["end_to_end"])


@pytest.mark.parametrize("cell", ["power.beams", "pfb1024.resident",
                                  "power.resident"])
def test_cell_finds_its_files(manifest, cell):
    work = run.find(manifest["workloads"], cell, "workload")
    assert work["chips"] == 1 and len(work["why"]) <= 200
    cfg = run.load_config(manifest, work["config"])
    assert cfg["name"] == work["config"]
    traffic = run.load_traffic(work["traffic"])
    assert hasattr(run.load_driver(traffic["driver"]), "setup")
    e2e = run.cell_metrics(manifest, cell, False)
    per_layer = run.cell_metrics(manifest, cell, True)
    assert "setup_s" in [m["name"] for m in e2e] and len(e2e) >= 2
    assert per_layer
    reported = {m["name"] for m in e2e}
    for m in e2e + per_layer:
        assert callable(run.load_reader(m["name"]).read)
    for m in per_layer:
        assert m["moves"] in reported


def test_configs_are_whole(manifest):
    for c in manifest["configs"]:
        assert c["reduced"] == []
        with open(os.path.join(run.ROOT, c["file"])) as f:
            cfg = json.load(f)
        # the reference's block: 8192 frames x 48 chunks x 7168 B
        assert cfg["ndf"] * cfg["nchk"] * cfg["frame_bytes"] == 2818572288
        assert cfg["compare"]["limit"] is not None


def test_per_layer_workloads_exist(manifest):
    cells = {w["name"] for w in manifest["workloads"]}
    layers = {}
    for m in manifest["per_layer"]:
        assert set(m["workloads"]) <= cells
        layers.setdefault(m["name"].split(".")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())
