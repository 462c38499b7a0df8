"""The benchmark's registries against BENCHMARK.json and the contract's
shapes: every name found by name, every name and unit of the allowed
characters, every per-layer metric moving an end-to-end metric that its
cells report."""

import json
import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

from benchmark.core import spec  # noqa: E402
from benchmark.reference.sim import reference_scan  # noqa: E402

BENCH = spec.benchmark()
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"}
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def test_top_level_keys_and_command():
    assert set(BENCH) == TOP_KEYS
    assert BENCH["paths"] == ["benchmark"]
    assert BENCH["command"] == ["python3", "benchmark/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_names_and_units_use_the_allowed_characters():
    named = (BENCH["configs"] + BENCH["workloads"] + BENCH["end_to_end"]
             + BENCH["per_layer"])
    for entry in named:
        assert spec.NAME.match(entry["name"]), entry["name"]
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert spec.UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for w in BENCH["workloads"]:
        assert spec.NAME.match(w["config"]) and spec.NAME.match(w["traffic"])
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in BENCH[kind]]
        assert len(names) == len(set(names)), kind


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_each_cell_finds_its_files_by_name(cell):
    w = spec.cell(BENCH, cell)
    cfg = spec.config(w["config"])
    mix = spec.traffic(w["traffic"])
    limits = spec.limits(cell)
    assert cfg["name"] == w["config"]
    assert os.path.exists(os.path.join(spec.BENCH_DIR, cfg["map"]))
    assert reference_scan(cfg["reference_scan"]).hit
    mode = spec.mode(mix["mode"])
    assert mode.FAULTS and mode.Check(mix, cfg).setup_calls >= 2
    assert mix["rate_metric"] in [m["name"] for m in
                                  spec.metrics_of(BENCH, "end_to_end", cell)]
    assert limits and all(v >= 0 for v in limits.values())
    e2e = [m["name"] for m in spec.metrics_of(BENCH, "end_to_end", cell)]
    assert "setup_s" in e2e and len(e2e) >= 2
    layer = spec.metrics_of(BENCH, "per_layer", cell)
    assert layer
    for m in layer:
        assert m["moves"] in e2e, (cell, m["name"])
        assert callable(spec.metric_reader(m["name"]))


def test_configs_match_their_files():
    for c in BENCH["configs"]:
        cfg = json.load(open(os.path.join(spec.ROOT, c["file"])))
        assert cfg["name"] == c["name"]
        assert c["file"].startswith("benchmark/")
        assert c["reduced"] == []
        assert 1 <= len(c["source"]) <= 200
        assert any(w["config"] == c["name"] for w in BENCH["workloads"])


def test_per_layer_metrics_name_a_layer_and_what_they_move():
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert 1 <= len(m["layer"]) <= 200
    layers = spec.kernel_layers()
    assert "Scan kernels" in layers and layers["Scan kernels"]


def test_bounds_and_chips():
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
    assert all(w["chips"] in (1, 4) for w in BENCH["workloads"])
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= 1
