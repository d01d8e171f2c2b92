"""The harness finds every file of every cell by its name, and BENCHMARK.json
keeps to the shape the benchmark's contract fixes."""

from __future__ import annotations

import json
import re

import pytest

import bench_spec

BENCH = bench_spec.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = [m["name"] for m in BENCH["per_layer"]]


def test_top_level_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "benchmark/run.py"]
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert len(json.dumps(BENCH)) <= 64 * 1024
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in BENCH[k]]
    assert all(NAME.match(n) for n in names) and len(set(names)) == len(names)
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")


@pytest.mark.parametrize("cell", CELLS)
def test_cell_finds_its_files(cell):
    c = bench_spec.cell(cell, BENCH)
    entry = next(w for w in BENCH["workloads"] if w["name"] == cell)
    assert c.chips == entry["chips"] == 1
    assert len(entry["why"]) <= 200 and "\n" not in entry["why"]
    assert c.traffic["runner"] in ("train", "test")
    assert bench_spec.load_module("runners", c.traffic["runner"]).run
    assert {m["name"] for m in c.end_to_end} >= {"setup_s", "exp_per_s"}
    assert c.per_layer, "every cell reports a per-layer metric"
    for m in c.per_layer:
        assert m["moves"] in {e["name"] for e in c.end_to_end}


@pytest.mark.parametrize("metric", METRICS)
def test_reader_declares_what_benchmark_json_says(metric):
    entry = next(m for m in BENCH["per_layer"] if m["name"] == metric)
    reader = bench_spec.load_module("metrics", metric)
    assert (reader.LAYER, reader.UNIT, reader.SOURCE, reader.MOVES) == (
        entry["layer"], entry["unit"], entry["source"], entry["moves"])
    assert set(entry["workloads"]) <= set(CELLS)
    assert reader.read(dict(spans={}, units=[], launches=[],
                            profile=dict(kernels={}, busy_s=0.0, window_s=0.0))) is None


@pytest.mark.parametrize("config", [c["name"] for c in BENCH["configs"]])
def test_config_file(config):
    entry = next(c for c in BENCH["configs"] if c["name"] == config)
    assert entry["file"] == f"benchmark/configs/{config}.json"
    cfg = bench_spec.load_json("configs", config)
    assert cfg["reduced"] == entry["reduced"] and len(cfg["source"]) <= 200
    assert cfg["flags"][0] == config and cfg["precision"].startswith("float32")
    assert all(NAME.match(k) for k in entry["reduced"])


@pytest.mark.parametrize("cell", CELLS)
def test_limits_cover_the_cells_numbers(cell):
    import bench_check
    limits = bench_spec.load_json("limits", cell)
    assert set(limits) <= set(bench_check.NAMES)
    assert all(v >= 0 for v in limits.values())
