"""The benchmark's files, found by the names in ``BENCHMARK.json``: a cell's
configuration (``configs/<config>.json``), traffic mix
(``traffic/<traffic>.json``), limits (``limits/<cell>.json``), runner
(``runners/<runner>.py``, named by the traffic) and per-layer metric readers
(``metrics/<metric>.py``).  A new cell, mix or metric is a new file; nothing
here names one."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def load_json(kind: str, name: str) -> dict:
    return json.loads((HERE / kind / f"{name}.json").read_text())


def load_module(kind: str, name: str):
    """``<kind>/<name>.py`` as a module of its own (a name may hold dots)."""
    path = HERE / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"bench_{kind}_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list      # the entries of BENCHMARK.json this cell reports
    per_layer: list


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(name: str, bench: dict | None = None) -> Cell:
    bench = bench or benchmark()
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise SystemExit(f"[bench] no workload {name!r} in BENCHMARK.json")
    return Cell(
        name=name, chips=entry["chips"],
        config=load_json("configs", entry["config"]),
        traffic=load_json("traffic", entry["traffic"]),
        limits=load_json("limits", name),
        end_to_end=[m for m in bench["end_to_end"] if applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if applies(m, name)])
