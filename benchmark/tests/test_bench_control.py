"""The control (the reference in TF32, put in the program's place) fails the
limits of every cell, at a size a test run holds; on the card only."""

from __future__ import annotations

import pytest

from conftest import TINY

import bench_check
import bench_session
import bench_spec


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(TINY))
def test_control_fails_the_limits(cuda, name):
    import argparse
    import time

    make_config, traffic, real = TINY[name]
    cfg = make_config()
    limits = bench_spec.load_json("limits", real)
    cell = bench_spec.Cell(name, 1, cfg, traffic, limits, [], [])
    seed = 2**31 + 23
    args = argparse.Namespace(workload=name, seed=seed, seconds=0.5, trace=0, control=False)
    session = bench_session.Session(cell, args, time.perf_counter(), cuda)
    bench_spec.load_module("runners", traffic["runner"]).run(session)
    control = bench_check.control_snapshot(cfg, traffic, session.snap, seed, cuda)
    readings = bench_check.numbers(cfg, traffic, control, seed, cuda)
    assert not bench_session.passed(bench_session.checks(readings, limits, 0)), readings
