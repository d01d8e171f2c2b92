"""A window's rate is all its work over all its time, from boundary to
boundary, and the window closes at the first boundary past --seconds."""

from __future__ import annotations

import argparse

import pytest

import bench_session
import bench_spec


class Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


class NoCaptures:
    in_window = False
    in_window_count = 0


def session(monkeypatch, seconds):
    clock = Clock()
    monkeypatch.setattr(bench_session.time, "perf_counter", clock)
    cell = bench_spec.Cell("c", 1, {}, {}, {}, [
        {"name": "exp_per_s", "unit": "exp/s"}, {"name": "setup_s", "unit": "s"}], [])
    args = argparse.Namespace(seconds=seconds, trace=0)
    s = bench_session.Session(cell, args, t0=90.0, device="cpu")
    s.captures = NoCaptures()
    return s, clock


def test_rate_is_all_the_work_over_all_the_time(monkeypatch):
    s, clock = session(monkeypatch, seconds=10.0)
    s.begin()
    assert s.setup_s == pytest.approx(10.0)
    lives, steps = [5000, 4000, 5000, 4500], [2.5, 3.5, 2.0, 3.0]
    for live, dt in zip(lives, steps):
        clock.t += dt
        s.boundary(dict(live=live, episodes=10, blowups=0, flops=0.0))
    assert s.phase == "check" and len(s.units) == 4
    m = s.end_to_end()
    assert m["exp_per_s"]["value"] == pytest.approx(sum(lives) / sum(steps))
    assert m["setup_s"]["value"] == pytest.approx(10.0)
    # the check unit ends the run at its boundary and adds nothing to the window
    clock.t += 7.0
    with pytest.raises(bench_session.StopRun):
        s.boundary(dict(live=1, episodes=1, blowups=1, flops=0.0))
    assert s.end_to_end()["exp_per_s"]["value"] == pytest.approx(sum(lives) / sum(steps))


def test_window_holds_whole_units_past_seconds(monkeypatch):
    s, clock = session(monkeypatch, seconds=5.0)
    s.begin()
    for _ in range(2):
        clock.t += 2.0
        s.boundary(dict(live=1, episodes=1, blowups=0, flops=0.0))
        assert s.phase == "window"
    clock.t += 2.0
    s.boundary(dict(live=1, episodes=1, blowups=0, flops=0.0))
    assert s.phase == "check" and s.window_s() == pytest.approx(6.0)


def test_checks_and_verdict():
    values = {"mu_gap": 1e-6, "obs_gap": float("inf")}
    check = bench_session.checks(values, {"mu_gap": 1e-5, "obs_gap": 1e-3}, 0)
    assert not bench_session.passed(check)
    assert bench_session.printable(check)["obs_gap"]["value"] == "inf"
    check = bench_session.checks({"mu_gap": 1e-6}, {"mu_gap": 1e-5}, 1)
    assert not bench_session.passed(check)       # a capture inside the window
    assert bench_session.passed(bench_session.checks({"mu_gap": 1e-6}, {"mu_gap": 1e-5}, 0))
    with pytest.raises(SystemExit):
        bench_session.checks({"mu_gap": 1e-6}, {}, 0)
