"""Fixtures of the benchmark's tests: the harness's modules on the path, and
each configuration cut to a size that the CPU runs in seconds (the program
runs there with the plain versions of its kernels and without graphs)."""

from __future__ import annotations

import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
for p in (str(BENCH), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)


def burger_config():
    import bench_spec
    cfg = bench_spec.load_json("configs", "burger-marl")
    cfg["flags"] = cfg["flags"] + ["--NDNS", "64", "--dt", "0.01", "--T", "0.1",
                                   "--episodelength", "5", "--rstart", "10", "--nagents", "4"]
    cfg["env"].update(N_dns=64, dt=0.01, T=0.1, episode_length=5, num_agents=4, obs_dim=10)
    cfg["learner"].update(replay_start_experiences=10, replay_max_experiences=1000)
    return cfg


def ks_config():
    import bench_spec
    cfg = bench_spec.load_json("configs", "ks")
    cfg["flags"] = cfg["flags"] + ["--NDNS", "64", "--episodelength", "5", "--ndns", "2",
                                   "--width", "32", "--rstart", "10"]
    cfg["env"].update(N_dns=64, episode_length=5, n_pool=2)
    cfg["learner"].update(width=32, replay_start_experiences=10, replay_max_experiences=1000)
    return cfg


# each cell's traffic, cut as its configuration is: (config, traffic, the cell whose limits hold)
TINY = {
    "train-experience": (burger_config, dict(
        runner="train", flags=["--numenvs", "2", "--minibatch", "experience", "--mbsize", "8",
                               "--maxupd", "8", "--diag", "--testfreq", "0"],
        learner={"minibatch_mode": "experience", "mini_batch_size": 8}, steady_updates=8,
        profile_units=1), "burger-marl.train-918"),
    "train-ks": (ks_config, dict(
        runner="train", flags=["--numenvs", "3", "--maxupd", "4", "--fused", "--testfreq", "0"],
        learner={}, steady_updates=4, profile_units=1), "ks.train-926"),
    "train-episode": (burger_config, dict(
        runner="train", flags=["--numenvs", "3", "--fused", "--minibatch", "episode",
                               "--maxupd", "3", "--testfreq", "0"],
        learner={"minibatch_mode": "episode"}, steady_updates=3, profile_units=1,
        check_episodes=2), "burger-marl.train-918"),
    "test-ks": (ks_config, dict(
        runner="test", flags=[], episodes=3, weights_noise=0.05, setup_units=2,
        profile_units=1), "ks.train-926"),
}


def run_tiny(name: str, seed: int = 2**31 + 11, fault: str | None = None):
    """One CPU run of the tiny cell ``name``: (session, the check's numbers,
    the checks against the real cell's limits)."""
    import argparse
    import time

    import torch

    import bench_check
    import bench_faults
    import bench_session
    import bench_spec

    make_config, traffic, real = TINY[name]
    cfg = make_config()
    limits = bench_spec.load_json("limits", real)
    cell = bench_spec.Cell(name, 1, cfg, traffic, limits, [], [])
    args = argparse.Namespace(workload=name, seed=seed, seconds=0.2, trace=0, control=False)
    session = bench_session.Session(cell, args, time.perf_counter(), "cpu")
    if fault:
        bench_faults.install(fault, session.patches)
    bench_spec.load_module("runners", traffic["runner"]).run(session)
    values = bench_check.numbers(cfg, traffic, session.snap, seed, torch.device("cpu"))
    return session, values, bench_session.checks(values, limits,
                                                 session.captures.in_window_count)


@pytest.fixture
def cuda():
    """The card, or a skip where there is none (decided here, never at import)."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
