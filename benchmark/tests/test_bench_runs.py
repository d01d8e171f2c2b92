"""Whole runs of each tiny cell on the CPU: a sound run is correct, and a run
with the timed path broken underneath is not, once for each fault a cell can
have (the exchange between chips has no place: every cell runs on one chip).
The configuration files state what the program runs."""

from __future__ import annotations

import dataclasses

import pytest

from conftest import TINY, run_tiny

import bench_check
import bench_session
import bench_spec


@pytest.mark.parametrize("name", sorted(TINY))
def test_sound_run_is_correct(name):
    session, values, check = run_tiny(name)
    assert bench_session.passed(check), check
    assert session.units and session.setup_s > 0
    train = TINY[name][1]["runner"] == "train"
    # an evaluation has no insert and no updates to compare
    assert set(values) == set(bench_check.NAMES if train else bench_check.NAMES[:5])
    assert session.end_to_end() == {}           # a tiny cell reports no metric of the card


FAULTS = [(f, n) for n in sorted(TINY) for f in ("unchanged", "half_batch", "altered")
          if TINY[n][1]["runner"] == "train" or f == "altered"]


@pytest.mark.parametrize("fault, name", FAULTS)
def test_broken_timed_path_is_not_correct(fault, name):
    _, values, check = run_tiny(name, fault=fault)
    assert not bench_session.passed(check), (fault, values)


@pytest.mark.parametrize("config, traffic", [
    ("burger-marl", "train-918"), ("burger-marl", "fused-1024"), ("ks", "train-926"),
    ("ks", "test-926")])
def test_files_state_what_the_program_runs(config, traffic):
    from marlpde_tpu_torch import run as cli
    from marlpde_tpu_torch.envs import burger_env, ks_env

    cfg, tr = bench_spec.load_json("configs", config), bench_spec.load_json("traffic", traffic)
    args = cli.build_parser().parse_args(cfg["flags"] + tr["flags"] + ["--seed", "5"])
    make_pool = {"burger-marl": burger_env, "ks": ks_env}[config]
    saved = make_pool.make_dns_pool
    make_pool.make_dns_pool = lambda c, n, **kw: saved(
        __import__("dataclasses").replace(c, N_dns=16, T=c.dt * 10) if config == "burger-marl"
        else __import__("dataclasses").replace(c, N_dns=64, t_end=c.t_transient + 10 * c.dt), 1,
        **kw)
    try:
        env, rl_cfg, tc = cli.make_workload(args, "cpu")
    finally:
        make_pool.make_dns_pool = saved
    ref = bench_check.rl_config(cfg, tr, cfg["env"])
    assert dataclasses.asdict(rl_cfg) == dataclasses.asdict(ref)
    e = cfg["env"]
    assert (env.obs_dim, env.num_agents, env.act_dim, env.episode_length) == (
        e["obs_dim"], e["num_agents"], e["num_actions"] // e["num_agents"], e["episode_length"])
    assert (env.action_low, env.action_high) == (e["action_low"], e["action_high"])
    c = env.cfg
    for key in ("N_dns", "grid_size", "num_actions", "num_agents", "dt", "L", "noise",
                "reward_factor", "spectral_reward", "dforce", "episode_length"):
        assert getattr(c, key) == pytest.approx(e[key]), key
    if config == "burger-marl":
        assert (c.T, c.nu, c.ic_case, c.version) == (e["T"], e["nu"], e["ic_case"], e["version"])
        assert env.whole_batch, "the flagship runs the whole-batch env on the ABCN op"
    else:
        assert (c.t_end, c.t_transient) == (e["t_end"], e["t_transient"])
    assert int(args.ndns) == e["n_pool"]
    if tr["runner"] == "train":
        assert tc.testing_frequency == 0
