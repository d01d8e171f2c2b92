"""The port's slice as a whole: a deterministic collection through the registry
env against JAX collect_episodes (float64), one update on that batch, and two
generations of the port's ``trainer.train``."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from marlpde_tpu.envs import registry as jreg
from marlpde_tpu.envs import rollout as jroll
from marlpde_tpu.rl import vracer as jv
from marlpde_tpu.train import trainer as jtr
from marlpde_tpu_torch.envs import registry as treg
from marlpde_tpu_torch.envs import rollout as troll
from marlpde_tpu_torch.kernels import abcn, mlp
from marlpde_tpu_torch.rl import vracer as tv
from marlpde_tpu_torch.train import trainer as ttr
from test_torch_interop import params64, train_state_from_jax, train_state_to_jax

torch.set_num_threads(1)

ENV_KW = dict(N_dns=64, grid_size=32, num_actions=32, num_agents=4, dt=0.01, T=0.5,
              nu=0.05, episode_length=5, ic_case="turbulence", spectral_reward=True,
              noise=0.0)
B = 4


@pytest.fixture(scope="module")
def envs():
    jenv = jreg.make_env("burger", dtype=jnp.float64, **ENV_KW)
    tenv = treg.make_env("burger", dtype=torch.float64, device="cpu", **ENV_KW)
    return jenv, tenv


def _train_states(jenv, tenv):
    cfg = jtr.default_rl_config(jenv, width=16)
    jts = params64(cfg, jv.init_train(cfg, jax.random.key(1), dtype=jnp.float64))
    # spread the weights so the deterministic policy acts visibly
    rng = np.random.default_rng(0)
    jts = jts.replace(params=jax.tree.map(
        lambda a: a + jnp.asarray(rng.standard_normal(a.shape) * 0.3), jts.params))
    tcfg = ttr.default_rl_config(tenv, width=16)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(cfg)
    return cfg, jts, tcfg, train_state_from_jax(tcfg, jts)


def test_deterministic_collect_then_update(envs):
    jenv, tenv = envs
    cfg, jts, tcfg, ts = _train_states(jenv, tenv)
    jtraj, jfinal = jroll.collect_episodes(jenv, cfg, jts, jax.random.key(2), B,
                                           deterministic=True)
    ttraj, tfinal = troll.collect_episodes(tenv, tcfg, ts, torch.Generator().manual_seed(2),
                                           B, deterministic=True)
    for name in ("obs", "actions", "mu", "sigma", "rewards", "mask", "final_obs"):
        assert ttraj[name].shape == jtraj[name].shape, name
        np.testing.assert_allclose(ttraj[name].numpy(), np.asarray(jtraj[name]),
                                   atol=1e-10, err_msg=name)
    np.testing.assert_array_equal(ttraj["truncated"].numpy(), np.asarray(jtraj["truncated"]))
    np.testing.assert_allclose(tfinal.cum_reward.numpy(), np.asarray(jfinal.cum_reward),
                               atol=1e-10)
    assert np.abs(np.asarray(jtraj["actions"])).max() > 0.05

    # then the normalizer update and one VRACER update on that batch
    jts = jv.observe_episodes(cfg, jts, jtraj)
    ts = tv.observe_episodes(tcfg, ts, ttraj)
    jts, jm = jv.update(cfg, jts, jtraj)
    ts, tm = tv.update(tcfg, ts, ttraj)
    back = train_state_to_jax(tcfg, ts, jts)
    for a, b in zip(jax.tree.leaves(back.params), jax.tree.leaves(jts.params)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-10)
    np.testing.assert_allclose(tm["loss"].numpy(), np.asarray(jm["loss"]), atol=1e-10)


def test_two_fused_generations_of_train(envs):
    _, tenv = envs
    tenv = dataclasses.replace(tenv, consts=dataclasses.replace(
        tenv.consts, **{f.name: (None if getattr(tenv.consts, f.name) is None
                                 else getattr(tenv.consts, f.name).float())
                        for f in dataclasses.fields(tenv.consts)}))
    rl_cfg = ttr.default_rl_config(tenv, width=16, replay_start_experiences=30,
                                   replay_max_experiences=30)
    tc = ttr.TrainerConfig(num_envs=B, fused=True, seed=0, max_updates_per_gen=3,
                           max_experiences=2 * B * tenv.episode_length)
    abcn_before, mlp_before = abcn.launches, mlp.launches
    seen = []
    ts, rep, hist = ttr.train(tenv, rl_cfg, tc, verbose=False,
                              callback=lambda g, ts_, rep_, h: seen.append(rep_.filled))
    assert hist["gen"] == [1, 2] and seen == [4, 6]
    # capacity 30 // 5 = 6 episodes; updates start once 30 // 5 = 6 are stored
    assert rep.filled == 6 and rep.cursor == 8 % 6
    assert hist["updates"] == [0, 3] and ts.n_updates == 3
    assert hist["metrics"][0] == {} and np.isfinite(list(hist["metrics"][1].values())).all()
    assert all(np.isfinite(r) for r in hist["mean_return"])
    assert hist["mean_ep_len"] == [5.0, 5.0] and hist["blowups"] == [0, 0]
    assert all(torch.isfinite(p).all() and p.dtype == torch.float32
               for p in ts.net.parameters())
    # on CPU tensors the ops run their plain versions: no launches counted
    assert (abcn.launches, mlp.launches) == (abcn_before, mlp_before)


def test_train_refuses_what_the_slice_does_not_cover(envs, tmp_path):
    """The trainer covers every TrainerConfig field now: the episode dump
    writes one npz a generation in both the train loop and the fused
    generation's collection (which records the fields for it)."""
    _, tenv = envs
    tc = ttr.TrainerConfig(num_envs=2, max_experiences=20, save_episodes_dir=str(tmp_path / "x"),
                           seed=3)
    ttr.train(tenv, ttr.default_rl_config(tenv, width=8), tc=tc, verbose=False)
    assert sorted(p.name for p in (tmp_path / "x").iterdir()) == ["episodes_gen1.npz",
                                                                  "episodes_gen2.npz"]
    fused = ttr.build_fused_generation(tenv, ttr.default_rl_config(tenv, width=8), tc, 1)
    ts = tv.init_train(ttr.default_rl_config(tenv, width=8), torch.Generator().manual_seed(0),
                       dtype=tenv.dtype, device=tenv.device)
    rep = ttr.make_replay(tenv, ttr.default_rl_config(tenv, width=8))
    _, _, traj, _, _, _ = fused(ts, rep, torch.Generator().manual_seed(1), 0, tenv.consts)
    assert traj["fields"].shape[:2] == (2, tenv.episode_length) and "ektt" in traj
    # experience mode is ported: its replay is the flat ring
    rep = ttr.make_replay(tenv, ttr.default_rl_config(tenv, minibatch_mode="experience",
                                                      replay_max_experiences=64))
    assert rep.capacity == 64 and rep.ep_capacity == 1024 and rep.cursor == 0
    assert ttr.updates_per_generation(ttr.default_rl_config(tenv), ttr.TrainerConfig(
        num_envs=1024), 500) == 200
