"""Training orchestration: generations of collection + REFER updates (port of
marlpde_tpu/train/trainer.py:35-180,183-489, episode-minibatch mode).

One generation collects ``num_envs`` episodes, inserts them into the episode
replay, updates the normalizers and, once the replay holds
``replay_start_episodes``, runs ``updates_per_generation`` VRACER updates —
the program the JAX package fuses into one dispatch
(``build_fused_generation``).  PyTorch runs it eagerly; the two branches that
JAX takes with ``lax.cond`` are decided on the host: whether updates run (the
replay fill is a host int) and which winsorization reference the reward
statistic uses (one scalar readback, in vracer.observe_episodes).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from marlpde_tpu_torch import NOT_PORTED as _NOT_PORTED
from marlpde_tpu_torch.envs.rollout import Env, collect_episodes
from marlpde_tpu_torch.rl import replay as replay_mod
from marlpde_tpu_torch.rl import running_stats, vracer


@dataclasses.dataclass(frozen=True)
class TrainerConfig:
    """Fields and defaults as marlpde_tpu/train/trainer.py:35-80.  ``fused``
    chooses nothing in the port: the eager generation is the same either way.
    Checkpointing, episode saving, testing, decay diagnostics and real
    experience counting raise NotImplementedError in ``train``."""

    num_envs: int = 16                 # episodes per generation
    max_experiences: float = 5e5       # korali Termination Criteria (run-vracer-burger.py:195)
    reuse_ratio: float = 512.0         # korali: 256 exp/update / 0.5 exp-between-updates
    max_updates_per_gen: int = 200
    seed: int = 42
    log_every: int = 1
    testing_frequency: int = 0
    testing_episodes: int = 8
    save_episodes_dir: Optional[str] = None
    save_episodes_threshold: float = -np.inf
    checkpoint_dir: Optional[str] = None
    checkpoint_every: int = 25
    serialize_replay: bool = False
    fused: bool = False
    decay_diagnostics: bool = False
    count_real_experiences: bool = False


def default_rl_config(env: Env, **overrides) -> vracer.VracerConfig:
    kw = dict(obs_dim=env.obs_dim, act_dim=env.act_dim,
              num_agents=env.num_agents, episode_length=env.episode_length,
              action_low=env.action_low, action_high=env.action_high)
    kw.update(overrides)
    return vracer.VracerConfig(**kw)


def _check_episode_mode(rl_cfg: vracer.VracerConfig):
    if rl_cfg.minibatch_mode != "episode":
        raise NotImplementedError(f"[trainer] minibatch_mode={rl_cfg.minibatch_mode!r} "
                                  f"{_NOT_PORTED}")


def _device_dtype(env: Env):
    return env.consts.uu.device, env.consts.uu.dtype


def make_replay(env: Env, rl_cfg: vracer.VracerConfig):
    """The episode-slot ring of episode minibatches, on the env's device."""
    _check_episode_mode(rl_cfg)
    device, dtype = _device_dtype(env)
    return replay_mod.init(rl_cfg.replay_capacity_episodes, env.episode_length,
                           env.num_agents, env.obs_dim, env.act_dim,
                           dtype=dtype, device=device)


def updates_per_generation(rl_cfg: vracer.VracerConfig, tc: TrainerConfig,
                           T: int) -> int:
    """korali economics: 1 update per `Experiences Between Policy Updates`
    new experiences, each consuming `Mini Batch Size` samples; episode-mode
    minibatches are K*T experiences."""
    exp_per_update = (rl_cfg.mini_batch_size
                      if rl_cfg.minibatch_mode == "experience"
                      else rl_cfg.mini_batch_episodes * T)
    return int(min(tc.max_updates_per_gen,
                   max(1, tc.num_envs * T * tc.reuse_ratio / exp_per_update)))


def build_fused_generation(env: Env, rl_cfg: vracer.VracerConfig,
                           tc: TrainerConfig, upd_per_gen: int):
    """One whole training generation (collect + replay insert + normalizer
    update + all gradient updates), as ``trainer.train`` runs it.

    Returns ``fused_generation(ts, rep, generator, episode_base, consts) ->
    (ts, rep, traj, final, metrics, stats)``; ``metrics`` are the last
    update's (empty when no update ran) and ``stats`` hold host numbers."""
    _check_episode_mode(rl_cfg)
    if tc.save_episodes_dir is not None:
        raise NotImplementedError(f"[trainer] save_episodes_dir {_NOT_PORTED}")

    def fused_generation(ts, rep, generator, episode_base, consts):
        traj, final = collect_episodes(env, rl_cfg, ts, generator, tc.num_envs,
                                       episode_base, consts=consts)
        rep = replay_mod.add_episodes(rep, traj)
        ts = vracer.observe_episodes(rl_cfg, ts, traj)
        did = rep.filled >= rl_cfg.replay_start_episodes
        metrics = {}
        if did:
            for _ in range(upd_per_gen):
                batch = replay_mod.sample_episodes(rep, generator,
                                                   rl_cfg.mini_batch_episodes)
                ts, metrics = vracer.update(rl_cfg, ts, batch)
        stats = dict(
            mean_return=float(final.cum_reward.reshape(tc.num_envs, -1).mean()),
            ep_len=float(traj["mask"].sum(1).mean()),
            n_upd=upd_per_gen if did else 0,
            blowups=int(traj["truncated"].sum()),
            rew_scale=float(running_stats.second_moment(ts.rew_stats)))
        return ts, rep, traj, final, metrics, stats

    return fused_generation


def train(env: Env, rl_cfg: Optional[vracer.VracerConfig] = None,
          tc: TrainerConfig = TrainerConfig(), verbose: bool = True,
          callback=None):
    """Run training; returns (train_state, replay, history dict).

    The generator seeded with ``tc.seed`` on the env's device draws the
    initial weights, the reset offsets, the action noise and the minibatch
    indices.  ``callback(gen, ts, rep, history)`` runs after each generation."""
    rl_cfg = rl_cfg or default_rl_config(env)
    for field, off in (("checkpoint_dir", None), ("save_episodes_dir", None),
                       ("testing_frequency", 0), ("decay_diagnostics", False),
                       ("count_real_experiences", False)):
        if getattr(tc, field) != off:
            raise NotImplementedError(f"[trainer] TrainerConfig.{field} {_NOT_PORTED}")
    device, dtype = _device_dtype(env)
    generator = torch.Generator(device=device)
    generator.manual_seed(tc.seed)
    ts = vracer.init_train(rl_cfg, generator, dtype=dtype, device=device)
    rep = make_replay(env, rl_cfg)
    T = env.episode_length
    upd_per_gen = updates_per_generation(rl_cfg, tc, T)
    generation = build_fused_generation(env, rl_cfg, tc, upd_per_gen)

    history = dict(gen=[], experiences=[], mean_return=[], mean_ep_len=[],
                   updates=[], metrics=[], test_return=[], wall_time=[],
                   env_steps_per_s=[], blowups=[], rew_scale=[])
    gen = total_exp = episode_base = 0
    t0 = time.time()
    while total_exp < tc.max_experiences:
        t_gen = time.perf_counter()
        ts, rep, traj, final, metrics, stats = generation(
            ts, rep, generator, episode_base, env.consts)
        episode_base += tc.num_envs
        gen_exp = tc.num_envs * T
        total_exp += gen_exp
        gen += 1
        history["gen"].append(gen)
        history["experiences"].append(total_exp)
        history["mean_return"].append(stats["mean_return"])
        history["mean_ep_len"].append(stats["ep_len"])
        history["updates"].append(stats["n_upd"])
        history["metrics"].append({k: float(v) for k, v in metrics.items()})
        history["wall_time"].append(time.time() - t0)
        history["env_steps_per_s"].append(gen_exp / (time.perf_counter() - t_gen))
        history["blowups"].append(stats["blowups"])
        history["rew_scale"].append(stats["rew_scale"])
        if verbose and gen % tc.log_every == 0:
            print(f"[trainer] gen {gen} exp {total_exp} return "
                  f"{stats['mean_return']:.5f} eplen {stats['ep_len']:.1f} "
                  f"updates {stats['n_upd']} "
                  f"beta {history['metrics'][-1].get('beta', '-')}", flush=True)
        if callback is not None:
            callback(gen, ts, rep, history)
    return ts, rep, history
