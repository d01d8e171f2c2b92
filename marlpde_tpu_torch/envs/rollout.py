"""Episode collection with the policy in the loop (port of
marlpde_tpu/envs/rollout.py:21-122, whole-batch branch).

The JAX macro-step ``lax.scan`` becomes a Python loop that writes each
macro-step into preallocated (B, T, ...) tensors, the layout replay takes.
Every macro-step makes one MLP-op call for all B*na agents and one ABCN-op
call for all B envs.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from marlpde_tpu_torch.rl import vracer


@dataclasses.dataclass(frozen=True)
class Env:
    """Uniform functional env interface over the whole-batch env modules.

    ``consts`` holds large runtime data (the DNS pool).  The per-env
    ``reset``/``step`` of the JAX Env wait for a later slice: the port rolls
    out through the whole-batch pair only."""

    name: str
    cfg: Any
    batch_reset: Callable     # (consts, generator, counts) -> (state, obs)
    batch_step: Callable      # (consts, state, actions) -> (state, obs, reward, done, info)
    obs_dim: int
    num_agents: int
    act_dim: int              # actions per agent
    episode_length: int
    action_low: float
    action_high: float
    consts: Any = ()


def collect_episodes(env: Env, rl_cfg, ts, generator, batch_size: int,
                     episode_base: int = 0, deterministic: bool = False,
                     consts=None):
    """Roll out ``batch_size`` envs for a full episode.

    Returns (traj, final_state): traj holds (B, T, na, ...) tensors obs,
    actions, mu, sigma, rewards, and mask (B, T), truncated (B,), final_obs
    (B, na, obs_dim) — ready for replay.add_episodes.  ``generator`` draws
    the reset offsets and the action noise."""
    consts = env.consts if consts is None else consts
    device = ts.beta.device
    counts = episode_base + torch.arange(batch_size, device=device)
    state, obs = env.batch_reset(consts, generator, counts)
    B, T, na = batch_size, env.episode_length, env.num_agents
    kw = dict(dtype=obs.dtype, device=obs.device)
    traj = dict(
        obs=torch.empty((B, T, na, env.obs_dim), **kw),
        actions=torch.empty((B, T, na, env.act_dim), **kw),
        mu=torch.empty((B, T, na, env.act_dim), **kw),
        sigma=torch.empty((B, T, na, env.act_dim), **kw),
        rewards=torch.empty((B, T, na), **kw),
        mask=torch.empty((B, T), **kw))
    blown = torch.empty((B, T), dtype=torch.bool, device=obs.device)
    for t in range(T):
        if deterministic:
            _, mu, sigma = vracer.policy_apply(rl_cfg, ts, obs)
            a = torch.clamp(mu, rl_cfg.action_low, rl_cfg.action_high)
        else:
            a, mu, sigma = vracer.act(rl_cfg, ts, obs, generator)
        traj["mask"][:, t] = ~state.done
        state, obs_next, rew, _, info = env.batch_step(consts, state, a)
        traj["obs"][:, t] = obs
        traj["actions"][:, t] = a
        traj["mu"][:, t] = mu
        traj["sigma"][:, t] = sigma
        traj["rewards"][:, t] = rew
        blown[:, t] = info["blown"]
        obs = obs_next
    # Truncated-vs-Terminal bookkeeping (burger_environment.py:198-204): a
    # numeric blowup ends the episode "Truncated" and the learner bootstraps
    # from V(final_obs); envs freeze once done, so final_obs is the
    # observation at truncation time
    traj["truncated"] = blown.any(dim=1)
    traj["final_obs"] = obs
    return traj, state
