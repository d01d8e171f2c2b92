"""Episode collection with the policy in the loop (port of
marlpde_tpu/envs/rollout.py:21-144).

The JAX macro-step ``lax.scan`` becomes a Python loop that writes each
macro-step into preallocated (B, T, ...) tensors, the layout replay takes.
Every macro-step makes one MLP-op call for all B*na agents, then one env step
for all B envs: the whole-batch pair when the env has one (one ABCN-op call),
else the per-env pair, which the port writes over a leading env axis in place
of JAX's vmap.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from marlpde_tpu_torch.rl import vracer


@dataclasses.dataclass(frozen=True)
class Env:
    """Uniform functional env interface over the concrete env modules.

    ``reset``/``step`` are the env's general pair, ``batch_reset``/
    ``batch_step`` the optional whole-batch fast pair (envs/burger_fast.py);
    both pairs take and return a leading env axis.  ``consts`` holds large
    runtime data (the DNS pool) or, for an env without a pool, a holder of
    its device and dtype; either way ``consts.device`` and ``consts.dtype``
    say where and in which dtype the env's tensors live."""

    name: str
    cfg: Any
    reset: Callable           # (consts, generator, counts) -> (state, obs)
    step: Callable            # (consts, state, actions) -> (state, obs, reward, done, info)
    obs_dim: int
    num_agents: int
    act_dim: int              # actions per agent
    episode_length: int
    action_low: float
    action_high: float
    consts: Any = ()
    batch_reset: Callable | None = None
    batch_step: Callable | None = None

    @property
    def device(self) -> torch.device:
        return placement(self.consts)[0]

    @property
    def dtype(self) -> torch.dtype:
        return placement(self.consts)[1]

    @property
    def whole_batch(self) -> bool:
        return self.batch_reset is not None and self.batch_step is not None

    def reset_batch(self, consts, generator, counts):
        """Reset through the whole-batch pair when there is one."""
        return (self.batch_reset if self.whole_batch else self.reset)(consts, generator, counts)


@dataclasses.dataclass(frozen=True)
class Placement:
    """The consts of an env without a pool (diffusion, advection, Laplace):
    only where and in which dtype its envs live."""

    device: torch.device
    dtype: torch.dtype


def placement(consts):
    """(device, dtype) of an env's consts; raises where they carry neither."""
    device, dtype = getattr(consts, "device", None), getattr(consts, "dtype", None)
    if device is None or dtype is None:
        raise ValueError(f"[rollout] the env's consts {type(consts).__name__} carry no "
                         f"device and dtype")
    return device, dtype


def _fields(state):
    """(u, ektt or None) of a state after a step: the solved field, and for
    spectral envs (a running ``ek_sum``) the cumulative-mean spectrum."""
    u = state.u if hasattr(state, "u") else state.solver.u
    if not hasattr(state, "ek_sum"):
        return u, None
    io = state.ioutnum if hasattr(state, "ioutnum") else state.solver.ioutnum
    return u, state.ek_sum / (io + 1).to(u.dtype)[..., None]


def collect_episodes(env: Env, rl_cfg, ts, generator, batch_size: int,
                     episode_base: int = 0, deterministic: bool = False,
                     consts=None, record_fields: bool = False):
    """Roll out ``batch_size`` envs for a full episode.

    Returns (traj, final_state): traj holds (B, T, na, ...) tensors obs,
    actions, mu, sigma, rewards, and mask (B, T), truncated (B,), final_obs
    (B, na, obs_dim) — ready for the replays.  ``generator`` draws the reset
    offsets and the action noise.  ``record_fields`` also records the solved
    field ``fields`` (B, T, N) after each step and, for spectral envs, the
    cumulative-mean energy spectrum ``ektt`` (B, T, N): the contents of the
    reference's save-episode npz (burger_environment.py:207-238: sgs_u /
    sgs_Ektt); the replays ignore both."""
    consts = env.consts if consts is None else consts
    device = ts.beta.device
    counts = episode_base + torch.arange(batch_size, device=device)
    step = env.batch_step if env.whole_batch else env.step
    state, obs = env.reset_batch(consts, generator, counts)
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
    recorded = dict(fields=[], ektt=[])
    for t in range(T):
        if deterministic:
            _, mu, sigma = vracer.policy_apply(rl_cfg, ts, obs)
            a = torch.clamp(mu, rl_cfg.action_low, rl_cfg.action_high)
        else:
            a, mu, sigma = vracer.act(rl_cfg, ts, obs, generator)
        traj["mask"][:, t] = ~state.done
        state, obs_next, rew, _, info = step(consts, state, a)
        traj["obs"][:, t] = obs
        traj["actions"][:, t] = a
        traj["mu"][:, t] = mu
        traj["sigma"][:, t] = sigma
        traj["rewards"][:, t] = rew
        blown[:, t] = info["blown"]
        obs = obs_next
        if record_fields:
            u, ektt = _fields(state)
            recorded["fields"].append(u)
            if ektt is not None:
                recorded["ektt"].append(ektt)
    # Truncated-vs-Terminal bookkeeping (burger_environment.py:198-204): a
    # numeric blowup ends the episode "Truncated" and the learner bootstraps
    # from V(final_obs); envs freeze once done, so final_obs is the
    # observation at truncation time
    traj["truncated"] = blown.any(dim=1)
    traj["final_obs"] = obs
    traj.update({k: torch.stack(v, dim=1) for k, v in recorded.items() if v})
    return traj, state


def zero_action_episode(env: Env, generator, batch_size: int = 1, episode_base: int = 0,
                        consts=None):
    """The reference's korali-free smoke loop (tests/burger/loop.py:99-135): a
    full episode of zero actions through the general pair; returns
    (traj dict of (B, T, ...) obs, rewards, done; final states)."""
    consts = env.consts if consts is None else consts
    device = placement(consts)[0]
    counts = episode_base + torch.arange(batch_size, device=device)
    state, obs = env.reset(consts, generator, counts)
    zero = torch.zeros((batch_size, env.num_agents, env.act_dim), dtype=obs.dtype,
                       device=obs.device)
    out = dict(obs=[], rewards=[], done=[])
    for _ in range(env.episode_length):
        state, obs_next, rew, done, _info = env.step(consts, state, zero)
        out["obs"].append(obs)
        out["rewards"].append(rew)
        out["done"].append(done)
        obs = obs_next
    return {k: torch.stack(v, dim=1) for k, v in out.items()}, state
