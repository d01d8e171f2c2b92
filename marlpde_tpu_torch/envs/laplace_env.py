"""Laplace pseudo-time RL environment (port of
marlpde_tpu/envs/laplace_env.py:1-88).

Parity target: laplace_environment.py (direct residual reward, fixed-length
episodes, no early stop) with Laplace.py (num_agents 3-weight stencils,
Dirichlet BC row; run-vracer-laplace.py defaults: N=32 agents, dt=0.01,
episodeLength=100, actions in [-3, 3]).  Written over a leading env axis
(B, ...); the offsets and the random forces' branch draws come from a
``torch.Generator``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from marlpde_tpu_torch.core import ic
from marlpde_tpu_torch.device import grid_array
from marlpde_tpu_torch.envs.diffusion_env import _keep
from marlpde_tpu_torch.envs.rollout import Placement
from marlpde_tpu_torch.solvers import laplace

# the source terms that draw which branch they take
RANDOM_FORCES = ("sincos", "fourier")


@dataclasses.dataclass(frozen=True, eq=True)
class LaplaceEnvConfig:
    num_agents: int = 32
    L: float = 2.0 * np.pi
    dt: float = 0.01
    episode_length: int = 100
    ic_case: str = "one"
    sforce: str = "zero"
    noise: float = 0.0

    @property
    def solver(self) -> laplace.LaplaceConfig:
        return laplace.LaplaceConfig(num_agents=self.num_agents, L=self.L, dt=self.dt)

    @property
    def obs_dim(self) -> int:
        return 4                      # [u_{i-1}, u_i, u_{i+1}, f_i] (Laplace.py:166)

    @property
    def actions_per_agent(self) -> int:
        return 3


@dataclasses.dataclass
class LaplaceEnvState:
    """Batched env state (leading axis = env)."""

    solver: laplace.LaplaceState
    macro_step: torch.Tensor    # (B,) int64
    done: torch.Tensor          # (B,) bool
    cum_reward: torch.Tensor    # (B,) mean over agents


def reset(cfg: LaplaceEnvConfig, consts: Placement, generator, episode_counts):
    """Start a batch of episodes; returns (state, obs).  The offsets
    (L * noise * N(0, 1), scaled by L unlike diffusion's) and the uniform
    draws of the random forces come from ``generator``."""
    B, dtype, device = episode_counts.shape[0], consts.dtype, consts.device
    offset = torch.zeros(B, dtype=dtype, device=device)
    if cfg.noise > 0.0:
        offset = cfg.L * cfg.noise * torch.randn(B, generator=generator, dtype=dtype,
                                                 device=device)
    r = None
    if cfg.sforce in RANDOM_FORCES:
        r = torch.rand(B, generator=generator, dtype=dtype, device=device)
    return reset_at(cfg, offset, r)


def reset_at(cfg: LaplaceEnvConfig, offset, r=None):
    """``reset`` with the offsets (B,) and, for the random forces, the
    uniform draws (B,) given."""
    B, dtype, device = offset.shape[0], offset.dtype, offset.device
    x = grid_array(cfg.solver.grid, "x", dtype, device)
    u0 = ic.laplace_ic(cfg.ic_case, x).expand(B, -1).clone()
    force = ic.laplace_force(cfg.sforce, None if r is None else r[:, None],
                             offset[:, None], x, cfg.L).expand(B, -1).clone()
    st = laplace.init(cfg.solver, u0, force)
    state = LaplaceEnvState(
        solver=st, macro_step=torch.zeros(B, dtype=torch.int64, device=device),
        done=torch.zeros(B, dtype=torch.bool, device=device),
        cum_reward=torch.zeros(B, dtype=dtype, device=device))
    return state, laplace.get_state(cfg.solver, st)


def step(cfg: LaplaceEnvConfig, consts, state: LaplaceEnvState, actions):
    """actions: (B, num_agents, 3).  Returns (state, obs, reward (B, na),
    done (B,), info)."""
    sol, _aux = laplace.step(cfg.solver, state.solver, actions)
    reward = laplace.direct_reward(cfg.solver, sol)
    blown = ~torch.isfinite(sol.u).all(-1)
    reward = torch.where(blown[:, None], torch.full_like(reward, -1e3), reward)

    was = state.done
    macro = state.macro_step + 1
    done = blown | (macro >= cfg.episode_length) | was
    sol = laplace.LaplaceState(**{
        f.name: _keep(was, getattr(sol, f.name), getattr(state.solver, f.name))
        for f in dataclasses.fields(laplace.LaplaceState)})
    new_state = LaplaceEnvState(
        solver=sol, macro_step=_keep(was, macro, state.macro_step), done=done,
        cum_reward=state.cum_reward + torch.where(was, torch.zeros_like(state.cum_reward),
                                                  reward.mean(-1)))
    reward = torch.where(was[:, None], torch.zeros_like(reward), reward)
    obs = laplace.get_state(cfg.solver, sol)
    obs = torch.where(torch.isfinite(obs), obs, torch.zeros_like(obs))
    return new_state, obs, reward, done, dict(blown=blown)
