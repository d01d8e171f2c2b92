"""Advection stencil-learning environment (port of
marlpde_tpu/envs/advection_env.py:1-113).

Parity target: advection_environment_simple.py (bonus dict :31-35, early stop
on cumreward<0) with Advection.py's pointwise 2-weight stencil actions
(:171-194; per agent 2*(N/numAgents) interleaved weights, even index ->
u_{i+1}, odd -> u_{i-1}) and the analytical sinus MSE reward (:238-249).
Written over a leading env axis (B, ...), the offsets drawn from a
``torch.Generator``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from marlpde_tpu_torch.core import ic
from marlpde_tpu_torch.device import grid_array
from marlpde_tpu_torch.envs import features
from marlpde_tpu_torch.envs.diffusion_env import _keep, draw_offset
from marlpde_tpu_torch.envs.rollout import Placement
from marlpde_tpu_torch.solvers import advection

# advection_environment_simple.py:31-35
BONUS = {128: 5e-2, 64: 5e-2, 32: 5e-2, 16: 1e-1, 8: 1e-1}


@dataclasses.dataclass(frozen=True, eq=True)
class AdvectionEnvConfig:
    """Mirrors run-vracer-advection-simple.py defaults."""

    N: int = 32
    num_agents: int = 1
    L: float = 2.0 * np.pi
    dt: float = 0.01
    nu: float = 0.5
    episode_length: int = 500
    ic_case: str = "sinus"
    noise: float = 0.0
    bonus: float | None = None

    @property
    def solver(self) -> advection.AdvectionConfig:
        return advection.AdvectionConfig(N=self.N, L=self.L, dt=self.dt, nu=self.nu)

    @property
    def survival_bonus(self) -> float:
        return self.bonus if self.bonus is not None else BONUS.get(self.N, 5e-2)

    @property
    def obs_dim(self) -> int:
        return self.N if self.num_agents == 1 else self.N // self.num_agents + 2

    @property
    def actions_per_agent(self) -> int:
        return 2 * self.N // self.num_agents


@dataclasses.dataclass
class AdvectionEnvState:
    """Batched env state (leading axis = env)."""

    solver: advection.AdvectionState
    macro_step: torch.Tensor    # (B,) int64
    done: torch.Tensor          # (B,) bool
    cum_reward: torch.Tensor    # (B,) mean over agents, for the early stop


def reset(cfg: AdvectionEnvConfig, consts: Placement, generator, episode_counts):
    """Start a batch of episodes; returns (state, obs).  The offsets
    (noise * N(0, 1)) come from ``generator``."""
    offset = draw_offset(cfg.noise, generator, episode_counts.shape[0], consts.dtype,
                         consts.device)
    return reset_at(cfg, offset)


def reset_at(cfg: AdvectionEnvConfig, offset):
    """``reset`` with the offsets (B,) given, in their dtype on their device."""
    assert cfg.ic_case == "sinus", "[advection_env] only sinus implemented (Advection.py:104-113)"
    B, dtype, device = offset.shape[0], offset.dtype, offset.device
    x = grid_array(cfg.solver.grid, "x", dtype, device)
    u0 = ic.diffusion_sinus(offset[:, None], x, cfg.L)
    st = advection.init(cfg.solver, u0, offset=offset)
    state = AdvectionEnvState(
        solver=st, macro_step=torch.zeros(B, dtype=torch.int64, device=device),
        done=torch.zeros(B, dtype=torch.bool, device=device),
        cum_reward=torch.zeros(B, dtype=dtype, device=device))
    return state, _observe(cfg, state)


def _observe(cfg: AdvectionEnvConfig, state: AdvectionEnvState):
    u = state.solver.u
    if cfg.num_agents == 1:
        return u[..., None, :]
    return u[..., features._halo_index_tensor(cfg.N, cfg.num_agents, u.device)]


def step(cfg: AdvectionEnvConfig, consts, state: AdvectionEnvState, actions):
    """actions: (B, num_agents, 2*N/num_agents), interleaved (a0, a1) per point."""
    B = state.solver.u.shape[0]
    pairs = actions.reshape(B, cfg.N, 2)
    sol, _aux = advection.step(cfg.solver, state.solver, (pairs[..., 0], pairs[..., 1]),
                               pointwise=True)

    truth = advection.analytical_sinus(sol, cfg.solver)
    sq = (truth - sol.u) ** 2
    reward = -features.agent_block_mean(sq, cfg.num_agents) + cfg.survival_bonus
    blown = ~torch.isfinite(sol.u).all(-1)
    reward = torch.where(blown[:, None], torch.full_like(reward, -1.0), reward)

    was = state.done
    macro = state.macro_step + 1
    cum = state.cum_reward + torch.where(was, torch.zeros_like(state.cum_reward),
                                         reward.mean(-1))
    done = blown | (macro >= cfg.episode_length) | (cum < 0.0) | was
    sol = advection.AdvectionState(**{
        f.name: _keep(was, getattr(sol, f.name), getattr(state.solver, f.name))
        for f in dataclasses.fields(advection.AdvectionState)})
    new_state = AdvectionEnvState(solver=sol, macro_step=_keep(was, macro, state.macro_step),
                                  done=done, cum_reward=_keep(was, cum, state.cum_reward))
    reward = torch.where(was[:, None], torch.zeros_like(reward), reward)
    obs = _observe(cfg, new_state)
    obs = torch.where(torch.isfinite(obs), obs, torch.zeros_like(obs))
    return new_state, obs, reward, done, dict(blown=blown)
