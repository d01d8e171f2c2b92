"""Diffusion stencil-learning environments (port of
marlpde_tpu/envs/diffusion_env.py:1-164).

Parity targets:
  * diffusion_environment_simple.py: per-point (or scalar) stencil action,
    analytical-MSE reward + survival bonus keyed by N (:32-40), early stop when
    cumreward < 0 (:70-71)
  * diffusion_environment_error.py: truncation-error correction on
    DiffusionError (bonus dict :31-35)
  * diffusion_environment.py: 3-weight global stencil; the reference's env
    passes 3 actions into Diffusion.step, which asserts len==1.  The JAX
    package implements the evident intent, and so does the port: the
    zero-sum stencil (M@u)_i = a0*u_{i-1} + a1*u_i + a2*u_{i+1}, a2 = -(a0+a1).

Mode is selected by ``mode`` in {'simple', 'error', 'stencil3'}.  Per-agent
observations are halo-extended slices of u (Diffusion.py:284-298).  The JAX
package vmaps its per-env (reset, step) pair; here both are written over a
leading env axis (B, ...), and the reset offsets come from a
``torch.Generator``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from marlpde_tpu_torch.core import ic
from marlpde_tpu_torch.device import grid_array
from marlpde_tpu_torch.envs import features
from marlpde_tpu_torch.envs.rollout import Placement
from marlpde_tpu_torch.solvers import diffusion

# survival bonus per grid size (diffusion_environment_simple.py:32-40)
SIMPLE_BONUS = {128: 5e-4, 64: 5e-5, 32: 5e-5, 16: 5e-5, 8: 5e-5, 4: 5e-5, 2: 5e-5, 1: 5e-5}
# diffusion_environment_error.py:31-35 keys on numAgents
ERROR_BONUS = {128: 5e-4, 64: 5e-5, 32: 5e-5, 16: 5e-5, 8: 5e-5, 4: 5e-5, 2: 5e-5, 1: 5e-5}


@dataclasses.dataclass(frozen=True, eq=True)
class DiffusionEnvConfig:
    """Mirrors run-vracer-diffusion-simple.py defaults."""

    N: int = 128
    num_agents: int = 1
    L: float = 2.0 * np.pi
    dt: float = 0.01
    nu: float = 0.1
    episode_length: int = 500
    ic_case: str = "sinus"
    noise: float = 0.5            # offset stddev, NOT scaled by L (Diffusion.py:48)
    mode: str = "simple"          # 'simple' | 'error' | 'stencil3'
    bonus: float | None = None    # override; default from the dicts above

    @property
    def t_end(self) -> float:
        return self.dt * self.episode_length

    @property
    def n_intermediate(self) -> int:
        return 1

    @property
    def solver(self) -> diffusion.DiffusionConfig:
        return diffusion.DiffusionConfig(N=self.N, L=self.L, dt=self.dt, nu=self.nu)

    @property
    def survival_bonus(self) -> float:
        if self.bonus is not None:
            return self.bonus
        return SIMPLE_BONUS.get(self.N, 5e-5)

    @property
    def obs_dim(self) -> int:
        # Diffusion.getState: full u (single) or halo slice (Diffusion.py:284-298)
        return self.N if self.num_agents == 1 else self.N // self.num_agents + 2

    @property
    def actions_per_agent(self) -> int:
        if self.mode == "stencil3":
            return 2                      # third weight is -(a0+a1)
        return self.N // self.num_agents  # per-point center weights


@dataclasses.dataclass
class DiffusionEnvState:
    """Batched env state (leading axis = env)."""

    solver: diffusion.DiffusionState
    macro_step: torch.Tensor    # (B,) int64
    done: torch.Tensor          # (B,) bool
    cum_reward: torch.Tensor    # (B,) mean over agents, for the early stop


def _ic_field(cfg: DiffusionEnvConfig, offset, x):
    if cfg.ic_case == "sinus":
        return ic.diffusion_sinus(offset, x, cfg.L)
    if cfg.ic_case == "box":
        return ic.diffusion_box(offset, x, cfg.L)
    if cfg.ic_case == "gaussian":
        return ic.diffusion_gaussian(offset, x, cfg.L)
    raise ValueError(f"[diffusion_env] unknown ic {cfg.ic_case}")


def draw_offset(noise: float, generator, batch: int, dtype, device):
    """offset = noise * N(0, 1) per env, 0 without noise (Diffusion.py:48)."""
    if noise <= 0.0:
        return torch.zeros(batch, dtype=dtype, device=device)
    return noise * torch.randn(batch, generator=generator, dtype=dtype, device=device)


def reset(cfg: DiffusionEnvConfig, consts: Placement, generator, episode_counts):
    """Start a batch of episodes; returns (state, obs).  The offsets come
    from ``generator``; the episode counts only give the batch size."""
    offset = draw_offset(cfg.noise, generator, episode_counts.shape[0], consts.dtype,
                         consts.device)
    return reset_at(cfg, offset)


def reset_at(cfg: DiffusionEnvConfig, offset):
    """``reset`` with the offsets (B,) given, in their dtype on their device."""
    B, dtype, device = offset.shape[0], offset.dtype, offset.device
    x = grid_array(cfg.solver.grid, "x", dtype, device)
    u0 = _ic_field(cfg, offset[:, None], x)
    st = diffusion.init(cfg.solver, u0, offset=offset)
    state = DiffusionEnvState(
        solver=st, macro_step=torch.zeros(B, dtype=torch.int64, device=device),
        done=torch.zeros(B, dtype=torch.bool, device=device),
        cum_reward=torch.zeros(B, dtype=dtype, device=device))
    return state, _observe(cfg, state)


def _observe(cfg: DiffusionEnvConfig, state: DiffusionEnvState):
    u = state.solver.u
    if cfg.num_agents == 1:
        return u[..., None, :]
    return u[..., features._halo_index_tensor(cfg.N, cfg.num_agents, u.device)]


def _keep(was, new, old):
    return torch.where(was.reshape((-1,) + (1,) * (new.ndim - 1)), old, new)


def step(cfg: DiffusionEnvConfig, consts, state: DiffusionEnvState, actions):
    """actions: (B, num_agents, actions_per_agent).  Returns
    (state, obs, reward (B, num_agents), done (B,), info)."""
    scfg = cfg.solver
    B = state.solver.u.shape[0]
    if cfg.mode == "stencil3":
        a = actions.reshape(B, -1)
        a0, a1 = a[:, :1], a[:, 1:2]
        a2 = -(a0 + a1)
        u = state.solver.u
        mu = a0 * torch.roll(u, 1, -1) + a1 * u + a2 * torch.roll(u, -1, -1)
        u_new = u + cfg.dt * state.solver.nu[..., None] * mu / scfg.grid.dx**2
        sol = diffusion.advance(scfg, state.solver, u_new)
    else:
        a = actions.reshape(B, -1)
        if a.shape[-1] != cfg.N:
            a = torch.repeat_interleave(a, cfg.N // a.shape[-1], dim=-1)
        sol, _aux = diffusion.step(scfg, state.solver, a, error_mode=(cfg.mode == "error"))

    # analytical MSE reward (Diffusion.py:238-252) + survival bonus
    truth = diffusion.analytical_sinus(sol, scfg)
    sq = (truth - sol.u) ** 2
    reward = -features.agent_block_mean(sq, cfg.num_agents) + cfg.survival_bonus
    blown = ~torch.isfinite(sol.u).all(-1)
    reward = torch.where(blown[:, None], torch.full_like(reward, -1.0), reward)

    was = state.done
    macro = state.macro_step + 1
    cum = state.cum_reward + torch.where(was, torch.zeros_like(state.cum_reward),
                                         reward.mean(-1))
    # early stop when cumreward < 0 (diffusion_environment_simple.py:70-71)
    done = blown | (macro >= cfg.episode_length) | (cum < 0.0) | was
    sol = diffusion.DiffusionState(**{
        f.name: _keep(was, getattr(sol, f.name), getattr(state.solver, f.name))
        for f in dataclasses.fields(diffusion.DiffusionState)})
    new_state = DiffusionEnvState(solver=sol, macro_step=_keep(was, macro, state.macro_step),
                                  done=done, cum_reward=_keep(was, cum, state.cum_reward))
    reward = torch.where(was[:, None], torch.zeros_like(reward), reward)
    obs = _observe(cfg, new_state)
    obs = torch.where(torch.isfinite(obs), obs, torch.zeros_like(obs))
    return new_state, obs, reward, done, dict(blown=blown)
