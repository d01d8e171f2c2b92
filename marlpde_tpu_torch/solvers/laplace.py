"""Laplace/Poisson pseudo-time RL solver: u_xx = f(x), agents output full
3-point stencils (port of marlpde_tpu/solvers/laplace.py:1-87).

Parity target: Laplace.py:116-151.
  N = numAgents + 1 (one Dirichlet BC row).  Row r = i+1 of the action matrix:
    (M@u)_r = a0_i*u_{r-1} + a1_i*u_r + a2_i*u_{(r+1) mod N},  r = 1..N-1; row 0 zero.
  Update u += dt*(M@u); then enforce u[0] = 1.
Direct reward (Laplace.py:153-160): -(d2udx2[1:] - f[1:])^2 with the centered
FD laplacian.

Every function works over any leading batch shape of the state.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from marlpde_tpu_torch.core.grids import Grid


@dataclasses.dataclass(frozen=True, eq=True)
class LaplaceConfig:
    num_agents: int
    L: float = 2.0 * np.pi
    dt: float = 0.01

    @property
    def N(self) -> int:
        # Laplace.py:17: N = int(N)+1 grid points, agents act on rows 1..N-1
        return self.num_agents + 1

    @property
    def grid(self) -> Grid:
        return Grid(self.N, self.L)


@dataclasses.dataclass
class LaplaceState:
    u: torch.Tensor          # (..., N)
    force: torch.Tensor      # (..., N)
    t: torch.Tensor          # (...,)
    ioutnum: torch.Tensor    # (...,) int64


def init(cfg: LaplaceConfig, u0, force) -> LaplaceState:
    batch = u0.shape[:-1]
    return LaplaceState(u=u0, force=force,
                        t=torch.zeros(batch, dtype=u0.dtype, device=u0.device),
                        ioutnum=torch.zeros(batch, dtype=torch.int64, device=u0.device))


def step(cfg: LaplaceConfig, state: LaplaceState, actions) -> tuple[LaplaceState, dict]:
    """``actions``: (..., num_agents, 3) stencil weights."""
    u = state.u
    a0, a1, a2 = actions[..., 0], actions[..., 1], actions[..., 2]
    # rows r=1..N-1: neighbors u[r-1], u[r], u[(r+1) % N]
    ur = u[..., 1:]
    up = torch.cat([u[..., 2:], u[..., :1]], dim=-1)
    mu_rows = a0 * u[..., :-1] + a1 * ur + a2 * up          # (..., N-1)
    mu = torch.cat([torch.zeros_like(u[..., :1]), mu_rows], dim=-1)
    u_new = u + cfg.dt * mu
    u_new[..., 0] = 1.0                                     # Dirichlet BC (Laplace.py:134)
    new_state = dataclasses.replace(state, u=u_new, t=state.t + cfg.dt,
                                    ioutnum=state.ioutnum + 1)
    return new_state, dict(gradient=mu)


def centered_laplacian(u, dx):
    return (torch.roll(u, 1, -1) - 2.0 * u + torch.roll(u, -1, -1)) / (dx * dx)


def direct_reward(cfg: LaplaceConfig, state: LaplaceState):
    """-(u_xx - f)^2 on rows 1..N-1 (Laplace.py:153-160); (..., num_agents)."""
    d2 = centered_laplacian(state.u, cfg.grid.dx)
    return -torch.square(d2[..., 1:] - state.force[..., 1:])


def get_state(cfg: LaplaceConfig, state: LaplaceState):
    """Per-agent observation [u_{i-1}, u_i, u_{i+1}, f_i], i = 0..num_agents-1
    (Laplace.py:162-167; note the i-1 wraps at i=0); (..., na, 4)."""
    u, f = state.u, state.force
    na = cfg.num_agents
    um = torch.roll(u, 1, -1)[..., :na]
    uc = u[..., :na]
    up = torch.roll(u, -1, -1)[..., :na]
    return torch.stack([um, uc, up, f[..., :na]], dim=-1)
