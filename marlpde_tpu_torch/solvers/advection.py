"""Advection solvers (u_t + nu*u_x = 0, periodic) — Lax scheme + RL stencil
actions (port of marlpde_tpu/solvers/advection.py:1-117).

Parity targets:
  * Lax step with Courant alpha = nu*dt/dx          Advection.py:42-43,138-152
    (M@u)_i = (0.5+0.5a)*u_{i-1} + (0.5-0.5a)*u_{i+1}
  * 2-weight stencil actions                        Advection.py:154-200
    global mode (2 scalars):   (M@u)_i = a0*u_{i-1} + (1-a0-a1)*u_i + a1*u_{i+1}
    per-point mode (2/point):  (M@u)_i = (1-a0_i-a1_i)*u_i + a0_i*u_{i+1} + a1_i*u_{i-1}
    NB: the two modes map (a0, a1) to *opposite* neighbors in the reference;
    replicated verbatim.
  * analytical solution sin((x-nu*t-offset)*2*pi/L) Advection.py:289-291

Every function works over any leading batch shape of the state.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from marlpde_tpu_torch.core.grids import Grid
from marlpde_tpu_torch.device import grid_array


@dataclasses.dataclass(frozen=True, eq=True)
class AdvectionConfig:
    N: int
    L: float = 2.0 * np.pi
    dt: float = 0.001
    nu: float = 0.01    # advection speed

    @property
    def grid(self) -> Grid:
        return Grid(self.N, self.L)

    @property
    def alpha(self) -> float:
        return self.nu * self.dt / self.grid.dx


@dataclasses.dataclass
class AdvectionState:
    u: torch.Tensor          # (..., N)
    t: torch.Tensor          # (...,)
    ioutnum: torch.Tensor    # (...,) int64
    nu: torch.Tensor         # (...,)
    offset: torch.Tensor     # (...,)


def init(cfg: AdvectionConfig, u0, *, nu=None, offset=0.0) -> AdvectionState:
    batch, dtype, device = u0.shape[:-1], u0.dtype, u0.device
    offset = torch.as_tensor(offset, dtype=dtype, device=device)
    return AdvectionState(
        u=u0, t=torch.zeros(batch, dtype=dtype, device=device),
        ioutnum=torch.zeros(batch, dtype=torch.int64, device=device),
        nu=torch.full(batch, cfg.nu if nu is None else nu, dtype=dtype, device=device),
        offset=offset * torch.ones(batch, dtype=dtype, device=device))


def lax_step(cfg: AdvectionConfig, state: AdvectionState):
    """Lax method (Advection.py:138-152), from the state's live nu as the
    JAX package does (the reference takes alpha from the constructor's nu,
    before its nunoise draw, Advection.py:43-46)."""
    u = state.u
    alpha = state.nu[..., None] * cfg.dt / cfg.grid.dx
    return (0.5 + 0.5 * alpha) * torch.roll(u, 1, -1) + (0.5 - 0.5 * alpha) * torch.roll(u, -1, -1)


def action_step_global(cfg: AdvectionConfig, state: AdvectionState, a0, a1):
    """2-scalar global stencil (Advection.py:160-169): a0 -> sub-diagonal
    (u_{i-1}), a1 -> super-diagonal (u_{i+1}), diag 1-a0-a1; a0, a1 (...,)."""
    u = state.u
    a0 = torch.as_tensor(a0, dtype=u.dtype, device=u.device)[..., None]
    a1 = torch.as_tensor(a1, dtype=u.dtype, device=u.device)[..., None]
    return a0 * torch.roll(u, 1, -1) + (1.0 - a0 - a1) * u + a1 * torch.roll(u, -1, -1)


def action_step_pointwise(cfg: AdvectionConfig, state: AdvectionState, a0, a1):
    """Per-point 2-weight stencil (Advection.py:171-194): for row i,
    a0_i -> u_{i+1}, a1_i -> u_{i-1}, diag 1-a0_i-a1_i.  a0, a1: (..., N)."""
    u = state.u
    return (1.0 - a0 - a1) * u + a0 * torch.roll(u, -1, -1) + a1 * torch.roll(u, 1, -1)


def advance(cfg: AdvectionConfig, state: AdvectionState, u_new) -> AdvectionState:
    return dataclasses.replace(state, u=u_new, t=state.t + cfg.dt, ioutnum=state.ioutnum + 1)


def step(cfg: AdvectionConfig, state: AdvectionState, actions=None,
         pointwise: bool = True) -> tuple[AdvectionState, dict]:
    if actions is None:
        return advance(cfg, state, lax_step(cfg, state)), {}
    a0, a1 = actions
    if pointwise:
        u_new = action_step_pointwise(cfg, state, a0, a1)
    else:
        u_new = action_step_global(cfg, state, a0, a1)
    return advance(cfg, state, u_new), dict(gradient=u_new)


def analytical_sinus(state: AdvectionState, cfg: AdvectionConfig, t=None):
    """sin((x - nu*t - offset)*2*pi/L)   (Advection.py:289-291)."""
    t = state.t if t is None else t
    x = grid_array(cfg.grid, "x", state.u.dtype, state.u.device)
    arg = x - (state.nu * t)[..., None] - state.offset[..., None]
    return torch.sin(arg * 2.0 * np.pi / cfg.L)


def simulate(cfg: AdvectionConfig, state: AdvectionState, nsteps: int):
    """Uncontrolled rollout; returns (final_state, uu) with the IC frame
    included, uu (nsteps + 1, ..., N)."""
    uu = [state.u]
    for _ in range(nsteps):
        state, _aux = step(cfg, state)
        uu.append(state.u)
    return state, torch.stack(uu)
