"""Heat-equation solvers (u_t = nu*u_xx, periodic) with RL stencil actions
(port of marlpde_tpu/solvers/diffusion.py:1-126).

Parity targets:
  * explicit Euler central FD                       Diffusion.py:152-160
  * implicit Euler — the reference builds a dense periodic tridiagonal matrix
    and calls np.linalg.solve (Diffusion.py:137-149); the matrix is circulant,
    so it is solved exactly in Fourier space (eigenvalues 1+2c-2c*cos(2*pi*m/N))
    on torch.fft, as the JAX package does
  * stencil actions: center weight a_i, neighbors -a_i/2,
    u += dt*nu*(M@u)/dx^2                           Diffusion.py:164-206
  * truncation-error actions: center -2+a_i, neighbors 1-a_i/2
                                                    DiffusionError.py:160-198
  * analytical sinus decay u0*exp(-(2*pi/L)^2*nu*t) Diffusion.py:301-303

Every function works over any leading batch shape of the state.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from marlpde_tpu_torch.core.grids import Grid


@dataclasses.dataclass(frozen=True, eq=True)
class DiffusionConfig:
    N: int
    L: float = 2.0 * np.pi
    dt: float = 0.001
    nu: float = 0.01
    implicit: bool = False

    @property
    def grid(self) -> Grid:
        return Grid(self.N, self.L)

    @property
    def cfl_violated(self) -> bool:
        # Diffusion.py:53: warn if 2*nu*dt >= dx^2 (explicit only)
        return (not self.implicit) and 2.0 * self.nu * self.dt >= self.grid.dx**2


@dataclasses.dataclass
class DiffusionState:
    u: torch.Tensor          # (..., N)
    t: torch.Tensor          # (...,)
    ioutnum: torch.Tensor    # (...,) int64
    nu: torch.Tensor         # (...,)
    offset: torch.Tensor     # (...,)
    u0: torch.Tensor         # (..., N) kept for the analytical sinus solution


def init(cfg: DiffusionConfig, u0, *, nu=None, offset=0.0) -> DiffusionState:
    batch, dtype, device = u0.shape[:-1], u0.dtype, u0.device
    offset = torch.as_tensor(offset, dtype=dtype, device=device)
    return DiffusionState(
        u=u0, t=torch.zeros(batch, dtype=dtype, device=device),
        ioutnum=torch.zeros(batch, dtype=torch.int64, device=device),
        nu=torch.full(batch, cfg.nu if nu is None else nu, dtype=dtype, device=device),
        offset=offset * torch.ones(batch, dtype=dtype, device=device), u0=u0)


def fd_step(cfg: DiffusionConfig, state: DiffusionState):
    """Uncontrolled update (Diffusion.py:137-162)."""
    u, nu = state.u, state.nu[..., None]
    dx2 = cfg.grid.dx**2
    if cfg.implicit:
        c = cfg.dt * nu / dx2
        m = torch.arange(cfg.N, dtype=u.dtype, device=u.device)
        eig = 1.0 + 2.0 * c - 2.0 * c * torch.cos(2.0 * np.pi * m / cfg.N)
        return torch.fft.ifft(torch.fft.fft(u, dim=-1) / eig, dim=-1).real
    d2udx2 = (torch.roll(u, 1, -1) - 2.0 * u + torch.roll(u, -1, -1)) / dx2
    return u + cfg.dt * nu * d2udx2


def action_step(cfg: DiffusionConfig, state: DiffusionState, a, error_mode: bool = False):
    """Stencil-action update from the per-point center weights ``a`` (..., N).

    Normal mode (Diffusion.py:176-206):  (M@u)_i = a_i*u_i - a_i/2*(u_{i-1}+u_{i+1}),
    then u += dt*nu*(M@u)/dx^2.  error_mode (DiffusionError.py:160-198):
    (M@u)_i = (-2+a_i)*u_i + (1-a_i/2)*(u_{i-1}+u_{i+1})."""
    u = state.u
    um, up = torch.roll(u, 1, -1), torch.roll(u, -1, -1)
    if error_mode:
        mu = (-2.0 + a) * u + (1.0 - a / 2.0) * (um + up)
        diag = -2.0 + a
    else:
        mu = a * u - a / 2.0 * (um + up)
        diag = a
    u_new = u + cfg.dt * state.nu[..., None] * mu / cfg.grid.dx**2
    return u_new, dict(gradient=mu, action_diag=diag)


def advance(cfg: DiffusionConfig, state: DiffusionState, u_new) -> DiffusionState:
    return dataclasses.replace(state, u=u_new, t=state.t + cfg.dt, ioutnum=state.ioutnum + 1)


def step(cfg: DiffusionConfig, state: DiffusionState, a=None,
         error_mode: bool = False) -> tuple[DiffusionState, dict]:
    if a is None:
        return advance(cfg, state, fd_step(cfg, state)), {}
    u_new, aux = action_step(cfg, state, a, error_mode)
    return advance(cfg, state, u_new), aux


def analytical_sinus(state: DiffusionState, cfg: DiffusionConfig, t=None):
    """u0*exp(-(2*pi/L)^2*nu*t)   (Diffusion.py:301-303)."""
    t = state.t if t is None else t
    decay = torch.exp(-((2.0 * np.pi / cfg.L) ** 2) * state.nu * t)
    return state.u0 * decay[..., None]


def simulate(cfg: DiffusionConfig, state: DiffusionState, nsteps: int):
    """Uncontrolled rollout; returns (final_state, uu) with the IC frame
    included, uu (nsteps + 1, ..., N)."""
    uu = [state.u]
    for _ in range(nsteps):
        state, _aux = step(cfg, state)
        uu.append(state.u)
    return state, torch.stack(uu)
