"""Viscous/stochastic Burgers solvers: pseudo-spectral ABCN, explicit FD,
spectral RK3 and compact-FD SSP-RK3 as batched step functions (port of
marlpde_tpu/solvers/burger.py).

Equation: u_t + u*u_x = nu*u_xx + F, periodic on [0, L).

Parity targets:
  * ABCN semi-implicit update                       Burger.py:482-489
  * stochastic 3-mode cosine forcing                Burger.py:410-421
    (incl. the reference's ``ridx = ioutnum % s`` table indexing quirk)
  * action forcing: dforce / d2udx2-scaled / ssmforce   Burger.py:435-466
  * ssm / dsm closures                              Burger.py:337-408 (closures.py)
  * explicit-FD variant                             Burger_fd.py:460-468
  * spectral RK3 variant                            Burger_jax.py:42-64
  * compact-FD SSP-RK3 variant                      Burger_rk.py:236-279

Every function works over any leading batch shape of the state, on
torch.fft; ``simulate`` is a Python loop over ``step``.  The whole-batch env
(envs/burger_fast.py) does not come through here: it advances with the ABCN
macro-step op.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from marlpde_tpu_torch.core import spectral
from marlpde_tpu_torch.device import constant, grid_array
from marlpde_tpu_torch.core.grids import Grid
from marlpde_tpu_torch.solvers import closures


@dataclasses.dataclass(frozen=True, eq=True)
class BurgerConfig:
    """Static Burgers solver configuration; fields as in the JAX package so
    configs carry over."""

    N: int
    L: float = 2.0 * np.pi
    dt: float = 0.001
    nu: float = 0.02            # default; the live value sits in the state (nunoise)
    stepper: int = 1            # LES time-scale ratio 's' (Burger.py:59)
    forcing: bool = False       # stochastic low-wavenumber forcing
    ssm: bool = False
    dsm: bool = False
    dforce: bool = True         # False: actions scale d2udx2 (Burger.py:445-450)
    ssmforce: bool = False      # actions act as a Smagorinsky constant field (Burger.py:452-463)
    cs: float = 0.1             # static Smagorinsky constant
    filter_state_quirk: bool = False  # replicate Burger.py:369-370 aliasing (see closures.py)
    scheme: str = "abcn"        # 'abcn' | 'fd' | 'rk3' | 'cfd_rk3'
    # Altered-coefficients linear symbol (Burger.py:160-175): the ABCN
    # Crank-Nicolson factor becomes C = 0.5*dt*l with the complex symbol.
    coeffs: Optional[tuple] = None
    # Kept for config compatibility; the port always transforms with torch.fft.
    fft_impl: str = "fft"

    def __post_init__(self):
        assert not (self.ssm and self.dsm)
        if self.ssmforce:
            assert self.dforce, "[burger] SSM forcing requires dforce (Burger.py:113-115)"

    @property
    def grid(self) -> Grid:
        return Grid(self.N, self.L)


@dataclasses.dataclass
class BurgerState:
    u: torch.Tensor              # (..., N) physical field
    v: torch.Tensor              # (..., N) complex spectrum
    fn_old: torch.Tensor         # (..., N) complex, ABCN nonlinear-term memory
    t: torch.Tensor              # (...,) time
    ioutnum: torch.Tensor        # (...,) int64 step counter
    nu: torch.Tensor             # (...,) viscosity
    offset: torch.Tensor         # (...,) random IC phase offset
    randfac1: torch.Tensor       # (..., 4, s) stochastic-forcing scales
    randfac2: torch.Tensor       # (..., 4, s) stochastic-forcing phases


def draw_forcing_tables(generator, stepper: int, dtype, batch=(), device=None):
    """Per-episode forcing tables (..., 4, s) of standard normals.

    The reference draws (32, nsteps) normals (Burger.py:94-95) but only rows
    k=1..3 and columns ``ioutnum % s`` are ever read (Burger.py:416-418), so
    just the (4, s) used slice is drawn, for each of ``batch``."""
    shape = tuple(batch) + (4, stepper)
    return (torch.randn(shape, generator=generator, dtype=dtype, device=device),
            torch.randn(shape, generator=generator, dtype=dtype, device=device))


def _per_env(x, batch, dtype, device):
    """A tensor or a number as a (batch...) tensor; a number is filled on the
    device, not copied from the host (a CUDA graph captures the fill)."""
    x = (torch.as_tensor(x, dtype=dtype, device=device) if isinstance(x, torch.Tensor)
         else torch.full((), x, dtype=dtype, device=device))
    return x.expand(batch).clone()


def init(cfg: BurgerConfig, u0=None, v0=None, *, nu=None, offset=0.0,
         randfac1=None, randfac2=None) -> BurgerState:
    """Build a solver state from a physical or spectral IC (Burger.py:205-320)."""
    if v0 is None:
        assert u0 is not None
        v0 = spectral.fft(u0)
    else:
        u0 = spectral.irfft_real(v0)
    dtype, device = u0.dtype, u0.device
    batch = u0.shape[:-1]
    if randfac1 is None:
        randfac1 = torch.zeros(batch + (4, cfg.stepper), dtype=dtype, device=device)
        randfac2 = torch.zeros(batch + (4, cfg.stepper), dtype=dtype, device=device)
    k1 = grid_array(cfg.grid, "k1", v0.dtype, device)
    nu = cfg.nu if nu is None else nu
    return BurgerState(
        u=u0,
        v=v0,
        fn_old=k1 * spectral.fft(0.5 * u0 * u0),    # Burger.py:320
        t=torch.zeros(batch, dtype=dtype, device=device),
        ioutnum=torch.zeros(batch, dtype=torch.int64, device=device),
        nu=_per_env(nu, batch, dtype, device),
        offset=_per_env(offset, batch, dtype, device),
        randfac1=torch.as_tensor(randfac1, dtype=dtype, device=device),
        randfac2=torch.as_tensor(randfac2, dtype=dtype, device=device),
    )


def stochastic_forcing(cfg: BurgerConfig, state: BurgerState):
    """3-mode cosine forcing with pre-drawn tables (Burger.py:410-421).

    forcing = sum_{k=1..3} r1[k,ridx]*A/sqrt(k*s*dt)*cos(2*pi*k*(x+offset)/L + 2*pi*r2[k,ridx]),
    A = sqrt(2)/L, ridx = ioutnum % s."""
    u = state.u
    x = grid_array(cfg.grid, "x", u.dtype, u.device)
    A = np.sqrt(2.0) / cfg.L
    ridx = (state.ioutnum % cfg.stepper)[..., None, None]
    ks = torch.arange(1, 4, dtype=u.dtype, device=u.device)
    r1 = torch.take_along_dim(state.randfac1, ridx, dim=-1)[..., 1:4, 0]
    r2 = torch.take_along_dim(state.randfac2, ridx, dim=-1)[..., 1:4, 0]
    amp = r1 * A / torch.sqrt(ks * cfg.stepper * cfg.dt)          # (..., 3)
    phase = ((2.0 * np.pi * ks[:, None]) * (x + state.offset[..., None])[..., None, :] / cfg.L
             + 2.0 * np.pi * r2[..., None])
    return torch.sum(amp[..., None] * torch.cos(phase), dim=-2)


def linear_symbol(coeffs, k):
    """Altered-coefficients linear symbol (Burger.py:171-175 / KS.py:120-124):
    l = -c0 - c1*i*k + (1+c2)*k^2 + c3*i*k^3 - (1+c4)*k^4, complex128."""
    c = np.asarray(coeffs, np.float64)
    k = np.asarray(k, np.float64)
    return (-c[0] - c[1] * 1j * k + (1 + c[2]) * k**2
            + c[3] * 1j * k**3 - (1 + c[4]) * k**4)


def _grid_symbol(coeffs, grid):
    return linear_symbol(coeffs, grid.k)


def total_forcing_spectrum(cfg: BurgerConfig, state: BurgerState,
                           action_field: Optional[torch.Tensor]):
    """Assemble the RHS forcing spectrum, replicating the reference's precedence:
    stochastic forcing *overwrites* ssm/dsm (Burger.py:421), actions add on top.

    Returns (F, aux) with aux = dict(sgs=..., forcing_phys=..., v_filtered=...)."""
    u, dx, N = state.u, cfg.grid.dx, cfg.N
    zero = torch.zeros_like(u)
    sgs = zero
    v_filtered = None
    F = torch.zeros_like(state.v)
    if cfg.ssm:
        sgs = closures.ssm_forcing(u, dx, N, cfg.cs)
        F = F + spectral.fft(sgs)
    if cfg.dsm:
        sgs, v_filtered = closures.dsm_forcing(u, state.v, cfg.grid.k, dx, N)
        F = F + spectral.fft(sgs)
    forcing_phys = zero
    if cfg.forcing:
        forcing_phys = stochastic_forcing(cfg, state)
        F = spectral.fft(forcing_phys)          # overwrites ssm/dsm (Burger.py:421)
    if action_field is not None:
        af = action_field
        if not cfg.dforce:
            af = af * closures.second_deriv(u, dx)              # Burger.py:445-450
        if cfg.ssmforce:
            delta = 2.0 * np.pi / N
            dudx = closures.first_deriv_onesided(u, dx)
            nu_ssm = (af * delta) ** 2 * torch.abs(dudx)
            af = nu_ssm * closures.second_deriv(u, dx)          # Burger.py:452-463
        sgs = af
        F = F + spectral.fft(af)
    return F, dict(sgs=sgs, forcing_phys=forcing_phys, v_filtered=v_filtered)


def _cfd_op(u, nu, dx):
    """Compact-weighted FD right-hand side, a 4th/6th order mix (Burger_rk.py:236-279)."""
    up1, up2 = torch.roll(u, -1, -1), torch.roll(u, -2, -1)
    um1, um2 = torch.roll(u, 1, -1), torch.roll(u, 2, -1)
    dudu = 3.0 / 5.0 * (14.0 / 9.0 * (up1 - um1) * 0.5 / dx
                        + 1.0 / 9.0 * (up2 - um2) * 0.25 / dx)
    d2udu2 = 11.0 / 15.0 * (12.0 / 11.0 * (up1 - 2 * u + um1) / dx**2
                            + 3.0 / 11.0 * (up2 - 2 * u + um2) / (4 * dx**2))
    return nu * d2udu2 - u * dudu


def rk3_stages(cfg: BurgerConfig, u, v, F, nu):
    """Spectral SSP-RK3 (Burger_jax.py:42-64) from (u, v) with the forcing
    spectrum ``F`` constant over the three stages; returns (u', v')."""
    k1 = grid_array(cfg.grid, "k1", v.dtype, v.device)
    k2 = grid_array(cfg.grid, "k2", v.dtype, v.device)

    def rhs(u_, v_):
        return -0.5 * k1 * spectral.fft(u_ * u_) + nu * k2 * v_ + F

    v1 = v + cfg.dt * rhs(u, v)
    u1 = spectral.irfft_real(v1)
    v2 = 0.75 * v + 0.25 * v1 + 0.25 * cfg.dt * rhs(u1, v1)
    u2 = spectral.irfft_real(v2)
    v3 = v / 3.0 + 2.0 / 3.0 * v2 + 2.0 / 3.0 * cfg.dt * rhs(u2, v2)
    return spectral.irfft_real(v3), v3


def step(cfg: BurgerConfig, state: BurgerState,
         action_field: Optional[torch.Tensor] = None) -> tuple[BurgerState, dict]:
    """One solver step of ``cfg.scheme``.  ``action_field`` is the (..., N)
    physical forcing field (actions @ basis, expanded in the env layer)."""
    F, aux = total_forcing_spectrum(cfg, state, action_field)
    v = state.v
    if cfg.filter_state_quirk and aux["v_filtered"] is not None:
        v = aux["v_filtered"]
    nu = state.nu[..., None]
    fn_new = state.fn_old
    if cfg.scheme == "abcn":
        # Adams-Bashforth(2) nonlinear / Crank-Nicolson viscous (Burger.py:482-489)
        k1 = grid_array(cfg.grid, "k1", v.dtype, v.device)
        if cfg.coeffs is None:
            k2 = grid_array(cfg.grid, "k2", v.dtype, v.device)
            C = -0.5 * k2 * nu * cfg.dt
        else:
            # altered linear symbol (Burger.py:171-175); see BurgerConfig.coeffs
            C = 0.5 * cfg.dt * constant(_grid_symbol, cfg.coeffs, cfg.grid,
                                        dtype=v.dtype, device=v.device)
        fn_new = k1 * spectral.fft(0.5 * state.u * state.u)
        v_new = ((1.0 - C) * v - 0.5 * cfg.dt * (3.0 * fn_new - state.fn_old)
                 + cfg.dt * F) / (1.0 + C)
        u_new = spectral.irfft_real(v_new)
    elif cfg.scheme == "fd":
        # Explicit Euler + one-sided/centered FD (Burger_fd.py:460-468)
        dx = cfg.grid.dx
        forcing_phys = spectral.irfft_real(F)
        dudx = closures.first_deriv_onesided(state.u, dx)
        d2udx2 = closures.second_deriv(state.u, dx)
        u_new = state.u + cfg.dt * (nu * d2udx2 - state.u * dudx + forcing_phys)
        v_new = spectral.fft(u_new)
    elif cfg.scheme == "rk3":
        u_new, v_new = rk3_stages(cfg, state.u, v, F, nu)
    elif cfg.scheme == "cfd_rk3":
        # Compact-weighted FD + SSP-RK3 (Burger_rk.py:236-279); no forcing
        dx = cfg.grid.dx
        u0 = state.u
        u1 = u0 + cfg.dt * _cfd_op(u0, nu, dx)
        u2 = 0.75 * u0 + 0.25 * u1 + 0.25 * cfg.dt * _cfd_op(u1, nu, dx)
        u_new = u0 / 3.0 + 2.0 / 3.0 * u2 + 2.0 / 3.0 * cfg.dt * _cfd_op(u2, nu, dx)
        v_new = spectral.fft(u_new)
    else:
        raise ValueError(f"[burger] unknown scheme {cfg.scheme}")
    new_state = dataclasses.replace(
        state, u=u_new, v=v_new, fn_old=fn_new,
        t=state.t + cfg.dt, ioutnum=state.ioutnum + 1)
    return new_state, aux


def simulate(cfg: BurgerConfig, state: BurgerState, nsteps: int, action_fields=None,
             correction=None):
    """Advance nsteps (Burger.py:501-530), returning (final_state, uu, vv) with
    a leading time axis of nsteps+1 including the IC frame.  ``action_fields``:
    optional (nsteps, ..., N) per-step forcing fields; ``correction``: optional
    (..., N) spectral correction added after each step (Burger.py:528-530)."""
    uu, vv = [state.u], [state.v]
    for n in range(nsteps):
        state, _ = step(cfg, state, None if action_fields is None else action_fields[n])
        if correction is not None:
            v = state.v + correction
            state = dataclasses.replace(state, v=v, u=spectral.irfft_real(v))
        uu.append(state.u)
        vv.append(state.v)
    return state, torch.stack(uu), torch.stack(vv)
