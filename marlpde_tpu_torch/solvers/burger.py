"""Burgers solver: configuration, state, initialisation and the pseudo-spectral
ABCN step (port of marlpde_tpu/solvers/burger.py:38-310).

Equation: u_t + u*u_x = nu*u_xx + F, periodic on [0, L).

Parity targets: the ABCN semi-implicit update (Burger.py:482-489) and the
action forcing, dforce / d2udx2-scaled / ssmforce (Burger.py:435-466).  Every
function works over any leading batch shape of the state, on torch.fft.  The
stochastic forcing, the ssm/dsm closures and the fd/rk3/cfd_rk3 schemes raise
until their slice (ROADMAP item 12).  The whole-batch env (envs/burger_fast.py)
does not come through here: it advances with the ABCN macro-step op.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from marlpde_tpu_torch import NOT_PORTED as _NOT_PORTED
from marlpde_tpu_torch.core import spectral
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
    filter_state_quirk: bool = False
    scheme: str = "abcn"        # 'abcn' | 'fd' | 'rk3' | 'cfd_rk3'
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
    k1 = torch.as_tensor(cfg.grid.k1, dtype=v0.dtype, device=device)
    nu = cfg.nu if nu is None else nu
    return BurgerState(
        u=u0,
        v=v0,
        fn_old=k1 * spectral.fft(0.5 * u0 * u0),    # Burger.py:320
        t=torch.zeros(batch, dtype=dtype, device=device),
        ioutnum=torch.zeros(batch, dtype=torch.int64, device=device),
        nu=torch.as_tensor(nu, dtype=dtype, device=device).expand(batch).clone(),
        offset=torch.as_tensor(offset, dtype=dtype, device=device).expand(batch).clone(),
        randfac1=torch.as_tensor(randfac1, dtype=dtype, device=device),
        randfac2=torch.as_tensor(randfac2, dtype=dtype, device=device),
    )


def linear_symbol(coeffs, k):
    """Altered-coefficients linear symbol (Burger.py:171-175 / KS.py:120-124):
    l = -c0 - c1*i*k + (1+c2)*k^2 + c3*i*k^3 - (1+c4)*k^4, complex128."""
    c = np.asarray(coeffs, np.float64)
    k = np.asarray(k, np.float64)
    return (-c[0] - c[1] * 1j * k + (1 + c[2]) * k**2
            + c[3] * 1j * k**3 - (1 + c[4]) * k**4)


def total_forcing_spectrum(cfg: BurgerConfig, state: BurgerState,
                           action_field: Optional[torch.Tensor]):
    """The RHS forcing spectrum of the action forcing (burger.py:167-204).
    Returns (F, aux) with aux = dict(sgs=..., forcing_phys=..., v_filtered=None)."""
    if cfg.forcing or cfg.ssm or cfg.dsm:
        raise NotImplementedError(f"[burger] stochastic forcing and the ssm/dsm "
                                  f"closures {_NOT_PORTED}")
    u, dx, N = state.u, cfg.grid.dx, cfg.N
    zero = torch.zeros_like(u)
    sgs = zero
    F = torch.zeros_like(state.v)
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
    return F, dict(sgs=sgs, forcing_phys=zero, v_filtered=None)


def step(cfg: BurgerConfig, state: BurgerState,
         action_field: Optional[torch.Tensor] = None) -> tuple[BurgerState, dict]:
    """One ABCN solver step: Adams-Bashforth(2) nonlinear, Crank-Nicolson
    viscous (Burger.py:482-489).  ``action_field`` is the (..., N) physical
    forcing field (actions @ basis, expanded in the env layer)."""
    if cfg.scheme != "abcn":
        raise NotImplementedError(f"[burger] scheme {cfg.scheme!r} {_NOT_PORTED}")
    F, aux = total_forcing_spectrum(cfg, state, action_field)
    v = state.v
    k1 = torch.as_tensor(cfg.grid.k1, dtype=v.dtype, device=v.device)
    if cfg.coeffs is None:
        k2 = torch.as_tensor(cfg.grid.k2, dtype=v.dtype, device=v.device)
        C = -0.5 * k2 * state.nu[..., None] * cfg.dt
    else:
        # altered linear symbol (Burger.py:171-175); see BurgerConfig.coeffs
        C = 0.5 * cfg.dt * torch.as_tensor(linear_symbol(cfg.coeffs, cfg.grid.k),
                                           dtype=v.dtype, device=v.device)
    Fn = k1 * spectral.fft(0.5 * state.u * state.u)
    v_new = ((1.0 - C) * v - 0.5 * cfg.dt * (3.0 * Fn - state.fn_old) + cfg.dt * F) / (1.0 + C)
    new_state = dataclasses.replace(
        state, u=spectral.irfft_real(v_new), v=v_new, fn_old=Fn,
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
