"""Burgers solver configuration, state and initialisation (port of
marlpde_tpu/solvers/burger.py:38-136).

Equation: u_t + u*u_x = nu*u_xx + F, periodic on [0, L).

Only what the flagship slice needs is ported: the whole-batch env
(envs/burger_fast.py) advances the state with the ABCN macro-step op, so the
per-step ``burger.step`` and ``simulate`` wait for a later slice (ROADMAP).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from marlpde_tpu_torch.core import spectral
from marlpde_tpu_torch.core.grids import Grid


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
