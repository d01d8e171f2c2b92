"""Uniform periodic 1D grids and their Fourier wavenumbers.

Copied from marlpde_tpu/core/grids.py (numpy only; the port may not import the
JAX package).

Conventions match the reference solvers (Burger.py:161-163):
  x  = linspace(0, L, N, endpoint=False)
  k  = fftfreq(N, L / (2*pi*N))        # radians-per-length wavenumbers
  k1 = 1j*k,  k2 = k1**2 = -k**2
"""

from __future__ import annotations

import dataclasses
from functools import cached_property

import numpy as np


@dataclasses.dataclass(frozen=True)
class Grid:
    """Static description of a uniform periodic grid on [0, L)."""

    N: int
    L: float = 2.0 * np.pi

    @property
    def dx(self) -> float:
        return self.L / self.N

    @cached_property
    def x(self) -> np.ndarray:
        return np.linspace(0.0, self.L, self.N, endpoint=False)

    @cached_property
    def k(self) -> np.ndarray:
        """Wavenumbers, identical to scipy.fftpack.fftfreq(N, L/(2*pi*N))."""
        return np.fft.fftfreq(self.N, self.L / (2.0 * np.pi * self.N))

    @cached_property
    def k1(self) -> np.ndarray:
        return 1j * self.k

    @cached_property
    def k2(self) -> np.ndarray:
        return self.k1**2

    def __hash__(self):
        return hash((self.N, self.L))

    def __eq__(self, other):
        return isinstance(other, Grid) and self.N == other.N and self.L == other.L
