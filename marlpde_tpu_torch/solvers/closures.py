"""Smagorinsky subgrid-scale closures, static and dynamic, as pure field maps
(port of marlpde_tpu/solvers/closures.py).

Parity targets: Burger.step's ssm branch (Burger.py:337-352) and dsm branch
(Burger.py:354-408).  Both use the one-sided first derivative
dudx = (u - roll(u,1))/dx and the centered second derivative, with
delta = 2*pi/N (independent of L — reference quirk, replicated).

The reference's dsm branch filters IN PLACE through numpy aliases
(``vh = self.v; vh[hidx] = 0`` at Burger.py:369-370), which zeroes the solver
state's high modes every step as a side effect.  Here the arrays are not
aliased: ``dsm_forcing`` returns the filtered spectrum so the caller can opt
in to the reference's state truncation (``filter_state_quirk`` in the Burgers
config).
"""

from __future__ import annotations

import numpy as np
import torch

from marlpde_tpu_torch.core import spectral
from marlpde_tpu_torch.device import constant


def first_deriv_onesided(u, dx):
    """(u - roll(u,1))/dx — the reference's upwind-style dudx (Burger.py:345)."""
    return (u - torch.roll(u, 1, dims=-1)) / dx


def second_deriv(u, dx):
    """(roll(u,-1) - 2u + roll(u,1))/dx^2 (Burger.py:346)."""
    return (torch.roll(u, -1, dims=-1) - 2.0 * u + torch.roll(u, 1, dims=-1)) / (dx * dx)


def ssm_forcing(u, dx, N, cs=0.1):
    """Static Smagorinsky SGS term: (cs*delta)^2*|dudx|*d2udx2 (Burger.py:337-352)."""
    delta = 2.0 * np.pi / N
    nu_ssm = (cs * delta) ** 2 * torch.abs(first_deriv_onesided(u, dx))
    return nu_ssm * second_deriv(u, dx)


def _test_filter(k: tuple, N: int) -> np.ndarray:
    """The test filter's kept modes, |k| <= N//4."""
    return np.abs(np.asarray(k)) <= N // 4


def dsm_forcing(u, v, k, dx, N):
    """Dynamic Smagorinsky (Germano-style, the reference's 'alt' estimator).

    Returns (sgs_alt, v_filtered): the SGS field added to the RHS
    (Burger.py:392-399,408) and the sharp-filtered state spectrum the
    reference leaks into ``self.v`` via aliasing.  Test filter: zero modes
    with |k| > N//4, deltah = 2*delta.  ``csd2alt`` is a ratio of means; a
    constant field gives 0/0 = NaN, as in the reference, and the env's blowup
    detection ends such an episode."""
    delta = 2.0 * np.pi / N
    deltah = 4.0 * np.pi / N
    keep = constant(_test_filter, tuple(np.asarray(k).tolist()), N, device=u.device)

    def filt(z):
        return torch.where(keep, z, torch.zeros_like(z))

    L1 = 0.5 * spectral.irfft_real(filt(spectral.fft(u * u)))
    vh = filt(v)
    uh = spectral.irfft_real(vh)
    Lg = L1 - 0.5 * uh * uh                 # Germano identity residual

    dudx = first_deriv_onesided(u, dx)
    M1 = delta**2 * spectral.irfft_real(filt(spectral.fft(torch.abs(dudx) * dudx)))
    duhdx = first_deriv_onesided(uh, dx)
    M2 = deltah**2 * torch.abs(duhdx) * duhdx

    H = -Lg
    malt = 4.0 / deltah**2 * M2 - 1.0 / delta**2 * M1
    Malt = (malt - torch.roll(malt, 1, dims=-1)) / dx
    csd2alt = (torch.mean(H * Malt, dim=-1, keepdim=True)
               / torch.mean(Malt * Malt, dim=-1, keepdim=True))
    return csd2alt * torch.abs(dudx) * second_deriv(u, dx), vh
