"""Spectral utilities on ``torch.fft`` (port of marlpde_tpu/core/spectral.py:21-104).

Behavior-parity targets (reference file:line):
  * energy spectrum  Ek_kt = 0.5*Re(conj(v)*v)/N * dx       (Burger.py:562)
  * cumulative-mean spectrum Ek_ktt                          (Burger.py:555)
  * DNS->LES spectral restriction with g/N rescale           (burger_environment.py:110-112)
  * phase-shift offset  v * exp(1j*2*pi*offset*k)            (burger_environment.py:110)

The JAX package's DFT-as-matmul variants (``*_mm``, ops/dft.py) are not
ported: they exist only because the TPU backend had no FFT lowering.
All functions batch over leading axes; the transform axis is the last one.
"""

from __future__ import annotations

import numpy as np
import torch


def fft(u):
    return torch.fft.fft(u, dim=-1)


def irfft_real(v):
    """real(ifft(v)) without assuming conjugate symmetry (matches np.real(ifft(v)))."""
    return torch.fft.ifft(v, dim=-1).real


def energy_spectrum(v, dx):
    """Kinetic energy per wavenumber: 0.5*Re(conj(v)*v)/N * dx.   [Burger.py:562]"""
    N = v.shape[-1]
    return 0.5 * (torch.conj(v) * v).real / N * dx


def cumulative_mean(a, axis=0):
    """Time-cumulative average along `axis`: out[t] = mean(a[:t+1]).  [Burger.py:555]"""
    n = a.shape[axis]
    counts_shape = [1] * a.ndim
    counts_shape[axis] = n
    counts = torch.arange(1, n + 1, dtype=a.dtype, device=a.device).reshape(counts_shape)
    return torch.cumsum(a, dim=axis) / counts


def restrict_modes(v, g):
    """Spectral DNS->LES restriction: keep the g lowest modes, rescale by g/N.

    v0 = concat(v[:(g+1)//2], v[-(g-1)//2:]) * g/N    [burger_environment.py:111]
    (the tail slice has g//2 elements, so lo + hi == g).
    """
    N = v.shape[-1]
    lo = (g + 1) // 2
    hi = g // 2
    out = torch.cat([v[..., :lo], v[..., N - hi:]], dim=-1)
    return out * (g / N)


def phase_shift(v, offset, k):
    """Apply the reference's random-offset phase shift: v*exp(1j*2*pi*offset*k).

    [burger_environment.py:110].  NB the reference multiplies by 2*pi even
    though k is already in radians-per-length; replicated verbatim.
    ``offset`` broadcasts against ``k`` (pass (B, 1) for a batch).
    """
    return v * torch.exp(1j * (2.0 * np.pi * offset * k))
