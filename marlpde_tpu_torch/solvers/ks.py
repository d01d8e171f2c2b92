"""Kuramoto-Sivashinsky solver: Fourier spectral + ETDRK4 (Kassam-Trefethen)
(port of marlpde_tpu/solvers/ks.py:39-204).

Equation: u_t + u_xx + u_xxxx + 0.5*(u^2)_x = 0, periodic on [0, L).

Parity targets:
  * linear symbol l = k^2 - k^4 (+ 'coeffs' override)     KS.py:112-124
  * ETDRK4 contour-integral coefficients (MM=62 roots)    KS.py:127-137
  * step with action forcing entering all phi-terms       KS.py:230-267

The state is the rfft half-spectrum, as in the JAX package: KS has a linearly
unstable band (0 < |k| < 1), so any anti-Hermitian roundoff of a full complex
spectrum grows unchecked and a full-spectrum solver blows up near step 1600.
``full_spectrum`` rebuilds the reference's full layout for diagnostics.

The wavenumber of the Nyquist bin is the negative fftfreq value, so the
nonlinear term gives the state a purely imaginary part in bins 0 and N/2
(where rfft(u*u) is real); the state keeps it, as JAX's does.  A C2R inverse
reads a Hermitian spectrum: pocketfft (numpy, torch on the CPU) ignores the
imaginary parts of those two bins and cuFFT does not promise to, so
``irfft`` zeroes them in the tensor it transforms, never in the state.

Every function works over any leading batch shape of the state.  The phi
coefficients depend on (N, L, dt, coeffs) only: they are computed once per
config in float64 numpy and cast once per (config, dtype, device).
"""

from __future__ import annotations

import dataclasses
from functools import lru_cache
from typing import Optional

import numpy as np
import torch

from marlpde_tpu_torch.core.grids import Grid


@dataclasses.dataclass(frozen=True, eq=True)
class KSConfig:
    """Fields as in the JAX package, without its ``fft_impl`` (a TPU
    workaround: the port transforms with torch.fft)."""

    N: int
    L: float = 22.0
    dt: float = 0.25
    dforce: bool = True
    coeffs: Optional[tuple] = None   # 5-tuple altering the linear symbol (KS.py:120-124)

    @property
    def grid(self) -> Grid:
        return Grid(self.N, self.L)


@dataclasses.dataclass
class KSState:
    u: torch.Tensor        # (..., N) physical field
    rv: torch.Tensor       # (..., N//2+1) complex rfft half-spectrum
    t: torch.Tensor        # (...,) time
    ioutnum: torch.Tensor  # (...,) int64 step counter


@lru_cache(maxsize=None)       # unbounded: a CUDA graph reads these by address
def _hermitian_mask(N: int, dtype: torch.dtype, device: torch.device):
    """(N//2+1, 2) ones, with 0 on the imaginary parts of bins 0 and N/2."""
    m = torch.ones(N // 2 + 1, 2, dtype=dtype)
    m[0, 1] = 0.0
    if N % 2 == 0:
        m[N // 2, 1] = 0.0
    return m.to(device)


def irfft(rv, N: int):
    """Real field of the half-spectrum ``rv``: irfft with the imaginary parts
    of bins 0 and N/2 taken as zero (what pocketfft does; cuFFT's C2R is told
    so explicitly).  One elementwise product on the real view."""
    re = torch.view_as_real(rv)
    z = torch.view_as_complex(re * _hermitian_mask(N, re.dtype, rv.device))
    return torch.fft.irfft(z, N, dim=-1)


def full_spectrum(rv, N: int):
    """Rebuild the reference's full fft layout from the rfft half-spectrum."""
    tail = torch.flip(torch.conj(rv[..., 1:N - N // 2]), dims=(-1,))
    return torch.cat([rv, tail], dim=-1)


def half_spectrum(v, N: int):
    return v[..., :N // 2 + 1]


@lru_cache(maxsize=16)
def etdrk4_coeffs(cfg: KSConfig):
    """E, E2, Q, f1, f2, f3, g on the half-spectrum — float64 numpy, per
    KS.py:127-137 (copied from the JAX package).

    The Nyquist entry keeps the reference's *negative* fftfreq value inside
    g = -0.5j*k (KS.py:137); even powers in l are sign-independent.
    """
    g = cfg.grid
    half = cfg.N // 2 + 1
    k = g.k[:half]                 # note: k[N//2] is negative, as in the reference
    if cfg.coeffs is None:
        l = k**2 - k**4
    else:
        c = cfg.coeffs
        l = (-c[0] * np.ones_like(k) - c[1] * 1j * k + (1 + c[2]) * k**2
             + c[3] * 1j * k**3 - (1 + c[4]) * k**4)
    dt = cfg.dt
    E = np.exp(dt * l)
    E2 = np.exp(dt * l / 2.0)
    MM = 62
    r = np.exp(1j * np.pi * (np.r_[1:MM + 1] - 0.5) / MM)
    LR = dt * np.repeat(np.asarray(l)[:, None], MM, axis=1) + np.repeat(r[None, :], half, axis=0)
    Q = dt * np.real(np.mean((np.exp(LR / 2.0) - 1.0) / LR, 1))
    f1 = dt * np.real(np.mean((-4.0 - LR + np.exp(LR) * (4.0 - 3.0 * LR + LR**2)) / LR**3, 1))
    f2 = dt * np.real(np.mean((2.0 + LR + np.exp(LR) * (-2.0 + LR)) / LR**3, 1))
    f3 = dt * np.real(np.mean((-4.0 - 3.0 * LR - LR**2 + np.exp(LR) * (4.0 - LR)) / LR**3, 1))
    gk = -0.5j * k
    return E, E2, Q, f1, f2, f3, gk


@lru_cache(maxsize=None)       # unbounded: a CUDA graph reads these by address
def _coeff_tensors(cfg: KSConfig, rdtype: torch.dtype, cdtype: torch.dtype,
                   device: torch.device):
    """``etdrk4_coeffs`` on ``device``, cast as JAX casts them (ks.py:142-147):
    E, E2 and g to the complex dtype, Q and f1-f3 to the real one."""
    E, E2, Q, f1, f2, f3, gk = etdrk4_coeffs(cfg)
    cx = lambda a: torch.as_tensor(np.asarray(a, np.complex128)).to(device=device, dtype=cdtype)
    re = lambda a: torch.as_tensor(np.asarray(a, np.float64)).to(device=device, dtype=rdtype)
    return cx(E), cx(E2), re(Q), re(f1), re(f2), re(f3), cx(gk)


def init(cfg: KSConfig, u0=None, v0=None) -> KSState:
    """v0 may be a full spectrum (reference layout) or an rfft half-spectrum."""
    if v0 is None:
        rv = torch.fft.rfft(u0, dim=-1)
    else:
        rv = half_spectrum(v0, cfg.N) if v0.shape[-1] == cfg.N else v0
        u0 = irfft(rv, cfg.N)
    batch = u0.shape[:-1]
    return KSState(u=u0, rv=rv, t=torch.zeros(batch, dtype=u0.dtype, device=u0.device),
                   ioutnum=torch.zeros(batch, dtype=torch.int64, device=u0.device))


def step(cfg: KSConfig, state: KSState, action_field=None) -> tuple[KSState, dict]:
    """One ETDRK4 step (KS.py:230-267).

    ``action_field``: (..., N) physical forcing (actions @ basis).  With
    dforce=False it is scaled by d2udx2 first (KS.py:240-245).
    """
    E, E2, Q, f1, f2, f3, gk = _coeff_tensors(cfg, state.u.dtype, state.rv.dtype,
                                              state.u.device)
    N = cfg.N
    aux = {}
    F = None
    if action_field is not None:
        af = action_field
        if not cfg.dforce:
            u = state.u
            d2udx2 = (torch.roll(u, 1, -1) - 2.0 * u + torch.roll(u, -1, -1)) / cfg.grid.dx**2
            af = af * d2udx2
        aux["sgs"] = af
        F = torch.fft.rfft(af, dim=-1)

    def nl(z):
        uz = irfft(z, N)
        return gk * torch.fft.rfft(uz * uz, dim=-1)

    v = state.rv
    Nv = nl(v)
    a = E2 * v + Q * Nv
    Na = nl(a)
    b = E2 * v + Q * Na
    Nb = nl(b)
    c = E2 * a + Q * (2.0 * Nb - Nv)
    Nc = nl(c)

    if F is not None:
        v_new = E * v + (Nv + F) * f1 + 2.0 * (Na + Nb + 2.0 * F) * f2 + (Nc + F) * f3
    else:
        v_new = E * v + Nv * f1 + 2.0 * (Na + Nb) * f2 + Nc * f3

    return KSState(u=irfft(v_new, N), rv=v_new, t=state.t + cfg.dt,
                   ioutnum=state.ioutnum + 1), aux


def simulate(cfg: KSConfig, state: KSState, nsteps: int, action_fields=None,
             correction=None):
    """Advance ``nsteps`` steps; returns (final_state, uu, vv_full), the
    trajectories (nsteps+1, ..., N) including the initial frame, vv_full in
    the reference's full-spectrum layout.  ``action_fields``: (nsteps, ..., N)."""
    s = state
    uu, rvv = [s.u], [s.rv]
    if correction is not None:
        correction = half_spectrum(torch.as_tensor(correction).to(
            device=s.rv.device, dtype=s.rv.dtype), cfg.N)
    for i in range(nsteps):
        s, _ = step(cfg, s, None if action_fields is None else action_fields[i])
        if correction is not None:
            rv = s.rv + correction
            s = dataclasses.replace(s, rv=rv, u=irfft(rv, cfg.N))
        uu.append(s.u)
        rvv.append(s.rv)
    return s, torch.stack(uu), full_spectrum(torch.stack(rvv), cfg.N)
