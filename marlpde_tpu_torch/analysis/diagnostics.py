"""Physics diagnostics: energy spectra, SGS-term extraction, error curves
(port of marlpde_tpu/analysis/diagnostics.py:21-116).

Parity targets:
  * compute_Ek family (Ek_kt/Ek_k/Ek_t/Ek_ktt/Ek_tt)          Burger.py:541-576
  * a-priori SGS extraction, 3 filter variants                 Burger.py:677-736
  * KS SGS extraction                                          KS.py:385-409
  * solver error curves (mse/linf/mass vs t) in the schema of
    diffusion_errors/error_*.json                              plotErrors.py:40-48

The spectral functions take torch tensors on any device, the frames on the
second-to-last axis and space on the last; every axis before them is a batch
axis (the JAX functions take one (T+1, N) trajectory).  The error-curve
helpers are numpy, copied.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from marlpde_tpu_torch.core import spectral


def compute_ek(vv, dx):
    """All energy forms from a spectrum trajectory vv (..., T+1, N)
    (Burger.py:541-576).  Returns dict(Ek_kt, Ek_k, Ek_t, Ek_ktt, Ek_tt)."""
    n_frames = vv.shape[-2]
    ek_kt = spectral.energy_spectrum(vv, dx)
    ek_k = ek_kt.sum(-2) / n_frames
    ek_t = ek_kt.sum(-1)
    ek_ktt = spectral.cumulative_mean(ek_kt, axis=-2)
    ek_tt = torch.cumsum(ek_t, -1) / torch.arange(1, n_frames + 1, dtype=ek_t.dtype,
                                                  device=ek_t.device)
    return dict(Ek_kt=ek_kt, Ek_k=ek_k, Ek_t=ek_t, Ek_ktt=ek_ktt, Ek_tt=ek_tt)


def _keep(k, n_urg, device):
    return torch.as_tensor(np.abs(np.asarray(k)) <= n_urg // 2, device=device)


def compute_sgs_burger(uu, k, dx, dt, nu, n_urg):
    """A-priori SGS terms from stored trajectories uu (..., T+1, N)
    (Burger.py:677-736), all frames at once.  ``nu`` is a number or a tensor
    of the batch shape.  Returns dict(sgs, sgs_alt, sgs_alt2):
      sgs     = -uh*duhdx + 0.5*du2hdx                (filtered advective form)
      sgs_alt = duhdt + uh*duhdx - nu*d2uhdx2         (residual form, same grid)
      sgs_alt2= the same residual on the restricted (n_urg) grid
    """
    N = uu.shape[-1]
    keep = _keep(k, n_urg, uu.device)
    r = n_urg / N
    nu = torch.as_tensor(nu, dtype=uu.dtype, device=uu.device)[..., None, None]

    vv = spectral.fft(uu)
    vv2 = spectral.fft(uu * uu)
    uh = spectral.irfft_real(vv * keep)
    u2h = spectral.irfft_real(vv2 * keep)

    # restricted-grid variant (Burger.py:695,710): bare mode slices, then *r
    uh_alt2 = spectral.irfft_real(
        torch.cat([vv[..., :(n_urg + 1) // 2], vv[..., N - n_urg // 2:]], dim=-1)) * r

    def ddt(a):
        # forward difference, the last frame backward*(-1) (Burger.py:686,714-716)
        d = (torch.roll(a, -1, -2) - a) / dt
        d[..., -1, :] = (a[..., -2, :] - a[..., -1, :]) / dt * -1.0
        return d

    def d1(a, h):
        return (a - torch.roll(a, 1, -1)) / h

    def d2(a, h):
        return (torch.roll(a, -1, -1) - 2 * a + torch.roll(a, 1, -1)) / h**2

    duhdx = d1(uh, dx)
    sgs = -uh * duhdx + 0.5 * d1(u2h, dx)
    sgs_alt = ddt(uh) + uh * duhdx - nu * d2(uh, dx)
    sgs_alt2 = (ddt(uh_alt2) + uh_alt2 * d1(uh_alt2, dx) * r
                - nu * d2(uh_alt2, dx) * r * r)
    return dict(sgs=sgs, sgs_alt=sgs_alt, sgs_alt2=sgs_alt2)


def compute_sgs_ks(uu, k, dx, n_urg):
    """KS a-priori SGS: -uh*duhdx + 0.5*du2hdx (KS.py:385-409), uu (..., N)."""
    keep = _keep(k, n_urg, uu.device)
    uh = spectral.irfft_real(spectral.fft(uu) * keep)
    u2h = spectral.irfft_real(spectral.fft(uu * uu) * keep)
    duhdx = (uh - torch.roll(uh, 1, -1)) / dx
    du2hdx = (u2h - torch.roll(u2h, 1, -1)) / dx
    return -uh * duhdx + 0.5 * du2hdx


def sgs_correlation(sgs_true, sgs_model):
    """Pearson correlation of SGS terms (other/correlation.py:16): scalar in [-1,1]."""
    a = np.asarray(sgs_true).ravel()
    b = np.asarray(sgs_model).ravel()
    return float(np.corrcoef(a, b)[0, 1])


def error_curves(uu, solution, tt):
    """mse/linf/mass curves in the error_*.json schema
    (diffusion_errors/plotErrors.py:40-48)."""
    uu = np.asarray(uu)
    sol = np.asarray(solution)
    return dict(
        t=np.asarray(tt).tolist(),
        mse=np.mean((uu - sol) ** 2, axis=1).tolist(),
        linf=np.amax(np.abs(uu - sol), axis=1).tolist(),
        mass=np.sum(uu, axis=1).tolist())


def write_error_json(path: str, curves: dict):
    with open(path, "w") as f:
        json.dump(curves, f)


def load_reference_error_json(path: str) -> dict:
    """An error_*.json of the reference (diffusion_errors/) or of
    ``write_error_json``."""
    with open(path) as f:
        return json.load(f)
