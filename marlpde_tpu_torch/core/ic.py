"""Initial conditions and source terms (port of marlpde_tpu/core/ic.py:24-202).

Parity targets:
  * 'sinus'      sin(4*pi*(x+offset)/L)                    (Burger.py:224)
  * 'turbulence' LCG-phase k^-5/3 spectrum + RMS rescale   (Burger.py:227-259)
  * 'forced'     seeded-normal low-amplitude random field  (Burger.py:265-273)
  * the diffusion/advection box, sinus and gaussian ICs (Diffusion.py:102-112)
  * the Laplace ICs and source terms (Laplace.py:50-96)

The turbulence IC's LCG (a=1103515245, c=12345, m=2^13) is evaluated in closed
form (a^k and c*sum a^j precomputed mod m), so a whole batch of envs builds its
ICs with one elementwise pass and one matmul on the device
(``burger_turbulence``); the host float64 versions serve the DNS pool build.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

LCG_A = 1103515245
LCG_C = 12345
LCG_M = 2**13


@lru_cache(maxsize=32)
def _lcg_closed_form(nk: int):
    """Precompute (a^k mod m, c*sum_{j<k} a^j mod m) for k = 1..nk as numpy arrays."""
    ak = np.zeros(nk, dtype=np.int64)
    ck = np.zeros(nk, dtype=np.int64)
    # state after (i+1) LCG applications: rng_{i+1} = a^{i+1}*rng0 + c*(a^i + ... + 1)
    a_pow, c_sum = 1, 0
    for i in range(nk):
        a_pow = (a_pow * LCG_A) % LCG_M
        c_sum = (c_sum * LCG_A + LCG_C) % LCG_M
        ak[i] = a_pow
        ck[i] = c_sum
    return ak, ck


def burger_turbulence_numpy(tseed, offset, x, L):
    """Host float64 version of the turbulence IC (bit-parity with the LCG loop)."""
    x = np.asarray(x, np.float64)
    N = x.shape[-1]
    rng = 123456789 + int(tseed)
    u0 = np.ones(N)
    for k in range(1, N):
        rng = (LCG_A * rng + LCG_C) % LCG_M
        phase = rng / LCG_M * 2.0 * np.pi
        Ek = 5.0 ** (-5.0 / 3.0) if k <= 5 else k ** (-5.0 / 3.0)
        u0 += np.sqrt(2 * Ek) * np.sin(k * 2 * np.pi * (x + offset) / L + phase)
    idx = 0
    criterion = np.sqrt(np.sum((u0 - 1.0) ** 2) / N)
    while criterion < 0.65 or criterion > 0.75:
        u0 *= 0.7 / criterion
        criterion = np.sqrt(np.sum((u0 - 1.0) ** 2) / N)
        idx += 1
        if idx > 100:
            break
    return u0


def turbulence_phases(tseeds, N: int, dtype, device=None):
    """Phases of the turbulence IC for wavenumbers k=1..N-1, one row per seed:
    rng_0 = 123456789 + tseed; rng_k = (a*rng_{k-1} + c) mod m;
    phase_k = rng_k/m * 2*pi.  tseeds: (B,) ints.  Returns (B, N-1)."""
    ak, ck = _lcg_closed_form(N - 1)
    rng0 = torch.remainder(123456789 + torch.as_tensor(tseeds, dtype=torch.int64,
                                                       device=device), LCG_M)
    rng_k = torch.remainder(torch.as_tensor(ak, device=device) * rng0[:, None]
                            + torch.as_tensor(ck, device=device), LCG_M)
    return rng_k.to(dtype) / LCG_M * 2.0 * np.pi


def burger_turbulence(tseeds, offset, x, L):
    """The turbulence IC (Burger.py:227-259) for a batch of seeds, on x's
    device and in x's dtype: u0 = 1 + sum_{k=1}^{N-1} sqrt(2*Ek) sin(k*2*pi*(x+offset)/L
    + phase_k), Ek = 5^{-5/3} for k<=5 else k^{-5/3}, then RMS-rescaled into
    [0.65, 0.75] by the reference's capped fixed-point loop, run per env on the
    device (a row stops where its criterion is met).  tseeds: (B,) ints;
    offset: scalar or (B,).  Returns (B, N)."""
    N = x.shape[-1]
    dtype, device = x.dtype, x.device
    kk = torch.arange(1, N, dtype=dtype, device=device)
    Ek = torch.where(kk <= 5, torch.full_like(kk, 5.0 ** (-5.0 / 3.0)), kk ** (-5.0 / 3.0))
    w = torch.sqrt(2.0 * Ek)
    phases = turbulence_phases(tseeds, N, dtype, device)                    # (B, N-1)
    xo = x + torch.as_tensor(offset, dtype=dtype, device=device).reshape(-1, 1)
    theta = kk[:, None] * (2.0 * np.pi * xo / L)[:, None, :] + phases[:, :, None]
    u0 = 1.0 + torch.einsum("k,bkn->bn", w, torch.sin(theta))

    def rms(u):
        return torch.sqrt(torch.sum((u - 1.0) ** 2, dim=-1) / N)

    crit = rms(u0)
    for _ in range(101):        # the reference's while loop: at most 101 rescalings
        active = (crit < 0.65) | (crit > 0.75)
        if not bool(active.any()):
            break
        u0 = torch.where(active[:, None], u0 * (0.7 / crit)[:, None], u0)
        crit = torch.where(active, rms(u0), crit)
    return u0


def burger_sinus(offset, x, L):
    """sin(4*pi*(x+offset)/L)   (Burger.py:224)"""
    return torch.sin(4.0 * np.pi * (x + offset) / L)


def burger_forced_numpy(seed, x, L):
    """The 'forced' IC (Burger.py:265-273), drawing from numpy's legacy global
    generator as the reference does: it reseeds ``np.random`` with ``seed``."""
    np.random.seed(seed)
    N = x.shape[-1]
    A = 1.0 / N
    u0 = np.zeros(N)
    for k in range(1, N):
        r1 = np.random.normal(loc=0.0, scale=1.0)
        r2 = np.random.normal(loc=0.0, scale=1.0)
        u0 += r1 * A * np.sin(2.0 * np.pi * (k * x / L + r2))
    return u0


def diffusion_box(offset, x, L):
    """Box: 1 on |x - L/2 - offset| < L/8   (Diffusion.py:102-104)"""
    return torch.where(torch.abs(x - L / 2.0 - offset) < L / 8.0, 1.0, 0.0).to(x.dtype)


def diffusion_sinus(offset, x, L):
    """sin((x - offset)*2*pi/L)   (Diffusion.py:108, Advection.py:108)"""
    return torch.sin((x - offset) * 2.0 * np.pi / L)


def diffusion_gaussian(offset, x, L):
    """exp(-0.5*(L/2 + offset - x)^2)   (Diffusion.py:112)"""
    return torch.exp(-0.5 * (0.5 * L + offset - x) ** 2)


def laplace_ic(kind, x):
    """Laplace initial fields (Laplace.py:50-57)."""
    if kind == "zero":
        return torch.zeros_like(x)
    if kind == "one":
        return torch.ones_like(x)
    if kind == "sin":
        return 1.0 + torch.sin(x)
    if kind == "cos":
        return torch.cos(x)
    raise ValueError(f"[ic] unknown laplace ic: {kind}")


def laplace_force(kind, r, offset, x, L):
    """Laplace source terms (Laplace.py:63-96).  ``r``: the uniform draw in
    [0, 1) that picks the branch of the random kinds ('sincos': sin where
    r > 0.5, else cos; 'fourier': 2, 3 or 4 half-periods where r > 0.66,
    r > 0.33, else), broadcasting like ``offset``; the other kinds ignore it."""
    if kind == "zero":
        return torch.zeros_like(x + offset)
    if kind == "sin":
        return torch.sin((x - offset) * 2.0 * np.pi / L)
    if kind == "cos":
        return torch.cos((x - offset) * 2.0 * np.pi / L)
    if kind == "sincos":
        return torch.where(r > 0.5, torch.sin((x - offset) * 2.0 * np.pi / L),
                           torch.cos((x - offset) * 2.0 * np.pi / L))
    if kind == "fourier":
        m = torch.where(r > 0.66, 2.0, torch.where(r > 0.33, 3.0, 4.0))
        return torch.sin((x - offset) * m * np.pi / L)
    if kind == "gaussian":
        return torch.exp(-0.5 * (0.5 * L - x + offset) ** 2)
    raise ValueError(f"[ic] unknown laplace force: {kind}")
