"""Interpolation of ground-truth trajectories (port of
marlpde_tpu/core/interp.py:23-133).

The reference interpolates DNS truth with scipy ``interp2d`` — cubic for
Burgers/KS (Burger.py:323, KS.py:223), linear for diffusion/advection
(Diffusion.py:132).  Queries always land on stored time slices (t = n*dt), so
time interpolation reduces to an index; only space needs real interpolation,
here a *periodic* cubic spline on the uniform grid whose circulant tridiagonal
system (M_{j-1} + 4 M_j + M_{j+1} = 6 d2y_j) is solved in Fourier space, one
FFT per trajectory frame, batched over every leading axis.
"""

from __future__ import annotations

import numpy as np
import torch

from marlpde_tpu_torch.device import constant


def periodic_spline_m(y):
    """Second-derivative spline coefficients M (same shape as y, last axis = space).

    Solves M_{j-1} + 4*M_j + M_{j+1} = 6*(y_{j-1} - 2*y_j + y_{j+1}) with h=1
    grid units (h is factored into the evaluation), via the circulant
    eigenvalues 4 + 2*cos(2*pi*m/N).
    """
    N = y.shape[-1]
    d2 = torch.roll(y, 1, -1) - 2.0 * y + torch.roll(y, -1, -1)
    eig = constant(_circulant_eigenvalues, N, dtype=y.dtype, device=y.device)
    return torch.fft.ifft(torch.fft.fft(6.0 * d2, dim=-1) / eig, dim=-1).real


def _circulant_eigenvalues(N: int) -> np.ndarray:
    return 4.0 + 2.0 * np.cos(2.0 * np.pi * np.arange(N) / N)


def _cubic(yj, yjp, Mj, Mjp, t):
    omt = 1.0 - t
    # grid-unit spline; M carries 1/h^2 implicitly since d2 was unscaled
    return yj * omt + yjp * t + ((omt**3 - omt) * Mj + (t**3 - t) * Mjp) / 6.0


def _cell(xq, L, N, dtype, device):
    """(j, j+1 mod N, t) of the query points: the cell and the fraction in it."""
    s = torch.remainder(torch.as_tensor(xq, dtype=dtype, device=device), L) / (L / N)
    fl = torch.floor(s)
    j = torch.remainder(fl.to(torch.int64), N)
    return j, torch.remainder(j + 1, N), s - fl


def periodic_spline_eval(y, M, xq, L):
    """Evaluate the periodic cubic spline of ``y`` (coefficients ``M``) at the
    points ``xq``.

    y, M: (..., N) values/coefficients on x_j = j*L/N.  xq: (Q,) query points
    shared by every row, or (..., Q) queries of each row (any real; wrapped
    into [0, L)).  Returns (..., Q).
    """
    j, jp, t = _cell(xq, L, y.shape[-1], y.dtype, y.device)
    if j.ndim == 1:
        return _cubic(y[..., j], y[..., jp], M[..., j], M[..., jp], t)
    batch = torch.broadcast_shapes(y.shape[:-1], j.shape[:-1])

    def at(a, i):
        return torch.gather(a.expand(batch + a.shape[-1:]), -1, i.expand(batch + i.shape[-1:]))

    return _cubic(at(y, j), at(y, jp), at(M, j), at(M, jp), t)


def periodic_spline_eval_uniform(y, M, offset, L, Q):
    """:func:`periodic_spline_eval` at the standard query grid
    x_i = i*L/Q + offset (the uniform coarse grid shifted by a per-row
    scalar).  The queries are uniformly strided, so j_i = (j0 + (N/Q)*i) mod N
    with one fraction t = frac(offset/h) shared by a row's queries.

    y, M: (..., N) frames; offset: scalar or (...,) per-row shift.  Returns
    (..., Q)."""
    N = y.shape[-1]
    assert N % Q == 0, (N, Q)
    stride = N // Q
    h = L / N
    s0 = torch.remainder(torch.as_tensor(offset, dtype=y.dtype, device=y.device), L) / h
    fl = torch.floor(s0)
    j0 = torch.remainder(fl.to(torch.int64), N)
    t = (s0 - fl)[..., None]
    idx = torch.remainder(j0[..., None] + stride * torch.arange(Q, device=y.device), N)
    idx = idx.expand(y.shape[:-1] + (Q,))
    idxp = torch.remainder(idx + 1, N)
    return _cubic(torch.gather(y, -1, idx), torch.gather(y, -1, idxp),
                  torch.gather(M, -1, idx), torch.gather(M, -1, idxp), t)


def cubic_interp(y, xq, L):
    """One-shot periodic cubic interpolation of y(..., N) at xq."""
    return periodic_spline_eval(y, periodic_spline_m(y), xq, L)


def linear_interp(y, xq, L):
    """Periodic linear interpolation of y(..., N) at the query points xq (Q,).

    Matches interp2d(kind='linear') away from the last cell; the reference's
    non-periodic interpolant clamps in [x_{N-1}, L) whereas this wraps.
    """
    j, jp, t = _cell(xq, L, y.shape[-1], y.dtype, y.device)
    return y[..., j] * (1.0 - t) + y[..., jp] * t


def frame_index(t, dt, nframes):
    """Index of the stored trajectory frame at time t (t is n*dt up to fp error)."""
    return torch.clamp(torch.round(t / dt).to(torch.int64), 0, nframes - 1)


def shifted_query_points(x, shift, L):
    """The reference's shifted-truth query grid (Burger.py:581-583):
    newx = x + shift, wrapped into [0, L]."""
    newx = x + shift
    newx = torch.where(newx > L, newx - L, newx)
    return torch.where(newx < 0, newx + L, newx)
