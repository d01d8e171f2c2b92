"""Exact viscous-Burgers solution via Gauss-Hermite quadrature (Basdevant et al. 1986).

Copied from marlpde_tpu/solvers/analytical.py (numpy only; the port may not
import the JAX package).

Parity target: burger_analytical.py:1-108 (Burkardt's burgers_viscous_time_exact1).
u_t + u*u_x = nu*u_xx on [-1,1], u(x,0) = -sin(pi*x), u(±1,t)=0:

  u(x,t) = -∫ sin(pi(x-eta)) phi(x-eta) dGauss / ∫ phi(x-eta) dGauss,
  eta = 2*sqrt(nu*t)*q,  phi(y) = exp(-cos(pi*y)/(2*pi*nu)).

The reference's hermite_ek_compute(8) builds the order-8 Gauss-Hermite rule
(weight e^{-x^2}) by Golub-Welsch; numpy's hermgauss produces the identical
nodes/weights, so no eigen-solver port is needed.  Vectorized over (x, t).
"""

from __future__ import annotations

import numpy as np


def burgers_viscous_exact(nu, x, t, qn: int = 8, f0=None):
    """Exact solution array of shape (len(x), len(t)).

    Matches burgers_viscous_time_exact1(nu, vxn, vx, vtn, vt): column 0 is the
    IC f0(x) (default -sin(pi*x)); columns t>0 use the quadrature formula.
    """
    x = np.atleast_1d(np.asarray(x, dtype=np.float64))
    t = np.atleast_1d(np.asarray(t, dtype=np.float64))
    qx, qw = np.polynomial.hermite.hermgauss(qn)
    if f0 is None:
        f0 = lambda z: -np.sin(np.pi * z)

    vu = np.zeros((x.size, t.size))
    vu[:, 0] = f0(x)
    for ti in range(1, t.size):
        c = 2.0 * np.sqrt(nu * t[ti])
        arg = np.pi * (x[:, None] - c * qx[None, :])          # (X, Q)
        w = qw[None, :] * c * np.exp(-np.cos(arg) / (2.0 * np.pi * nu))
        top = -np.sum(w * np.sin(arg), axis=1)
        bot = np.sum(w, axis=1)
        vu[:, ti] = top / bot
    return vu
