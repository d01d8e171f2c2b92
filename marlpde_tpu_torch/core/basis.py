"""Action-basis builders: partition-of-unity expansions of per-agent actions onto the grid.

Copied from marlpde_tpu/core/basis.py (numpy only; the port may not import the
JAX package).  Parity target: Burger.setup_basis (Burger.py:177-203).  The
forcing applied to the PDE is ``actions @ basis`` (Burger.py:442).
"""

from __future__ import annotations

import numpy as np


def hat(x, mean, dx):
    """Reference hat function (Burger.py:12-15): overlapping linear hats."""
    left = np.clip((x + dx - mean) / dx, a_min=0.0, a_max=1.0)
    right = np.clip((dx - x + mean) / dx, a_min=0.0, a_max=1.0)
    return left + right - 1.0


def make_basis(M: int, N: int, L: float, kind: str = "uniform") -> np.ndarray:
    """Build an (M, N) partition-of-unity action basis.

    kind='uniform': disjoint blocks of N//M ones (requires M | N).
    kind='hat':     overlapping hats centered at i*L/(M-1), matching the
                    reference including its wrap-around at the domain edges.
    For M == 1 the basis is a single row of ones.
    """
    x = np.linspace(0.0, L, N, endpoint=False)
    if M <= 1:
        basis = np.ones((max(M, 1), N))
    elif kind == "uniform":
        assert N % M == 0, "[basis] uniform basis requires M | N"
        basis = np.zeros((M, N))
        for i in range(M):
            basis[i, i * (N // M):(i + 1) * (N // M)] = 1.0
    elif kind == "hat":
        dx = L / (M - 1)
        basis = np.stack([hat(x, i * dx, dx) for i in range(M)])
    else:
        raise ValueError(f"[basis] unknown basis kind: {kind}")

    np.testing.assert_allclose(np.sum(basis, axis=0), 1.0)
    return basis
