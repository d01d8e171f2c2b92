"""Finite-difference derivatives of the Smagorinsky closures (port of
marlpde_tpu/solvers/closures.py:24-31).

Only the two stencils that the action forcing needs are ported (dforce=False
scales the actions by d2u/dx2, ssmforce turns them into a Smagorinsky
constant field); the ssm/dsm closures themselves wait for ROADMAP item 12.
"""

from __future__ import annotations

import torch


def first_deriv_onesided(u, dx):
    """(u - roll(u,1))/dx — the reference's upwind-style dudx (Burger.py:345)."""
    return (u - torch.roll(u, 1, dims=-1)) / dx


def second_deriv(u, dx):
    """(roll(u,-1) - 2u + roll(u,1))/dx^2 (Burger.py:346)."""
    return (torch.roll(u, -1, dims=-1) - 2.0 * u + torch.roll(u, 1, dims=-1)) / (dx * dx)
