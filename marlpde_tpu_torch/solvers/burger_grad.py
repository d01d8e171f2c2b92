"""Differentiable Burgers: action->state Jacobians for gradient-aware RL
(port of marlpde_tpu/solvers/burger_grad.py).

Parity target: Burger_jax.py — RK3 kernels with forward-mode Jacobians
w.r.t. (actions, u) (:23-66) and the chain-rule accumulation
``gradient = dudu @ gradient + duda`` across sub-steps (:337-374), published
to korali as s["State Gradient"] (burger_jax_environment.py:50,94).

The rollout is a plain torch program, so the generic path is
``torch.func.jacfwd`` over the rolled-out step (torch.fft has forward-mode
rules); this module provides (a) that generic Jacobian, and (b) the
reference's explicit accumulated-Jacobian recurrence for step-by-step
parity.  The JAX ``lax.scan``s become Python loops.
"""

from __future__ import annotations

import torch
from torch.func import jacfwd

from marlpde_tpu_torch.core import spectral
from marlpde_tpu_torch.solvers import burger


def rk3_kernel(cfg: burger.BurgerConfig):
    """(action_field, u, v) -> (u', v'): one RK3 sub-step with direct forcing
    (Burger_jax.py:42-64), through ``burger.rk3_stages`` at the config's
    viscosity.  ``basis`` is applied by the caller."""

    def kern(action_field, u, v):
        return burger.rk3_stages(cfg, u, v, spectral.fft(action_field), cfg.nu)

    return kern


def step_with_grad(cfg: burger.BurgerConfig, basis, u, v, grad, actions,
                   n_intermediate: int):
    """Advance n_intermediate RK3 sub-steps accumulating d u / d actions.

    Replicates Burger_jax.step (:337-374): per sub-step,
      (duda, dudu) = jacfwd(kernel, argnums=(0, 1)) evaluated in real space,
      gradient <- dudu @ gradient + duda.
    grad: (N, M) accumulated Jacobian.  Returns (u, v, grad).
    """
    kern = rk3_kernel(cfg)
    B = torch.as_tensor(basis, dtype=u.dtype, device=u.device)
    field = actions @ B

    def u_out(a_field, uu):
        return kern(a_field, uu, spectral.fft(uu))[0]

    for _ in range(n_intermediate):
        duda_field, dudu = jacfwd(u_out, argnums=(0, 1))(field, u)
        duda = duda_field @ B.T                      # chain through the basis
        u, v = kern(field, u, v)
        grad = dudu @ grad + duda
    return u, v, grad


def episode_jacobian(cfg: burger.BurgerConfig, basis, u0, actions_seq,
                     n_intermediate: int):
    """Full-episode action Jacobians, (T, N, T, M), from one jacfwd over the
    rollout of T macro-steps (no per-step accumulation)."""
    B = torch.as_tensor(basis, dtype=u0.dtype, device=u0.device)
    kern = rk3_kernel(cfg)

    def roll(acts):
        u, us = u0, []
        for a in acts:
            field = a @ B
            for _ in range(n_intermediate):
                u = kern(field, u, spectral.fft(u))[0]
            us.append(u)
        return torch.stack(us)

    return jacfwd(roll)(actions_seq)
