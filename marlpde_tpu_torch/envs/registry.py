"""Workload registry (port of marlpde_tpu/envs/registry.py:32-73,183).

The port covers the whole-batch Burgers presets only: 'burger'
(run-vracer-burger.py) and 'burger-marl' (run-vracer-burger-marl.py), on
configs that the whole-batch env implements (``fast_burger_ok``).  Every
other preset, and the general per-env rollout (``fast='off'``), raise
NotImplementedError until their slice lands (ROADMAP queue 1).
"""

from __future__ import annotations

import dataclasses
from functools import partial

import numpy as np
import torch

from marlpde_tpu_torch import NOT_PORTED as _NOT_PORTED
from marlpde_tpu_torch.device import resolve_device
from marlpde_tpu_torch.envs import burger_env, burger_fast
from marlpde_tpu_torch.envs.rollout import Env


def fast_burger_ok(cfg: burger_env.BurgerEnvConfig) -> bool:
    """Does the whole-batch env (envs/burger_fast.py) implement this config?
    Flagship spectral-reward ABCN closure without stochastic forcing or
    eddy-viscosity closures (the fused kernel covers exactly that math)."""
    return (cfg.scheme == "abcn" and cfg.spectral_reward and cfg.dforce
            and cfg.dns_mode == "pool" and not cfg.coupled
            and not (cfg.ssm or cfg.dsm or cfg.forcing or cfg.ssmforce)
            and not cfg.nunoise and np.isinf(cfg.state_bound))


def make_burger_env(cfg: burger_env.BurgerEnvConfig = None, n_dns: int = 1,
                    pool=None, dtype=torch.float32, fast: str = "auto",
                    device=None, **overrides) -> Env:
    """The whole-batch Burgers env on ``device``.  ``fast`` is kept for config
    compatibility: 'auto' and 'pallas' both take the whole-batch env, whose
    ABCN op launches the CUDA kernel on the card and runs its plain version on
    the CPU; 'off' (the general per-env env) is not ported yet."""
    if cfg is None:
        cfg = burger_env.BurgerEnvConfig(**overrides)
    elif overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    if fast not in ("auto", "pallas"):
        raise NotImplementedError(f"[registry] fast={fast!r}: the general per-env "
                                  f"Burgers env {_NOT_PORTED}")
    if not fast_burger_ok(cfg):
        raise NotImplementedError(f"[registry] this Burgers configuration needs the "
                                  f"general per-env env, which {_NOT_PORTED}: {cfg}")
    if pool is None:
        pool = burger_env.make_dns_pool(cfg, n_dns, dtype=dtype,
                                        device=resolve_device(device))
    return Env(
        name="burger-marl" if cfg.num_agents > 1 else "burger", cfg=cfg,
        batch_reset=partial(burger_fast.reset, cfg),
        batch_step=partial(burger_fast.step, cfg),
        obs_dim=cfg.obs_dim, num_agents=cfg.num_agents,
        act_dim=cfg.actions_per_agent, episode_length=cfg.episode_length,
        action_low=-5.0, action_high=5.0,   # run-vracer-burger.py:156-157
        consts=pool)


MAKERS = {
    "burger": make_burger_env,
    "burger-marl": lambda **kw: make_burger_env(num_agents=kw.pop("num_agents", 32), **kw),
}

# presets of the JAX registry that wait for a later slice
PENDING = ("burger-jax", "burger-lockstep", "coupled-burger", "burger-fd", "ks",
           "diffusion-simple", "diffusion-error", "diffusion-stencil3",
           "advection-simple", "laplace")


def make_env(name: str, **overrides) -> Env:
    if name in PENDING:
        raise NotImplementedError(f"[registry] env '{name}' {_NOT_PORTED}")
    if name not in MAKERS:
        raise ValueError(f"[registry] unknown env '{name}'; have {sorted(MAKERS)}")
    return MAKERS[name](**overrides)
