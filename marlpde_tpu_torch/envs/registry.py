"""Workload registry: each reference driver becomes a config preset producing a
uniform functional Env (port of marlpde_tpu/envs/registry.py:32-92,141-192).

Driver map (reference -> preset name):
  run-vracer-burger.py            -> 'burger'
  run-vracer-burger-marl.py       -> 'burger-marl'
  run-vracer-burger-fd.py         -> 'burger-fd'
  run-vracer-coupled-burger.py    -> 'coupled-burger'
  run-vracer-burger-jax.py        -> 'burger-jax'  (the spectral RK3 scheme)
  (the nunoise path of burger_environment.py:57-75) -> 'burger-lockstep'
  run-vracer-ks.py                -> 'ks'
  run-vracer-diffusion-simple.py  -> 'diffusion-simple'
  run-vracer-diffusion.py         -> 'diffusion-stencil3'
  run-vracer-diffusion-error.py   -> 'diffusion-error'
  run-vracer-advection-simple.py  -> 'advection-simple'
  run-vracer-laplace.py           -> 'laplace'

Every Burgers config runs on the general per-env env (``burger_env.step``,
torch.fft); where the whole-batch env implements the config
(``fast_burger_ok``) and ``fast`` is not 'off', its pair on the ABCN op is
attached as well.  The diffusion, advection and Laplace envs have no pool:
their consts (``rollout.Placement``) say only where and in which dtype they
live.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import numpy as np
import torch

from marlpde_tpu_torch.device import resolve_device
from marlpde_tpu_torch.envs import (advection_env, burger_env, burger_fast, diffusion_env,
                                    ks_env, laplace_env)
from marlpde_tpu_torch.envs.rollout import Env, Placement


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
    """The Burgers env on ``device`` (None: the card, raising where there is
    none; a given ``pool`` keeps its own device).  ``fast`` picks the rollout
    backend for configs the whole-batch env implements: 'auto' and 'pallas'
    attach the whole-batch pair, whose ABCN op launches the CUDA kernel on the
    card and runs its plain version on the CPU; 'off' keeps the general
    per-env env (the torch.fft solver), as every other config does."""
    if cfg is None:
        cfg = burger_env.BurgerEnvConfig(**overrides)
    elif overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    if fast not in ("auto", "pallas", "off"):
        raise ValueError(f"[registry] unknown fast={fast!r}")
    if pool is None:
        pool = burger_env.make_dns_pool(cfg, n_dns, dtype=dtype,
                                        device=resolve_device(device))
    name = "burger-fd" if cfg.scheme == "fd" else (
        "burger-marl" if cfg.num_agents > 1 else "burger")
    batch_reset = batch_step = None
    if fast != "off" and fast_burger_ok(cfg):
        batch_reset = partial(burger_fast.reset, cfg)
        batch_step = partial(burger_fast.step, cfg)
    return Env(
        name=name, cfg=cfg,
        reset=partial(burger_env.reset, cfg), step=partial(burger_env.step, cfg),
        obs_dim=cfg.obs_dim, num_agents=cfg.num_agents,
        act_dim=cfg.actions_per_agent, episode_length=cfg.episode_length,
        action_low=-5.0, action_high=5.0,   # run-vracer-burger.py:156-157
        consts=pool, batch_reset=batch_reset, batch_step=batch_step)


def make_burger_lockstep_env(cfg: burger_env.BurgerEnvConfig = None, dtype=torch.float32,
                             device=None, **overrides) -> Env:
    """Fresh-DNS-per-episode mode (the nunoise path), on ``device`` (None: the
    card) in ``dtype``; no pool."""
    overrides.setdefault("nunoise", True)
    if cfg is None:
        cfg = burger_env.BurgerEnvConfig(dns_mode="lockstep", **overrides)
    else:
        cfg = dataclasses.replace(cfg, dns_mode="lockstep", **overrides)
    return Env(
        name="burger-lockstep", cfg=cfg,
        reset=partial(burger_env.reset_lockstep, cfg),
        step=partial(burger_env.step_lockstep, cfg),
        obs_dim=cfg.obs_dim, num_agents=cfg.num_agents,
        act_dim=cfg.actions_per_agent, episode_length=cfg.episode_length,
        action_low=-5.0, action_high=5.0,
        consts=burger_env.LockstepConsts(device=resolve_device(device), dtype=dtype))


def make_coupled_burger_env(**kw) -> Env:
    env = make_burger_env(coupled=True, spectral_reward=False, **kw)
    # run-vracer-coupled-burger.py:68-69: actions in [-1, 1]
    return dataclasses.replace(env, name="coupled-burger", action_low=-1.0, action_high=1.0)


def make_burger_jax_env(**kw) -> Env:
    """The differentiable-Burgers closure env (run-vracer-burger-jax.py): the
    spectral RK3 scheme (Burger_jax.py:42-66), state = d2udx2
    (Burger_jax.py:499-508, i.e. version 0), actions in [-5, 5]
    (run-vracer-burger-jax.py:91-93)."""
    env = make_burger_env(scheme="rk3", version=kw.pop("version", 0), **kw)
    return dataclasses.replace(env, name="burger-jax")


def make_ks_env(cfg: ks_env.KSEnvConfig = None, n_dns: int = 1, pool=None,
                dtype=torch.float32, device=None, **overrides) -> Env:
    """The KS env on ``device`` (None: the card, raising where there is none;
    a given ``pool`` keeps its own device)."""
    if cfg is None:
        cfg = ks_env.KSEnvConfig(**overrides)
    elif overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    if pool is None:
        pool = ks_env.make_dns_pool(cfg, n_dns, dtype=dtype, device=resolve_device(device))
    return Env(
        name="ks", cfg=cfg,
        reset=partial(ks_env.reset, cfg), step=partial(ks_env.step, cfg),
        obs_dim=cfg.obs_dim, num_agents=cfg.num_agents,
        act_dim=cfg.actions_per_agent, episode_length=cfg.episode_length,
        action_low=-5.0, action_high=5.0,   # run-vracer-ks.py:92-93
        consts=pool)


def _simple_env(name, module, cfg, dtype, device, action_low, action_high) -> Env:
    """An env without a pool on ``device`` (None: the card) in ``dtype``."""
    return Env(
        name=name, cfg=cfg, reset=partial(module.reset, cfg), step=partial(module.step, cfg),
        obs_dim=cfg.obs_dim, num_agents=cfg.num_agents, act_dim=cfg.actions_per_agent,
        episode_length=cfg.episode_length, action_low=action_low, action_high=action_high,
        consts=Placement(device=resolve_device(device), dtype=dtype))


def make_diffusion_env(cfg: diffusion_env.DiffusionEnvConfig = None, dtype=torch.float32,
                       device=None, **overrides) -> Env:
    if cfg is None:
        cfg = diffusion_env.DiffusionEnvConfig(**overrides)
    elif overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    name = {"simple": "diffusion-simple", "error": "diffusion-error",
            "stencil3": "diffusion-stencil3"}[cfg.mode]
    # run-vracer-diffusion-simple.py:95-96; the error script acts in [-0.1, 0.1]
    lo, hi = (-0.1, 0.1) if cfg.mode == "error" else (-5.0, 5.0)
    return _simple_env(name, diffusion_env, cfg, dtype, device, lo, hi)


def make_advection_env(cfg: advection_env.AdvectionEnvConfig = None, dtype=torch.float32,
                       device=None, **overrides) -> Env:
    if cfg is None:
        cfg = advection_env.AdvectionEnvConfig(**overrides)
    elif overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    # run-vracer-advection-simple.py:95-96
    return _simple_env("advection-simple", advection_env, cfg, dtype, device, -2.0, 2.0)


def make_laplace_env(cfg: laplace_env.LaplaceEnvConfig = None, dtype=torch.float32,
                     device=None, **overrides) -> Env:
    if cfg is None:
        cfg = laplace_env.LaplaceEnvConfig(**overrides)
    elif overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    # run-vracer-laplace.py:85-86
    return _simple_env("laplace", laplace_env, cfg, dtype, device, -3.0, 3.0)


MAKERS = {
    "burger": make_burger_env,
    "burger-jax": make_burger_jax_env,
    "burger-lockstep": make_burger_lockstep_env,
    "coupled-burger": make_coupled_burger_env,
    "burger-marl": lambda **kw: make_burger_env(num_agents=kw.pop("num_agents", 32), **kw),
    "burger-fd": lambda **kw: make_burger_env(
        scheme="fd", state_bound=kw.pop("state_bound", 1e6), **kw),
    "ks": make_ks_env,
    "diffusion-simple": make_diffusion_env,
    "diffusion-error": lambda **kw: make_diffusion_env(mode="error", **kw),
    "diffusion-stencil3": lambda **kw: make_diffusion_env(mode="stencil3", **kw),
    "advection-simple": make_advection_env,
    "laplace": make_laplace_env,
}


def make_env(name: str, **overrides) -> Env:
    if name not in MAKERS:
        raise ValueError(f"[registry] unknown env '{name}'; have {sorted(MAKERS)}")
    return MAKERS[name](**overrides)
