"""Analytic policy gradient (APG): backprop through the differentiable env
(port of marlpde_tpu/rl/apg.py).

The reference's gradient-aware RL (korali safe-rl branch) consumes per-step
action Jacobians published as ``s["State Gradient"]``
(burger_jax_environment.py:50,94) that Burger_jax accumulates host-side with
an explicit chain rule (Burger_jax.py:334-374).  Here the whole rollout is one
autograd graph, so the return is differentiated directly:

    theta <- theta + lr * d/dtheta E[ sum_t r_t(rollout(theta)) ]

The policy forward runs through the ``VracerNet`` module, as the JAX package
differentiates ``make_net(cfg).apply`` (not the Pallas kernel, which has no
VJP); the MLP kernel serves only the gradient-free acting of the --test stage.
Each macro-step is wrapped in ``torch.utils.checkpoint`` (the JAX
``jax.checkpoint``), so BPTT memory keeps the macro-steps' inputs and not every
sub-step's activations.  The Burgers env's step draws nothing from a
generator, so the recomputed step sees the values of the first pass; the only
draws (the resets' phase offsets) happen before the loop.

Works with any env whose step is differentiable w.r.t. actions — the
'burger-jax' preset (RK3 scheme, envs/registry.py) is the parity workload.
Actions are bounded with a smooth tanh squash (a hard clip would zero the
gradient at the bounds, killing the signal APG depends on).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint as _checkpoint

from marlpde_tpu_torch.rl import vracer


@dataclasses.dataclass(frozen=True)
class ApgConfig:
    iterations: int = 100
    batch_size: int = 16
    lr: float = 1e-3
    max_grad_norm: float = 1.0


def squash(mu, low, high):
    """Smooth [low, high] bound: center + halfwidth * tanh(mu / halfwidth)."""
    c = 0.5 * (low + high)
    s = 0.5 * (high - low)
    return c + s * torch.tanh((mu - c) / s)


def episode_return(env, rl_cfg, ts, consts, generator, episode_base, batch_size,
                   checkpoint: bool = True):
    """Mean (over batch and agents) undiscounted episode return of the
    deterministic squashed policy, differentiable w.r.t. the parameters of
    ``ts.net`` (the JAX function's ``params``).  ``checkpoint`` recomputes
    each macro-step in the backward pass, as the JAX package always does;
    without it the backward pass keeps every sub-step's tensors."""
    counts = episode_base + torch.arange(batch_size, device=env.device)
    state, obs = env.reset(consts, generator, counts)

    def macro(st, ob):
        _, mu, _ = ts.net(vracer._prep_obs(rl_cfg, ts, ob))
        a = squash(mu, rl_cfg.action_low, rl_cfg.action_high)
        alive = ~st.done
        st2, ob2, rew, _done, _ = env.step(consts, st, a)
        return st2, ob2, rew * alive[..., None].to(rew.dtype)

    total = 0.0
    for _ in range(env.episode_length):
        if checkpoint:
            state, obs, rew = _checkpoint(macro, state, obs, use_reentrant=False)
        else:
            state, obs, rew = macro(state, obs)
        total = total + rew
    return torch.mean(total)


def train_apg(env, rl_cfg: vracer.VracerConfig, cfg: ApgConfig = ApgConfig(),
              generator: Optional[torch.Generator] = None,
              init_ts: Optional[vracer.TrainState] = None, verbose: bool = True):
    """Gradient ascent on the analytic return.  Returns (ts, history), ``ts``
    holding the incumbent-best parameters; its VRACER optimizer is untouched.

    The optimizer is optax's ``chain(clip_by_global_norm, adam)``: the global
    norm clip of ``vracer.clip_by_global_norm``, then a fresh Adam of its own.
    ``generator`` (on the env's device) draws the initial weights where no
    ``init_ts`` is given, then the resets' offsets."""
    device = env.device
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    ts = init_ts if init_ts is not None else vracer.init_train(
        rl_cfg, generator, dtype=env.dtype, device=device)
    params = list(ts.net.parameters())
    # every parameter keeps a gradient, zero where the return does not reach
    # it (the value and sigma heads), as jax.grad gives
    for p in params:
        p.grad = torch.zeros_like(p)
    opt = torch.optim.Adam(params, lr=cfg.lr, eps=1e-8)

    history = {"iter": [], "mean_return": [], "best_return": []}
    # incumbent-best tracking (CMAES semantics): the objective is the
    # DETERMINISTIC squashed-mean return, so the best-seen iterate is a
    # well-defined optimizer output — BPTT through chaotic rollouts makes the
    # raw iterate sequence noisy, and returning the incumbent is the standard
    # fix.  Adam steps the parameters in place, so the best is a copy.
    best_ret, best = -np.inf, [p.detach().clone() for p in params]
    for it in range(cfg.iterations):
        opt.zero_grad(set_to_none=False)
        ret = episode_return(env, rl_cfg, ts, env.consts, generator, it * cfg.batch_size,
                             cfg.batch_size)
        (-ret).backward()
        # ret is the return OF the parameters before this update
        ret = float(ret.detach())
        if ret > best_ret:
            best_ret, best = ret, [p.detach().clone() for p in params]
        vracer.clip_by_global_norm([p.grad for p in params], cfg.max_grad_norm)
        opt.step()
        history["iter"].append(it)
        history["mean_return"].append(ret)
        history["best_return"].append(float(best_ret))
        if verbose and (it % max(1, cfg.iterations // 10) == 0
                        or it == cfg.iterations - 1):
            print(f"[apg] iter {it} return {ret:.6f} best {best_ret:.6f}")
    with torch.no_grad():
        for p, b in zip(params, best):
            p.copy_(b)
            p.grad = None
    return ts, history
