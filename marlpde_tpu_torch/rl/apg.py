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
The JAX package wraps each macro-step in ``jax.checkpoint`` and jits the
whole ``value_and_grad`` and update.  ``train_apg`` runs that program as its
pieces (``Bptt``): a forward pass that keeps each macro-step's inputs (the
carry) on a tape, a reverse pass that recomputes each macro-step and applies
its VJP, and the update, each step a CUDA graph on the card
(utils/graphs.py).  So BPTT memory keeps the macro-steps' inputs and not
every sub-step's activations.  ``episode_return`` is the plain version: the
same return under ``torch.utils.checkpoint`` per macro-step and autograd's
backward pass.  The Burgers env's step draws nothing from a generator, so
the recomputed step sees the values of the first pass; the only draws (the
resets' phase offsets) happen before the macro-steps.

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
from marlpde_tpu_torch.utils import graphs


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


def _macro_step(env, rl_cfg, ts, consts, st, ob):
    """One macro-step of the deterministic squashed policy: (state, obs,
    reward masked to the envs still alive)."""
    _, mu, _ = ts.net(vracer._prep_obs(rl_cfg, ts, ob))
    a = squash(mu, rl_cfg.action_low, rl_cfg.action_high)
    alive = ~st.done
    st2, ob2, rew, _done, _ = env.step(consts, st, a)
    return st2, ob2, rew * alive[..., None].to(rew.dtype)


def episode_return(env, rl_cfg, ts, consts, generator, episode_base, batch_size,
                   checkpoint: bool = True):
    """Mean (over batch and agents) undiscounted episode return of the
    deterministic squashed policy, differentiable w.r.t. the parameters of
    ``ts.net`` (the JAX function's ``params``).  ``checkpoint`` recomputes
    each macro-step in the backward pass, as the JAX package always does;
    without it the backward pass keeps every sub-step's tensors.  The plain
    version of what ``Bptt`` computes in pieces."""
    counts = episode_base + torch.arange(batch_size, device=env.device)
    state, obs = env.reset(consts, generator, counts)

    def macro(st, ob):
        return _macro_step(env, rl_cfg, ts, consts, st, ob)

    total = 0.0
    for _ in range(env.episode_length):
        if checkpoint:
            state, obs, rew = _checkpoint(macro, state, obs, use_reentrant=False)
        else:
            state, obs, rew = macro(state, obs)
        total = total + rew
    return torch.mean(total)


def _differentiable(x) -> bool:
    return x.is_floating_point() or x.is_complex()


class Bptt:
    """An APG iteration as the program the JAX package compiles it to: a
    checkpointed ``lax.scan`` under ``value_and_grad`` is a forward scan that
    keeps each macro-step's carry, then a reverse scan whose body recomputes
    that macro-step and applies its VJP; then optax's clip and Adam.  Four
    steps on buffers this object owns, each a ``graphs.Step`` (one CUDA graph
    on the card, direct calls elsewhere):

      * ``begin``: the resets (episodes ``base`` .. ``base + B``, offsets from
        ``generator``) into slot 0 of the tape, the return's accumulator, the
        carry's cotangent and the gradients zeroed;
      * ``forward`` (T times): macro-step t without autograd from tape slot
        t into slot t + 1, the masked reward added to the accumulator;
      * ``vjp`` (T times, t from T - 1 down to 0): macro-step t recomputed
        from slot t under autograd, its VJP taking the carry's cotangent at
        t + 1 and the reward's, -1/(B A) (the gradient of minus the mean
        return), to the carry's cotangent at t and the parameters' gradients,
        which it adds up;
      * ``update``: the return, the incumbent (the parameters before the
        update, kept where the return beats the best so far: -inf at first,
        and NaN never wins, as ``float(ret) > best`` in JAX), the global-norm
        clip and Adam.

    The carry's complex fields pass their cotangents as autograd passes them;
    integer and bool fields have none.  Nothing in a macro-step draws, so the
    recomputation sees the forward pass's values."""

    def __init__(self, env, rl_cfg, ts, cfg: ApgConfig, consts, generator):
        self.env, self.rl_cfg, self.ts, self.consts = env, rl_cfg, ts, consts
        self.generator, self.max_grad_norm = generator, cfg.max_grad_norm
        self.B, self.T = cfg.batch_size, env.episode_length
        device, dtype = env.device, env.dtype
        self.params = list(ts.net.parameters())
        self.grads = [torch.zeros_like(p) for p in self.params]
        # every parameter keeps a gradient, zero where the return does not
        # reach it (the value and sigma heads), as jax.grad gives
        for p, g in zip(self.params, self.grads):
            p.grad = g
        self.opt = graphs.adam(self.params, cfg.lr)
        self.base = torch.zeros((), dtype=torch.int64, device=device)
        self.t = torch.zeros((), dtype=torch.int64, device=device)
        # the carry's shapes, from a reset that draws from a generator of its own
        carry = env.reset(consts, torch.Generator(device=device),
                          torch.arange(self.B, device=device))
        self.tape = graphs.tree_map(lambda x: x.new_zeros((self.T + 1,) + x.shape), carry)
        self.cot = [torch.zeros_like(x) for x in graphs.tensors(carry) if _differentiable(x)]
        rew = torch.zeros((self.B, env.num_agents), dtype=dtype, device=device)
        self.acc = torch.zeros_like(rew)
        self.rew_cot = torch.full_like(rew, -1.0 / rew.numel())
        self.best = [p.detach().clone() for p in self.params]
        self.best_ret = torch.full((), -np.inf, dtype=dtype, device=device)
        # (the return before this update, the best so far)
        self.out = torch.zeros(2, dtype=dtype, device=device)
        self.steps = {name: graphs.Step(f"APG {name}", getattr(self, name), device,
                                        [generator] if name == "begin" else [])
                      for name in ("begin", "forward", "vjp", "update")}

    def _at(self, t):
        return graphs.tree_map(lambda b: b.index_select(0, t.view(1)).squeeze(0), self.tape)

    def _put(self, t, carry):
        for b, x in zip(graphs.tensors(self.tape), graphs.tensors(carry)):
            b.index_copy_(0, t.view(1), x.unsqueeze(0))

    def _macro(self, st, ob):
        return _macro_step(self.env, self.rl_cfg, self.ts, self.consts, st, ob)

    @torch.no_grad()
    def begin(self):
        counts = self.base + torch.arange(self.B, device=self.base.device)
        carry = self.env.reset(self.consts, self.generator, counts)
        self.base.add_(self.B)
        self.t.zero_()
        self._put(self.t, carry)
        for x in [self.acc, *self.cot, *self.grads]:
            x.zero_()

    @torch.no_grad()
    def forward(self):
        st, ob, rew = self._macro(*self._at(self.t))
        self.t.add_(1)
        self._put(self.t, (st, ob))
        self.acc.add_(rew)

    def vjp(self):
        self.t.sub_(1)
        carry = self._at(self.t)
        inputs = [x.requires_grad_() for x in graphs.tensors(carry) if _differentiable(x)]
        with torch.enable_grad():
            st, ob, rew = self._macro(*carry)
        outs = [x for x in graphs.tensors((st, ob)) if _differentiable(x)]
        keep = [i for i, x in enumerate(outs) if x.requires_grad]
        grads = torch.autograd.grad([outs[i] for i in keep] + [rew], inputs + self.params,
                                    [self.cot[i] for i in keep] + [self.rew_cot],
                                    allow_unused=True, materialize_grads=True)
        graphs.copy_(self.cot, list(grads[:len(inputs)]))
        with torch.no_grad():
            for g, d in zip(self.grads, grads[len(inputs):]):
                g.add_(d)

    @torch.no_grad()
    def update(self):
        ret = torch.mean(self.acc)
        better = ret > self.best_ret
        for b, p in zip(self.best, self.params):
            b.copy_(torch.where(better, p, b))
        self.best_ret.copy_(torch.where(better, ret, self.best_ret))
        self.out.copy_(torch.stack((ret, self.best_ret)))
        vracer.clip_by_global_norm(self.grads, self.max_grad_norm)
        self.opt.step()

    def iteration(self):
        """One iteration: 2 T + 2 calls of the steps."""
        self.steps["begin"]()
        for _ in range(self.T):
            self.steps["forward"]()
        for _ in range(self.T):
            self.steps["vjp"]()
        self.steps["update"]()


def train_apg(env, rl_cfg: vracer.VracerConfig, cfg: ApgConfig = ApgConfig(),
              generator: Optional[torch.Generator] = None,
              init_ts: Optional[vracer.TrainState] = None, verbose: bool = True):
    """Gradient ascent on the analytic return.  Returns (ts, history), ``ts``
    holding the incumbent-best parameters; its VRACER optimizer is untouched.

    The optimizer is optax's ``chain(clip_by_global_norm, adam)``: the global
    norm clip of ``vracer.clip_by_global_norm``, then a fresh Adam of its own
    (capturable on the card).  ``generator`` (on the env's device) draws the
    initial weights where no ``init_ts`` is given, then the resets' offsets.
    Each iteration is a ``Bptt`` iteration: on the card 2 T + 2 graph replays
    (the first iteration runs each step for real once, the capture's
    warm-up), elsewhere direct calls.  The returns stay on the device; they
    are read at the iterations that print and after the last one."""
    device = env.device
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    ts = init_ts if init_ts is not None else vracer.init_train(
        rl_cfg, generator, dtype=env.dtype, device=device)
    # incumbent-best tracking (CMAES semantics): the objective is the
    # DETERMINISTIC squashed-mean return, so the best-seen iterate is a
    # well-defined optimizer output — BPTT through chaotic rollouts makes the
    # raw iterate sequence noisy, and returning the incumbent is the standard
    # fix.  Adam steps the parameters in place, so the best is a copy.
    bptt = Bptt(env, rl_cfg, ts, cfg, env.consts, generator)
    returns = torch.zeros((cfg.iterations, 2), dtype=env.dtype, device=device)
    for it in range(cfg.iterations):
        bptt.iteration()
        returns[it].copy_(bptt.out)
        if verbose and (it % max(1, cfg.iterations // 10) == 0
                        or it == cfg.iterations - 1):
            ret, best = returns[it].tolist()
            print(f"[apg] iter {it} return {ret:.6f} best {best:.6f}")
    rows = returns.tolist()
    history = {"iter": list(range(cfg.iterations)),
               "mean_return": [r for r, _ in rows], "best_return": [b for _, b in rows]}
    with torch.no_grad():
        for p, b in zip(bptt.params, bptt.best):
            p.copy_(b)
            p.grad = None
    return ts, history
