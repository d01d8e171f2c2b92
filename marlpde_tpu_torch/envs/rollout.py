"""Episode collection with the policy in the loop (port of
marlpde_tpu/envs/rollout.py:21-144).

The JAX macro-step ``lax.scan`` under ``jax.jit`` becomes ``MacroStep``, one
macro-step in place on preallocated buffers (the (B, T, ...) layout replay
takes), captured once as a CUDA graph and replayed T times on the card, or
called T times on the CPU.  Every macro-step makes one MLP-op call for all
B*na agents, then one env step for all B envs: the whole-batch pair when the
env has one (one ABCN-op call), else the per-env pair, which the port writes
over a leading env axis in place of JAX's vmap.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from marlpde_tpu_torch.rl import vracer
from marlpde_tpu_torch.utils import graphs


@dataclasses.dataclass(frozen=True)
class Env:
    """Uniform functional env interface over the concrete env modules.

    ``reset``/``step`` are the env's general pair, ``batch_reset``/
    ``batch_step`` the optional whole-batch fast pair (envs/burger_fast.py);
    both pairs take and return a leading env axis.  ``consts`` holds large
    runtime data (the DNS pool) or, for an env without a pool, a holder of
    its device and dtype; either way ``consts.device`` and ``consts.dtype``
    say where and in which dtype the env's tensors live."""

    name: str
    cfg: Any
    reset: Callable           # (consts, generator, counts) -> (state, obs)
    step: Callable            # (consts, state, actions) -> (state, obs, reward, done, info)
    obs_dim: int
    num_agents: int
    act_dim: int              # actions per agent
    episode_length: int
    action_low: float
    action_high: float
    consts: Any = ()
    batch_reset: Callable | None = None
    batch_step: Callable | None = None

    @property
    def device(self) -> torch.device:
        return placement(self.consts)[0]

    @property
    def dtype(self) -> torch.dtype:
        return placement(self.consts)[1]

    @property
    def whole_batch(self) -> bool:
        return self.batch_reset is not None and self.batch_step is not None

    def reset_batch(self, consts, generator, counts):
        """Reset through the whole-batch pair when there is one."""
        return (self.batch_reset if self.whole_batch else self.reset)(consts, generator, counts)


@dataclasses.dataclass(frozen=True)
class Placement:
    """The consts of an env without a pool (diffusion, advection, Laplace):
    only where and in which dtype its envs live."""

    device: torch.device
    dtype: torch.dtype


def placement(consts):
    """(device, dtype) of an env's consts; raises where they carry neither."""
    device, dtype = getattr(consts, "device", None), getattr(consts, "dtype", None)
    if device is None or dtype is None:
        raise ValueError(f"[rollout] the env's consts {type(consts).__name__} carry no "
                         f"device and dtype")
    return device, dtype


def _fields(state):
    """(u, ektt or None) of a state after a step: the solved field, and for
    spectral envs (a running ``ek_sum``) the cumulative-mean spectrum."""
    u = state.u if hasattr(state, "u") else state.solver.u
    if not hasattr(state, "ek_sum"):
        return u, None
    io = state.ioutnum if hasattr(state, "ioutnum") else state.solver.ioutnum
    return u, state.ek_sum / (io + 1).to(u.dtype)[..., None]


class MacroStep:
    """One macro-step of a batch of envs, in place on buffers that it owns: the
    policy acts on ``obs``, the env steps ``state``, the results go to index
    ``t`` (a device scalar) of the (B, T, ...) trajectory buffers, and the new
    state and observation are copied into ``state`` and ``obs``.  The body of
    the collection's loop: called directly (on the CPU, or on the card inside
    ``graphs.eager()``), or captured once and replayed as a CUDA graph, which
    needs exactly this: fixed buffers, and an index that the step itself
    advances on the device.

    ``ts`` is the policy's train state; the graph's own copy of it holds the
    observation normalizer in buffers that each collection copies into
    (``observe_episodes`` makes new ones every generation)."""

    def __init__(self, env: Env, rl_cfg, ts, generator, state, obs, deterministic: bool,
                 record_fields: bool, consts):
        B, T, na = obs.shape[0], env.episode_length, env.num_agents
        self.rl_cfg, self.ts, self.generator = rl_cfg, ts, generator
        self.deterministic, self.consts = deterministic, consts
        self.env_step = env.batch_step if env.whole_batch else env.step
        self.state, self.obs = state, obs
        self.t = torch.zeros((), dtype=torch.int64, device=obs.device)
        kw = dict(dtype=obs.dtype, device=obs.device)
        self.traj = dict(
            obs=torch.zeros((B, T, na, env.obs_dim), **kw),
            actions=torch.zeros((B, T, na, env.act_dim), **kw),
            mu=torch.zeros((B, T, na, env.act_dim), **kw),
            sigma=torch.zeros((B, T, na, env.act_dim), **kw),
            rewards=torch.zeros((B, T, na), **kw),
            mask=torch.zeros((B, T), **kw))
        self.blown = torch.zeros((B, T), dtype=torch.bool, device=obs.device)
        self.recorded = {}
        if record_fields:
            for name, x in zip(("fields", "ektt"), _fields(state)):
                if x is not None:
                    self.recorded[name] = torch.zeros((B, T) + tuple(x.shape[1:]),
                                                      dtype=x.dtype, device=x.device)

    def _put(self, buf, x):
        buf.index_copy_(1, self.t.view(1), x.unsqueeze(1).to(buf.dtype))

    def __call__(self):
        cfg = self.rl_cfg
        if self.deterministic:
            _, mu, sigma = vracer.policy_apply(cfg, self.ts, self.obs)
            a = torch.clamp(mu, cfg.action_low, cfg.action_high)
        else:
            a, mu, sigma = vracer.act(cfg, self.ts, self.obs, self.generator)
        self._put(self.traj["mask"], ~self.state.done)
        state, obs_next, rew, _, info = self.env_step(self.consts, self.state, a)
        for name, x in (("obs", self.obs), ("actions", a), ("mu", mu), ("sigma", sigma),
                        ("rewards", rew)):
            self._put(self.traj[name], x)
        self._put(self.blown, info["blown"])
        if self.recorded:
            for name, x in zip(("fields", "ektt"), _fields(state)):
                if name in self.recorded:
                    self._put(self.recorded[name], x)
        graphs.copy_((self.state, self.obs), (state, obs_next))
        self.t.add_(1)

    def result(self, copy: bool):
        """(traj, final state); copies of the buffers when ``copy`` (a graph
        overwrites its buffers at the next collection)."""
        c = graphs.clone if copy else (lambda x: x)
        traj = {k: c(v) for k, v in self.traj.items()}
        # Truncated-vs-Terminal bookkeeping (burger_environment.py:198-204): a
        # numeric blowup ends the episode "Truncated" and the learner bootstraps
        # from V(final_obs); envs freeze once done, so final_obs is the
        # observation at truncation time
        traj["truncated"] = self.blown.any(dim=1)
        traj["final_obs"] = c(self.obs)
        traj.update({k: c(v) for k, v in self.recorded.items()})
        return traj, c(self.state)


def _graphed_collection(env: Env, rl_cfg, ts, generator, state, obs, deterministic,
                        record_fields, consts):
    """The MacroStep captured for (env, consts, generator, batch, mode, RL
    config) on this network, reset to ``state``/``obs``; the first collection
    of a key runs its first macro-step for real (the capture's warm-up).  The
    step reads ``rl_cfg`` by value (the action bounds, the observation
    scaling), so the config is part of the key: it is a frozen dataclass,
    equal and hashed field by field."""
    key = ("collect", rl_cfg, obs.shape[0], env.episode_length, deterministic, record_fields,
           graphs.pointers(list(ts.net.parameters())), graphs.pointers(consts))
    # a deterministic step draws nothing: any generator replays it
    generators = [] if deterministic or generator is None else [generator]
    objects = (ts.net, env, consts, *generators)
    hit = graphs.cached(key, objects)
    if hit is not None:
        step, graph = hit
        graphs.copy_((step.state, step.obs, step.ts.obs_stats), (state, obs, ts.obs_stats))
        step.t.zero_()
        return step, graph, 0
    static_ts = dataclasses.replace(ts, obs_stats=graphs.clone(ts.obs_stats))
    step = MacroStep(env, rl_cfg, static_ts, generator, graphs.clone(state), graphs.clone(obs),
                     deterministic, record_fields, consts)
    _, graph = graphs.capture(f"{env.name} macro-step", step, obs.device, generators)
    graphs.store(key, objects, (step, graph))
    return step, graph, 1


def collect_episodes(env: Env, rl_cfg, ts, generator, batch_size: int,
                     episode_base: int = 0, deterministic: bool = False,
                     consts=None, record_fields: bool = False):
    """Roll out ``batch_size`` envs for a full episode.

    Returns (traj, final_state): traj holds (B, T, na, ...) tensors obs,
    actions, mu, sigma, rewards, and mask (B, T), truncated (B,), final_obs
    (B, na, obs_dim) — ready for the replays.  ``generator`` draws the reset
    offsets and the action noise.  ``record_fields`` also records the solved
    field ``fields`` (B, T, N) after each step and, for spectral envs, the
    cumulative-mean energy spectrum ``ektt`` (B, T, N): the contents of the
    reference's save-episode npz (burger_environment.py:207-238: sgs_u /
    sgs_Ektt); the replays ignore both.

    The reset runs eagerly; on the card the T macro-steps are replays of one
    captured ``MacroStep`` (utils/graphs.py), elsewhere direct calls of it."""
    consts = env.consts if consts is None else consts
    device = ts.beta.device
    counts = episode_base + torch.arange(batch_size, device=device)
    state, obs = env.reset_batch(consts, generator, counts)
    T = env.episode_length
    if graphs.enabled(obs.device):
        step, graph, done = _graphed_collection(env, rl_cfg, ts, generator, state, obs,
                                                deterministic, record_fields, consts)
        for _ in range(T - done):
            graph.replay()
        return step.result(copy=True)
    step = MacroStep(env, rl_cfg, ts, generator, graphs.clone(state), graphs.clone(obs),
                     deterministic, record_fields, consts)
    for _ in range(T):
        step()
    return step.result(copy=False)


def zero_action_episode(env: Env, generator, batch_size: int = 1, episode_base: int = 0,
                        consts=None):
    """The reference's korali-free smoke loop (tests/burger/loop.py:99-135): a
    full episode of zero actions through the general pair; returns
    (traj dict of (B, T, ...) obs, rewards, done; final states)."""
    consts = env.consts if consts is None else consts
    device = placement(consts)[0]
    counts = episode_base + torch.arange(batch_size, device=device)
    state, obs = env.reset(consts, generator, counts)
    zero = torch.zeros((batch_size, env.num_agents, env.act_dim), dtype=obs.dtype,
                       device=obs.device)
    out = dict(obs=[], rewards=[], done=[])
    for _ in range(env.episode_length):
        state, obs_next, rew, done, _info = env.step(consts, state, zero)
        out["obs"].append(obs)
        out["rewards"].append(rew)
        out["done"].append(done)
        obs = obs_next
    return {k: torch.stack(v, dim=1) for k, v in out.items()}, state
