"""Faults planted under the timed path, to show that the check catches them
(``run.py --fault <name>`` on the card; ``benchmark/tests/test_bench_runs.py``
on the CPU).  The benchmark's own runs plant none.

  unchanged    the updates return the state unchanged
  half_batch   half of every batch left out and the mean taken over the
               rest: the second half of the generation's episodes replaced by
               the first before the insert, and of every update's minibatch
  altered      answers altered where they are produced, by a relative 1e-3:
               the initial weights' first leaf, the policy's mean from the
               MLP op, and the env step's rewards

The exchange between chips, the fourth fault of a training cell, has no
place here: every cell runs on one chip.
"""

from __future__ import annotations

import functools

NAMES = ("unchanged", "half_batch", "altered")
SCALE = 1.0 + 1e-3


def _halved(x):
    """x with its second half (along dim 0) replaced by its first half."""
    import torch

    n = x.shape[0]
    return torch.cat([x[:n - n // 2], x[:n // 2]])


def install(name: str, patches):
    """Plant fault ``name`` through ``patches`` (a ``bench_trace.Patches``)."""
    import torch

    from marlpde_tpu_torch.envs import burger_fast, ks_env
    from marlpde_tpu_torch.kernels import mlp
    from marlpde_tpu_torch.rl import replay as replay_mod
    from marlpde_tpu_torch.rl import replay_flat, vracer
    from marlpde_tpu_torch.train import trainer

    if name == "unchanged":
        patches.wrap(trainer, "run_updates", lambda fn: (
            lambda rl_cfg, ts, rep, generator, n, *a, **kw: (ts, rep, {})))
    elif name == "half_batch":
        def make_insert(fn):
            def insert(rl_cfg, ts, rep, traj):
                return fn(rl_cfg, ts, rep, {k: _halved(v) for k, v in traj.items()})
            return insert

        def make_ids(fn):
            def ids(rep, generator, n):
                return _halved(fn(rep, generator, n))
            return ids

        def make_episodes(fn):
            def episodes(rep, generator, n):
                return {k: _halved(v) for k, v in fn(rep, generator, n).items()}
            return episodes

        patches.wrap(trainer, "insert_generation", make_insert)
        patches.wrap(replay_flat, "sample_ids", make_ids)
        patches.wrap(replay_mod, "sample_episodes", make_episodes)
    elif name == "altered":
        def make_init(fn):
            @functools.wraps(fn)
            def init(*a, **kw):
                ts = fn(*a, **kw)
                with torch.no_grad():
                    next(ts.net.parameters()).mul_(SCALE)
                return ts
            return init

        def make_mlp(fn):
            @functools.wraps(fn)
            def forward(*a, **kw):
                V, mu, sigma = fn(*a, **kw)
                return V, mu * SCALE, sigma
            return forward

        def make_step(fn):
            @functools.wraps(fn)
            def step(*a, **kw):
                state, obs, reward, done, info = fn(*a, **kw)
                return state, obs, reward * SCALE, done, info
            return step

        patches.wrap(vracer, "init_train", make_init)
        patches.wrap(mlp, "mlp_forward", make_mlp)
        patches.wrap(burger_fast, "step", make_step)
        patches.wrap(ks_env, "step", make_step)
    else:
        raise SystemExit(f"[bench] unknown fault {name!r}; one of {NAMES}")
