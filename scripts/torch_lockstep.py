"""Run 918's training loop in both packages in lockstep: the same action noise
and the same minibatch draws through the JAX package's ``trainer.train`` and
the port's, from the same weights, so that everything else in the loop (the
collection with its sampled and clipped actions, the normalizers, the replay
insert with its retrace values, korali's ledger, every update with its
refreshes, the REFER beta, the clip and Adam) must agree up to rounding.

The tape is never stored: both halves regenerate it from ``--tape-seed``
(``Tape``).  It holds one array of standard normals ``z`` shaped like ``mu``
for each ``act`` call and one array of uniforms ``p`` in [0, 1) for each
minibatch draw.  Each half patches only its package's draw sites, through
the module attributes the package calls them by:

- ``distributions.sample`` becomes ``clip(mu + sigma * z)`` (in the port
  ``distributions.sample_from_noise``);
- ``replay_flat.sample_ids`` becomes ``cursor - live + floor(p * max(live, 1))``
  and, in episode mode, ``replay.sample_episodes`` gathers the slots
  ``floor(p * max(filled, 1))``.

``mu``, ``sigma``, ``cursor``, ``live`` and ``filled`` are each package's
own; ``floor(p * n)`` is taken on the host in float64 for both, so the ids are
equal whenever the counters are.  Each half counts its draws at each site, and the
port's generator must end where its seed put it (no draw went around the tape).

The JAX half runs ``marlpde_tpu.train.trainer.train`` as it stands, jitted,
and feeds the tape through ``jax.experimental.io_callback(..., ordered=True)``:
under ``jax.disable_jit()`` every operation of run 918's 2500 updates and
2500 macro-steps would dispatch on its own from Python, far too slow at full
width, and the compiled programs are what the JAX package runs.  The torch
half runs ``marlpde_tpu_torch.train.trainer.train`` under ``graphs.eager()``
(a graph replay runs no Python and cannot read the tape; the graphs are held
bit for bit against eager elsewhere).  Each half imports one package only.

Both start from the same weights (a flax-layout tree; run 918's are the JAX
package's seed-42 draw in scripts/jax_init_918.npz) and build the workload
through their ``run.make_workload`` from the same flags.  Each records, per
generation, the mean return, ep_len, the updates taken, the blow-ups, the
reward scale, the replay's cursor, the last update's metrics and a sample of
the generation's replay rows; the metrics of each of the first ``n_upd_rec``
updates; and at the end every parameter, Adam moment and normalizer.

scripts/lockstep_918.npz is run 918 at its full widths (10 envs x 500
macro-steps, 32 agents, N=32, width 128, experience mode at mbsize 8,
rstart 20000, maxupd 2500), 5 generations (4 fill the replay, the 5th takes
korali's 2500 updates), tape seed 0, in float32: the JAX package's run
(``jax/``) and the port's on the CPU (``cpu/``, the yardstick of float32
drift).  Regenerate it, on a CPU, with

    env JAX_PLATFORMS=cpu python3 scripts/torch_lockstep.py jax
    python3 scripts/torch_lockstep.py torch --device cpu --yardstick

and hold the port on the card against it with

    python3 scripts/torch_lockstep.py torch --device cuda

The same run in float64 with float64 replays, every update recorded, in each
package and in the JAX package from weights one ulp apart (``--nudge``),
then each run's per-update gap against the JAX run (``drift``):

    env JAX_PLATFORMS=cpu python3 scripts/torch_lockstep.py jax --dtype float64 \
        --replay-in-dtype --updates 2500 --out jax64.npz [--nudge]
    python3 scripts/torch_lockstep.py torch --device cpu --dtype float64 \
        --replay-in-dtype --updates 2500 --out torch64.npz
    python3 scripts/torch_lockstep.py drift jax64.npz torch64.npz
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
from torch_jax_init import FLAGS_918, TRAIN_918  # noqa: E402
from torch_jax_init import _params as weights_918  # noqa: E402  (flax layout, by seed)

NPZ = os.path.join(HERE, "lockstep_918.npz")
ARGV_918 = FLAGS_918 + TRAIN_918
GENS_918 = 5
ROWS_918 = 4           # replay rows kept per generation in the npz
UPD_REC = 200          # updates whose metrics are recorded one by one
ROW_FIELDS = ("obs", "actions", "mu", "sigma", "rewards")


class Tape:
    """The draws of a lockstep run, regenerated from ``seed``: a stream of
    standard normals and a stream of uniforms, each consumed in call order,
    and a count of the draws at each site."""

    def __init__(self, seed: int):
        self.z = np.random.default_rng([seed, 0])
        self.p = np.random.default_rng([seed, 1])
        self.counts = dict(noise=0, ids=0, episodes=0)

    def noise(self, shape):
        self.counts["noise"] += 1
        return self.z.standard_normal(tuple(shape))

    def slots(self, site: str, n: int, bound) -> np.ndarray:
        """floor(p * max(bound, 1)) for n fresh uniforms p, in float64."""
        self.counts[site] += 1
        return np.floor(self.p.random(n) * max(int(bound), 1)).astype(np.int64)


class _Done(Exception):
    """Raised by the generation callback after the last generation."""


class Recorder:
    """What a half records; ``arrays()`` flattens it to the npz layout.  Only
    the first ``n_upd_rec`` updates are read back."""

    def __init__(self, n_gens: int, rows_per_gen: int, n_upd_rec: int):
        self.n_gens, self.rows_per_gen, self.n_upd_rec = n_gens, rows_per_gen, n_upd_rec
        self.gens, self.updates, self.final = [], [], {}

    def update(self, metrics: dict):
        if len(self.updates) < self.n_upd_rec:
            self.updates.append({k: float(v) for k, v in metrics.items()})

    def generation(self, history, blowups, rew_scale, cursor, n_updates, block):
        """``block``: this generation's replay rows (numpy, rows leading)."""
        n = len(block["obs"])
        idx = (np.arange(self.rows_per_gen) * n) // self.rows_per_gen
        self.gens.append(dict(
            mean_return=history["mean_return"][-1], ep_len=history["mean_ep_len"][-1],
            n_upd=history["updates"][-1], blowups=int(blowups), rew_scale=float(rew_scale),
            cursor=int(cursor), n_updates=int(n_updates), metrics=dict(history["metrics"][-1]),
            rows={f: block[f][idx] for f in ROW_FIELDS},
            absum={f: float(np.abs(block[f].astype(np.float64)).sum()) for f in ROW_FIELDS}))
        return len(self.gens) == self.n_gens

    def arrays(self, prefix: str, counts: dict) -> dict:
        out = {}
        for k in ("mean_return", "ep_len", "n_upd", "blowups", "rew_scale", "cursor",
                  "n_updates"):
            out[f"gen/{k}"] = np.array([g[k] for g in self.gens], dtype=np.float64)
        names = sorted({k for g in self.gens for k in g["metrics"]})
        for k in names:
            out[f"gen/metrics/{k}"] = np.array([g["metrics"].get(k, np.nan)
                                                for g in self.gens])
        for f in ROW_FIELDS:
            out[f"gen/rows/{f}"] = np.stack([g["rows"][f] for g in self.gens])
            out[f"gen/absum/{f}"] = np.array([g["absum"][f] for g in self.gens])
        for k in sorted({k for u in self.updates for k in u}):
            out[f"upd/{k}"] = np.array([u.get(k, np.nan) for u in self.updates])
        out.update({f"final/{k}": v for k, v in self.final.items()})
        out.update({f"draws/{k}": np.array(v) for k, v in counts.items()})
        return {f"{prefix}/{k}": v for k, v in out.items()}


def flat_tree(tree, prefix):
    """A flax-layout {"params": {layer: {name: array}}} tree as flat keys."""
    p = tree["params"] if "params" in tree else tree
    return {f"{prefix}/{layer}/{name}": np.asarray(a)
            for layer, leaves in p.items() for name, a in leaves.items()}


# ------------------------------------------------------------------ the JAX half

def jax_run(argv, params, *, tape_seed=0, n_gens=GENS_918, dtype="float32",
            rows_per_gen=ROWS_918, n_upd_rec=UPD_REC, pool=None, replay_in_dtype=False,
            env_overrides=None):
    """The JAX package's ``trainer.train`` on the tape: returns (records, env,
    seconds).  ``pool`` replaces the env's DNS pool (a pool object of the
    package), ``env_overrides`` are env config fields the flags do not reach.
    ``replay_in_dtype`` hands ``train`` a replay in ``dtype``
    (``init_replay``) in place of the trainer's float32 one."""
    import jax
    import jax.numpy as jnp
    from jax.experimental import io_callback

    from marlpde_tpu import run
    from marlpde_tpu.envs import registry
    from marlpde_tpu.rl import distributions as D
    from marlpde_tpu.rl import replay as replay_mod
    from marlpde_tpu.rl import replay_flat, running_stats, vracer
    from marlpde_tpu.train import trainer

    jdt = getattr(jnp, dtype)
    tape = Tape(tape_seed)
    rec = Recorder(n_gens, rows_per_gen, n_upd_rec)

    def sample(key, mu, sigma, lb, ub):
        z = io_callback(lambda: tape.noise(mu.shape).astype(mu.dtype),
                        jax.ShapeDtypeStruct(mu.shape, mu.dtype), ordered=True)
        return jnp.clip(mu + sigma * z, lb, ub)

    def sample_ids(rep, key, n):
        u = io_callback(lambda live: tape.slots("ids", n, live).astype(rep.cursor.dtype),
                        jax.ShapeDtypeStruct((n,), rep.cursor.dtype), rep.live, ordered=True)
        return rep.cursor - rep.live + u

    def sample_episodes(rep, key, n):
        idx = io_callback(lambda filled: tape.slots("episodes", n, filled).astype(np.int32),
                          jax.ShapeDtypeStruct((n,), jnp.int32), rep.filled, ordered=True)
        return {f.name: getattr(rep, f.name)[idx] for f in dataclasses.fields(rep)
                if f.name not in ("filled", "cursor")}

    def recorded(update):
        def wrapped(*a, **kw):
            out = update(*a, **kw)
            io_callback(rec.update, None, out[-1], ordered=True)
            return out
        return wrapped

    make_env = registry.make_env

    def make_env_here(name, **kw):
        if pool is not None:
            kw["pool"] = pool
        return make_env(name, dtype=jdt, **kw, **(env_overrides or {}))

    patches = [(D, "sample", sample), (replay_flat, "sample_ids", sample_ids),
               (replay_mod, "sample_episodes", sample_episodes),
               (vracer, "update_experience", recorded(vracer.update_experience)),
               (vracer, "update", recorded(vracer.update)),
               (registry, "make_env", make_env_here)]
    with _patched(patches):
        env, rl_cfg, tc = run.make_workload(run.build_parser().parse_args(argv))
        ts = vracer.init_train(rl_cfg, jax.random.key(0), dtype=jdt)
        p = jax.tree.map(lambda a: jnp.asarray(a, jdt), params)
        ts = ts.replace(params=p, opt_state=vracer.make_optimizer(rl_cfg).init(p))
        exp_mode = rl_cfg.minibatch_mode == "experience"
        rep0 = None
        if replay_in_dtype and exp_mode:
            rep0 = replay_flat.init_flat(rl_cfg.replay_max_experiences,
                                         rl_cfg.flat_episode_capacity, env.num_agents,
                                         env.obs_dim, env.act_dim, dtype=jdt)
        elif replay_in_dtype:
            rep0 = replay_mod.init(rl_cfg.replay_capacity_episodes, env.episode_length,
                                   env.num_agents, env.obs_dim, env.act_dim, dtype=jdt)
        prev = dict(cursor=0)

        def callback(gen, ts_, rep, history):
            if exp_mode:
                c0, c1 = prev["cursor"], int(rep.cursor)
                slots = jnp.asarray(np.arange(c0, c1) % rep.capacity)
                es = (int(rep.n_episodes) - tc.num_envs + np.arange(tc.num_envs)) \
                    % rep.ep_capacity
                blowups = int(np.asarray(rep.truncated_ep)[es].sum())
                block = {f: np.asarray(getattr(rep, f)[slots]) for f in ROW_FIELDS}
                prev["cursor"] = c1
            else:
                slots = (int(rep.cursor) - tc.num_envs + np.arange(tc.num_envs)) \
                    % rep.capacity
                blowups = int(np.asarray(rep.truncated)[slots].sum())
                block = {f: _steps(np.asarray(getattr(rep, f)[jnp.asarray(slots)]))
                         for f in ROW_FIELDS}
            last = rec.generation(history, blowups,
                                  np.asarray(running_stats.second_moment(ts_.rew_stats)),
                                  int(rep.cursor), int(ts_.n_updates), block)
            if last:
                rec.final = _jax_final(ts_)
                raise _Done

        t0 = time.time()
        try:
            trainer.train(env, rl_cfg, tc, verbose=False, callback=callback, init_ts=ts,
                          init_replay=rep0)
        except _Done:
            pass
        else:
            raise RuntimeError("[lockstep] the JAX run ended before its last generation")
    seconds = time.time() - t0
    print(f"[lockstep] jax half: {n_gens} generations in {seconds:.1f} s, "
          f"draws {tape.counts}", flush=True)
    return rec.arrays("jax", tape.counts), env, seconds


def _steps(a):
    """(B, T, ...) episode-ring fields -> (B*T, ...) rows."""
    return a.reshape((-1,) + a.shape[2:])


def _jax_final(ts):
    adam = ts.opt_state[1][0]
    out = {**flat_tree(ts.params, "params"), **flat_tree(adam.mu, "adam_mu"),
           **flat_tree(adam.nu, "adam_nu"), "adam_count": np.asarray(adam.count),
           "beta": np.asarray(ts.beta)}
    for s in ("obs_stats", "rew_stats"):
        for f in ("mean", "m2", "count"):
            out[f"{s}/{f}"] = np.asarray(getattr(getattr(ts, s), f))
    return out


@contextlib.contextmanager
def _patched(patches):
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in patches]
    try:
        for mod, name, fn in patches:
            setattr(mod, name, fn)
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


# ---------------------------------------------------------------- the torch half

def torch_run(argv, params, *, device="cuda", tape_seed=0, n_gens=GENS_918,
              dtype="float32", rows_per_gen=ROWS_918, n_upd_rec=UPD_REC, pool=None,
              replay_in_dtype=False, env_overrides=None):
    """The port's ``trainer.train`` on the tape, under ``graphs.eager()``:
    returns (records, env, seconds).  ``pool``: {field: numpy array} of the
    JAX package's KS pool, carried into the env.
    ``replay_in_dtype`` and ``env_overrides`` as in ``jax_run``."""
    import torch

    from marlpde_tpu_torch import run
    from marlpde_tpu_torch.envs import registry
    from marlpde_tpu_torch.rl import distributions as D
    from marlpde_tpu_torch.rl import networks, running_stats, vracer
    from marlpde_tpu_torch.rl import replay as replay_mod
    from marlpde_tpu_torch.rl import replay_flat
    from marlpde_tpu_torch.train import trainer
    from marlpde_tpu_torch.utils import graphs

    tdt = getattr(torch, dtype)
    tape = Tape(tape_seed)
    rec = Recorder(n_gens, rows_per_gen, n_upd_rec)
    seen = []                                  # the generators the draw sites were given

    def given(generator):
        if not any(g is generator for g in seen):
            seen.append(generator)

    def sample(generator, mu, sigma, lb, ub):
        given(generator)
        z = torch.from_numpy(tape.noise(mu.shape)).to(device=mu.device, dtype=mu.dtype)
        return D.sample_from_noise(z, mu, sigma, lb, ub)

    def slots(site, n, bound, generator):
        """The tape's slots below the device counter ``bound``, on its device."""
        given(generator)
        return torch.from_numpy(tape.slots(site, n, int(bound))).to(bound.device)

    def sample_ids(rep, generator, n):
        cursor, live = rep.counters[0], rep.counters[1]
        return (cursor - live) + slots("ids", n, live, generator)

    def sample_episodes(rep, generator, n):
        idx = slots("episodes", n, rep.counters[0], generator)
        return {name: getattr(rep, name)[idx] for name in replay_mod._FIELDS}

    def recorded(update):
        def wrapped(*a, **kw):
            out = update(*a, **kw)
            rec.update(out[-1])
            return out
        return wrapped

    make_env = registry.make_env

    def make_env_here(name, **kw):
        if pool is not None:
            kw["pool"] = _ks_pool(pool, tdt, kw.get("device"))
        return make_env(name, dtype=tdt, **kw, **(env_overrides or {}))

    patches = [(D, "sample", sample), (replay_flat, "sample_ids", sample_ids),
               (replay_mod, "sample_episodes", sample_episodes),
               (vracer, "update_experience", recorded(vracer.update_experience)),
               (vracer, "update", recorded(vracer.update)),
               (registry, "make_env", make_env_here)]
    with _patched(patches), graphs.eager():
        env, rl_cfg, tc = run.make_workload(run.build_parser().parse_args(argv), device)
        ts = vracer.init_train(rl_cfg, torch.Generator(device=env.device).manual_seed(0),
                               dtype=tdt, device=env.device)
        ts.net.load_state_dict({k: v.to(device=env.device, dtype=tdt) for k, v in
                                networks.params_from_flax(params).items()})
        exp_mode = rl_cfg.minibatch_mode == "experience"
        rep0 = None
        if replay_in_dtype and exp_mode:
            rep0 = replay_flat.init_flat(rl_cfg.replay_max_experiences,
                                         rl_cfg.flat_episode_capacity, env.num_agents,
                                         env.obs_dim, env.act_dim, dtype=tdt, device=env.device)
        elif replay_in_dtype:
            rep0 = replay_mod.init(rl_cfg.replay_capacity_episodes, env.episode_length,
                                   env.num_agents, env.obs_dim, env.act_dim, dtype=tdt,
                                   device=env.device)
        prev = dict(cursor=0)
        dev = env.device

        def callback(gen, ts_, rep, history):
            if exp_mode:
                c0, c1 = prev["cursor"], rep.cursor
                slots_ = torch.as_tensor(np.arange(c0, c1) % rep.capacity, device=dev)
                es = torch.as_tensor((rep.n_episodes - tc.num_envs + np.arange(tc.num_envs))
                                     % rep.ep_capacity, device=dev)
                blowups = int(rep.truncated_ep[es].sum())
                block = {f: getattr(rep, f)[slots_].cpu().numpy() for f in ROW_FIELDS}
                prev["cursor"] = c1
            else:
                s = torch.as_tensor((rep.cursor - tc.num_envs + np.arange(tc.num_envs))
                                    % rep.capacity, device=dev)
                blowups = int(rep.truncated[s].sum())
                block = {f: _steps(getattr(rep, f)[s].cpu().numpy()) for f in ROW_FIELDS}
            last = rec.generation(history, blowups,
                                  float(running_stats.second_moment(ts_.rew_stats)),
                                  rep.cursor, ts_.n_updates, block)
            if last:
                rec.final = _torch_final(rl_cfg, ts_)
                raise _Done

        t0 = time.time()
        try:
            trainer.train(env, rl_cfg, tc, verbose=False, callback=callback, init_ts=ts,
                          init_replay=rep0)
        except _Done:
            pass
        else:
            raise RuntimeError("[lockstep] the port's run ended before its last generation")
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    fresh = torch.Generator(device=dev).manual_seed(tc.seed).get_state()
    unmoved = len(seen) == 1 and bool(torch.equal(seen[0].get_state(), fresh))
    seconds = time.time() - t0
    print(f"[lockstep] torch half ({dev}, {dtype}): {n_gens} generations in {seconds:.1f} s, "
          f"draws {tape.counts}, generator unmoved {unmoved}", flush=True)
    out = rec.arrays("torch", {**tape.counts, "generators": len(seen),
                               "generator_unmoved": int(unmoved)})
    return out, env, seconds


def _ks_pool(arrays, dtype, device):
    """The JAX package's KS pool ({field: numpy array}, v0 split into v0_re
    and v0_im) as the port's, on ``device``."""
    import torch

    from marlpde_tpu_torch.envs import ks_env
    arrays = dict(arrays, v0=arrays["v0_re"] + 1j * arrays["v0_im"])
    cdt = torch.complex128 if dtype == torch.float64 else torch.complex64
    kw = {}
    for f in dataclasses.fields(ks_env.KSDnsPool):
        t = torch.from_numpy(np.array(arrays[f.name]))
        kw[f.name] = t.to(device=device, dtype=cdt if t.is_complex() else dtype)
    return ks_env.KSDnsPool(**kw)


def _torch_final(cfg, ts):
    from marlpde_tpu_torch.rl import networks, vracer
    out = flat_tree(networks.params_to_flax(ts.net), "params")
    names = [n for n, _ in ts.net.named_parameters()]
    state = [ts.opt.state[p] for p in ts.net.parameters()]
    for key, prefix in (("exp_avg", "adam_mu"), ("exp_avg_sq", "adam_nu")):
        fake = vracer.make_net(cfg, dtype=ts.beta.dtype)
        fake.load_state_dict({n: s[key].detach().cpu() for n, s in zip(names, state)})
        out.update(flat_tree(networks.params_to_flax(fake), prefix))
    out["adam_count"] = np.asarray(int(state[0]["step"]))
    out["beta"] = ts.beta.detach().cpu().numpy()
    for s in ("obs_stats", "rew_stats"):
        for f in ("mean", "m2", "count"):
            out[f"{s}/{f}"] = getattr(getattr(ts, s), f).detach().cpu().numpy()
    return out


# ------------------------------------------------------------------ comparisons

def strip(d, prefix):
    """The records under ``prefix/`` without it."""
    return {k[len(prefix) + 1:]: v for k, v in d.items() if k.startswith(prefix + "/")}


def gap(got, want):
    """Normwise relative gap max|got - want| / max|want| of two arrays, over
    their finite entries; inf where the non-finite entries or the shapes
    differ.  0 for two all-zero arrays."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if got.shape != want.shape:
        return np.inf
    fin = np.isfinite(want)
    if not np.array_equal(fin, np.isfinite(got)) or not np.array_equal(
            got[~fin], want[~fin], equal_nan=True):
        return np.inf
    if not fin.any():
        return 0.0
    scale = np.abs(want[fin]).max()
    diff = np.abs(got[fin] - want[fin]).max()
    return float(diff / scale) if scale > 0 else float(diff)


def gaps(got: dict, want: dict, keys) -> dict:
    """{key: gap} over ``keys``; a key missing from ``got`` is inf."""
    return {k: (gap(got[k], want[k]) if k in got else np.inf) for k in keys}


LOSS_TERMS = ("loss", "v_loss", "pg_loss", "kl_loss")


def update_gaps(got: dict, want: dict) -> np.ndarray:
    """Per recorded update, the largest gap of its loss terms, each term's
    |got - want| over the larger of |want| and the total loss's |want| (a
    term near 0, as pg_loss becomes, is measured against the loss)."""
    n = min(len(got["upd/loss"]), len(want["upd/loss"]))
    total = np.abs(np.asarray(want["upd/loss"][:n]))
    per = [np.abs(np.asarray(got[f"upd/{k}"][:n]) - np.asarray(want[f"upd/{k}"][:n]))
           / np.maximum(np.maximum(np.abs(np.asarray(want[f"upd/{k}"][:n])), total), 1e-30)
           for k in LOSS_TERMS]
    return np.max(np.stack(per), axis=0)


def final_gaps(got: dict, want: dict) -> dict:
    """``gaps`` of the final train states (unprefixed ``final/`` records),
    the normalizers' means measured against their standard deviation
    sqrt(m2 / count): a mean near 0 has no relative gap of its own."""
    out = gaps(got, want, [k for k in want if not k.endswith("_stats/mean")])
    for s in ("obs_stats", "rew_stats"):
        std = np.sqrt(np.asarray(want[f"{s}/m2"], np.float64)
                      / np.maximum(np.asarray(want[f"{s}/count"], np.float64), 1.0))
        diff = np.abs(np.asarray(got[f"{s}/mean"], np.float64)
                      - np.asarray(want[f"{s}/mean"], np.float64))
        out[f"{s}/mean"] = float(np.max(diff / np.maximum(std, 1e-30)))
    return out


# ------------------------------------------------------------------------- main

def _meta(args):
    return dict(argv=ARGV_918, weights_seed=args.weights_seed, tape_seed=args.tape_seed,
                dtype=args.dtype, generations=GENS_918, updates=args.updates,
                replay_in_dtype=args.replay_in_dtype, nudge=args.nudge)


def _weights(args):
    """Run 918's weights; ``--nudge`` raises every first-layer weight by one
    float64 ulp (a control: how fast training parts two runs of one code
    that start a rounding apart)."""
    params = weights_918(args.weights_seed)
    if args.nudge:
        params["params"]["Dense_0"] = {k: np.asarray(v, np.float64) * (1.0 + 2.0 ** -52)
                                       for k, v in params["params"]["Dense_0"].items()}
    return params


def run_kwargs(meta):
    """``jax_run``/``torch_run`` keywords of a record's meta."""
    return dict(tape_seed=meta["tape_seed"], dtype=meta["dtype"], n_upd_rec=meta["updates"],
                replay_in_dtype=meta["replay_in_dtype"])


def _save(path, arrays, meta):
    np.savez_compressed(path, meta=np.array(json.dumps(meta)), **arrays)
    print(f"[lockstep] wrote {path} ({os.path.getsize(path)} bytes)")


def jax_main(args):
    import jax
    jax.config.update("jax_enable_x64", args.dtype == "float64")
    meta = _meta(args)
    arrays, _, _ = jax_run(ARGV_918 + ["--seed", str(args.weights_seed)], _weights(args),
                           **run_kwargs(meta))
    _save(args.out, arrays, meta)


def torch_main(args):
    """With ``--out``: the port's run on the given settings, saved.  Else the
    port's run on ``--ref``'s settings, compared with its JAX run."""
    if args.out:
        meta = _meta(args)
        arrays, _, _ = torch_run(ARGV_918 + ["--seed", str(args.weights_seed)],
                                 _weights(args), device=args.device, **run_kwargs(meta))
        _save(args.out, arrays, meta)
        return 0
    with np.load(args.ref) as d:
        ref = {k: d[k] for k in d.files}
    meta = json.loads(str(ref["meta"]))
    arrays, _, _ = torch_run(meta["argv"] + ["--seed", str(meta["weights_seed"])],
                             weights_918(meta["weights_seed"]), device=args.device,
                             **run_kwargs(meta))
    got = strip(arrays, "torch")
    report = compare_918(got, ref)
    print(json.dumps(report["summary"]))
    if args.yardstick:
        ref.update({"cpu/" + k: v for k, v in got.items()})
        np.savez_compressed(args.ref, **ref)
        print(f"[lockstep] added the port's CPU run to {args.ref} "
              f"({os.path.getsize(args.ref)} bytes)")
    return 0 if report["ok"] or args.yardstick else 1


def _records(path):
    """The one run a ``--out`` file holds, unprefixed."""
    with np.load(path) as d:
        prefix = next(k.split("/")[0] for k in d.files if "/" in k)
        return strip({k: d[k] for k in d.files}, prefix)


def drift_main(args):
    """Update by update, the gap of run B against run A (``update_gaps``),
    every ``--every``th, and the first update past 1e-9, 1e-6 and 1e-3."""
    a, b = _records(args.a), _records(args.b)
    per = update_gaps(b, a)
    first = {f"{t:g}": (int(np.argmax(per > t)) + 1 if (per > t).any() else None)
             for t in (1e-9, 1e-6, 1e-3)}
    print(json.dumps(dict(updates=len(per), worst=float(per.max()), first_past=first,
                          final=final_gaps(strip(b, "final"), strip(a, "final")),
                          every=args.every,
                          gaps=[float(x) for x in per[::args.every]])))


# float32 tolerances of the card against the JAX package's CPU run of run 918
# (the normwise relative gap of each recorded array; ``update_gaps`` for the
# updates), about 10 times the port's CPU float32 run's gaps (8.0e-5 over
# generations 1-4, the replay rows' mu; 1.9e-4 over the first 10 updates):
# generations 1-4 have no updates, so only the collection's rounding parts
# them; the first updates of generation 5 start from those replays
TOL_COLLECT = 1e-3
TOL_FIRST_UPDATES = 2e-3
FIRST_UPDATES = 10


def compare_918(got: dict, ref: dict) -> dict:
    """The port's run 918 (``got``, unprefixed) against the JAX package's
    (``ref['jax/...']``), beside the port's CPU float32 run where ``ref``
    holds it: the gaps of generations 1-4 (no updates), of the first updates
    of generation 5 and update by update."""
    want = strip(ref, "jax")
    cpu = strip(ref, "cpu") or None
    n_fill = GENS_918 - 1
    fill = {}
    for k in ("mean_return", "ep_len", "n_upd", "blowups", "cursor"):
        fill[k] = gap(got[f"gen/{k}"][:n_fill], want[f"gen/{k}"][:n_fill])
    for f in ROW_FIELDS:
        fill[f"rows/{f}"] = gap(got[f"gen/rows/{f}"][:n_fill], want[f"gen/rows/{f}"][:n_fill])
        fill[f"absum/{f}"] = gap(got[f"gen/absum/{f}"][:n_fill],
                                 want[f"gen/absum/{f}"][:n_fill])
    per_update = update_gaps(got, want)
    yard = update_gaps(cpu, want) if cpu is not None else None
    first = float(per_update[:FIRST_UPDATES].max())
    exceeds = None
    if yard is not None:
        n = min(len(per_update), len(yard))
        over = np.nonzero(per_update[:n] > 10.0 * np.maximum(yard[:n], 1e-30))[0]
        exceeds = int(over[0]) + 1 if len(over) else None
    final = final_gaps(strip(got, "final"), strip(want, "final"))
    last = {k: gap(got[f"gen/{k}"][n_fill:], want[f"gen/{k}"][n_fill:])
            for k in ("mean_return", "n_upd", "rew_scale", "n_updates")}
    draws = {k: (int(got[f"draws/{k}"]), int(want[f"draws/{k}"]))
             for k in ("noise", "ids", "episodes")}
    ok = (max(fill.values()) <= TOL_COLLECT and first <= TOL_FIRST_UPDATES
          and all(a == b for a, b in draws.values())
          and int(got["draws/generator_unmoved"]) == 1)
    summary = dict(
        collect_worst=max(fill.values()), collect_worst_key=max(fill, key=fill.get),
        collect_tol=TOL_COLLECT, first_updates_worst=first, first_updates=FIRST_UPDATES,
        first_updates_tol=TOL_FIRST_UPDATES,
        gen5=last, final_worst=max(final.values()), final_worst_key=max(final, key=final.get),
        update_gap_every_20=[float(x) for x in per_update[::20]],
        cpu_update_gap_every_20=(None if yard is None else [float(x) for x in yard[::20]]),
        first_update_over_10x_cpu=exceeds, draws=draws,
        generator_unmoved=int(got["draws/generator_unmoved"]), ok=bool(ok))
    return dict(ok=ok, summary=summary, fill=fill, per_update=per_update, yardstick=yard,
                final=final)


def main(argv=None):
    sys.path.insert(0, os.path.dirname(HERE))          # the packages, from a checkout
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = p.add_subparsers(dest="half", required=True)

    def run_options(q):
        q.add_argument("--weights-seed", type=int, default=42)
        q.add_argument("--tape-seed", type=int, default=0)
        q.add_argument("--dtype", default="float32")
        q.add_argument("--updates", type=int, default=UPD_REC,
                       help="updates whose metrics are recorded one by one")
        q.add_argument("--replay-in-dtype", action="store_true",
                       help="hand train a replay in --dtype (the trainers' is float32)")
        q.add_argument("--nudge", action="store_true",
                       help="raise every first-layer weight by one float64 ulp")

    j = sub.add_parser("jax", help="the JAX package's run on the CPU -> --out")
    j.add_argument("--out", default=NPZ)
    run_options(j)
    t = sub.add_parser("torch", help="the port's run against --ref, or -> --out")
    t.add_argument("--ref", default=NPZ)
    t.add_argument("--out", default=None)
    t.add_argument("--device", default="cuda")
    t.add_argument("--yardstick", action="store_true",
                   help="store this run (the CPU float32 one) in --ref as cpu/")
    run_options(t)
    d = sub.add_parser("drift", help="run b's per-update gap against run a's")
    d.add_argument("a")
    d.add_argument("b")
    d.add_argument("--every", type=int, default=20)
    args = p.parse_args(argv)
    return dict(jax=jax_main, torch=torch_main, drift=drift_main)[args.half](args)


if __name__ == "__main__":
    sys.exit(main())
