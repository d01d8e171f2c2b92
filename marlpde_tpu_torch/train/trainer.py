"""Training orchestration: generations of collection + REFER updates (port of
marlpde_tpu/train/trainer.py:35-502).

korali's generation loop (Episodes Per Generation = 10, run-vracer-burger.py:128)
becomes: collect ``num_envs`` episodes, update the normalizers and insert them
into the replay, then run gradient updates at korali's `Experiences Between
Policy Updates` economics.  Both minibatch modes are ported: episode mode
(whole-episode minibatches on the episode ring) and the korali-faithful
experience mode (uniform experiences on the flat REFER replay, the CLI
default).

The JAX package's fused and unfused paths are one generation loop here:
``train`` runs the static update count of ``updates_per_generation`` with
padded experience accounting, or korali's real-experience ledger with
``count_real_experiences``, and adds testing, checkpoints and the decay
diagnostics.  ``build_fused_generation`` keeps the JAX name for one such
generation at the static count.  On the card a generation is a handful of
device programs, as in the JAX package: the collection's macro-step and
UPDATE_CHUNK updates are CUDA graphs (utils/graphs.py), replayed T and
n / UPDATE_CHUNK times, around the eager reset, normalizer update and
replay insert.  One ``torch.Generator`` on the env's device draws the
initial weights, the reset offsets, the action noise and every minibatch;
the graphs advance it as the eager steps would.
Counters that decide control flow (replay fill, update counts, the ledger)
are host ints; the update counter and the replay's bounds also live on the
device, where the graphs read them.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Optional

import numpy as np
import torch

from marlpde_tpu_torch.envs.rollout import Env, collect_episodes
from marlpde_tpu_torch.rl import replay as replay_mod
from marlpde_tpu_torch.rl import replay_flat, running_stats, vracer
from marlpde_tpu_torch.utils import checkpoint as ckpt
from marlpde_tpu_torch.utils import graphs, profiling

# updates in one graph of ``run_updates``: the JAX package's UPDATE_CHUNK
# (marlpde_tpu/train/trainer.py:32), its updates in one compiled scan
UPDATE_CHUNK = 50
# the replays' dtype in every run (marlpde_tpu/rl/replay.py:52-53,
# replay_flat.py:87-88 and the trainer's and mesh's calls without a dtype)
REPLAY_DTYPE = torch.float32


@dataclasses.dataclass(frozen=True)
class TrainerConfig:
    """Fields, defaults and meaning as marlpde_tpu/train/trainer.py:35-80."""

    num_envs: int = 16                 # episodes per generation
    max_experiences: float = 5e5       # korali Termination Criteria (run-vracer-burger.py:195)
    reuse_ratio: float = 512.0         # korali: 256 exp/update / 0.5 exp-between-updates
    max_updates_per_gen: int = 200
    seed: int = 42
    log_every: int = 1
    testing_frequency: int = 0         # generations between deterministic evals (0 = off)
    testing_episodes: int = 8
    save_episodes_dir: Optional[str] = None
    save_episodes_threshold: float = -np.inf
    # korali File Output (run-vracer-burger.py:198-201): periodic checkpoints
    checkpoint_dir: Optional[str] = None
    checkpoint_every: int = 25
    serialize_replay: bool = False
    # the JAX package's one-program generation: run.py gives it the padded
    # accounting (a static update count), and its default real-experience
    # accounting is for the unfused path; either way a generation on the
    # card is the collection's and the update's graph replays plus the eager
    # insert
    fused: bool = False
    # per-generation probe of the policy on a fixed batch of initial states
    # into history["diag"]
    decay_diagnostics: bool = False
    # korali's experience accounting: only live env-steps count toward Max
    # Experiences, the replay-start gate and the update ledger
    count_real_experiences: bool = False


def default_rl_config(env: Env, **overrides) -> vracer.VracerConfig:
    kw = dict(obs_dim=env.obs_dim, act_dim=env.act_dim,
              num_agents=env.num_agents, episode_length=env.episode_length,
              action_low=env.action_low, action_high=env.action_high)
    kw.update(overrides)
    return vracer.VracerConfig(**kw)


def make_replay(env: Env, rl_cfg: vracer.VracerConfig):
    """The trainer's replay layout, on the env's device (also the template a
    checkpointed replay loads into): the episode-slot ring for episode
    minibatches, the flat experience ring with korali's REFER metadata for
    experience minibatches.  In float32 whatever the env's dtype, as in the
    JAX package (its replays' default dtype): a float64 run stores its rows
    rounded to float32."""
    kw = dict(dtype=REPLAY_DTYPE, device=env.device)
    if rl_cfg.minibatch_mode == "experience":
        return replay_flat.init_flat(rl_cfg.replay_max_experiences, rl_cfg.flat_episode_capacity,
                                     env.num_agents, env.obs_dim, env.act_dim, **kw)
    return replay_mod.init(rl_cfg.replay_capacity_episodes, env.episode_length,
                           env.num_agents, env.obs_dim, env.act_dim, **kw)


def updates_per_generation(rl_cfg: vracer.VracerConfig, tc: TrainerConfig,
                           T: int) -> int:
    """korali economics: 1 update per `Experiences Between Policy Updates`
    new experiences, each consuming `Mini Batch Size` samples; episode-mode
    minibatches are K*T experiences."""
    exp_per_update = (rl_cfg.mini_batch_size
                      if rl_cfg.minibatch_mode == "experience"
                      else rl_cfg.mini_batch_episodes * T)
    return int(min(tc.max_updates_per_gen,
                   max(1, tc.num_envs * T * tc.reuse_ratio / exp_per_update)))


def insert_generation(rl_cfg, ts, rep, traj):
    """Normalizers and replay insert, in the JAX order: experience mode
    observes first (its insert-time retrace values use the updated scale),
    episode mode inserts first."""
    if rl_cfg.minibatch_mode == "experience":
        ts = vracer.observe_episodes(rl_cfg, ts, traj)
        rep = vracer.flat_insert(rl_cfg, ts, rep, traj)
    else:
        rep = replay_mod.add_episodes(rep, traj)
        ts = vracer.observe_episodes(rl_cfg, ts, traj)
    return ts, rep


def _updates_started(rl_cfg, rep) -> bool:
    if rl_cfg.minibatch_mode == "experience":
        return rep.cursor >= rl_cfg.replay_start_experiences
    return rep.filled >= rl_cfg.replay_start_episodes


def _update(rl_cfg, ts, rep, generator, group=None, mini_batch=None):
    """One update of either minibatch mode, in place; returns its metrics.
    Under ``group`` (a ``parallel.mesh.Mesh``) ``rep`` is the rank's shard
    and ``mini_batch`` its slice of an experience-mode minibatch."""
    if rl_cfg.minibatch_mode == "experience":
        return vracer.update_experience(rl_cfg, ts, rep, generator, group=group,
                                        mini_batch=mini_batch)[2]
    batch = replay_mod.sample_episodes(rep, generator, rl_cfg.mini_batch_episodes)
    return vracer.update(rl_cfg, ts, batch, group=group)[1]


def _updates(rl_cfg, ts, rep, generator, group, mini_batch, k: int):
    """``k`` sequential updates in place; returns the last one's metrics."""
    for _ in range(k):
        metrics = _update(rl_cfg, ts, rep, generator, group, mini_batch)
    return metrics


def _update_key(rl_cfg, ts, rep, mini_batch, k):
    return ("update", rl_cfg, mini_batch, k, graphs.pointers(
        (list(ts.net.parameters()), list(ts.opt.state.values()), ts.beta, ts.n_updates,
         rep, rep.counters)))


def _update_graph(rl_cfg, ts, rep, generator, group, mini_batch, k):
    """(``k`` sequential updates captured as one graph for this train state,
    replay, generator and group; the warm-up's metrics, or None).  The
    warm-up runs the ``k`` updates for real.  The graph reads the normalizers
    from its own buffers, which each call copies into; everything else it
    reads and writes in place (the module, Adam's state, beta, the counter,
    the replay).

    Under ``group`` the capture holds the updates' all_reduces.  A rank that
    replays while another captures would wait for collectives the capture
    only records, so the ranks agree first: every rank captures when any
    rank's key missed."""
    objects = (ts.net, rep, generator, group)
    hit = graphs.cached(_update_key(rl_cfg, ts, rep, mini_batch, k), objects)
    if group is not None and not all(group.all_gather_object(hit is not None)):
        hit = None
    if hit is not None:
        static_ts, graph = hit
        graphs.copy_((static_ts.obs_stats, static_ts.rew_stats), (ts.obs_stats, ts.rew_stats))
        return graph, None
    static_ts = dataclasses.replace(ts, obs_stats=graphs.clone(ts.obs_stats),
                                    rew_stats=graphs.clone(ts.rew_stats))
    first, graph = graphs.capture(
        f"{k} {rl_cfg.minibatch_mode}-mode updates",
        lambda: _updates(rl_cfg, static_ts, rep, generator, group, mini_batch, k),
        ts.beta.device, generators=[generator])
    # under the key the next call computes: the warm-up made Adam's state
    graphs.store(_update_key(rl_cfg, ts, rep, mini_batch, k), objects, (static_ts, graph))
    return graph, first


def run_updates(rl_cfg, ts, rep, generator, n: int, group=None, mini_batch=None):
    """``n`` sequential updates from ``generator``; returns (ts, rep, the last
    update's metrics, {} when n is 0).  On the card they are replays of one
    graph of UPDATE_CHUNK updates, ``n // UPDATE_CHUNK`` times, then of one
    graph of the remaining ``n % UPDATE_CHUNK`` (the JAX package's update
    scans, marlpde_tpu/train/trainer.py:233-257); the first call of a chunk
    length for a train state runs its updates for real (the capture's
    warm-up), and they count toward ``n``.  Elsewhere direct calls.  Under
    ``group`` (the rank's ``Mesh``, with ``mini_batch`` its experience-mode
    slice) the updates average over the ranks, and they are replays only
    where the group's collectives can be captured (``Mesh.captures``): on
    NCCL a chunk holds its updates' all_reduces."""
    metrics = {}
    if n and graphs.enabled(ts.beta.device) and (group is None or group.captures):
        full, rem = divmod(n, UPDATE_CHUNK)
        for k, times in ((UPDATE_CHUNK, full), (rem, 1)):
            if not (k and times):
                continue
            graph, first = _update_graph(rl_cfg, ts, rep, generator, group, mini_batch, k)
            metrics = first if first is not None else metrics
            for _ in range(times - (first is not None)):
                metrics = graph.replay()
        return ts, rep, {name: v.clone() for name, v in metrics.items()}
    for _ in range(n):
        metrics = _update(rl_cfg, ts, rep, generator, group, mini_batch)
    return ts, rep, metrics


def build_fused_generation(env: Env, rl_cfg: vracer.VracerConfig,
                           tc: TrainerConfig, upd_per_gen: int):
    """One whole training generation (collect + normalizer update + replay
    insert + all gradient updates) at the static count ``upd_per_gen``: the
    program the JAX package fuses, and what ``train`` runs a generation as
    without real-experience accounting.

    Returns ``fused_generation(ts, rep, generator, episode_base, consts) ->
    (ts, rep, traj, final, metrics, stats)``; ``metrics`` are the last
    update's (empty when no update ran) and ``stats`` hold host numbers."""
    record = tc.save_episodes_dir is not None

    def fused_generation(ts, rep, generator, episode_base, consts):
        traj, final = collect_episodes(env, rl_cfg, ts, generator, tc.num_envs,
                                       episode_base, consts=consts, record_fields=record)
        ts, rep = insert_generation(rl_cfg, ts, rep, traj)
        did = _updates_started(rl_cfg, rep)
        ts, rep, metrics = run_updates(rl_cfg, ts, rep, generator, upd_per_gen if did else 0)
        stats = dict(
            mean_return=float(final.cum_reward.reshape(tc.num_envs, -1).mean()),
            ep_len=float(traj["mask"].sum(1).mean()),
            n_upd=upd_per_gen if did else 0,
            blowups=int(traj["truncated"].sum()),
            rew_scale=float(running_stats.second_moment(ts.rew_stats)))
        return ts, rep, traj, final, metrics, stats

    return fused_generation


def _n_target(rl_cfg, tc, rep, T, real_in_replay, gen_exp, updates_done, upd_per_gen):
    """Updates this generation runs (trainer.py:349-373).
    With real-experience accounting in experience mode this is korali's exact
    ledger: the cumulative target (experienceCount - startSize) / Experiences
    Between Policy Updates, less the updates already taken, capped by
    max_updates_per_gen."""
    exp_mode = rl_cfg.minibatch_mode == "experience"
    if not tc.count_real_experiences:
        return upd_per_gen if _updates_started(rl_cfg, rep) else 0
    if real_in_replay < rl_cfg.replay_start_experiences:
        return 0
    if exp_mode:
        target_total = int(max(0.0, (real_in_replay - rl_cfg.replay_start_experiences)
                               / rl_cfg.experiences_between_updates))
        return min(tc.max_updates_per_gen, max(0, target_total - updates_done))
    exp_per_update = rl_cfg.mini_batch_episodes * T
    return int(min(tc.max_updates_per_gen,
                   max(0.0, gen_exp * tc.reuse_ratio / exp_per_update)))


def save_episodes(tc: TrainerConfig, gen: int, traj, final):
    """The episodes of generation ``gen`` whose mean return beats
    ``tc.save_episodes_threshold``, as ``episodes_gen{gen}.npz`` in
    ``tc.save_episodes_dir`` (marlpde_tpu/train/trainer.py:424-445): the RL
    tensors actions, rewards, obs and cumreward, plus the reference's
    save-episode content (burger_environment.py:207-238) where the env has
    it: the solved fields (sgs_u), the cumulative spectra (sgs_Ektt) and the
    DNS pool rows (indeces, int32 as in the JAX package)."""
    cum = final.cum_reward.reshape(tc.num_envs, -1).mean(-1)
    keep = (cum > tc.save_episodes_threshold).cpu().numpy()
    if not keep.any():
        return None
    os.makedirs(tc.save_episodes_dir, exist_ok=True)
    host = lambda x: x.detach().cpu().numpy()[keep]
    extra = {k: host(traj[k]) for k in ("fields", "ektt") if k in traj}
    if hasattr(final, "sidx"):
        extra["indeces"] = host(final.sidx).astype(np.int32)
    path = os.path.join(tc.save_episodes_dir, f"episodes_gen{gen}.npz")
    np.savez_compressed(path, actions=host(traj["actions"]), rewards=host(traj["rewards"]),
                        obs=host(traj["obs"]), cumreward=host(final.cum_reward), **extra)
    return path


def _save_checkpoint(tc, ts, history, rep, generator, gen, total_exp, episode_base,
                     real_in_replay, rl_cfg):
    ckpt.save_train_state(tc.checkpoint_dir, ts, history)
    ckpt.save_meta(tc.checkpoint_dir, generator, gen, total_exp, episode_base,
                   real_in_replay=real_in_replay, rl_cfg=rl_cfg)
    if tc.serialize_replay:
        ckpt.save_replay(tc.checkpoint_dir, rep)


def train(env: Env, rl_cfg: Optional[vracer.VracerConfig] = None,
          tc: TrainerConfig = TrainerConfig(), verbose: bool = True,
          callback=None, init_ts=None, init_history=None, init_replay=None,
          init_generator_state=None, init_counters: Optional[dict] = None):
    """Run training; returns (train_state, replay, history dict).

    The generator seeded with ``tc.seed`` on the env's device draws the
    initial weights (unless ``init_ts`` is given), the reset offsets, the
    action noise and the minibatches.  Resume (korali's e.loadState):
    ``init_ts``/``init_history`` restore the learner and the curves,
    ``init_replay`` the buffer, ``init_generator_state``/``init_counters``
    (from checkpoint.load_meta) the stream and the gen / total_exp /
    episode_base / real_in_replay counters, so a resumed run continues
    bitwise.  ``callback(gen, ts, rep, history)`` runs after each generation."""
    rl_cfg = rl_cfg or default_rl_config(env)
    record = tc.save_episodes_dir is not None
    device, dtype = env.device, env.dtype
    with profiling.span("setup.init", sync=device):
        generator = torch.Generator(device=device)
        generator.manual_seed(tc.seed)
        ts = (vracer.init_train(rl_cfg, generator, dtype=dtype, device=device)
              if init_ts is None else init_ts)
        if init_generator_state is not None:
            generator.set_state(init_generator_state)
        rep = init_replay if init_replay is not None else make_replay(env, rl_cfg)
        prev_probe_mu = init_probe_mu = None
        if tc.decay_diagnostics:
            n_probe = 32
            probe_gen = torch.Generator(device=device).manual_seed(tc.seed + 777)
            _, probe_obs = env.reset_batch(env.consts, probe_gen,
                                           torch.arange(n_probe, device=device))
    exp_mode = rl_cfg.minibatch_mode == "experience"

    history = init_history if init_history else dict(
        gen=[], experiences=[], mean_return=[], mean_ep_len=[], updates=[], metrics=[],
        test_return=[], wall_time=[], env_steps_per_s=[], blowups=[], rew_scale=[])
    for key in ("env_steps_per_s", "blowups", "rew_scale"):
        history.setdefault(key, [])
    if tc.decay_diagnostics:
        history.setdefault("diag", [])
    if init_counters is not None:
        gen = init_counters["gen"]
        total_exp = init_counters["total_exp"]
        episode_base = init_counters["episode_base"]
    else:
        total_exp = history["experiences"][-1] if history.get("experiences") else 0
        gen = history["gen"][-1] if history.get("gen") else 0
        episode_base = gen * tc.num_envs
    updates_done = int(sum(history.get("updates") or [0]))
    best_test = max(history.get("test_return") or [-np.inf])
    T = env.episode_length
    upd_per_gen = updates_per_generation(rl_cfg, tc, T)
    real_mode = tc.count_real_experiences
    # cumulative live experiences inserted (korali's _experienceCount): the
    # replay-start gate and the update ledger; restored on resume, else the
    # ledger would take no updates until the run re-collects what it had
    if init_counters is not None and init_counters.get("real_in_replay") is not None:
        real_in_replay = int(init_counters["real_in_replay"])
    elif real_mode and total_exp:
        real_in_replay = int(total_exp)
    else:
        real_in_replay = 0

    t0 = time.time()
    while total_exp < tc.max_experiences:
        # one generation, its spans and readbacks in the tracer; the callback
        # runs after it
        with profiling.span("generation", gen=gen + 1) as unit:
            with profiling.span("collect", work=T):
                traj, final = collect_episodes(env, rl_cfg, ts, generator, tc.num_envs,
                                               episode_base, record_fields=record)
            with profiling.span("insert", work=1):
                ts, rep = insert_generation(rl_cfg, ts, rep, traj)
            episode_base += tc.num_envs
            if real_mode:
                gen_exp = int(profiling.host(traj["mask"].sum()))
                real_in_replay += gen_exp
            else:
                gen_exp = tc.num_envs * T
            n_upd = _n_target(rl_cfg, tc, rep, T, real_in_replay, gen_exp, updates_done,
                              upd_per_gen)
            with profiling.span("updates", work=n_upd):
                ts, rep, metrics = run_updates(rl_cfg, ts, rep, generator, n_upd)
            total_exp += gen_exp
            gen += 1
            updates_done += n_upd
            names = list(metrics)
            mean_ret, ep_len, blowups, rew_scale, *values = profiling.host(
                final.cum_reward.mean(), traj["mask"].sum(1).mean(), traj["truncated"].sum(),
                running_stats.second_moment(ts.rew_stats), *metrics.values())
            history["gen"].append(gen)
            history["experiences"].append(total_exp)
            history["mean_return"].append(mean_ret)
            history["mean_ep_len"].append(ep_len)
            history["updates"].append(n_upd)
            history["metrics"].append({k: float(v) for k, v in zip(names, values)})
            history["wall_time"].append(time.time() - t0)
            history["blowups"].append(blowups)
            history["rew_scale"].append(rew_scale)

            if tc.decay_diagnostics:
                with profiling.span("diag"):
                    V, mu_p, sigma_p = vracer.policy_apply(rl_cfg, ts, probe_obs)
                    v0, sigma_mean, mu_p = profiling.host(V.mean(), sigma_p.mean(), mu_p)
                    if init_probe_mu is None:
                        init_probe_mu = mu_p
                    rms = lambda a: float(np.sqrt(np.mean(a * a)))
                    occ = (min(rep.cursor, rl_cfg.replay_max_experiences) if exp_mode
                           else rep.filled)
                    history["diag"].append(dict(
                        # V(s0) and the realized return, both in SCALED units
                        v0_scaled=v0,
                        return_scaled=float(mean_ret / max(rew_scale, 1e-30)),
                        rew_scale=rew_scale,
                        mu_drift_rms=(rms(mu_p - prev_probe_mu) if prev_probe_mu is not None
                                      else 0.0),
                        mu_from_init_rms=rms(mu_p - init_probe_mu),
                        mu_rms=rms(mu_p), sigma_probe=sigma_mean,
                        replay_occupancy=int(occ)))
                    prev_probe_mu = mu_p

            if record:
                with profiling.span("save_episodes"):
                    save_episodes(tc, gen, traj, final)
            if tc.testing_frequency and gen % tc.testing_frequency == 0:
                with profiling.span("test", work=T):
                    _, tfinal = collect_episodes(env, rl_cfg, ts, generator,
                                                 tc.testing_episodes, 0, deterministic=True)
                    tret = profiling.host(tfinal.cum_reward.mean())
                    history["test_return"].append(tret)
                    # best-policy checkpoint by deterministic test return
                    if tc.checkpoint_dir and tret > best_test:
                        best_test = tret
                        best = os.path.join(tc.checkpoint_dir, "best")
                        ckpt.save_train_state(best, ts, None)
                        with open(os.path.join(best, "best.json"), "w") as f:
                            json.dump({"gen": gen, "test_return": tret}, f)
            if tc.checkpoint_dir and gen % tc.checkpoint_every == 0:
                with profiling.span("checkpoint"):
                    _save_checkpoint(tc, ts, history, rep, generator, gen, total_exp,
                                     episode_base, real_in_replay, rl_cfg)
            if verbose and gen % tc.log_every == 0:
                print(f"[trainer] gen {gen} exp {total_exp} return {mean_ret:.5f} "
                      f"eplen {ep_len:.1f} updates {n_upd} "
                      f"beta {history['metrics'][-1].get('beta', '-')}", flush=True)
        # the generation's experiences over its span (korali's per-generation rate)
        history["env_steps_per_s"].append(gen_exp / max(unit.ns * 1e-9, 1e-9))
        if callback is not None:
            callback(gen, ts, rep, history)

    if tc.checkpoint_dir:
        with profiling.span("checkpoint"):
            _save_checkpoint(tc, ts, history, rep, generator, gen, total_exp, episode_base,
                             real_in_replay, rl_cfg)
    return ts, rep, history


def evaluate(env: Env, rl_cfg, ts, generator=None, n_episodes: int = 8):
    """Deterministic-policy evaluation; returns per-episode returns (n, na) as
    numpy.  ``generator`` draws the reset offsets of noisy configs."""
    _traj, final = collect_episodes(env, rl_cfg, ts, generator, n_episodes, 0,
                                    deterministic=True)
    return final.cum_reward.cpu().numpy()
