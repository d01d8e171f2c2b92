"""Data-parallel training (marlpde_tpu_torch/parallel/mesh.py and the CLI's
--mesh) against the JAX package's shard_map mesh (marlpde_tpu/parallel/mesh.py).

The port's ranks are processes under gloo, started with ``python -c WORKER``
so that they import neither JAX nor this file; JAX runs on the first W of
conftest's 8 virtual CPU devices.  Both start from the same float64 weights,
and each rank is handed the episodes and minibatch ids that the JAX device of
its index gets (collection and sampling are patched in both, as their RNG
streams never match; ``jax.lax.axis_index`` picks the device's share).
Tolerance 1e-9 relative: float64 arithmetic, summed in another order over the
ranks.  Both meshes keep their replays in float32 whatever the env's dtype
(JAX's ``init_flat``/``replay.init`` defaults, the port's
``trainer.REPLAY_DTYPE``); these tests build them in float64 on both sides.
Then the invariants of
tests/test_parallel.py, the CLI at world 1 and under two ranks, the "orbax"
(torch.distributed.checkpoint) backend and the multi-process dry run."""

import dataclasses
import functools
import json
import os
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import Mesh as JMesh
from jax.sharding import PartitionSpec as P

import graph_standins as standins
import marlpde_tpu.rl.replay as jreplay
import marlpde_tpu.rl.replay_flat as jflat
from marlpde_tpu import run as jrun
from marlpde_tpu.envs import registry as jregistry
from marlpde_tpu.parallel import mesh as jmesh
from marlpde_tpu.rl import running_stats as jrs
from marlpde_tpu.rl import vracer as jv
from marlpde_tpu_torch import run as trun
from marlpde_tpu_torch.envs import registry as tregistry
from marlpde_tpu_torch.parallel import dryrun
from marlpde_tpu_torch.parallel import mesh as pmesh
from marlpde_tpu_torch.rl import networks as tnet
from marlpde_tpu_torch.rl import vracer as tv
from marlpde_tpu_torch.train import trainer as ttrainer
from marlpde_tpu_torch.utils import checkpoint as tckpt
from marlpde_tpu_torch.utils import graphs
from test_torch_interop import np_tree, params64

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL, ATOL = 1e-9, 1e-12
T, NA, OBS, ACT = 5, 2, 3, 1
# the small flagship of __graft_entry__._flagship(small=True)
SMALL = dict(N_dns=64, grid_size=16, num_actions=16, num_agents=4, dt=0.01, T=0.2, nu=0.05,
             episode_length=5, ic_case="turbulence", spectral_reward=True, noise=0.0)
DIFFUSION = dict(N=8, episode_length=10, noise=0.0)
TINY = ("burger --specreward --dforce --ic turbulence --NDNS 32 --N 8 --NA 8 --dt 0.01 "
        "--T 0.05 --episodelength 5 --width 8 --ndns 3 --numenvs 8 --NE 80 --mesh").split()

# One rank of the port: runs the cases of the plan in the npz it is given
# and writes what it ends with to <out>.<rank>.npz (or .json).
WORKER = r'''
import contextlib, dataclasses, json, sys, types
import numpy as np, torch
import torch.distributed as dist
torch.set_num_threads(1)
from marlpde_tpu_torch.parallel import mesh as pmesh
from marlpde_tpu_torch.rl import replay, replay_flat, running_stats, vracer
from marlpde_tpu_torch.utils import checkpoint as ckpt

d = np.load(sys.argv[1])
out = sys.argv[2]
plan = json.loads(str(d["plan"]))
mesh = pmesh.make_mesh("cpu")
r = mesh.rank
res = {}
tensor = lambda k: torch.from_numpy(d[k].copy())
group = lambda prefix: {k[len(prefix):]: tensor(k) for k in d.files if k.startswith(prefix)}


@contextlib.contextmanager
def patched(module, name, value):
    saved = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, saved)


def train_state(case, cfg):
    ts = vracer.init_train(cfg, torch.Generator().manual_seed(0), dtype=torch.float64)
    ts.net.load_state_dict(group(f"{case}.param."))
    stats = {s: running_stats.RunningStats(*(tensor(f"{case}.{s}.{f}") for f in ("mean", "m2", "count")))
             for s in ("obs_stats", "rew_stats")}
    return dataclasses.replace(ts, beta=tensor(f"{case}.beta"), **stats)


def dump(case, ts, rep):
    for k, v in ckpt.dcp_state(ts).items():
        res[f"{case}.ts.{k}"] = v.numpy()
    for f in dataclasses.fields(rep):
        v = getattr(rep, f.name)
        res[f"{case}.rep.{f.name}"] = v.numpy() if torch.is_tensor(v) else np.asarray(v)


def insert(case, spec, cfg):
    ts = train_state(case, cfg)
    rep = replay_flat.init_flat(16, 4, NA, cfg.obs_dim, cfg.act_dim, dtype=torch.float64)
    for i in range(2):
        rep = vracer.flat_insert(cfg, ts, rep, group(f"{case}.batch.{r}.{i}."), group=mesh)
    ids = iter(tensor(f"{case}.ids.{r}"))
    with patched(replay_flat, "sample_ids", lambda rep, generator, n: next(ids)):
        for k in range(2):
            ts, rep, m = vracer.update_experience(cfg, ts, rep, None, group=mesh,
                                                  mini_batch=spec["mb"])
            for name in ("rew_scale", "frac_off_replay", "beta"):
                res[f"{case}.m{k}.{name}"] = m[name].numpy()
    dump(case, ts, rep)


def generation(case, spec, cfg):
    ts = train_state(case, cfg)
    traj = group(f"{case}.traj.{r}.")
    final = types.SimpleNamespace(cum_reward=traj.pop("cum_reward"))
    sampled = group(f"{case}.sample.{r}.")
    env = types.SimpleNamespace(device=torch.device("cpu"), dtype=torch.float64, episode_length=T,
                                num_agents=NA, obs_dim=cfg.obs_dim, act_dim=cfg.act_dim)
    gen_fn, init_rep = pmesh.make_sharded_generation(env, cfg, mesh, spec["epd"], spec["upd"])
    with patched(pmesh, "collect_episodes", lambda *a, **k: (traj, final)), \
            patched(replay, "sample_episodes", lambda rep, generator, n: sampled), \
            patched(pmesh.trainer, "REPLAY_DTYPE", torch.float64):
        ts, rep, _ = gen_fn(ts, init_rep(), None, 0)
    dump(case, ts, rep)


def invariants(spec):
    from marlpde_tpu_torch.envs import registry
    from marlpde_tpu_torch.train import trainer
    digest = lambda ts: [float(v.double().sum()) for v in ckpt.dcp_state(ts).values()]
    env = registry.make_env("diffusion-simple", device="cpu", **spec["diffusion"])
    cfg = lambda e, mode, **kw: trainer.default_rl_config(
        e, width=16, replay_start_experiences=10, mini_batch_episodes=2, minibatch_mode=mode,
        **{"replay_max_experiences": 1600, **kw})
    out = {}
    for mode in ("experience", "episode"):
        ts, rep, hist = pmesh.run_generations(env, cfg(env, mode), mesh, envs_per_device=2,
                                              updates_per_gen=2, n_generations=2)
        shard = pmesh.make_sharded_generation(env, cfg(env, mode), mesh, 2, 1)[1]()
        out[mode] = dict(digest=digest(ts), n_updates=int(ts.n_updates), returns=hist["mean_return"],
                         experiences=hist["experiences"], shard=shard.obs.shape[0])
    burger = registry.make_env("burger", device="cpu", **spec["small"])
    ts, _, hist = pmesh.run_generations(burger, cfg(burger, "episode", replay_max_experiences=800),
                                        mesh, envs_per_device=1, updates_per_gen=1, n_generations=1)
    out["burger"] = dict(returns=hist["mean_return"], n_updates=int(ts.n_updates), digest=digest(ts))
    c = cfg(env, "episode")
    _, _, hist = pmesh.run_generations(env, c, mesh, 2, 1, 3, testing_frequency=2,
                                       testing_episodes=2, checkpoint_dir=spec["ckpt"],
                                       checkpoint_every=2)
    out["testfreq"] = hist["test_return"]
    pmesh.run_generations(env, c, mesh, 2, 1, 2, checkpoint_dir=spec["resume"], checkpoint_every=1)
    meta = ckpt.load_meta(spec["resume"])
    ts, _, hist = pmesh.run_generations(
        env, c, mesh, 2, 1, 2, init_ts=ckpt.load_train_state(spec["resume"], c),
        history=ckpt.load_history(spec["resume"]), init_key=meta["generator"])
    out["resume"] = dict(gen=hist["gen"], experiences=hist["experiences"], digest=digest(ts))
    pool = registry.make_env("burger", n_dns=3, device="cpu", **spec["small"])
    bases, real = [], pmesh.collect_episodes

    def recorded(env, rl_cfg, ts, generator, n, base, **kw):
        traj, final = real(env, rl_cfg, ts, generator, n, base, **kw)
        bases.append(dict(base=int(base), sidx=final.sidx.tolist()))
        return traj, final

    with patched(pmesh, "collect_episodes", recorded):
        pmesh.run_generations(pool, cfg(pool, "episode"), mesh, 2, 1, 2)
    out["bases"] = bases
    with open(f"{out_path}.{r}.json", "w") as f:
        json.dump(out, f)


NA, T = plan.pop("_dims")
out_path = out
for case, spec in plan.items():
    if spec["kind"] == "invariants":
        invariants(spec)
        continue
    cfg = vracer.VracerConfig(**spec["cfg"])
    {"insert": insert, "generation": generation}[spec["kind"]](case, spec, cfg)
np.savez(f"{out}.{r}.npz", **res)
dist.destroy_process_group()
'''


def _ranks(world, inputs, out, timeout=240):
    """``WORKER`` on ``world`` gloo ranks (the dry run's launcher); fails with
    every rank's output if one fails (the others are then killed)."""
    rcs, outs = dryrun.launch(world, [inputs, out], code=WORKER, timeout=timeout)
    assert rcs == [0] * world, "\n".join(f"--- rank {r} rc {rc}\n{o}"
                                         for r, (rc, o) in enumerate(zip(rcs, outs)))


# ---------------------------------------------------------------- the inputs


def _batch(seed, B=3, cut=2):
    """B episodes of T steps; episode 1 blows up at step ``cut`` (-inf reward,
    a NaN final observation, Truncated)."""
    rng = np.random.default_rng(seed)
    mask = np.ones((B, T))
    mask[1, cut:] = 0.0
    rewards = rng.standard_normal((B, T, NA)) * 0.05
    rewards[1, cut - 1] = -np.inf
    rewards[1, cut:] = 0.0
    mu = rng.standard_normal((B, T, NA, ACT)) * 0.3
    sigma = np.exp(rng.standard_normal((B, T, NA, ACT)) * 0.3) * 0.2
    final_obs = rng.standard_normal((B, NA, OBS))
    final_obs[1, 0, 0] = np.nan
    truncated = np.zeros(B, bool)
    truncated[1] = True
    return dict(obs=rng.standard_normal((B, T, NA, OBS)) * 1.5,
                actions=np.clip(mu + 2 * sigma * rng.standard_normal(mu.shape), -5, 5), mu=mu,
                sigma=sigma, rewards=rewards, mask=mask, final_obs=final_obs, truncated=truncated)


def _learner(seed=2, rew_count=2000.0, **cfg_kw):
    """(JAX config, JAX float64 train state with perturbed weights and warm
    normalizers, the port's config)."""
    cfg_kw.setdefault("replay_episode_capacity", 4)
    cfg = jv.VracerConfig(obs_dim=OBS, act_dim=ACT, num_agents=NA, episode_length=T, width=8,
                          mini_batch_size=8, **cfg_kw)
    jts = params64(cfg, jv.init_train(cfg, jax.random.key(seed), dtype=jnp.float64))
    rng = np.random.default_rng(seed + 7)
    jts = jts.replace(
        params=jax.tree.map(lambda a: a + jnp.asarray(rng.standard_normal(a.shape) * 0.3),
                            jts.params),
        obs_stats=jrs.RunningStats(mean=jnp.asarray([0.3, 0.5, -0.2]),
                                   m2=jnp.asarray([40.0, 80.0, 30.0]), count=jnp.asarray(20.0)),
        rew_stats=jrs.RunningStats(mean=jnp.asarray(0.01), m2=jnp.asarray(0.4),
                                   count=jnp.asarray(rew_count)))
    return cfg, jts, tv.VracerConfig(**dataclasses.asdict(cfg))


def _state_inputs(case, cfg, jts):
    d = {f"{case}.param.{k}": v.numpy()
         for k, v in tnet.params_from_flax(np_tree(jts.params)).items()}
    d[f"{case}.beta"] = np.asarray(jts.beta)
    for s in ("obs_stats", "rew_stats"):
        for f in ("mean", "m2", "count"):
            d[f"{case}.{s}.{f}"] = np.asarray(getattr(getattr(jts, s), f))
    return d


def _stack(trees):
    return jax.tree.map(lambda *a: jnp.stack([jnp.asarray(x) for x in a]), *trees)


def _jmesh(W):
    return JMesh(np.asarray(jax.devices()[:W]), ("env",))


INSERT_CASES = [(W, src) for W in (2, 4) for src in ("replay", "cumulative")]


def _insert_case(W, src):
    """Two flat inserts of each rank's own episodes (the second evicts) and
    two updates on the rank's ids, in both packages."""
    cfg, jts, tcfg = _learner(reward_scale_source=src, minibatch_mode="experience")
    cuts = [[1 + (r + i) % 4 for i in range(2)] for r in range(W)]
    batches = [[_batch(10 * r + i, cut=cuts[r][i]) for i in range(2)] for r in range(W)]
    rng = np.random.default_rng(W)
    mb = cfg.mini_batch_size // W
    ids = []
    for r in range(W):
        cursor = int(sum(b["mask"].sum() for b in batches[r]))
        ids.append(rng.integers(max(0, cursor - 16), cursor, size=(2, mb)))
    ids = np.asarray(ids)
    return cfg, jts, tcfg, batches, ids, mb


def _jax_insert(cfg, jts, W, batches, ids, mb, monkeypatch):
    calls = []

    def sample(rep, key, n):
        calls.append(None)
        return jnp.asarray(ids, jnp.int32)[jax.lax.axis_index("env"), len(calls) - 1]

    monkeypatch.setattr(jflat, "sample_ids", sample)
    shard = jflat.init_flat(16, 4, NA, OBS, ACT, dtype=jnp.float64)

    def local(ts, rep, b0, b1):
        first = lambda t: jax.tree.map(lambda a: a[0], t)
        rep = first(rep)
        for b in (first(b0), first(b1)):
            rep = jv.flat_insert(cfg, ts, rep, b, axis="env")
        ms = []
        for _ in range(2):
            ts, rep, m = jv.update_experience(cfg, ts, rep, jax.random.key(0), axis="env",
                                              mini_batch=mb)
            ms.append({k: m[k] for k in ("rew_scale", "frac_off_replay", "beta")})
        lift = lambda t: jax.tree.map(lambda a: jnp.asarray(a)[None], t)
        return lift(ts), lift(rep), lift(ms)

    fn = jax.jit(jax.shard_map(local, mesh=_jmesh(W), in_specs=(P(), P("env"), P("env"), P("env")),
                               out_specs=P("env"), check_vma=False))
    return fn(jts, _stack([shard] * W), _stack([b[0] for b in batches]),
              _stack([b[1] for b in batches]))


GEN_CASES = {
    # the episode-mode update of mesh.py:164-185: averaged gradients and
    # far-policy fraction through the clip, Adam and beta, 2 updates.  The
    # ranks' own minibatches are far-policy in shares on either side of the
    # off-policy target (1.0 and 0.875 before the first update), so beta
    # moves by their mean's side
    "episode": dict(W=2, cfg=dict(minibatch_mode="episode", mini_batch_episodes=2,
                                  replay_start_experiences=1, replay_max_experiences=40,
                                  offpolicy_target=0.95),
                    upd=2),
    # the leafwise normalizer pmean after observe_episodes (the batch-median
    # winsor path: a cold reward accumulator) and the flat insert of every
    # rank's shard at the summed scale; the replay stays cold, no update
    "normalizers": dict(W=4, cfg=dict(minibatch_mode="experience", replay_start_experiences=10**6,
                                      replay_max_experiences=64, replay_episode_capacity=16),
                        upd=2, rew_count=20.0),
}
EPD = 3


def _generation_case(name):
    spec = GEN_CASES[name]
    cfg, jts, tcfg = _learner(rew_count=spec.get("rew_count", 2000.0), **spec["cfg"])
    W = spec["W"]
    trajs = [_batch(100 + r, B=EPD, cut=1 + r % 4) for r in range(W)]
    rng = np.random.default_rng(5)
    cums = [rng.standard_normal((EPD, NA)) for _ in range(W)]
    samples = [_batch(200 + r, B=cfg.mini_batch_episodes, cut=2 + r % 3) for r in range(W)]
    return spec, cfg, jts, tcfg, trajs, cums, samples


def _jax_generation(spec, cfg, jts, trajs, cums, samples, monkeypatch):
    """One generation of the JAX mesh's own gen_fn on the injected episodes."""
    W = spec["W"]
    tr, cum, sa = _stack(trajs), jnp.asarray(np.stack(cums)), _stack(samples)
    pick = lambda tree: jax.tree.map(lambda a: a[jax.lax.axis_index("env")], tree)
    monkeypatch.setattr(jmesh, "collect_episodes", lambda *a, **k: (
        pick(tr), types.SimpleNamespace(cum_reward=pick(cum))))
    monkeypatch.setattr(jreplay, "sample_episodes", lambda rep, key, n: pick(sa))
    monkeypatch.setattr(jflat, "init_flat", functools.partial(jflat.init_flat, dtype=jnp.float64))
    monkeypatch.setattr(jreplay, "init", functools.partial(jreplay.init, dtype=jnp.float64))
    env = types.SimpleNamespace(episode_length=T, num_agents=NA, obs_dim=OBS, act_dim=ACT,
                                consts=())
    gen_fn, init_rep = jmesh.make_sharded_generation(env, cfg, _jmesh(W), EPD, spec["upd"])
    return gen_fn(jts, init_rep(), jax.random.split(jax.random.key(0), W),
                  jnp.zeros((W,), jnp.int32), ())


def _plan_inputs(W):
    """The npz of W ranks' cases: every insert case of this W and every
    generation case of this W."""
    plan, d = {"_dims": [NA, T]}, {}
    for w, src in INSERT_CASES:
        if w != W:
            continue
        cfg, jts, _, batches, ids, mb = _insert_case(W, src)
        case = f"insert-{src}"
        plan[case] = dict(kind="insert", cfg=dataclasses.asdict(cfg), mb=mb)
        d.update(_state_inputs(case, cfg, jts))
        for r in range(W):
            for i, b in enumerate(batches[r]):
                d.update({f"{case}.batch.{r}.{i}.{k}": v for k, v in b.items()})
            d[f"{case}.ids.{r}"] = ids[r]
    for name, spec in GEN_CASES.items():
        if spec["W"] != W:
            continue
        _, cfg, jts, _, trajs, cums, samples = _generation_case(name)
        plan[name] = dict(kind="generation", cfg=dataclasses.asdict(cfg), epd=EPD, upd=spec["upd"])
        d.update(_state_inputs(name, cfg, jts))
        for r in range(W):
            d.update({f"{name}.traj.{r}.{k}": v for k, v in trajs[r].items()})
            d[f"{name}.traj.{r}.cum_reward"] = cums[r]
            d.update({f"{name}.sample.{r}.{k}": v for k, v in samples[r].items()})
    return plan, d


@pytest.fixture(scope="module")
def rank_results(tmp_path_factory):
    """Each W's ranks run once, all their cases together; W=4 also runs the
    invariants.  Returns {W: [each rank's npz], "invariants": ...}."""
    out = {}
    for W in (2, 4):
        tmp = tmp_path_factory.mktemp(f"w{W}")
        plan, d = _plan_inputs(W)
        if W == 4:
            plan["invariants"] = dict(kind="invariants", diffusion=DIFFUSION, small=SMALL,
                                      ckpt=str(tmp / "ckpt"), resume=str(tmp / "resume"))
        np.savez(tmp / "in.npz", plan=json.dumps(plan), **d)
        _ranks(W, str(tmp / "in.npz"), str(tmp / "out"))
        out[W] = [dict(np.load(tmp / f"out.{r}.npz")) for r in range(W)]
        if W == 4:
            out["invariants"] = [json.load(open(tmp / f"out.{r}.json")) for r in range(W)]
            out["dirs"] = (tmp / "ckpt", tmp / "resume")
    return out


# ------------------------------------------------------- parity against JAX


def _close(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    if want.dtype.kind == "f":
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL, err_msg=what)
    else:
        np.testing.assert_array_equal(got, want.astype(got.dtype), err_msg=what)


def _assert_state(res, case, tcfg, jts_r):
    """A rank's dumped train state against the JAX state of its device."""
    names = [n for n, _ in tv.make_net(tcfg).named_parameters()]
    for k, v in tnet.params_from_flax(np_tree(jts_r.params)).items():
        _close(res[f"{case}.ts.net.{k}"], v.numpy(), f"{case} param {k}")
    adam = jts_r.opt_state[1][0]
    for key, tree in (("exp_avg", adam.mu), ("exp_avg_sq", adam.nu)):
        want = tnet.params_from_flax(np_tree(tree))
        for i, n in enumerate(names):
            _close(res[f"{case}.ts.adam.{i}.{key}"], want[n].numpy(), f"{case} {key} {n}")
    for i in range(len(names)):
        assert res[f"{case}.ts.adam.{i}.step"] == int(adam.count), case
    _close(res[f"{case}.ts.beta"], jts_r.beta, f"{case} beta")
    assert int(res[f"{case}.ts.n_updates"]) == int(jts_r.n_updates), case
    for s in ("obs_stats", "rew_stats"):
        for f in ("mean", "m2", "count"):
            _close(res[f"{case}.ts.{s}.{f}"], getattr(getattr(jts_r, s), f), f"{case} {s}.{f}")


def _assert_ranks_equal(results, case):
    """Every rank took the same step, bit for bit."""
    first = results[0]
    for res in results[1:]:
        for k in first:
            if k.startswith(f"{case}.ts."):
                np.testing.assert_array_equal(res[k], first[k], err_msg=k)


def _assert_replay(res, case, jrep_r):
    for f in dataclasses.fields(jrep_r):
        _close(res[f"{case}.rep.{f.name}"], getattr(jrep_r, f.name), f"{case} replay {f.name}")


@pytest.mark.parametrize("W,src", INSERT_CASES, ids=[f"W{w}-{s}" for w, s in INSERT_CASES])
def test_sharded_insert_and_updates_match_jax(W, src, rank_results, monkeypatch):
    """flat_insert of each rank's episodes into its shard, then two
    update_experience steps on the rank's ids (mesh.py:121-137 with
    vracer's ``axis``): the refreshed shard, params, Adam moments, beta,
    rew_scale and frac_off_replay of every rank equal those of the JAX device
    of its index; the ranks' counters differ (episodes cut at other steps)."""
    cfg, jts, tcfg, batches, ids, mb = _insert_case(W, src)
    jts_w, jrep_w, ms = _jax_insert(cfg, jts, W, batches, ids, mb, monkeypatch)
    case = f"insert-{src}"
    counts = {int(res[f"{case}.rep.cursor"]) for res in rank_results[W]}
    assert len(counts) > 1, counts
    for r, res in enumerate(rank_results[W]):
        at = lambda t: jax.tree.map(lambda a: a[r], t)
        _assert_state(res, case, tcfg, at(jts_w))
        _assert_replay(res, case, at(jrep_w))
        for k in range(2):
            for name in ("rew_scale", "frac_off_replay", "beta"):
                _close(res[f"{case}.m{k}.{name}"], ms[k][name][r], f"rank {r} update {k} {name}")
    _assert_ranks_equal(rank_results[W], case)


@pytest.mark.parametrize("name", list(GEN_CASES))
def test_sharded_generation_matches_jax(name, rank_results, monkeypatch):
    """One generation of ``make_sharded_generation`` on the injected episodes
    against the JAX mesh's own gen_fn: "episode" (W=2) holds the episode-mode
    update of mesh.py:164-185, "normalizers" (W=4) the leafwise pmean of
    observe_episodes' statistics and the insert into every rank's flat shard."""
    spec, cfg, jts, tcfg, trajs, cums, samples = _generation_case(name)
    jts1, jrep, _ = _jax_generation(spec, cfg, jts, trajs, cums, samples, monkeypatch)
    W = spec["W"]
    assert int(jts1.n_updates) == (spec["upd"] if name == "episode" else 0)
    for r, res in enumerate(rank_results[W]):
        _assert_state(res, name, tcfg, jts1)
        if cfg.minibatch_mode == "experience":
            _assert_replay(res, name, jax.tree.map(lambda a: a[r], jrep))
        else:
            cap = res[f"{name}.rep.obs"].shape[0]
            _assert_replay(res, name, jax.tree.map(
                lambda a: a[r * cap:(r + 1) * cap] if jnp.ndim(a) else a, jrep))
    _assert_ranks_equal(rank_results[W], name)


# ------------------------------------------ invariants (tests/test_parallel.py)


def _invariants(rank_results):
    return rank_results["invariants"]


@pytest.mark.parametrize("mode", ["experience", "episode"])
def test_one_generation_runs_and_replicates(mode, rank_results):
    ranks = [res[mode] for res in _invariants(rank_results)]
    assert all(r["digest"] == ranks[0]["digest"] for r in ranks)
    assert all(np.isfinite(r["returns"]).all() and r["n_updates"] >= 1 for r in ranks)
    assert ranks[0]["experiences"] == [4 * 2 * 10, 4 * 2 * 2 * 10]


def test_burger_marl_sharded_step(rank_results):
    ranks = [res["burger"] for res in _invariants(rank_results)]
    assert np.isfinite(ranks[0]["returns"]).all() and ranks[0]["n_updates"] == 1
    assert all(r["digest"] == ranks[0]["digest"] for r in ranks)


@pytest.mark.parametrize("mode", ["experience", "episode"])
def test_replay_shards_stay_local(mode, rank_results):
    """Each rank's shard holds the global capacity over W (JAX: shard shape
    = global shape / 8)."""
    cfg = ttrainer.default_rl_config(tregistry.make_env("diffusion-simple", device="cpu",
                                                        **DIFFUSION),
                                     replay_max_experiences=1600, minibatch_mode=mode)
    want = (cfg.replay_max_experiences if mode == "experience"
            else cfg.replay_capacity_episodes) // 4
    assert [res[mode]["shard"] for res in _invariants(rank_results)] == [want] * 4


def test_testfreq_and_checkpoints(rank_results):
    env = tregistry.make_env("diffusion-simple", device="cpu", **DIFFUSION)
    cfg = ttrainer.default_rl_config(env, width=16, replay_start_experiences=10,
                                     replay_max_experiences=1600, mini_batch_episodes=2)
    ckpt_dir = str(rank_results["dirs"][0])
    tests = [res["testfreq"] for res in _invariants(rank_results)]
    assert len(tests[0]) == 1 and np.isfinite(tests[0][0]) and tests == [tests[0]] * 4
    assert tckpt.load_train_state(ckpt_dir, cfg) is not None
    assert tckpt.load_meta(ckpt_dir)["gen"] == 3
    assert tckpt.load_history(ckpt_dir)["gen"][-1] == 3


def test_resume_continues(rank_results):
    ranks = [res["resume"] for res in _invariants(rank_results)]
    assert ranks[0]["gen"] == [1, 2, 3, 4]
    assert ranks[0]["experiences"][-1] == 4 * 4 * 2 * 10
    assert all(r["digest"] == ranks[0]["digest"] for r in ranks)


def test_episode_bases_and_pool_rows(rank_results):
    """Rank r's envs of generation g start at the JAX mesh's base
    (g * W * envs_per_device + r * envs_per_device, mesh.py:152, 274-275) and
    reset to the pool rows the JAX env resets those episode counts to."""
    jenv = jregistry.make_env("burger", n_dns=3, **SMALL)
    for r, res in enumerate(_invariants(rank_results)):
        assert [b["base"] for b in res["bases"]] == [g * 4 * 2 + r * 2 for g in range(2)]
        for b in res["bases"]:
            counts = jnp.arange(b["base"], b["base"] + 2)
            sidx = jax.vmap(lambda c: jenv.reset(jenv.consts, jax.random.key(0), c)[0].sidx)(counts)
            assert b["sidx"] == np.asarray(sidx).tolist()


# ------------------------------------------------------------------ the CLI


def _json_lines(out):
    return [json.loads(ln) for ln in out.splitlines() if ln.startswith("{")]


def test_cli_mesh_world_1_in_process(tmp_path, monkeypatch, capsys):
    """--mesh under a plain call: a world of 1, one JSON line with the JAX
    CLI's keys (marlpde_tpu/run.py:493-495) and its generation count,
    --NE // (--numenvs * T), and no process group left behind (the JAX CLI's
    own line is held beside the port's in
    tests/test_torch_run_test.py::test_training_only_flags_are_ignored_by_the_test_stage_as_in_jax)."""
    monkeypatch.chdir(tmp_path)
    ts, rep, hist = trun.main(TINY, device="cpu")
    out = capsys.readouterr().out
    got = _json_lines(out)
    assert len(got) == 1 and list(got[0]) == ["workload", "mesh_devices", "final_mean_return",
                                              "generations"]
    assert got[0]["generations"] == 80 // (8 * 5) == hist["gen"][-1]
    assert got[0]["mesh_devices"] == 1 and got[0]["final_mean_return"] == hist["mean_return"][-1]
    assert "[mesh] 1 rank(s), backend gloo (ranks on the CPU)" in out
    assert out.count("[mesh-trainer] gen ") == 2 and not dist.is_initialized()
    assert {p.name for p in (tmp_path / "_result_burger_0").iterdir()} == {
        "latest.pt", "history.json", "meta.npz"}


def test_cli_numenvs_must_divide_the_world(tmp_path, monkeypatch):
    """JAX's SystemExit, raised before anything is built; the process group
    the CLI started is gone."""
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    monkeypatch.chdir(tmp_path / "j")
    argv = TINY[:-5] + ["--numenvs", "3", "--mesh"]
    with pytest.raises(SystemExit, match="--numenvs 3 must divide the device count 8"):
        jrun.main(argv)
    # in process the port's world is 1: the mesh reports a world of 2
    monkeypatch.chdir(tmp_path / "t")
    make = pmesh.make_mesh
    monkeypatch.setattr(pmesh, "make_mesh", lambda device: dataclasses.replace(make(device),
                                                                              world=2))
    with pytest.raises(SystemExit, match="--numenvs 3 must divide the device count 2"):
        trun.main(argv, device="cpu")
    assert not dist.is_initialized() and list((tmp_path / "t").iterdir()) == []


def test_cli_mesh_under_two_ranks(tmp_path):
    """Two spawned ranks of run.main(..., device="cpu"): rank 0 prints the
    one JSON line, with mesh_devices 2; the other prints none; both ranks
    end with the same train state, bit for bit, after the same updates."""
    out = subprocess.run(
        [sys.executable, "-m", "marlpde_tpu_torch.parallel.dryrun", "--world", "2",
         "--device", "cpu", "--cli",
         *TINY[:-5], "--numenvs", "4", "--NE", "40", "--rstart", "10", "--run", "3", "--mesh"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=ROOT))
    assert out.returncode == 0, out.stdout + out.stderr
    verdict = json.loads(out.stdout.strip().splitlines()[-1])
    assert verdict["ok"] and verdict["processes"] == 2
    first, second = verdict["json_lines"]
    assert second == [] and len(first) == 1 and list(first[0]) == [
        "workload", "mesh_devices", "final_mean_return", "generations"]
    assert first[0]["mesh_devices"] == 2 and first[0]["generations"] == 2
    assert out.stderr.count("[mesh-trainer] gen ") == 2
    # rstart 10: 40 updates in each generation (4 episodes of 5 steps at
    # korali's 512 reuse over minibatches of 256)
    assert verdict["n_updates"] == [80, 80] and len(set(verdict["digests"])) == 1
    assert [len(w) for w in verdict["wall_time"]] == [2, 2]


# ------------------------------------------------------------ CUDA graphs

# One gloo rank that runs the mesh's generations of both modes directly, then
# graphed through tests/graph_standins.py with the capture decision forced on
# (on the card only NCCL ranks capture); writes what it found to
# <out>.<rank>.json.
GRAPH_WORKER = r'''
import json, sys
import torch
import torch.distributed as dist
torch.set_num_threads(1)
spec = json.loads(sys.argv[1])
sys.path.insert(0, spec["tests"])
import graph_standins as standins
from marlpde_tpu_torch.envs import registry
from marlpde_tpu_torch.parallel import mesh as pmesh
from marlpde_tpu_torch.train import trainer
from marlpde_tpu_torch.utils import checkpoint as ckpt
from marlpde_tpu_torch.utils import graphs

mesh = pmesh.make_mesh("cpu")
env = registry.make_env("burger", device="cpu", **spec["small"])
direct_graph, direct_enabled, direct_captures = graphs.new_graph, graphs.enabled, pmesh.Mesh.captures
real_capture, captured = graphs.capture, []


def counted_capture(name, fn, *a, **kw):
    captured.append(name + (" (test)" if getattr(fn, "deterministic", False) else ""))
    return real_capture(name, fn, *a, **kw)


def run(mode, graphed):
    graphs.new_graph = standins.Replayed if graphed else direct_graph
    graphs.enabled = (lambda device: True) if graphed else direct_enabled
    pmesh.Mesh.captures = property(lambda self: True) if graphed else direct_captures
    cfg = trainer.default_rl_config(env, width=8, minibatch_mode=mode, mini_batch_size=8,
                                    mini_batch_episodes=1, replay_start_experiences=10,
                                    replay_max_experiences=40, replay_episode_capacity=8)
    ts, rep, hist = pmesh.run_generations(env, cfg, mesh, envs_per_device=2, updates_per_gen=3,
                                          n_generations=3, seed=4, testing_frequency=2,
                                          testing_episodes=2)
    learner = graphs.tensors((list(ckpt.dcp_state(ts).values()), ts.obs_stats, ts.rew_stats))
    kept = sum(any(o is mesh for o in objs) for objs, _ in graphs._CACHE.values())
    return learner, graphs.tensors(rep), hist, int(ts.n_updates), kept


graphs.capture = counted_capture
out = {}
for mode in ("experience", "episode"):
    (a, ra, ha, na, _), (b, rb, hb, nb, kept) = run(mode, False), run(mode, True)
    out[mode] = dict(tensors=len(a + ra), equal=sum(torch.equal(x.nan_to_num(), y.nan_to_num())
                                                    for x, y in zip(a + ra, b + rb)),
                     returns=[ha["mean_return"], hb["mean_return"], ha["test_return"],
                              hb["test_return"]],
                     n_updates=[na, nb], captures=sorted(captured), kept=kept,
                     digest=[float(x.double().sum()) for x in b])
    captured.clear()
with open(f"{spec['out']}.{mesh.rank}.json", "w") as f:
    json.dump(out, f)
dist.destroy_process_group()
'''


def test_mesh_graphs_give_the_direct_bits_on_two_ranks(tmp_path):
    """Two gloo ranks, both modes, 3 generations with updates from the first
    and a test collection: the graphed run (collections and updates, the
    updates with their all_reduces, through the stand-ins) ends with the
    direct run's train state, normalizers, replay shard and returns, bit for
    bit; each rank captured the training macro-step, the test macro-step and
    its 3 updates (one graph, trainer.run_updates' remainder of UPDATE_CHUNK)
    once in the run, and kept no graph of the group's collectives
    after it (NCCL cannot destroy a communicator such a graph holds); the
    ranks end equal."""
    spec = dict(small=SMALL, tests=os.path.join(ROOT, "tests"), out=str(tmp_path / "out"))
    rcs, outs = dryrun.launch(2, [json.dumps(spec)], code=GRAPH_WORKER, timeout=300)
    assert rcs == [0, 0], "\n".join(outs)
    res = [json.load(open(tmp_path / f"out.{r}.json")) for r in range(2)]
    for mode, update in (("experience", "3 experience-mode updates"),
                         ("episode", "3 episode-mode updates")):
        for r in res:
            got = r[mode]
            assert got["equal"] == got["tensors"] > 20, (mode, got)
            ret, ret_g, test, test_g = got["returns"]
            assert ret == ret_g and test == test_g and len(test) == 1, (mode, got["returns"])
            assert got["n_updates"] == [9, 9], (mode, got["n_updates"])
            assert got["kept"] == 0        # the run's update graphs end with it
            assert got["captures"] == sorted(["burger-marl macro-step",
                                              "burger-marl macro-step (test)",
                                              update]), (mode, got["captures"])
        assert res[0][mode]["digest"] == res[1][mode]["digest"], mode


def test_cli_mesh_captures_the_macro_step_once_a_run(tmp_path, monkeypatch, capsys):
    """run.main(... --mesh) at a world of 1 over 4 generations, graphed
    through the stand-ins: the rank keeps one device generator, so the
    training macro-step is captured once in the run (it was once a
    generation while each generation made a new generator), and the test
    collection once; the gloo rank's updates stay eager, no update captured."""
    monkeypatch.chdir(tmp_path)
    standins.use(monkeypatch, standins.Replayed)
    captured, real = [], graphs.capture

    def counted(name, fn, *a, **kw):
        captured.append((name, getattr(fn, "deterministic", None)))
        return real(name, fn, *a, **kw)

    monkeypatch.setattr(graphs, "capture", counted)
    _, _, hist = trun.main(TINY[:-3] + ["--NE", "160", "--rstart", "10", "--testfreq", "2",
                                        "--testepisodes", "2", "--mesh"], device="cpu")
    assert hist["gen"] == [1, 2, 3, 4] and len(hist["test_return"]) == 2
    assert sorted(captured, key=str) == [("burger macro-step", False),
                                         ("burger macro-step", True)]
    assert "backend gloo" in capsys.readouterr().out


def test_the_rank_reseeds_one_device_generator(monkeypatch):
    """run_generations keeps the rank's device generator for the run and
    reseeds it each generation from the host stream, unchanged: at every
    collection it draws what a fresh generator of that seed draws."""
    env = tregistry.make_env("diffusion-simple", device="cpu", **DIFFUSION)
    cfg = ttrainer.default_rl_config(env, width=8, replay_start_experiences=10**6)
    seen, real = [], pmesh.collect_episodes

    def recorded(env, rl_cfg, ts, generator, *a, **kw):
        seen.append((generator, generator.get_state()))
        return real(env, rl_cfg, ts, generator, *a, **kw)

    monkeypatch.setattr(pmesh, "collect_episodes", recorded)
    mesh = pmesh.make_mesh("cpu")
    try:
        pmesh.run_generations(env, cfg, mesh, envs_per_device=2, updates_per_gen=1,
                              n_generations=3, seed=11)
    finally:
        dist.destroy_process_group()
    host = torch.Generator().manual_seed(11)
    pmesh._seeds(host, 1)                       # the initial weights' seed
    assert len(seen) == 3 and len({id(g) for g, _ in seen}) == 1
    for _, state in seen:
        fresh = torch.Generator().manual_seed(pmesh._seeds(host, 1)[0])
        reseeded = torch.Generator()
        reseeded.set_state(state)
        assert torch.equal(state, fresh.get_state())
        assert torch.equal(torch.rand(8, generator=reseeded), torch.rand(8, generator=fresh))


# ------------------------------------------------------ checkpoint, dry run


def test_dcp_checkpoint_round_trip_one_rank(tmp_path):
    """The "orbax" backend in one process (no process group): before and
    after the first Adam step, every tensor back bit for bit."""
    cfg, jts, tcfg = _learner()
    ts = tv.init_train(tcfg, torch.Generator().manual_seed(3), dtype=torch.float64)
    for step in (False, True):
        if step:
            ts.net(torch.randn(4, OBS, dtype=torch.float64))[0].sum().backward()
            ts.opt.step()
            ts = dataclasses.replace(ts, n_updates=5)
        tckpt.save_train_state(str(tmp_path), ts, {"gen": [1]}, backend="orbax")
        back = tckpt.load_train_state(str(tmp_path), tcfg, backend="orbax")
        live, restored = tckpt.dcp_state(ts), tckpt.dcp_state(back)
        assert live.keys() == restored.keys()
        for k in live:
            assert live[k].dtype == restored[k].dtype and torch.equal(live[k], restored[k]), k
        assert back.n_updates == ts.n_updates
    assert not (tmp_path / "latest.pt").exists()
    assert tckpt.load_history(str(tmp_path)) == {"gen": [1]}


@pytest.fixture(scope="module")
def two_rank_dryrun(tmp_path_factory):
    out_dir = tmp_path_factory.mktemp("dryrun")
    out = subprocess.run(
        [sys.executable, "-m", "marlpde_tpu_torch.parallel.dryrun", "--world", "2",
         "--device", "cpu", "--out", str(out_dir)], cwd=out_dir, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=ROOT))
    return out, out_dir


def test_dryrun_two_ranks(two_rank_dryrun):
    """Both modes on both ranks: updates, the train state equal bit for bit
    across the ranks, filled shards, the checkpoint restored on each rank;
    no kernel launched on the CPU, and each rank's experience-mode updates
    (3 generations of 2, the replay warm from the first)."""
    out, _ = two_rank_dryrun
    assert out.returncode == 0, out.stdout + out.stderr
    verdict = json.loads(out.stdout.strip().splitlines()[-1])
    assert verdict == {"ok": True, "processes": 2, "global_devices": 2, "device": "cpu",
                       "launches": [{"abcn_macro_step": 0, "mlp_forward": 0,
                                     "vracer_loss": 0}] * 2,
                       "generations": 3, "experience_updates": [6, 6]}
    assert out.stderr.count("experience-mode OK") == 2, out.stderr
    assert out.stderr.count("episode-mode OK") == 2, out.stderr


def test_dcp_checkpoint_round_trip_two_ranks(two_rank_dryrun, tmp_path):
    """The checkpoint the two ranks wrote together: each rank restored it bit
    for bit (the dry run's check); it holds one copy of the state (the
    replicated tensors written once, spread over the ranks' files), and one
    process reads it back."""
    out, out_dir = two_rank_dryrun
    assert out.returncode == 0, out.stdout + out.stderr
    env = tregistry.make_env("burger", device="cpu", **SMALL)
    for mode in ("experience", "episode"):
        cfg = ttrainer.default_rl_config(env, width=dryrun.WIDTH, replay_start_experiences=2,
                                         replay_max_experiences=400, mini_batch_episodes=1,
                                         minibatch_mode=mode, mini_batch_size=16)
        ts = tckpt.load_train_state(str(out_dir / mode), cfg, backend="orbax")
        assert ts.n_updates == 6
        two = sorted((out_dir / mode / "latest_dcp").glob("*.distcp"))
        assert len(two) == 2
        tckpt.save_train_state(str(tmp_path / mode), ts, backend="orbax")
        one = list((tmp_path / mode / "latest_dcp").glob("*.distcp"))
        size = lambda files: sum(f.stat().st_size for f in files)
        assert size(two) < 1.5 * size(one), (size(two), size(one))


def test_dryrun_refuses_a_cli_without_mesh():
    with pytest.raises(SystemExit):
        dryrun.main(["--world", "2", "--cli", "burger"])
