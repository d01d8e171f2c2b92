"""JAX <-> PyTorch state conversion for the port's parity tests, through numpy.

The helpers turn a JAX ``TrainState`` / ``Replay`` / ``FastEnvState`` /
``DnsPool`` into the port's counterpart and back, so each parity test starts
both sides from identical state.  Other ``test_torch_*`` files import them;
the tests below check that a round trip changes nothing.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

from marlpde_tpu.envs import burger_env as jbe
from marlpde_tpu.envs import burger_fast as jbf
from marlpde_tpu.rl import replay as jreplay
from marlpde_tpu.rl import replay_flat as jflat
from marlpde_tpu.rl import running_stats as jrs
from marlpde_tpu.solvers import burger as jburger
from marlpde_tpu.rl import vracer as jv
from marlpde_tpu_torch.envs import burger_env as tbe
from marlpde_tpu_torch.envs import burger_fast as tbf
from marlpde_tpu_torch.rl import networks as tnet
from marlpde_tpu_torch.rl import replay as treplay
from marlpde_tpu_torch.rl import replay_flat as tflat
from marlpde_tpu_torch.rl import running_stats as trs
from marlpde_tpu_torch.rl import vracer as tv
from marlpde_tpu_torch.solvers import burger as tburger

torch.set_num_threads(1)

_INT_FIELDS = ("sidx", "ioutnum", "macro_step")
_FLAT_IDS = ("ep_first", "ep_last", "ep_idx")
_FLAT_COUNTERS = ("cursor", "n_episodes")


def t(x, dtype=None):
    """numpy-able -> torch tensor (CPU), optionally cast."""
    out = torch.from_numpy(np.array(x))
    return out if dtype is None else out.to(dtype)


def n(x):
    """torch tensor -> numpy."""
    return x.detach().cpu().numpy()


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _flax_tree(state_dict_np_tree, dtype):
    return jax.tree.map(lambda a: jnp.asarray(a, dtype), state_dict_np_tree)


def params64(cfg, jts):
    """A JAX TrainState with float64 params and a fresh float64 Adam state
    (flax creates float32 params whatever the input dtype)."""
    params = jax.tree.map(lambda a: a.astype(jnp.float64), jts.params)
    return jts.replace(params=params, opt_state=jv.make_optimizer(cfg).init(params))


def stats_from_jax(rs):
    return trs.RunningStats(mean=t(rs.mean), m2=t(rs.m2), count=t(rs.count))


def stats_to_jax(rs):
    return jrs.RunningStats(mean=jnp.asarray(n(rs.mean)), m2=jnp.asarray(n(rs.m2)),
                            count=jnp.asarray(n(rs.count)))


def train_state_from_jax(cfg, jts) -> tv.TrainState:
    """JAX TrainState -> port TrainState (CPU; dtype of the JAX params)."""
    params = np_tree(jts.params)
    dtype = t(params["params"]["Dense_0"]["kernel"]).dtype
    net = tv.make_net(cfg, dtype=dtype)
    net.load_state_dict(tnet.params_from_flax(params))
    opt = tv.make_optimizer(cfg, net)
    adam = jts.opt_state[1][0]
    count = int(adam.count)
    if count:
        mu = tnet.params_from_flax(np_tree(adam.mu))
        nu = tnet.params_from_flax(np_tree(adam.nu))
        for name, p in net.named_parameters():
            opt.state[p] = dict(step=torch.tensor(float(count)),
                                exp_avg=mu[name].to(dtype).clone(),
                                exp_avg_sq=nu[name].to(dtype).clone())
    return tv.TrainState(net=net, opt=opt, beta=t(jts.beta), n_updates=int(jts.n_updates),
                         obs_stats=stats_from_jax(jts.obs_stats),
                         rew_stats=stats_from_jax(jts.rew_stats))


def train_state_to_jax(cfg, ts, jtemplate):
    """Port TrainState -> JAX TrainState shaped like ``jtemplate``."""
    dtype = jax.tree.leaves(jtemplate.params)[0].dtype
    params = _flax_tree(tnet.params_to_flax(ts.net), dtype)
    adam = jtemplate.opt_state[1][0]
    names = [name for name, _ in ts.net.named_parameters()]
    st = [ts.opt.state.get(p) for p in ts.net.parameters()]
    if st[0]:
        def tree(key):
            fake = tv.make_net(cfg, dtype=ts.beta.dtype)
            fake.load_state_dict({nm: s[key] for nm, s in zip(names, st)})
            return _flax_tree(tnet.params_to_flax(fake), dtype)
        adam = adam._replace(count=jnp.asarray(int(st[0]["step"]), jnp.int32),
                             mu=tree("exp_avg"), nu=tree("exp_avg_sq"))
    opt_state = (jtemplate.opt_state[0], (adam,) + tuple(jtemplate.opt_state[1][1:]))
    return jtemplate.replace(params=params, opt_state=opt_state,
                             beta=jnp.asarray(n(ts.beta)),
                             n_updates=jnp.asarray(ts.n_updates, jnp.int32),
                             obs_stats=stats_to_jax(ts.obs_stats),
                             rew_stats=stats_to_jax(ts.rew_stats))


def replay_from_jax(jrep) -> treplay.Replay:
    kw = {f.name: t(getattr(jrep, f.name)) for f in dataclasses.fields(treplay.Replay)
          if f.name not in ("filled", "cursor")}
    return treplay.Replay(**kw, filled=int(jrep.filled), cursor=int(jrep.cursor))


def replay_to_jax(rep) -> jreplay.Replay:
    kw = {f.name: jnp.asarray(n(getattr(rep, f.name)))
          for f in dataclasses.fields(treplay.Replay) if f.name not in ("filled", "cursor")}
    return jreplay.Replay(**kw, filled=jnp.asarray(rep.filled, jnp.int32),
                          cursor=jnp.asarray(rep.cursor, jnp.int32))


def flat_from_jax(jrep) -> tflat.FlatReplay:
    """JAX FlatReplay (int32 ids, device counters) -> the port's (int64 ids,
    host counters)."""
    kw = {f.name: t(getattr(jrep, f.name), torch.int64 if f.name in _FLAT_IDS else None)
          for f in dataclasses.fields(tflat.FlatReplay) if f.name not in _FLAT_COUNTERS}
    return tflat.FlatReplay(**kw, cursor=int(jrep.cursor), n_episodes=int(jrep.n_episodes))


def flat_to_jax(rep) -> jflat.FlatReplay:
    kw = {f.name: jnp.asarray(n(getattr(rep, f.name)).astype(np.int32)
                              if f.name in _FLAT_IDS else n(getattr(rep, f.name)))
          for f in dataclasses.fields(tflat.FlatReplay) if f.name not in _FLAT_COUNTERS}
    return jflat.FlatReplay(**kw, cursor=jnp.asarray(rep.cursor, jnp.int32),
                            n_episodes=jnp.asarray(rep.n_episodes, jnp.int32))


def fast_state_from_jax(jst) -> tbf.FastEnvState:
    return tbf.FastEnvState(**{
        f.name: t(getattr(jst, f.name), torch.int64 if f.name in _INT_FIELDS else None)
        for f in dataclasses.fields(tbf.FastEnvState)})


def fast_state_to_jax(st) -> jbf.FastEnvState:
    return jbf.FastEnvState(**{
        f.name: jnp.asarray(n(getattr(st, f.name)).astype(np.int32)
                            if f.name in _INT_FIELDS else n(getattr(st, f.name)))
        for f in dataclasses.fields(tbf.FastEnvState)})


def _to_t(name, x):
    return t(x, torch.int64 if name in _INT_FIELDS else None)


def _to_j(name, x):
    a = n(x)
    return jnp.asarray(a.astype(np.int32) if name in _INT_FIELDS else a)


def env_state_from_jax(jst) -> tbe.BurgerEnvState:
    """JAX BurgerEnvState (batched by vmap) -> the port's."""
    solver = tburger.BurgerState(**{f.name: _to_t(f.name, getattr(jst.solver, f.name))
                                    for f in dataclasses.fields(tburger.BurgerState)})
    return tbe.BurgerEnvState(solver=solver, **{
        f.name: _to_t(f.name, getattr(jst, f.name))
        for f in dataclasses.fields(tbe.BurgerEnvState) if f.name != "solver"})


def env_state_to_jax(st) -> jbe.BurgerEnvState:
    solver = jburger.BurgerState(**{f.name: _to_j(f.name, getattr(st.solver, f.name))
                                    for f in dataclasses.fields(tburger.BurgerState)})
    return jbe.BurgerEnvState(solver=solver, **{
        f.name: _to_j(f.name, getattr(st, f.name))
        for f in dataclasses.fields(tbe.BurgerEnvState) if f.name != "solver"})


def pool_from_jax(jpool) -> tbe.DnsPool:
    return tbe.DnsPool(**{f.name: (None if getattr(jpool, f.name) is None
                                   else t(getattr(jpool, f.name)))
                          for f in dataclasses.fields(tbe.DnsPool)})


# ---------------------------------------------------------------- round trips

def _updated_jax_state(dtype):
    cfg = jv.VracerConfig(obs_dim=3, act_dim=1, num_agents=2, episode_length=4,
                          width=8)
    jts = jv.init_train(cfg, jax.random.key(3), dtype=dtype)
    if dtype == jnp.float64:
        jts = params64(cfg, jts)
    # one optimizer step so the Adam state is non-trivial
    grads = jax.tree.map(lambda a: jnp.full_like(a, 0.01), jts.params)
    upd, opt_state = jv.make_optimizer(cfg).update(grads, jts.opt_state, jts.params)
    return cfg, jts.replace(params=optax.apply_updates(jts.params, upd),
                            opt_state=opt_state, n_updates=jnp.asarray(1, jnp.int32))


def test_train_state_round_trip():
    cfg, jts = _updated_jax_state(jnp.float64)
    ts = train_state_from_jax(cfg, jts)
    assert ts.n_updates == 1 and ts.net.hidden[0].weight.dtype == torch.float64
    back = train_state_to_jax(cfg, ts, jts)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jts)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_replay_and_fast_state_round_trip():
    rep = jreplay.init(3, 4, 2, 5, 1, dtype=jnp.float32)
    rep = rep.replace(obs=rep.obs + 1.5, filled=jnp.asarray(2, jnp.int32),
                      cursor=jnp.asarray(2, jnp.int32))
    back = replay_to_jax(replay_from_jax(rep))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(rep)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    frep = jflat.init_flat(6, 3, 2, 5, 1, dtype=jnp.float64)
    frep = frep.replace(obs=frep.obs + 1.5, ep_last=frep.ep_last + 4,
                        off=frep.off.at[2].set(True), cursor=jnp.asarray(9, jnp.int32),
                        n_episodes=jnp.asarray(2, jnp.int32))
    tback = flat_from_jax(frep)
    assert tback.ep_last.dtype == torch.int64 and (tback.cursor, tback.live) == (9, 6)
    back = flat_to_jax(tback)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(frep)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        assert np.asarray(a).dtype == np.asarray(b).dtype

    cfg = jbe.BurgerEnvConfig(N_dns=64, grid_size=32, num_actions=32, num_agents=4,
                              dt=0.01, T=0.5, nu=0.05, episode_length=5,
                              ic_case="turbulence", spectral_reward=True)
    pool = jbe.make_dns_pool(cfg, 1, dtype=jnp.float32)
    jst, _ = jbf.reset(cfg, pool, jax.random.split(jax.random.key(0), 2), jnp.arange(2))
    back = fast_state_to_jax(fast_state_from_jax(jst))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jst)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        assert np.asarray(a).dtype == np.asarray(b).dtype
