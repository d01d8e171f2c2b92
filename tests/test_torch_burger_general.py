"""Port parity: the general Burgers path — ``solvers/burger.step``/``simulate``,
the per-env ``burger_env.step`` written over a leading env axis, and the
``fast='off'`` collection — against the JAX package in float64.

Tolerance 1e-10 absolute on fields of order 1-25 (the same float64 math on
torch.fft and on jnp.fft); flags exact."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from marlpde_tpu.envs import burger_env as jbe
from marlpde_tpu.envs import registry as jreg
from marlpde_tpu.envs import rollout as jroll
from marlpde_tpu.rl import vracer as jv
from marlpde_tpu.solvers import burger as jburger
from marlpde_tpu.train import trainer as jtr
from marlpde_tpu_torch.envs import burger_env as tbe
from marlpde_tpu_torch.envs import registry as treg
from marlpde_tpu_torch.envs import rollout as troll
from marlpde_tpu_torch.solvers import burger as tburger
from marlpde_tpu_torch.train import trainer as ttr
from test_torch_interop import (env_state_from_jax, env_state_to_jax, params64,
                                pool_from_jax, train_state_from_jax)

torch.set_num_threads(1)
ATOL = 1e-10

CFG = jbe.BurgerEnvConfig(N_dns=64, grid_size=32, num_actions=32, num_agents=4,
                          dt=0.01, T=0.5, nu=0.05, episode_length=5,
                          ic_case="turbulence", spectral_reward=True, noise=0.0)
ENV_KW = dataclasses.asdict(CFG)


def tcfg(cfg):
    return tbe.BurgerEnvConfig(**dataclasses.asdict(cfg))


def _solver_state(cfg, B, seed):
    rng = np.random.default_rng(seed)
    u0 = rng.standard_normal((B, cfg.N))
    nu = rng.uniform(0.01, 0.05, B)
    js = jburger.init(cfg, u0=jnp.asarray(u0), nu=jnp.asarray(nu))
    tcfg_ = tburger.BurgerConfig(**dataclasses.asdict(cfg))
    ts = tburger.init(tcfg_, u0=torch.from_numpy(u0), nu=torch.from_numpy(nu))
    return tcfg_, js, ts


def _assert_solver(ts, js):
    for f in dataclasses.fields(tburger.BurgerState):
        np.testing.assert_allclose(getattr(ts, f.name).numpy(), np.asarray(getattr(js, f.name)),
                                   atol=ATOL, rtol=0, err_msg=f.name)


@pytest.mark.parametrize("kw", [dict(), dict(dforce=False), dict(ssmforce=True),
                                dict(coeffs=(0.0, 0.1, -0.97, 0.001, -1.0))],
                         ids=["dforce", "d2udx2", "ssmforce", "coeffs"])
def test_solver_step_and_simulate(kw):
    cfg = jburger.BurgerConfig(N=32, nu=0.03, dt=1e-3, **kw)
    tcfg_, js, ts = _solver_state(cfg, 3, 0)
    rng = np.random.default_rng(1)
    af = rng.standard_normal((4, 3, 32)) * 0.5
    for i in range(2):
        js, jaux = jburger.step(cfg, js, jnp.asarray(af[i]))
        ts, taux = tburger.step(tcfg_, ts, torch.from_numpy(af[i]))
        _assert_solver(ts, js)
        np.testing.assert_allclose(taux["sgs"].numpy(), np.asarray(jaux["sgs"]), atol=ATOL)
    jfin, juu, jvv = jburger.simulate(cfg, js, 4, action_fields=jnp.asarray(af))
    tfin, tuu, tvv = tburger.simulate(tcfg_, ts, 4, action_fields=torch.from_numpy(af))
    _assert_solver(tfin, jfin)
    assert tuu.shape == juu.shape == (5, 3, 32)
    np.testing.assert_allclose(tuu.numpy(), np.asarray(juu), atol=ATOL)
    np.testing.assert_allclose(tvv.numpy(), np.asarray(jvv), atol=ATOL)


def test_simulate_unforced_with_correction():
    cfg = jburger.BurgerConfig(N=32, nu=0.03)
    tcfg_, js, ts = _solver_state(cfg, 2, 3)
    corr = np.fft.fft(np.random.default_rng(4).standard_normal(32)) * 1e-3
    jfin, juu, _ = jburger.simulate(cfg, js, 3, correction=jnp.asarray(corr))
    tfin, tuu, _ = tburger.simulate(tcfg_, ts, 3, correction=torch.from_numpy(corr))
    _assert_solver(tfin, jfin)
    np.testing.assert_allclose(tuu.numpy(), np.asarray(juu), atol=ATOL)


def test_solver_refuses_what_it_does_not_cover():
    """An unknown scheme raises at the step; both closures at once, and
    ssmforce without dforce, at the config (Burger.py:113-115), as in JAX."""
    cfg = tburger.BurgerConfig(N=16, scheme="rk4")
    st = tburger.init(cfg, u0=torch.zeros(1, 16, dtype=torch.float64))
    with pytest.raises(ValueError, match="unknown scheme"):
        tburger.step(cfg, st, torch.zeros(1, 16, dtype=torch.float64))
    for kw in (dict(ssm=True, dsm=True), dict(ssmforce=True, dforce=False)):
        with pytest.raises(AssertionError):
            tburger.BurgerConfig(N=16, **kw)
        with pytest.raises(AssertionError):
            jburger.BurgerConfig(N=16, **kw)


@pytest.fixture(scope="module")
def pools():
    jpool = jbe.make_dns_pool(CFG, 2, dtype=jnp.float64)
    return jpool, pool_from_jax(jpool)


@pytest.mark.parametrize("cfg_kw", [dict(), dict(version=3, noise=0.1),
                                    dict(dforce=False, reward_factor=2.0),
                                    dict(state_bound=3.0)],
                         ids=["flagship", "v3-noise", "d2udx2", "state-bound"])
def test_env_step_matches_vmapped_jax(cfg_kw, pools):
    """Four envs, three macro-steps: env 1 blows up at the first step (a NaN
    in its field), env 2 starts done, the others run."""
    jpool, tpool = pools
    cfg = dataclasses.replace(CFG, **cfg_kw)
    B = 4
    keys = jax.random.split(jax.random.key(3), B)
    jst, _ = jax.vmap(lambda k, c: jbe.reset(cfg, jpool, k, c))(keys, jnp.arange(B))
    tst = env_state_from_jax(jst)
    tst.solver.u[1, 4] = float("nan")
    tst.done[2] = True
    jst = env_state_to_jax(tst)
    rng = np.random.default_rng(5)
    for i in range(3):
        a = rng.standard_normal((B, cfg.num_agents, cfg.actions_per_agent))
        jout = jax.vmap(lambda s, a_: jbe.step(cfg, jpool, s, a_))(jst, jnp.asarray(a))
        tout = tbe.step(tcfg(cfg), tpool, tst, torch.from_numpy(a))
        jst, tst = jout[0], tout[0]
        back = env_state_to_jax(tst)
        for path_leaf, want in zip(jax.tree_util.tree_leaves_with_path(back),
                                   jax.tree.leaves(jst)):
            got = np.asarray(path_leaf[1])
            if got.dtype.kind in "bi":
                np.testing.assert_array_equal(got, np.asarray(want), err_msg=str(path_leaf[0]))
            else:
                np.testing.assert_allclose(got, np.asarray(want), atol=ATOL,
                                           err_msg=f"step {i} {path_leaf[0]}")
        for x, y in zip(tout[1:3], jout[1:3]):
            np.testing.assert_allclose(x.numpy(), np.asarray(y), atol=ATOL)
        np.testing.assert_array_equal(tout[3].numpy(), np.asarray(jout[3]))
        np.testing.assert_array_equal(tout[4]["blown"].numpy(), np.asarray(jout[4]["blown"]))
    assert bool(tst.done[1]) and torch.isneginf(tst.cum_reward[1]).all()
    assert (tst.cum_reward[2] == 0).all() and torch.isfinite(tout[1]).all()


def _weights(jenv, tenv):
    cfg = jtr.default_rl_config(jenv, width=16)
    jts = params64(cfg, jv.init_train(cfg, jax.random.key(1), dtype=jnp.float64))
    rng = np.random.default_rng(0)
    jts = jts.replace(params=jax.tree.map(
        lambda a: a + jnp.asarray(rng.standard_normal(a.shape) * 0.3), jts.params))
    tcfg_ = ttr.default_rl_config(tenv, width=16)
    return cfg, jts, tcfg_, train_state_from_jax(tcfg_, jts)


def test_fast_off_collection_matches_auto_and_jax(pools):
    """A deterministic collection through the per-env env (fast='off') equals
    the same collection through the whole-batch env (fast='auto') and JAX's
    fast='off' collection."""
    jpool, tpool = pools
    B = 3
    jenv = jreg.make_env("burger", pool=jpool, fast="off", **ENV_KW)
    tenv_off = treg.make_env("burger", pool=tpool, fast="off", **ENV_KW)
    tenv_auto = treg.make_env("burger", pool=tpool, fast="auto", **ENV_KW)
    assert not tenv_off.whole_batch and tenv_auto.whole_batch
    cfg, jts, tcfg_, ts = _weights(jenv, tenv_off)
    jtraj, jfinal = jroll.collect_episodes(jenv, cfg, jts, jax.random.key(2), B,
                                           deterministic=True)
    trajs = {name: troll.collect_episodes(env, tcfg_, ts, None, B, deterministic=True)
             for name, env in (("off", tenv_off), ("auto", tenv_auto))}
    for name in ("obs", "actions", "mu", "sigma", "rewards", "mask", "final_obs"):
        for which, (traj, _) in trajs.items():
            np.testing.assert_allclose(traj[name].numpy(), np.asarray(jtraj[name]), atol=ATOL,
                                       err_msg=f"{which} {name}")
    for traj, final in trajs.values():
        np.testing.assert_array_equal(traj["truncated"].numpy(), np.asarray(jtraj["truncated"]))
        np.testing.assert_allclose(final.cum_reward.numpy(), np.asarray(jfinal.cum_reward),
                                   atol=ATOL)
    assert np.abs(np.asarray(jtraj["actions"])).max() > 0.05


def test_zero_action_episode_matches_jax(pools):
    jpool, tpool = pools
    jenv = jreg.make_env("burger", pool=jpool, fast="off", **ENV_KW)
    tenv = treg.make_env("burger", pool=tpool, fast="off", **ENV_KW)
    jtraj, jfin = jroll.zero_action_episode(jenv, jax.random.key(0), 2)
    ttraj, tfin = troll.zero_action_episode(tenv, None, 2)
    for k in ("obs", "rewards"):
        assert ttraj[k].shape == jtraj[k].shape
        np.testing.assert_allclose(ttraj[k].numpy(), np.asarray(jtraj[k]), atol=ATOL, err_msg=k)
    np.testing.assert_array_equal(ttraj["done"].numpy(), np.asarray(jtraj["done"]))
    np.testing.assert_allclose(tfin.cum_reward.numpy(), np.asarray(jfin.cum_reward), atol=ATOL)
