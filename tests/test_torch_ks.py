"""Port parity: core/interp.py, solvers/ks.py (ETDRK4), envs/ks_env.py and the
registry's 'ks' against the JAX package, in float64.

Tolerances: the interpolation at 1e-12; the ETDRK4 solver over 40 steps at
rtol 1e-10 (the same float64 arithmetic on torch.fft and on jnp.fft, compared
over a horizon short enough that KS's chaos does not amplify the last bits);
the host DNS pool field by field at 1e-12; whole episodes through reset/step
at 1e-9; flags exact.  The noise offsets of ``reset`` are drawn by JAX's key
and injected into the port's ``reset_at``."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from marlpde_tpu.core import interp as jinterp
from marlpde_tpu.envs import ks_env as jke
from marlpde_tpu.envs import registry as jreg
from marlpde_tpu.envs import rollout as jroll
from marlpde_tpu.rl import vracer as jv
from marlpde_tpu.solvers import ks as jks
from marlpde_tpu.train import trainer as jtr
from marlpde_tpu_torch.core import interp as tinterp
from marlpde_tpu_torch.envs import ks_env as tke
from marlpde_tpu_torch.envs import registry as treg
from marlpde_tpu_torch.envs import rollout as troll
from marlpde_tpu_torch.solvers import ks as tks
from marlpde_tpu_torch.train import trainer as ttr
from test_torch_interop import params64, train_state_from_jax

torch.set_num_threads(1)

SMALL = dict(N_dns=64, grid_size=16, num_actions=16, t_transient=5.0, t_end=15.0,
             episode_length=5)
_INT = ("sidx", "macro_step", "ioutnum")


def tcfg(jcfg):
    """The port's KSEnvConfig of a JAX one (which also has fft_impl)."""
    return tke.KSEnvConfig(**{k: v for k, v in dataclasses.asdict(jcfg).items()
                              if k != "fft_impl"})


def _t(name, x):
    return torch.from_numpy(np.array(x)).to(torch.int64 if name in _INT else None)


def _j(name, x):
    a = x.numpy()
    return jnp.asarray(a.astype(np.int32) if name in _INT else a)


def state_from_jax(jst) -> tke.KSEnvState:
    solver = tks.KSState(**{f.name: _t(f.name, getattr(jst.solver, f.name))
                            for f in dataclasses.fields(tks.KSState)})
    return tke.KSEnvState(solver=solver, **{
        f.name: _t(f.name, getattr(jst, f.name))
        for f in dataclasses.fields(tke.KSEnvState) if f.name != "solver"})


def state_to_jax(st) -> jke.KSEnvState:
    solver = jks.KSState(**{f.name: _j(f.name, getattr(st.solver, f.name))
                            for f in dataclasses.fields(tks.KSState)})
    return jke.KSEnvState(solver=solver, **{
        f.name: _j(f.name, getattr(st, f.name))
        for f in dataclasses.fields(tke.KSEnvState) if f.name != "solver"})


def pool_from_jax(jpool) -> tke.KSDnsPool:
    return tke.KSDnsPool(**{f.name: torch.from_numpy(np.array(getattr(jpool, f.name)))
                            for f in dataclasses.fields(tke.KSDnsPool)})


def assert_state(st, jst, tol, msg=""):
    back = state_to_jax(st)
    for (path, got), want in zip(jax.tree_util.tree_leaves_with_path(back),
                                 jax.tree.leaves(jst)):
        got, want = np.asarray(got), np.asarray(want)
        if got.dtype.kind in "bi":
            np.testing.assert_array_equal(got, want, err_msg=f"{msg} {path}")
        else:
            np.testing.assert_allclose(got, want, rtol=tol, atol=tol, err_msg=f"{msg} {path}")


# ------------------------------------------------------------------ interp

def test_interp_matches_jax():
    rng = np.random.default_rng(0)
    L, N = 22.0, 32
    y = rng.standard_normal((3, 4, N))
    xq = rng.uniform(-L, 2 * L, 17)
    jm = jinterp.periodic_spline_m(jnp.asarray(y))
    tm = tinterp.periodic_spline_m(torch.from_numpy(y))
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), atol=1e-12)
    pairs = [
        (tinterp.periodic_spline_eval(torch.from_numpy(y), tm, torch.from_numpy(xq), L),
         jinterp.periodic_spline_eval(jnp.asarray(y), jm, jnp.asarray(xq), L)),
        (tinterp.cubic_interp(torch.from_numpy(y), torch.from_numpy(xq), L),
         jinterp.cubic_interp(jnp.asarray(y), jnp.asarray(xq), L)),
        (tinterp.linear_interp(torch.from_numpy(y), torch.from_numpy(xq), L),
         jinterp.linear_interp(jnp.asarray(y), jnp.asarray(xq), L)),
    ]
    # per-row offsets on the uniform query grid (JAX: one scalar offset, vmapped)
    off = rng.uniform(-L, L, 3)
    want = jax.vmap(lambda a, b, o: jinterp.periodic_spline_eval_uniform(a, b, o, L, 8))(
        jnp.asarray(y), jm, jnp.asarray(off))
    pairs.append((tinterp.periodic_spline_eval_uniform(torch.from_numpy(y), tm,
                                                       torch.from_numpy(off)[:, None], L, 8),
                  want))
    for got, want in pairs:
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-12)
    t = rng.uniform(-0.3, 3.0, 9)
    np.testing.assert_array_equal(
        tinterp.frame_index(torch.from_numpy(t), 0.25, 7).numpy(),
        np.asarray(jinterp.frame_index(jnp.asarray(t), 0.25, 7)))
    x = np.linspace(0, L, 16, endpoint=False)
    for shift in (-5.0, 0.3, 21.0):
        np.testing.assert_allclose(
            tinterp.shifted_query_points(torch.from_numpy(x), shift, L).numpy(),
            np.asarray(jinterp.shifted_query_points(jnp.asarray(x), shift, L)), atol=1e-12)


# ------------------------------------------------------------------ solver

COEFFS = (0.01, 0.1, 0.02, 0.001, 0.05)   # a stable altered symbol


@pytest.mark.parametrize("coeffs", [None, COEFFS], ids=["plain", "coeffs"])
def test_etdrk4_coeffs_equal(coeffs):
    jc = jks.etdrk4_coeffs(jks.KSConfig(N=32, dt=0.25, coeffs=coeffs))
    tc = tks.etdrk4_coeffs(tks.KSConfig(N=32, dt=0.25, coeffs=coeffs))
    for a, b in zip(tc, jc):
        np.testing.assert_array_equal(a, b)


def _assert_solver(ts, js, tol=1e-10):
    for f in dataclasses.fields(tks.KSState):
        a, b = getattr(ts, f.name).numpy(), np.asarray(getattr(js, f.name))
        np.testing.assert_allclose(a, b, rtol=tol, atol=tol * np.abs(b).max(), err_msg=f.name)


@pytest.mark.parametrize("kw,forced", [(dict(), True), (dict(), False),
                                       (dict(dforce=False), True),
                                       (dict(coeffs=COEFFS), True)],
                         ids=["dforce", "unforced", "d2udx2", "coeffs"])
def test_step_and_simulate_40_steps(kw, forced):
    jcfg, tcfg_ = jks.KSConfig(N=32, **kw), tks.KSConfig(N=32, **kw)
    rng = np.random.default_rng(1)
    u0 = rng.standard_normal((3, 32))
    js, ts = jks.init(jcfg, u0=jnp.asarray(u0)), tks.init(tcfg_, u0=torch.from_numpy(u0))
    af = rng.standard_normal((40, 3, 32)) * 0.2 if forced else None
    for i in range(2):
        a = None if af is None else af[i]
        js, jaux = jks.step(jcfg, js, None if a is None else jnp.asarray(a))
        ts, taux = tks.step(tcfg_, ts, None if a is None else torch.from_numpy(a))
        _assert_solver(ts, js)
        if forced:
            np.testing.assert_allclose(taux["sgs"].numpy(), np.asarray(jaux["sgs"]), atol=1e-12)
    jf, juu, jvv = jks.simulate(jcfg, js, 38, None if af is None else jnp.asarray(af[2:]))
    tf, tuu, tvv = tks.simulate(tcfg_, ts, 38, None if af is None else torch.from_numpy(af[2:]))
    _assert_solver(tf, jf)
    assert tuu.shape == juu.shape == (39, 3, 32) and tvv.shape == jvv.shape
    for a, b in ((tuu, juu), (tvv, jvv)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-10,
                                   atol=1e-10 * np.abs(np.asarray(b)).max())


def test_simulate_with_correction():
    cfg = jks.KSConfig(N=32)
    rng = np.random.default_rng(2)
    u0 = rng.standard_normal((2, 32))
    corr = np.fft.fft(rng.standard_normal(32)) * 1e-3
    jf, juu, _ = jks.simulate(cfg, jks.init(cfg, u0=jnp.asarray(u0)), 10,
                              correction=jnp.asarray(corr))
    tf, tuu, _ = tks.simulate(tks.KSConfig(N=32), tks.init(tks.KSConfig(N=32),
                                                           u0=torch.from_numpy(u0)), 10,
                              correction=torch.from_numpy(corr))
    _assert_solver(tf, jf)
    np.testing.assert_allclose(tuu.numpy(), np.asarray(juu), atol=1e-10)


def test_irfft_takes_bins_0_and_nyquist_as_real_and_the_state_keeps_them():
    """The state carries imaginary parts in bins 0 and N/2 (the negative
    Nyquist wavenumber in g = -0.5j k); the inverse transform reads them as
    zero, as numpy's and JAX's do, and the state keeps them as JAX's does."""
    rng = np.random.default_rng(3)
    rv = rng.standard_normal((4, 17)) + 1j * rng.standard_normal((4, 17))
    want = np.fft.irfft(rv, 32)
    zeroed = rv.copy()
    zeroed[:, [0, 16]] = zeroed[:, [0, 16]].real
    np.testing.assert_allclose(want, np.fft.irfft(zeroed, 32), atol=1e-14)
    np.testing.assert_allclose(tks.irfft(torch.from_numpy(rv), 32).numpy(), want, atol=1e-14)
    cfg = tks.KSConfig(N=32)
    st, _ = tks.step(cfg, tks.init(cfg, u0=torch.from_numpy(want)))
    assert (st.rv[:, 16].imag.abs() > 1e-6).all()
    jst, _ = jks.step(jks.KSConfig(N=32), jks.init(jks.KSConfig(N=32), u0=jnp.asarray(want)))
    np.testing.assert_allclose(st.rv.numpy(), np.asarray(jst.rv), atol=1e-12)


# ------------------------------------------------------------------ env

@pytest.fixture(scope="module")
def pools():
    jcfg = jke.KSEnvConfig(**SMALL)
    jpool = jke.make_dns_pool(jcfg, 2, dtype=jnp.float64)
    return jpool, pool_from_jax(jpool)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_host_pool_field_by_field(dtype):
    jcfg = jke.KSEnvConfig(**dict(SMALL, seed=7))
    jpool = jke.make_dns_pool(jcfg, 2, dtype=getattr(jnp, dtype))
    tpool = tke.make_dns_pool(tcfg(jcfg), 2, dtype=getattr(torch, dtype), device="cpu")
    assert tpool.uu.shape == (2, jcfg.n_dns_steps + 1, 64) and tpool.v0.is_complex()
    for name in ("uu", "spline_m", "ek_ktt", "nu", "v0"):
        got, want = getattr(tpool, name).numpy(), np.asarray(getattr(jpool, name))
        assert got.dtype == want.dtype, name
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-12, err_msg=name)


def _offsets(jcfg, keys, dtype):
    """The offsets JAX's reset draws from these keys (ks_env.py:235-239)."""
    if jcfg.noise <= 0.0:
        return np.zeros(len(keys))
    sigma = jcfg.noise * jcfg.L
    lim = jcfg.L / sigma
    return np.asarray(jax.vmap(lambda k: sigma * jax.random.truncated_normal(
        k, -lim, lim, dtype=dtype))(keys))


@pytest.mark.parametrize("kw", [dict(), dict(num_agents=4), dict(spectral_reward=False),
                                dict(spectral_reward=False, num_agents=4),
                                dict(noise=0.1, dforce=False, reward_factor=2.0)],
                         ids=["spectral", "marl", "pointwise", "pointwise-marl",
                              "noise-d2udx2"])
def test_episode_matches_vmapped_jax(kw, pools):
    """Three envs (pool rows 0, 1, 0) through a whole episode with injected
    actions: every state field, the observations, rewards, done and blown."""
    jpool, tpool = pools
    jcfg = jke.KSEnvConfig(**dict(SMALL, **kw))
    cfg = tcfg(jcfg)
    B = 3
    keys = jax.random.split(jax.random.key(3), B)
    jst, jobs = jax.vmap(lambda k, c: jke.reset(jcfg, jpool, k, c))(keys, jnp.arange(B))
    off = torch.from_numpy(_offsets(jcfg, keys, jnp.float64))
    st, obs = tke.reset_at(cfg, tpool, off, torch.arange(B))
    assert_state(st, jst, 1e-9, "reset")
    np.testing.assert_allclose(obs.numpy(), np.asarray(jobs), atol=1e-9)
    assert obs.shape == (B, cfg.num_agents, cfg.obs_dim)
    jstep = jax.jit(jax.vmap(lambda s, a: jke.step(jcfg, jpool, s, a)))
    rng = np.random.default_rng(4)
    for i in range(cfg.episode_length):
        a = rng.standard_normal((B, cfg.num_agents, cfg.actions_per_agent)) * 0.5
        jst, jo, jr, jd, jinfo = jstep(jst, jnp.asarray(a))
        st, o, r, d, info = tke.step(cfg, tpool, st, torch.from_numpy(a))
        assert_state(st, jst, 1e-9, f"step {i}")
        np.testing.assert_allclose(o.numpy(), np.asarray(jo), atol=1e-9)
        np.testing.assert_allclose(r.numpy(), np.asarray(jr), atol=1e-9)
        np.testing.assert_array_equal(d.numpy(), np.asarray(jd))
        np.testing.assert_array_equal(info["blown"].numpy(), np.asarray(jinfo["blown"]))
    assert d.all() and torch.isfinite(st.cum_reward).all()


def test_blown_env_freezes(pools):
    """Env 1 blows up at its first step (a NaN in its field) and env 2 starts
    done: both keep every field from then on, as JAX's keep_old does."""
    jpool, tpool = pools
    jcfg = jke.KSEnvConfig(**SMALL)
    cfg = tcfg(jcfg)
    jst, _ = jax.vmap(lambda k, c: jke.reset(jcfg, jpool, k, c))(
        jax.random.split(jax.random.key(0), 3), jnp.arange(3))
    st = state_from_jax(jst)
    st.solver.u[1, 3] = float("nan")
    st.solver.rv[1, 2] = complex("nan+nanj")
    st.done[2] = True
    jst = state_to_jax(st)
    frozen = []
    for i in range(3):
        a = np.full((3, 1, 16), 0.1 * (i + 1))
        jst, *_ = jke_step(jcfg, jpool, jst, a)
        st, obs, r, d, info = tke.step(cfg, tpool, st, torch.from_numpy(a))
        assert_state(st, jst, 1e-9, f"step {i}")
        frozen.append(state_to_jax(st))
        assert bool(d[1]) and bool(d[2]) and not bool(d[0])
        assert torch.isfinite(obs).all()
        assert (r[2] == 0).all() and (r[1] == (-np.inf if i == 0 else 0.0)).all()
    assert bool(info["blown"][1]) and torch.isneginf(st.cum_reward[1]).all()
    assert (st.cum_reward[2] == 0).all()
    for a, b in zip(jax.tree.leaves(frozen[1]), jax.tree.leaves(frozen[2])):
        np.testing.assert_array_equal(np.asarray(a)[1:], np.asarray(b)[1:])


def jke_step(jcfg, jpool, jst, a):
    return jax.vmap(lambda s, a_: jke.step(jcfg, jpool, s, a_))(jst, jnp.asarray(a))


def test_registry_zero_action_episode_and_collection_match_jax(pools):
    """registry.make_env('ks') on the CPU against the JAX registry's env, then
    a zero-action episode and a deterministic collection (sigma-relative
    policy of width 16, the same weights) through the port's rollout."""
    jpool, tpool = pools
    jenv = jreg.make_env("ks", pool=jpool, **SMALL)
    tenv = treg.make_env("ks", pool=tpool, **SMALL)
    for f in ("name", "obs_dim", "num_agents", "act_dim", "episode_length", "action_low",
              "action_high"):
        assert getattr(tenv, f) == getattr(jenv, f), f
    assert not tenv.whole_batch and tenv.cfg == tcfg(jenv.cfg)

    jtraj, jfin = jroll.zero_action_episode(jenv, jax.random.key(0), 3)
    ttraj, tfin = troll.zero_action_episode(tenv, None, 3)
    for k in ("obs", "rewards"):
        np.testing.assert_allclose(ttraj[k].numpy(), np.asarray(jtraj[k]), atol=1e-9, err_msg=k)
    np.testing.assert_array_equal(ttraj["done"].numpy(), np.asarray(jtraj["done"]))
    np.testing.assert_allclose(tfin.cum_reward.numpy(), np.asarray(jfin.cum_reward), atol=1e-9)

    kw = dict(width=16, mu_param="sigma_relative", cutoff_dim_norm=True, sigma_max=5.0)
    jcfg_rl = jtr.default_rl_config(jenv, **kw)
    jts = params64(jcfg_rl, jv.init_train(jcfg_rl, jax.random.key(1), dtype=jnp.float64))
    rng = np.random.default_rng(5)
    jts = jts.replace(params=jax.tree.map(
        lambda a: a + jnp.asarray(rng.standard_normal(a.shape) * 0.3), jts.params))
    tcfg_rl = ttr.default_rl_config(tenv, **kw)
    ts = train_state_from_jax(tcfg_rl, jts)
    jtraj, jfinal = jroll.collect_episodes(jenv, jcfg_rl, jts, jax.random.key(2), 3,
                                           deterministic=True)
    traj, final = troll.collect_episodes(tenv, tcfg_rl, ts, None, 3, deterministic=True)
    for name in ("obs", "actions", "mu", "sigma", "rewards", "mask", "final_obs"):
        np.testing.assert_allclose(traj[name].numpy(), np.asarray(jtraj[name]), atol=1e-9,
                                   err_msg=name)
    np.testing.assert_allclose(final.cum_reward.numpy(), np.asarray(jfinal.cum_reward),
                               atol=1e-9)
    assert np.abs(np.asarray(jtraj["actions"])).max() > 0.05


def test_make_env_builds_its_pool_in_the_dtype_asked():
    env = treg.make_env("ks", device="cpu", n_dns=2, **SMALL)
    assert env.consts.uu.dtype == torch.float32 and env.consts.v0.dtype == torch.complex64
    assert env.consts.uu.shape == (2, 41, 64) and env.consts.ek_ktt.shape == (2, 41, 8)
