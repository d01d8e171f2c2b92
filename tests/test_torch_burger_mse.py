"""Port parity: the Burgers env's MSE-reward, forced, coupled and lockstep
paths against the JAX package in float64 on the CPU.

  * the forced and MSE host DNS pools, ``truth_les`` included, against
    ``_make_dns_pool_host`` (1e-12 relative: the same float64 numpy build);
  * the MSE reset, with noise 0 and with injected offsets;
  * whole tiny episodes of the MSE (truth channel and spline paths), coupled
    and lockstep rewards, envs done or blown mid-episode included, and two
    macro-steps past the episode's end, whose frame indices clamp
    (1e-9 relative to each tensor's max |value|);
  * the lockstep env's rewards equal the pool env's (carried over from
    tests/test_envs.py::TestLockstepDns, at its 2e-5).

The JAX lockstep reset draws nu, the offset and the forcing tables from
``jax.random``; the streams never match, so the tests draw them in JAX and
inject them through ``reset_lockstep_at``."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from marlpde_tpu.envs import burger_env as jbe
from marlpde_tpu.solvers import burger as jburger
from marlpde_tpu_torch.envs import burger_env as tbe
from marlpde_tpu_torch.envs import registry as treg
from marlpde_tpu_torch.envs import rollout as troll
from marlpde_tpu_torch.solvers import burger as tburger
from test_torch_interop import env_state_from_jax, env_state_to_jax, pool_from_jax

torch.set_num_threads(1)
POOL_REL = 1e-12
EP_REL = 1e-9

BASE = dict(N_dns=64, grid_size=16, num_actions=16, num_agents=1, dt=0.01, T=0.2, nu=0.05,
            episode_length=5, ic_case="turbulence", spectral_reward=False, noise=0.0)
CASES = {
    "mse": dict(),
    "mse-noise-marl": dict(noise=0.1, num_agents=4),
    "mse-forced": dict(forcing=True, stepper=2, ic_case="forced"),
    "mse-fd": dict(scheme="fd", state_bound=1e6),
    "coupled": dict(coupled=True, ic_case="box", num_actions=1),
    "coupled-dsm": dict(coupled=True, ic_case="box", num_actions=1, dsm=True),
}


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    if got.dtype.kind in "bi":
        return float(not np.array_equal(got, want))
    both = np.isfinite(want)
    assert (np.isfinite(got) == both).all()
    scale = max(np.abs(want[both]).max(initial=0.0), 1e-300)
    return np.abs(got[both] - want[both]).max(initial=0.0) / scale


def _jcfg(name):
    return jbe.BurgerEnvConfig(**{**BASE, **CASES[name]})


def _tcfg(cfg):
    return tbe.BurgerEnvConfig(**dataclasses.asdict(cfg))


@pytest.fixture(scope="module")
def pools():
    out = {}
    for name in CASES:
        cfg = _jcfg(name)
        out[name] = (jbe._make_dns_pool_host(cfg, 2, None, jnp.float64),
                     tbe.make_dns_pool(_tcfg(cfg), 2, dtype=torch.float64, device="cpu"))
    return out


@pytest.mark.parametrize("name", ["mse", "mse-forced", "coupled"])
def test_host_pools_match_jax(name, pools):
    jpool, tpool = pools[name]
    for f in dataclasses.fields(tbe.DnsPool):
        want, got = getattr(jpool, f.name), getattr(tpool, f.name)
        assert (got is None) == (want is None), f.name
        if want is not None:
            assert got.dtype == torch.float64
            assert _rel(got.numpy(), want) <= POOL_REL, f.name
    # the truth channel: the MSE reward's pools, never the coupled one
    assert (tpool.truth_les is not None) == (name != "coupled")
    if tpool.truth_les is not None:
        assert tpool.truth_les.shape == (2, 21, 16)
        assert torch.equal(tpool.truth_les, tpool.uu[:, :, ::4])


def test_forced_pool_ic_reseeds_numpy_as_the_reference():
    cfg = _tcfg(_jcfg("mse-forced"))
    a = tbe.make_dns_pool(cfg, 1, dtype=torch.float64, device="cpu")
    np.random.seed(123)
    b = tbe.make_dns_pool(cfg, 1, dtype=torch.float64, device="cpu")
    assert torch.equal(a.uu, b.uu) and a.uu.abs().max() > 0


def _jax_reset(cfg, jpool, seeds, counts):
    keys = jax.vmap(jax.random.key)(jnp.asarray(seeds))
    jst, jobs = jax.vmap(lambda k, c: jbe.reset(cfg, jpool, k, c))(keys, jnp.asarray(counts))
    offsets = jax.vmap(lambda k: jbe._draw_offset(cfg, k, jnp.float64))(keys)
    return jst, jobs, torch.from_numpy(np.array(offsets))


@pytest.mark.parametrize("name", ["mse", "mse-noise-marl"])
def test_mse_reset_matches_jax(name, pools):
    """Noise 0, and an offset drawn in JAX and injected."""
    jpool, tpool = pools[name]
    cfg = _jcfg(name)
    jst, jobs, offsets = _jax_reset(cfg, jpool, [1, 2, 3], [0, 1, 2])
    assert (offsets != 0).any() == (cfg.noise > 0)
    tst, tobs = tbe.reset_at(_tcfg(cfg), tpool, offsets, torch.arange(3))
    back = env_state_to_jax(tst)
    for got, want in zip(jax.tree.leaves(back), jax.tree.leaves(jst)):
        assert _rel(got, want) <= EP_REL
    assert _rel(tobs.numpy(), jobs) <= EP_REL


@pytest.mark.parametrize("name", list(CASES))
def test_episode_matches_vmapped_jax(name, pools):
    """Four envs over seven macro-steps of a five-step episode: env 1 blows
    up at the first step (a NaN in its field), env 2 starts done, the others
    run to the end and two steps past it."""
    jpool, tpool = pools[name]
    cfg = _jcfg(name)
    B = 4
    jst, _, offsets = _jax_reset(cfg, jpool, [5, 6, 7, 8], [0, 1, 2, 3])
    tst = env_state_from_jax(jst)
    tst.solver.u[1, 4] = float("nan")
    tst.done[2] = True
    jst = env_state_to_jax(tst)
    rng = np.random.default_rng(len(name))
    tcfg = _tcfg(cfg)
    for i in range(cfg.episode_length + 2):
        a = rng.standard_normal((B, cfg.num_agents, cfg.actions_per_agent)) * 0.5
        jout = jax.vmap(lambda s, a_: jbe.step(cfg, jpool, s, a_))(jst, jnp.asarray(a))
        tout = tbe.step(tcfg, tpool, tst, torch.from_numpy(a))
        jst, tst = jout[0], tout[0]
        for path_leaf, want in zip(jax.tree_util.tree_leaves_with_path(env_state_to_jax(tst)),
                                   jax.tree.leaves(jst)):
            assert _rel(path_leaf[1], want) <= EP_REL, (i, path_leaf[0])
        for got, want in zip(tout[1:4], jout[1:4]):
            assert _rel(got.numpy(), want) <= EP_REL, i
        assert _rel(tout[4]["blown"].numpy(), jout[4]["blown"]) == 0
    assert bool(tst.done.all()) and torch.isneginf(tst.cum_reward[1]).all()
    assert (tst.cum_reward[2] == 0).all() and torch.isfinite(tst.cum_reward[[0, 3]]).all()
    assert (tst.cum_reward[[0, 3]] != 0).all()


# ------------------------------------------------------------------ lockstep

LOCK = dict(N_dns=64, grid_size=16, num_actions=16, dt=0.01, T=0.2, nu=0.05, episode_length=5,
            ic_case="turbulence", noise=0.1)


def _jax_lockstep_draws(cfg, seeds):
    """What jbe.reset_lockstep draws from each key (nu, offset, tables)."""
    def one(key):
        k_nu, k_off, k_f = jax.random.split(key, 3)
        nu = jnp.asarray(cfg.nu, jnp.float64)
        if cfg.nunoise:
            nu = 0.01 + 0.02 * jax.random.uniform(k_nu, dtype=jnp.float64)
        rf1, rf2 = jburger.draw_forcing_tables(k_f, cfg.stepper, jnp.float64)
        return nu, jbe._draw_offset(cfg, k_off, jnp.float64), rf1, rf2
    keys = jax.vmap(jax.random.key)(jnp.asarray(seeds))
    return keys, [torch.from_numpy(np.array(a)) for a in jax.vmap(one)(keys)]


@pytest.mark.parametrize("kw", [dict(spectral_reward=False),
                                dict(spectral_reward=True, forcing=True, stepper=2),
                                dict(spectral_reward=False, ic_case="sinus", num_agents=4)],
                         ids=["mse", "spectral-forced", "mse-sinus-marl"])
def test_lockstep_episode_matches_vmapped_jax(kw):
    cfg = jbe.BurgerEnvConfig(**{**LOCK, **kw}, dns_mode="lockstep", nunoise=True)
    tcfg = _tcfg(cfg)
    B = 3
    keys, (nu, offset, rf1, rf2) = _jax_lockstep_draws(cfg, [1, 2, 3])
    counts = jnp.asarray([0, 4, 9])
    jst, jobs = jax.vmap(lambda k, c: jbe.reset_lockstep(cfg, (), k, c))(keys, counts)
    tst, tobs = tbe.reset_lockstep_at(tcfg, nu, offset, rf1, rf2,
                                      torch.from_numpy(np.array(counts)))
    assert _rel(tobs.numpy(), jobs) <= EP_REL
    assert _rel(tst.dns.u.numpy(), jst.dns.u) <= EP_REL
    tst.done[2] = True
    jst = jst.replace(done=jnp.asarray(tst.done.numpy()))
    rng = np.random.default_rng(4)
    for i in range(cfg.episode_length + 1):
        a = rng.standard_normal((B, cfg.num_agents, cfg.actions_per_agent)) * 0.5
        jout = jax.vmap(lambda s, a_: jbe.step_lockstep(cfg, (), s, a_))(jst, jnp.asarray(a))
        tout = tbe.step_lockstep(tcfg, None, tst, torch.from_numpy(a))
        jst, tst = jout[0], tout[0]
        for which in ("les", "dns"):
            for f in dataclasses.fields(tburger.BurgerState):
                assert _rel(getattr(getattr(tst, which), f.name).numpy(),
                            getattr(getattr(jst, which), f.name)) <= EP_REL, (i, which, f.name)
        for f in ("u_prev", "macro_step", "ek_sum", "dns_ek_sum", "prev_rel_err", "done",
                  "cum_reward"):
            assert _rel(getattr(tst, f).numpy(), getattr(jst, f)) <= EP_REL, (i, f)
        for got, want in zip(tout[1:4], jout[1:4]):
            assert _rel(got.numpy(), want) <= EP_REL, i
    assert bool(tst.done.all()) and (tst.cum_reward[2] == 0).all()
    assert torch.isfinite(tst.cum_reward).all() and (tst.cum_reward[:2] != 0).all()


def test_lockstep_reset_draws_on_the_env_device_and_dtype():
    env = treg.make_env("burger-lockstep", device="cpu", dtype=torch.float64,
                        **dict(LOCK, spectral_reward=True))
    assert env.device == torch.device("cpu") and env.dtype == torch.float64
    st, obs = env.reset(env.consts, torch.Generator().manual_seed(0), torch.arange(4))
    assert st.les.u.dtype == obs.dtype == torch.float64
    nu = st.dns.nu
    assert ((nu >= 0.01) & (nu <= 0.03)).all() and nu.unique().numel() == 4   # Burger.py:89
    assert (st.les.offset != 0).all() and st.les.randfac1.shape == (4, 4, 1)


def test_lockstep_matches_pool_env_rewards():
    """With nunoise off, identical ICs and zero actions, the lockstep env's
    spectral rewards match the pool env's (tests/test_envs.py:304-318, 2e-5).
    (An MSE-reward pool env starts from the truth's spline at the coarse
    grid, the lockstep env from the spectral restriction, in JAX too.)"""
    kw = dict(LOCK, noise=0.0, spectral_reward=True, nunoise=False)
    env_pool = treg.make_env("burger", dtype=torch.float64, device="cpu", **kw)
    env_lock = treg.make_env("burger-lockstep", dtype=torch.float64, device="cpu", **kw)
    tp, _ = troll.zero_action_episode(env_pool, None)
    tl, _ = troll.zero_action_episode(env_lock, torch.Generator().manual_seed(0))
    assert tl["rewards"].shape == tp["rewards"].shape == (1, 5, 1)
    np.testing.assert_allclose(tl["rewards"][0, :, 0].numpy(), tp["rewards"][0, :, 0].numpy(),
                               atol=2e-5)
    assert (tp["rewards"] != 0).all()


def test_env_without_device_raises():
    env = dataclasses.replace(treg.make_env("burger-lockstep", device="cpu", **LOCK), consts=())
    with pytest.raises(ValueError, match="device and dtype"):
        _ = env.device
