"""Port parity: the host DNS pool, the solver init, the spectral reset and the
features of the Burgers env, against the JAX package (float64)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from marlpde_tpu.envs import burger_env as jbe
from marlpde_tpu.envs import features as jfeat
from marlpde_tpu.solvers import burger as jburger
from marlpde_tpu_torch.envs import burger_env as tbe
from marlpde_tpu_torch.envs import features as tfeat
from marlpde_tpu_torch.envs import registry as treg
from marlpde_tpu_torch.solvers import burger as tburger

torch.set_num_threads(1)

CFG = jbe.BurgerEnvConfig(N_dns=64, grid_size=32, num_actions=32, num_agents=4,
                          dt=0.01, T=0.5, nu=0.05, episode_length=5,
                          ic_case="turbulence", spectral_reward=True, noise=0.0)


def tcfg(cfg):
    return tbe.BurgerEnvConfig(**dataclasses.asdict(cfg))


@pytest.fixture(scope="module")
def pools():
    jpool = jbe.make_dns_pool(CFG, 2, dtype=jnp.float64)
    tpool = tbe.make_dns_pool(tcfg(CFG), 2, dtype=torch.float64, device="cpu")
    return jpool, tpool


def test_config_properties_carry_over():
    t = tcfg(CFG)
    for name in ("n_dns_steps", "n_intermediate", "obs_dim", "actions_per_agent"):
        assert getattr(t, name) == getattr(CFG, name)
    np.testing.assert_array_equal(tbe.action_basis(t), jbe.action_basis(CFG))


@pytest.mark.parametrize("ic_case", ["turbulence", "sinus"])
def test_host_pool_field_by_field(ic_case, pools):
    if ic_case == "turbulence":
        jpool, tpool = pools
    else:
        cfg = dataclasses.replace(CFG, ic_case=ic_case)
        jpool = jbe.make_dns_pool(cfg, 1, dtype=jnp.float64)
        tpool = tbe.make_dns_pool(tcfg(cfg), 1, dtype=torch.float64, device="cpu")
    for f in dataclasses.fields(tbe.DnsPool):
        a, b = getattr(tpool, f.name), getattr(jpool, f.name)
        if b is None:
            assert a is None, f.name
            continue
        assert a.dtype == torch.float64, f.name
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-12, err_msg=f.name)


def test_pool_float32_transfer():
    jpool = jbe.make_dns_pool(CFG, 1, dtype=jnp.float32)
    tpool = tbe.make_dns_pool(tcfg(CFG), 1, dtype=torch.float32, device="cpu")
    assert tpool.uu.dtype == torch.float32
    np.testing.assert_array_equal(tpool.ek_ktt.numpy(), np.asarray(jpool.ek_ktt))


def test_solver_init_from_spectrum():
    cfg = jburger.BurgerConfig(N=32, nu=0.03)
    rng = np.random.default_rng(0)
    v0 = np.fft.fft(rng.standard_normal((3, 32)), axis=-1)
    js = jburger.init(cfg, v0=jnp.asarray(v0), offset=0.25)
    ts = tburger.init(tburger.BurgerConfig(N=32, nu=0.03), v0=torch.from_numpy(v0),
                      offset=0.25)
    for f in dataclasses.fields(tburger.BurgerState):
        np.testing.assert_allclose(getattr(ts, f.name).numpy(),
                                   np.asarray(getattr(js, f.name)), atol=1e-10,
                                   err_msg=f.name)


@pytest.mark.parametrize("noise", [0.0, 0.1])
def test_spectral_reset(noise, pools):
    jpool, tpool = pools
    cfg = dataclasses.replace(CFG, noise=noise)
    B = 3
    keys = jax.random.split(jax.random.key(5), B)
    counts = jnp.arange(B) + 7
    jst, jobs = jax.vmap(lambda k, c: jbe.reset(cfg, jpool, k, c))(keys, counts)
    # the offsets the JAX reset drew, fed to the port's reset
    offs = jax.vmap(lambda k: jbe._draw_offset(cfg, k, jnp.float64))(keys)
    tst, tobs = tbe.reset_at(tcfg(cfg), tpool, torch.from_numpy(np.array(offs)),
                             torch.from_numpy(np.array(counts)))
    np.testing.assert_allclose(tobs.numpy(), np.asarray(jobs), atol=1e-10)
    np.testing.assert_allclose(tst.solver.u.numpy(), np.asarray(jst.solver.u), atol=1e-10)
    np.testing.assert_allclose(tst.solver.fn_old.numpy(), np.asarray(jst.solver.fn_old),
                               atol=1e-10)
    np.testing.assert_allclose(tst.ek_sum.numpy(), np.asarray(jst.ek_sum), atol=1e-10)
    np.testing.assert_array_equal(tst.sidx.numpy(), np.asarray(jst.sidx))


def test_reset_offset_draw_is_truncated_normal():
    cfg = tcfg(dataclasses.replace(CFG, noise=0.5))
    g = torch.Generator().manual_seed(0)
    off = tbe._draw_offset(cfg, g, 20000, torch.float64, "cpu")
    assert off.abs().max() <= cfg.L
    # N(0, pi) conditioned on |x| <= 2*pi: std 2.767 (truncated-normal formula)
    assert abs(off.std().item() - 2.767) < 0.05
    assert abs(off.mean().item()) < 0.05


@pytest.mark.parametrize("version", [0, 1, 2, 3, 4])
@pytest.mark.parametrize("num_agents", [1, 4])
def test_burger_features(version, num_agents):
    rng = np.random.default_rng(version)
    u, u_prev = rng.standard_normal((2, 3, 32))
    v = np.fft.fft(u, axis=-1)
    dx = 2 * np.pi / 32
    want = jfeat.burger_features(version, num_agents, jnp.asarray(u), jnp.asarray(u_prev),
                                 jnp.asarray(v), 0.01, dx)
    got = tfeat.burger_features(version, num_agents, torch.from_numpy(u),
                                torch.from_numpy(u_prev), torch.from_numpy(v), 0.01, dx)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-10)


def test_registry_covers_the_slice_only(pools):
    _, tpool = pools
    kw = dict(dataclasses.asdict(CFG))
    env = treg.make_env("burger-marl", pool=tpool, **{k: v for k, v in kw.items()
                                                     if k != "num_agents"})
    assert env.num_agents == 32 and env.name == "burger-marl"
    env = treg.make_env("burger", pool=tpool, **kw)
    assert env.obs_dim == CFG.obs_dim and env.act_dim == CFG.actions_per_agent
    assert env.whole_batch
    # fast='off' and configs the whole-batch env does not take get the
    # general per-env env, the MSE reward and the closures included
    for off_fast in (dict(fast="off"), dict(dforce=False), dict(nunoise=True),
                     dict(spectral_reward=False), dict(ssm=True), dict(forcing=True)):
        env = treg.make_env("burger", pool=tpool, **{**kw, **off_fast})
        assert not env.whole_batch and env.step.func is tbe.step
    # as in JAX, the solver config's assertions and the step's scheme check
    # refuse what the solver does not take, at the first reset or step
    for bad, err in ((dict(ssm=True, dsm=True), AssertionError),
                     (dict(ssmforce=True, dforce=False), AssertionError),
                     (dict(scheme="no-such-scheme"), ValueError)):
        env = treg.make_env("burger", pool=tpool, **{**kw, **bad})
        with pytest.raises(err):
            st, _ = env.reset(env.consts, None, torch.arange(2))
            env.step(env.consts, st, torch.zeros(2, env.num_agents, env.act_dim,
                                                 dtype=torch.float64))
    for simple in ("advection-simple", "diffusion-simple"):
        assert treg.make_env(simple, device="cpu").name == simple
    with pytest.raises(ValueError):
        treg.make_env("no-such-env")
