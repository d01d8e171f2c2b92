"""Port parity: the whole-batch env (envs/burger_fast.py) — reset, then three
macro-steps with injected actions — against JAX burger_fast."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from marlpde_tpu.envs import burger_env as jbe
from marlpde_tpu.envs import burger_fast as jbf
from marlpde_tpu_torch.envs import burger_env as tbe
from marlpde_tpu_torch.envs import burger_fast as tbf
from test_torch_interop import fast_state_from_jax, fast_state_to_jax, pool_from_jax

torch.set_num_threads(1)

CFG = jbe.BurgerEnvConfig(N_dns=64, grid_size=32, num_actions=32, num_agents=4,
                          dt=0.01, T=0.5, nu=0.05, episode_length=5,
                          ic_case="turbulence", spectral_reward=True, noise=0.0)
B = 4


@pytest.fixture(autouse=True)
def interpret_pallas(monkeypatch):
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))


def _actions(rng, cfg, dtype):
    return rng.standard_normal((B, cfg.num_agents, cfg.actions_per_agent)).astype(dtype)


def _close(a, b, tol, msg, relative):
    """|a - b| <= tol, or with ``relative`` tol * max(1, max|b|): relative to
    the field's scale."""
    b = np.asarray(b)
    scale = max(1.0, float(np.abs(b[np.isfinite(b)]).max(initial=0.0))) if relative else 1.0
    np.testing.assert_allclose(a, b, rtol=0, atol=tol * scale, err_msg=msg)


def _compare(tout, jout, tol, msg, relative=False):
    tst, tobs, trew, tdone, tinfo = tout
    jst, jobs, jrew, jdone, jinfo = jout
    for f in dataclasses.fields(tbf.FastEnvState):
        _close(getattr(tst, f.name).numpy(), getattr(jst, f.name), tol, f"{msg} {f.name}",
               relative)
    _close(tobs.numpy(), jobs, tol, f"{msg} obs", relative)
    _close(trew.numpy(), jrew, tol, f"{msg} reward", relative)
    np.testing.assert_array_equal(tdone.numpy(), np.asarray(jdone))
    np.testing.assert_array_equal(tinfo["blown"].numpy(), np.asarray(jinfo["blown"]))


@pytest.mark.parametrize("version", [0, 1, 3])
def test_reset_then_three_steps_float64(version):
    cfg = dataclasses.replace(CFG, version=version)
    jpool = jbe.make_dns_pool(cfg, 2, dtype=jnp.float64)
    tpool = pool_from_jax(jpool)
    tcfg = tbe.BurgerEnvConfig(**dataclasses.asdict(cfg))
    counts = np.arange(B)
    jst, jobs = jbf.reset(cfg, jpool, jax.random.split(jax.random.key(0), B),
                          jnp.asarray(counts))
    tst, tobs = tbf.reset(tcfg, tpool, torch.Generator().manual_seed(0),
                          torch.from_numpy(counts))
    np.testing.assert_allclose(tobs.numpy(), np.asarray(jobs), atol=1e-10)
    np.testing.assert_array_equal(tst.sidx.numpy(), np.asarray(jst.sidx))
    rng = np.random.default_rng(1)
    for i in range(3):
        a = _actions(rng, cfg, np.float64)
        jout = jbf.step(cfg, jpool, jst, jnp.asarray(a), use_pallas=False)
        tout = tbf.step(tcfg, tpool, tst, torch.from_numpy(a))
        _compare(tout, jout, 1e-10, f"step {i}")
        jst, tst = jout[0], tout[0]


def test_three_steps_float32_against_pallas_kernel():
    jpool = jbe.make_dns_pool(CFG, 1, dtype=jnp.float32)
    tpool = pool_from_jax(jpool)
    tcfg = tbe.BurgerEnvConfig(**dataclasses.asdict(CFG))
    jst, _ = jbf.reset(CFG, jpool, jax.random.split(jax.random.key(0), B), jnp.arange(B))
    tst = fast_state_from_jax(jst)
    rng = np.random.default_rng(2)
    for i in range(3):
        a = _actions(rng, CFG, np.float32)
        jout = jbf.step(CFG, jpool, jst, jnp.asarray(a), use_pallas=True, tile_b=4)
        tout = tbf.step(tcfg, tpool, tst, torch.from_numpy(a))
        assert tout[1].dtype == torch.float32 and tout[2].dtype == torch.float32
        # torch.fft against the kernel's DFT matmuls from a turbulent IC, whose
        # nonlinear term reaches |fn| ~ 25: 1e-5 of each field's scale (the
        # env-level test_pallas.py tolerance is 2e-4 absolute)
        _compare(tout, jout, 1e-5, f"step {i}", relative=True)
        jst, tst = jout[0], tout[0]


def test_frozen_and_blown_envs_are_selected_not_multiplied():
    """A done env keeps its state (and gets reward 0) even though it still
    goes through the op; an env whose field is NaN blows up, is penalized
    -inf and reports blown; NaN observations become 0."""
    jpool = jbe.make_dns_pool(CFG, 1, dtype=jnp.float64)
    tpool = pool_from_jax(jpool)
    tcfg = tbe.BurgerEnvConfig(**dataclasses.asdict(CFG))
    jst, _ = jbf.reset(CFG, jpool, jax.random.split(jax.random.key(0), B), jnp.arange(B))
    tst = fast_state_from_jax(jst)
    tst.u[1, 3] = float("nan")
    tst.done[2] = True
    tst.u[2, 5] = float("inf")            # a frozen env holding inf stays as it is
    jst = fast_state_to_jax(tst)
    a = _actions(np.random.default_rng(3), CFG, np.float64)
    jout = jbf.step(CFG, jpool, jst, jnp.asarray(a), use_pallas=False)
    tout = tbf.step(tcfg, tpool, tst, torch.from_numpy(a))
    _compare(tout, jout, 1e-10, "blown/frozen")
    _, tobs, trew, tdone, tinfo = tout
    assert bool(tinfo["blown"][1]) and bool(tdone[1]) and bool(tdone[2])
    assert torch.isneginf(trew[1]).all() and (trew[2] == 0).all()
    assert torch.isfinite(tobs).all()
    assert torch.isinf(tout[0].u[2, 5])


def test_frozen_env_past_the_table_end():
    """A done env whose step counter is at the end of the DNS table steps
    again without an out-of-range gather (JAX clamps the index)."""
    jpool = jbe.make_dns_pool(CFG, 1, dtype=jnp.float64)
    tpool = pool_from_jax(jpool)
    tcfg = tbe.BurgerEnvConfig(**dataclasses.asdict(CFG))
    jst, _ = jbf.reset(CFG, jpool, jax.random.split(jax.random.key(0), B), jnp.arange(B))
    tst = fast_state_from_jax(jst)
    tst.ioutnum[:] = CFG.n_dns_steps
    tst.done[:] = True
    jst = fast_state_to_jax(tst)
    a = _actions(np.random.default_rng(4), CFG, np.float64)
    _compare(tbf.step(tcfg, tpool, tst, torch.from_numpy(a)),
             jbf.step(CFG, jpool, jst, jnp.asarray(a), use_pallas=False), 1e-10, "end")
