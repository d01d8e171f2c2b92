"""Port parity: ``solvers/burger_grad.py`` (the RK3 kernel, the reference's
accumulated action Jacobian ``step_with_grad`` and the whole-episode
``episode_jacobian``) against the JAX package in float64, from the same
numpy-made inputs; then the port of the reference's finite-difference check
and causality.

Tolerance: 1e-10 relative to each Jacobian's max |value| (the same float64
forward-mode derivatives through torch.fft and jnp.fft)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from marlpde_tpu.solvers import burger as jburger
from marlpde_tpu.solvers import burger_grad as jgrad
from marlpde_tpu_torch.core import basis as tbasis
from marlpde_tpu_torch.solvers import burger as tburger
from marlpde_tpu_torch.solvers import burger_grad as tgrad

torch.set_num_threads(1)
REL = 1e-10


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-300)


def _case(N, M, nu=0.05, dt=1e-3, seed=0):
    rng = np.random.default_rng(seed)
    x = np.linspace(0, 2 * np.pi, N, endpoint=False)
    u0 = np.sin(2 * x) + 0.3 * rng.standard_normal(N)
    kw = dict(N=N, dt=dt, nu=nu, scheme="rk3")
    return (jburger.BurgerConfig(**kw), tburger.BurgerConfig(**kw),
            tbasis.make_basis(M, N, 2 * np.pi, "hat"), u0, rng)


@pytest.mark.parametrize("N,M,n_int", [(16, 4, 1), (32, 8, 3)])
def test_step_with_grad_matches_jax(N, M, n_int):
    jcfg, tcfg, B, u0, rng = _case(N, M)
    actions = 0.1 * rng.standard_normal(M)
    grad0 = 0.01 * rng.standard_normal((N, M))
    ju, jv, jg = jgrad.step_with_grad(jcfg, B, jnp.asarray(u0), jnp.fft.fft(u0),
                                      jnp.asarray(grad0), jnp.asarray(actions), n_int)
    u = torch.from_numpy(u0)
    tu, tv, tg = tgrad.step_with_grad(tcfg, B, u, torch.fft.fft(u), torch.from_numpy(grad0),
                                      torch.from_numpy(actions), n_int)
    assert tg.dtype == torch.float64 and tg.shape == (N, M)
    for got, want in ((tu, ju), (tv, jv), (tg, jg)):
        assert _rel(got.numpy(), want) < REL


def test_rk3_kernel_matches_the_solver_step():
    """One kernel call is the solver's rk3 step with the field as forcing."""
    _, tcfg, B, u0, rng = _case(16, 4)
    field = torch.from_numpy(0.1 * rng.standard_normal(4) @ B)
    u = torch.from_numpy(u0)
    ku, kv = tgrad.rk3_kernel(tcfg)(field, u, torch.fft.fft(u))
    st, _ = tburger.step(tcfg, tburger.init(tcfg, u0=u), field)
    assert _rel(ku.numpy(), st.u.numpy()) < REL and _rel(kv.numpy(), st.v.numpy()) < REL


@pytest.mark.parametrize("T,n_int", [(4, 2), (6, 1)])
def test_episode_jacobian_matches_jax(T, n_int):
    N, M = 16, 4
    jcfg, tcfg, B, u0, rng = _case(N, M, seed=T)
    acts = 0.2 * rng.standard_normal((T, M))
    want = np.asarray(jgrad.episode_jacobian(jcfg, B, jnp.asarray(u0), jnp.asarray(acts),
                                             n_int))
    got = tgrad.episode_jacobian(tcfg, B, torch.from_numpy(u0), torch.from_numpy(acts), n_int)
    assert got.shape == (T, N, T, M)
    assert _rel(got.numpy(), want) < REL


def test_jacobian_matches_finite_differences():
    """The reference's own gradient check (tests/burger/grad_check.py:36-64),
    as tests/test_extras.py runs it on the JAX package."""
    N, M, L, n_int = 32, 8, 2 * np.pi, 3
    cfg = tburger.BurgerConfig(N=N, L=L, dt=1e-3, nu=0.05, scheme="rk3")
    B = tbasis.make_basis(M, N, L, "hat")
    x = np.linspace(0, L, N, endpoint=False)
    u0 = torch.from_numpy(np.sin(4 * np.pi * x / L))
    actions = torch.from_numpy(0.1 * np.arange(M, dtype=float) / M)
    _, _, grad = tgrad.step_with_grad(cfg, B, u0, torch.fft.fft(u0),
                                      torch.zeros((N, M), dtype=torch.float64), actions, n_int)

    def roll(a):
        kern = tgrad.rk3_kernel(cfg)
        uu, vv = u0, torch.fft.fft(u0)
        field = a @ torch.from_numpy(B)
        for _ in range(n_int):
            uu, vv = kern(field, uu, vv)
        return uu

    eps = 1e-6
    for j in range(M):
        e = torch.zeros(M, dtype=torch.float64)
        e[j] = eps
        fd = (roll(actions + e) - roll(actions - e)) / (2 * eps)
        np.testing.assert_allclose(grad[:, j].numpy(), fd.numpy(), atol=1e-5)


def test_episode_jacobian_is_causal():
    N, M = 16, 4
    cfg = tburger.BurgerConfig(N=N, dt=1e-3, nu=0.05, scheme="rk3")
    B = tbasis.make_basis(M, N, 2 * np.pi, "hat")
    u0 = torch.sin(torch.linspace(0, 2 * np.pi, N + 1, dtype=torch.float64)[:-1])
    jac = tgrad.episode_jacobian(cfg, B, u0, torch.zeros((5, M), dtype=torch.float64), 2)
    assert jac.shape == (5, N, 5, M)
    # the state at macro-step t does not depend on later actions
    for t in range(5):
        assert jac[t, :, :t + 1].abs().max().item() > 0.0
        if t < 4:
            assert jac[t, :, t + 1:].abs().max().item() == 0.0
