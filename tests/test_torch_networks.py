"""Port parity: VracerNet with flax weights, the MLP op's plain version, the
clipped-normal distribution and the running statistics, against the JAX
package."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from marlpde_tpu.ops import mlp_pallas
from marlpde_tpu.rl import distributions as jD
from marlpde_tpu.rl import networks as jnet
from marlpde_tpu.rl import running_stats as jrs
from marlpde_tpu_torch.kernels import mlp
from marlpde_tpu_torch.rl import distributions as tD
from marlpde_tpu_torch.rl import networks as tnet
from marlpde_tpu_torch.rl import running_stats as trs
from test_torch_interop import np_tree

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def interpret_pallas(monkeypatch):
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))


def _nets(mu_param, sigma_max, dtype, seed=0, obs_dim=5, act_dim=2, width=16):
    """A flax VracerNet with random (non-zero-head) weights and the port's
    VracerNet loaded with the same weights."""
    jn = jnet.VracerNet(act_dim=act_dim, width=width, init_noise=0.3,
                        mu_param=mu_param, sigma_max=sigma_max)
    params = jn.init(jax.random.key(seed), jnp.zeros((1, obs_dim)))
    rng = np.random.default_rng(seed)
    params = jax.tree.map(
        lambda a: jnp.asarray(rng.standard_normal(a.shape) * 0.5, dtype), params)
    tn = tnet.VracerNet(obs_dim, act_dim, width=width, init_noise=0.3,
                        mu_param=mu_param, sigma_max=sigma_max,
                        dtype=torch.float64 if dtype == jnp.float64 else torch.float32)
    tn.load_state_dict(tnet.params_from_flax(np_tree(params)))
    return jn, params, tn


@pytest.mark.parametrize("mu_param", ["absolute", "sigma_relative"])
@pytest.mark.parametrize("sigma_max", [np.inf, 0.5])
def test_forward_and_grads_match_flax_float64(mu_param, sigma_max):
    jn, params, tn = _nets(mu_param, sigma_max, jnp.float64)
    obs = np.random.default_rng(1).standard_normal((7, 3, 5))

    def jloss(p):
        v, mu, sigma = jn.apply(p, jnp.asarray(obs))
        return jnp.sum(v * 0.3) + jnp.sum(jnp.sin(mu)) + jnp.sum(sigma**2), (v, mu, sigma)

    jgrads, jout = jax.grad(jloss, has_aux=True)(params)
    tout = tn(torch.from_numpy(obs))
    (torch.sum(tout[0] * 0.3) + torch.sum(torch.sin(tout[1]))
     + torch.sum(tout[2] ** 2)).backward()
    for a, b in zip(tout, jout):
        assert a.dtype == torch.float64
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), atol=1e-10)
    if np.isfinite(sigma_max):
        assert (tout[2] <= sigma_max).all() and (tout[2] == sigma_max).any()
    want = tnet.params_from_flax(np_tree(jgrads))
    for name, p in tn.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), atol=1e-10,
                                   err_msg=name)


def test_params_round_trip_and_layer_order():
    _, params, tn = _nets("absolute", np.inf, jnp.float32)
    back = tnet.params_to_flax(tn)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(np_tree(params))):
        np.testing.assert_array_equal(a, b)
    assert [n for n, _ in tn.named_parameters()][:2] == ["hidden.0.weight", "hidden.0.bias"]


@pytest.mark.parametrize("mu_param", ["absolute", "sigma_relative"])
def test_init_follows_flax_statistics(mu_param):
    width, obs_dim = 256, 64
    tn = tnet.VracerNet(obs_dim, 3, width=width, mu_param=mu_param,
                        generator=torch.Generator().manual_seed(0))
    jn = jnet.VracerNet(act_dim=3, width=width, mu_param=mu_param)
    jp = np_tree(jn.init(jax.random.key(0), jnp.zeros((1, obs_dim))))["params"]
    for i, lin in enumerate(tn.layers()):
        k = jp[f"Dense_{i}"]["kernel"]
        w = lin.weight.detach().numpy()
        assert (lin.bias == 0).all()
        if not k.any():
            assert not w.any(), f"Dense_{i} should start at zero"
            continue
        std = np.sqrt(1.0 / lin.in_features)
        # lecun normal: std sqrt(1/fan_in), truncated at 2 / 0.8796 std
        assert np.abs(w).max() <= 2 * std / 0.87962566103423978 + 1e-7
        if w.size >= 1000:
            assert abs(w.std() / std - 1) < 0.05 and abs(k.std() / std - 1) < 0.05
    v, mu, sigma = tn(torch.zeros(2, obs_dim))
    np.testing.assert_allclose(sigma.detach().numpy(), 0.1 + 1e-5, rtol=1e-6)
    if mu_param == "sigma_relative":
        assert not mu.any()


@pytest.mark.parametrize("mu_param,sigma_max", [("absolute", np.inf),
                                                ("absolute", 0.5),
                                                ("sigma_relative", 0.5)])
def test_mlp_op_plain_version_float32(mu_param, sigma_max):
    """On CPU tensors the MLP op is the module itself; held against the JAX
    Pallas kernel (interpret mode, plain heads) and flax apply (atol 2e-5)."""
    jn, params, tn = _nets(mu_param, sigma_max, jnp.float32, width=32)
    obs = np.random.default_rng(2).standard_normal((37, 5)).astype(np.float32)
    before = mlp.launches
    with torch.no_grad():
        V, mu, sigma = mlp.mlp_forward(torch.from_numpy(obs), tn)
    assert mlp.launches == before
    assert V.shape == (37,) and mu.shape == sigma.shape == (37, 2)
    jv_, jmu, jsig = jn.apply(params, jnp.asarray(obs))
    for a, b in zip((V, mu, sigma), (jv_, jmu, jsig)):
        assert a.dtype == torch.float32 and np.asarray(b).dtype == np.float32
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=2e-5)
    pv, pmu, psig = mlp_pallas.mlp_forward(jnp.asarray(obs), params, init_noise=0.3,
                                           tile_r=32)
    np.testing.assert_allclose(V.numpy(), np.asarray(pv), atol=2e-5)
    # the Pallas kernel leaves the cap and the sigma-relative mean to its caller
    raw_sigma = np.asarray(psig)
    np.testing.assert_allclose(sigma.numpy(), np.minimum(raw_sigma, sigma_max), atol=2e-5)
    if mu_param == "absolute":
        np.testing.assert_allclose(mu.numpy(), np.asarray(pmu), atol=2e-5)


def test_mlp_op_rejects_bad_inputs():
    _, _, tn = _nets("absolute", np.inf, jnp.float32, width=32)
    with pytest.raises(ValueError, match="obs"):
        mlp.mlp_forward(torch.zeros(4, 3), tn)
    with pytest.raises(ValueError, match="parameter"):
        mlp.mlp_forward(torch.zeros(4, 5, dtype=torch.float64), tn)


def test_leaky_sigma_cap_straight_through():
    s = torch.tensor([0.2, 0.5, 0.9], dtype=torch.float64, requires_grad=True)
    out = tnet.leaky_sigma_cap(s, 0.5)
    out.sum().backward()
    np.testing.assert_array_equal(out.detach().numpy(), [0.2, 0.5, 0.5])
    js = jnp.asarray([0.2, 0.5, 0.9])
    jg = jax.grad(lambda x: jnet.leaky_sigma_cap(x, 0.5).sum())(js)
    np.testing.assert_allclose(s.grad.numpy(), np.asarray(jg), atol=1e-12)


def test_distributions_float64():
    rng = np.random.default_rng(3)
    mu = rng.standard_normal((6, 4)) * 3
    sigma = np.exp(rng.standard_normal((6, 4)) * 0.5)
    mu_b = mu + rng.standard_normal((6, 4)) * 0.2
    sigma_b = sigma * np.exp(rng.standard_normal((6, 4)) * 0.1)
    a = np.clip(rng.standard_normal((6, 4)) * 4, -5, 5)
    a[0, :2] = [-5.0, 5.0]
    noise = rng.standard_normal((6, 4))
    T = [torch.from_numpy(x) for x in (a, mu, sigma, mu_b, sigma_b, noise)]
    J = [jnp.asarray(x) for x in (a, mu, sigma, mu_b, sigma_b, noise)]
    pairs = [
        (tD.log_prob(T[0], T[1], T[2], -5.0, 5.0), jD.log_prob(J[0], J[1], J[2], -5.0, 5.0)),
        (tD.joint_log_prob(T[0], T[1], T[2], -5.0, 5.0),
         jD.joint_log_prob(J[0], J[1], J[2], -5.0, 5.0)),
        (tD.kl_normal(T[3], T[4], T[1], T[2]), jD.kl_normal(J[3], J[4], J[1], J[2])),
        (tD.kl_jeffreys(T[3], T[4], T[1], T[2]), jD.kl_jeffreys(J[3], J[4], J[1], J[2])),
        (tD.sample_from_noise(T[5], T[1], T[2], -5.0, 5.0),
         jnp.clip(J[1] + J[2] * J[5], -5.0, 5.0)),
    ]
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-10)


def test_distribution_dtypes_stay_float32():
    x = torch.ones(3, 2)
    assert tD.log_prob(x * 0.1, x * 0.0, x, -5.0, 5.0).dtype == torch.float32
    assert jD.log_prob(jnp.ones((3, 2), jnp.float32) * 0.1, jnp.zeros((3, 2), jnp.float32),
                       jnp.ones((3, 2), jnp.float32), -5.0, 5.0).dtype == jnp.float32
    g = torch.Generator().manual_seed(0)
    s = tD.sample(g, torch.zeros(20000), torch.ones(20000), -5.0, 5.0)
    assert s.dtype == torch.float32 and abs(s.std().item() - 1) < 0.03


@pytest.mark.parametrize("weighted", [False, True])
def test_running_stats(weighted):
    rng = np.random.default_rng(4)
    x = rng.standard_normal((50, 3)) * 2 + 1
    x[3] = 1e30
    w = (rng.uniform(size=50) > 0.3).astype(np.float64)
    w[3] = 0.0
    js, ts = jrs.init((3,), jnp.float64), trs.init((3,), torch.float64)
    for _ in range(2):
        js = jrs.update(js, jnp.asarray(x), jnp.asarray(w) if weighted else None)
        ts = trs.update(ts, torch.from_numpy(x), torch.from_numpy(w) if weighted else None)
    for name in ("mean", "m2", "count", "std"):
        np.testing.assert_allclose(getattr(ts, name).numpy(), np.asarray(getattr(js, name)),
                                   rtol=1e-12, err_msg=name)
    np.testing.assert_allclose(trs.normalize(ts, torch.from_numpy(x[:4])).numpy(),
                               np.asarray(jrs.normalize(js, jnp.asarray(x[:4]))), rtol=1e-12)
    r = rng.standard_normal(40)
    js, ts = jrs.init((), jnp.float64), trs.init((), torch.float64)
    js = jrs.update(js, jnp.asarray(r))
    ts = trs.update(ts, torch.from_numpy(r))
    np.testing.assert_allclose(trs.second_moment(ts).numpy(),
                               np.asarray(jrs.second_moment(js)), rtol=1e-12)
    np.testing.assert_allclose(trs.scale(ts, torch.from_numpy(r)).numpy(),
                               np.asarray(jrs.scale(js, jnp.asarray(r))), rtol=1e-12)
