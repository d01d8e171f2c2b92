"""Port parity: VRACER episode mode (normalizer updates, V-trace, the loss and
one update) and the episode replay, against the JAX package in float64."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from marlpde_tpu.rl import replay as jreplay
from marlpde_tpu.rl import running_stats as jrs
from marlpde_tpu.rl import vracer as jv
from marlpde_tpu_torch.rl import networks as tnet
from marlpde_tpu_torch.rl import replay as treplay
from marlpde_tpu_torch.rl import vracer as tv
from test_torch_interop import (np_tree, params64, replay_from_jax, replay_to_jax,
                                train_state_from_jax, train_state_to_jax)

torch.set_num_threads(1)
ATOL = 1e-10


def _batch(seed, K=3, T=6, na=2, obs_dim=3, act_dim=1, blowup=True):
    rng = np.random.default_rng(seed)
    mask = np.ones((K, T))
    mask[1, 4:] = 0.0                       # episode 1 ends early (blowup)
    rewards = rng.standard_normal((K, T, na)) * 0.05
    rewards[2, 1, 0] = 3.0                  # a spike for the winsorization
    if blowup:
        rewards[1, 3] = -np.inf             # the env's truncation penalty
    rewards[1, 4:] = 0.0
    mu = rng.standard_normal((K, T, na, act_dim)) * 0.3
    sigma = np.exp(rng.standard_normal((K, T, na, act_dim)) * 0.2) * 0.1
    actions = np.clip(mu + sigma * rng.standard_normal(mu.shape), -5, 5)
    actions[0, 0, 0, 0] = 5.0               # a clipped action (point mass)
    obs = rng.standard_normal((K, T, na, obs_dim)) * 2 + 0.5
    obs[2, 5, 1, 0] = 1e8                   # excluded from the obs statistic
    final_obs = rng.standard_normal((K, na, obs_dim))
    final_obs[1, 0, 0] = np.nan
    return dict(obs=obs, actions=actions, mu=mu, sigma=sigma, rewards=rewards,
                mask=mask, final_obs=final_obs, truncated=np.array([False, True, False]))


def _to(batch, lib):
    conv = (lambda a: jnp.asarray(a)) if lib == "jax" else (lambda a: torch.from_numpy(a))
    return {k: conv(v) for k, v in batch.items()}


def _states(seed=0, **cfg_kw):
    cfg = jv.VracerConfig(obs_dim=3, act_dim=1, num_agents=2, episode_length=6,
                          width=8, **cfg_kw)
    jts = params64(cfg, jv.init_train(cfg, jax.random.key(seed), dtype=jnp.float64))
    # non-trivial normalizers
    jts = jts.replace(obs_stats=jrs.RunningStats(
        mean=jnp.asarray([0.3, 0.5, -0.2]), m2=jnp.asarray([40.0, 80.0, 30.0]),
        count=jnp.asarray(20.0)))
    tcfg = tv.VracerConfig(**dataclasses.asdict(cfg))
    return cfg, jts, tcfg, train_state_from_jax(tcfg, jts)


def _assert_stats(ts, jts):
    for which in ("obs_stats", "rew_stats"):
        for f in ("mean", "m2", "count"):
            np.testing.assert_allclose(getattr(getattr(ts, which), f).numpy(),
                                       np.asarray(getattr(getattr(jts, which), f)),
                                       rtol=1e-12, atol=ATOL, err_msg=f"{which}.{f}")


@pytest.mark.parametrize("warm,n_updates", [(False, 0), (True, 0), (False, 3)])
def test_observe_episodes(warm, n_updates):
    cfg, jts, tcfg, ts = _states()
    rew = jrs.RunningStats(mean=jnp.asarray(0.01), m2=jnp.asarray(0.4),
                           count=jnp.asarray(2000.0 if warm else 5.0))
    jts = jts.replace(rew_stats=rew, n_updates=jnp.asarray(n_updates, jnp.int32))
    ts = train_state_from_jax(tcfg, jts)
    batch = _batch(1)
    jout = jv.observe_episodes(cfg, jts, _to(batch, "jax"))
    tout = tv.observe_episodes(tcfg, ts, _to(batch, "torch"))
    _assert_stats(tout, jout)


@pytest.mark.parametrize("n_valid", [0, 1, 2, 7, 8])
def test_median_interpolates_like_nanquantile(n_valid):
    rng = np.random.default_rng(n_valid)
    r = rng.standard_normal(12)
    w = np.zeros(12)
    w[rng.permutation(12)[:n_valid]] = 1.0
    got = tv._median_abs(torch.from_numpy(r), torch.from_numpy(w)).item()
    absr = np.where(w > 0, np.abs(r), np.nan)
    want = 0.0 if n_valid == 0 else max(float(jnp.nanquantile(jnp.asarray(absr), 0.5)), 1e-30)
    assert got == pytest.approx(want, abs=1e-15)


@pytest.mark.parametrize("with_bootstrap", [False, True])
def test_vtrace_truncated_bootstrap(with_bootstrap):
    rng = np.random.default_rng(2)
    K, na, T = 3, 2, 7
    V = rng.standard_normal((K, na, T))
    rewards = rng.standard_normal((K, na, T))
    rho = np.exp(rng.standard_normal((K, na, T)) * 0.5)
    mask = np.ones((K, na, T))
    mask[1, :, 5:] = 0.0
    mask[2, :, 2:] = 0.0
    boot = rng.standard_normal((K, na)) * np.array([0.0, 1.0, 1.0])[:, None]
    kw_j = dict(bootstrap=jnp.asarray(boot)) if with_bootstrap else {}
    kw_t = dict(bootstrap=torch.from_numpy(boot)) if with_bootstrap else {}
    jvtg, jadv = jv._vtrace(jnp.asarray(V), jnp.asarray(rewards), jnp.asarray(rho),
                            jnp.asarray(mask), 0.97, **kw_j)
    tvtg, tadv = tv._vtrace(torch.from_numpy(V), torch.from_numpy(rewards),
                            torch.from_numpy(rho), torch.from_numpy(mask), 0.97, **kw_t)
    np.testing.assert_allclose(tvtg.numpy(), np.asarray(jvtg), atol=ATOL)
    np.testing.assert_allclose(tadv.numpy(), np.asarray(jadv), atol=ATOL)


@pytest.mark.parametrize("cfg_kw", [dict(),
                                    dict(trust_region="forward", mu_param="sigma_relative",
                                         multi_agent_relationship="cooperation",
                                         multi_agent_correlation=True, sigma_max=0.15)])
def test_one_update_grads_and_params(cfg_kw):
    cfg, jts, tcfg, ts = _states(seed=4, **cfg_kw)
    batch = _batch(5)
    jb, tb = _to(batch, "jax"), _to(batch, "torch")
    jts = jv.observe_episodes(cfg, jts, jb)
    ts = train_state_from_jax(tcfg, jts)

    # gradients of the loss
    cutoff = jnp.asarray(4.0, jnp.float32)
    jgrads, jm = jax.grad(lambda p: jv._loss(cfg, p, jts, jb, cutoff), has_aux=True)(
        jts.params)
    loss, tm = tv._loss(tcfg, ts.net, ts, tb, torch.tensor(4.0))
    loss.backward()
    want = tnet.params_from_flax(np_tree(jgrads))
    for name, p in ts.net.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), atol=ATOL,
                                   err_msg=name)
    for k, v in tm.items():
        np.testing.assert_allclose(v.numpy(), np.asarray(jm[k]), atol=ATOL, err_msg=k)

    # one update: clipped Adam step, beta adaptation, counters
    ts = train_state_from_jax(tcfg, jts)
    jts1, jm1 = jv.update(cfg, jts, jb)
    ts1, tm1 = tv.update(tcfg, ts, tb)
    back = train_state_to_jax(tcfg, ts1, jts1)
    for a, b in zip(jax.tree.leaves(back.params), jax.tree.leaves(jts1.params)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=ATOL)
    for a, b in zip(jax.tree.leaves(back.opt_state), jax.tree.leaves(jts1.opt_state)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=ATOL)
    assert ts1.n_updates == int(jts1.n_updates) == 1
    np.testing.assert_allclose(ts1.beta.numpy(), np.asarray(jts1.beta), atol=ATOL)
    for k in ("loss", "frac_far", "beta", "cutoff"):
        np.testing.assert_allclose(tm1[k].numpy(), np.asarray(jm1[k]), atol=ATOL, err_msg=k)


@pytest.mark.parametrize("scale", [0.01, 1e3])
def test_clip_by_global_norm_matches_optax(scale):
    rng = np.random.default_rng(6)
    gs = [rng.standard_normal((4, 3)) * scale, rng.standard_normal(5) * scale]
    want, _ = optax.clip_by_global_norm(10.0).update([jnp.asarray(g) for g in gs], None)
    got = [torch.from_numpy(g.copy()) for g in gs]
    tv.clip_by_global_norm(got, 10.0)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-14)


def test_replay_insert_matches_jax_and_wraps():
    C, T, na, D, A = 5, 4, 2, 3, 1
    jrep = jreplay.init(C, T, na, D, A, dtype=jnp.float64)
    trep = replay_from_jax(jrep)
    for seed, B in ((0, 3), (1, 3), (2, 4)):          # the ring wraps twice
        rng = np.random.default_rng(seed)
        b = dict(obs=rng.standard_normal((B, T, na, D)),
                 actions=rng.standard_normal((B, T, na, A)),
                 mu=rng.standard_normal((B, T, na, A)),
                 sigma=rng.uniform(0.1, 1, (B, T, na, A)),
                 rewards=rng.standard_normal((B, T, na)), mask=np.ones((B, T)),
                 final_obs=rng.standard_normal((B, na, D)),
                 truncated=rng.uniform(size=B) > 0.5)
        jrep = jreplay.add_episodes(jrep, _to(b, "jax"))
        trep = treplay.add_episodes(trep, _to(b, "torch"))
        back = replay_to_jax(trep)
        for a, w in zip(jax.tree.leaves(back), jax.tree.leaves(jrep)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(w))
    assert treplay.num_experiences(trep) == int(jreplay.num_experiences(jrep)) == C * T
    s = treplay.sample_episodes(trep, torch.Generator().manual_seed(0), 7)
    assert s["obs"].shape == (7, T, na, D) and s["truncated"].dtype == torch.bool


def test_replay_insert_larger_than_capacity_keeps_the_newest():
    C, T = 3, 2
    trep = treplay.init(C, T, 1, 1, 1, dtype=torch.float64)
    treplay.add_episodes(trep, dict(
        obs=torch.zeros(1, T, 1, 1), actions=torch.zeros(1, T, 1, 1),
        mu=torch.zeros(1, T, 1, 1), sigma=torch.ones(1, T, 1, 1),
        rewards=torch.zeros(1, T, 1), mask=torch.ones(1, T),
        final_obs=torch.zeros(1, 1, 1), truncated=torch.zeros(1, dtype=torch.bool)))
    B = 8                                   # episode i carries the value i
    ids = torch.arange(B, dtype=torch.float64)
    trep = treplay.add_episodes(trep, dict(
        obs=ids[:, None, None, None].expand(B, T, 1, 1), actions=torch.zeros(B, T, 1, 1),
        mu=torch.zeros(B, T, 1, 1), sigma=torch.ones(B, T, 1, 1),
        rewards=ids[:, None, None].expand(B, T, 1), mask=torch.ones(B, T),
        final_obs=ids[:, None, None], truncated=ids > 5))
    # sequential ring writes from cursor 1: episode i lands in slot (1 + i) % 3,
    # so the last writer of slot s is the newest i with that slot
    want = {(1 + i) % C: i for i in range(B)}
    for slot, i in want.items():
        assert trep.obs[slot, 0, 0, 0].item() == i and trep.final_obs[slot, 0, 0].item() == i
        assert bool(trep.truncated[slot]) == (i > 5)
    assert trep.filled == C and trep.cursor == (1 + B) % C
