"""Port parity: VRACER's experience mode — ``flat_insert`` into the flat replay,
then one ``update_experience`` — against the JAX package in float64.

The minibatch ids are patched into ``replay_flat.sample_ids`` of both packages
(their RNG streams never match).  Compared: every replay field after the
insert and after the update's refreshes, the clipped gradients, the new
parameters and Adam state, beta, the counters and the metrics.  Tolerance
1e-9 relative (float64 math, summed in other orders), ids and flags exact."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import marlpde_tpu.rl.replay_flat as jflat
import marlpde_tpu_torch.rl.replay_flat as tflat
from marlpde_tpu.rl import running_stats as jrs
from marlpde_tpu.rl import vracer as jv
from marlpde_tpu_torch.rl import networks as tnet
from marlpde_tpu_torch.rl import vracer as tv
from test_torch_interop import (flat_from_jax, flat_to_jax, np_tree, params64,
                                train_state_from_jax, train_state_to_jax)

torch.set_num_threads(1)
RTOL, ATOL = 1e-9, 1e-12
T, NA = 5, 2
# live ids 8..23 after two inserts: duplicates, an episode whose head (id 7)
# was evicted, a terminal end (11), a truncated end (18)
IDS = np.array([9, 9, 11, 8, 18, 17, 12, 23])


def _batch(seed, B=3, obs_dim=3, act_dim=1, sigma_scale=0.2):
    rng = np.random.default_rng(seed)
    mask = np.ones((B, T))
    mask[1, 2:] = 0.0                               # episode 1 blows up after 2 steps
    rewards = rng.standard_normal((B, T, NA)) * 0.05
    rewards[1, 1] = -np.inf
    rewards[1, 2:] = 0.0
    mu = rng.standard_normal((B, T, NA, act_dim)) * 0.3
    sigma = np.exp(rng.standard_normal((B, T, NA, act_dim)) * 0.3) * sigma_scale
    actions = np.clip(mu + 2 * sigma * rng.standard_normal(mu.shape), -5, 5)
    final_obs = rng.standard_normal((B, NA, obs_dim))
    final_obs[1, 0, 0] = np.nan
    return dict(obs=rng.standard_normal((B, T, NA, obs_dim)) * 1.5, actions=actions, mu=mu,
                sigma=sigma, rewards=rewards, mask=mask, final_obs=final_obs,
                truncated=np.array([False, True, False]))


def _states(obs_dim=3, act_dim=1, width=8, **cfg_kw):
    cfg = jv.VracerConfig(obs_dim=obs_dim, act_dim=act_dim, num_agents=NA, episode_length=T,
                          width=width, mini_batch_size=len(IDS), replay_max_experiences=16,
                          replay_episode_capacity=4, **cfg_kw)
    jts = params64(cfg, jv.init_train(cfg, jax.random.key(2), dtype=jnp.float64))
    rng = np.random.default_rng(9)
    mean, m2 = ([0.3, 0.5, -0.2], [40.0, 80.0, 30.0]) if obs_dim == 3 else (
        np.linspace(-0.3, 0.5, obs_dim), np.linspace(30.0, 80.0, obs_dim))
    jts = jts.replace(
        params=jax.tree.map(lambda a: a + jnp.asarray(rng.standard_normal(a.shape) * 0.3),
                            jts.params),
        obs_stats=jrs.RunningStats(mean=jnp.asarray(mean), m2=jnp.asarray(m2),
                                   count=jnp.asarray(20.0)),
        rew_stats=jrs.RunningStats(mean=jnp.asarray(0.01), m2=jnp.asarray(0.4),
                                   count=jnp.asarray(2000.0)))
    tcfg = tv.VracerConfig(**dataclasses.asdict(cfg))
    assert tcfg.flat_episode_capacity == cfg.flat_episode_capacity == 4
    return cfg, jts, tcfg, train_state_from_jax(tcfg, jts)


def _assert_replay(trep, jrep):
    back = flat_to_jax(trep)
    for f in dataclasses.fields(jflat.FlatReplay):
        a, b = np.asarray(getattr(back, f.name)), np.asarray(getattr(jrep, f.name))
        if a.dtype == np.float64:
            np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL, err_msg=f.name)
        else:
            np.testing.assert_array_equal(a, b, err_msg=f.name)


def _insert_both(cfg, jts, tcfg, ts):
    """Two generations (observe, then insert, the trainer's experience-mode
    order) into a ring of 16: the second evicts the first's oldest steps."""
    jrep = jflat.init_flat(16, 4, NA, cfg.obs_dim, cfg.act_dim, dtype=jnp.float64)
    trep = flat_from_jax(jrep)
    for seed in (0, 1):
        b = _batch(seed, obs_dim=cfg.obs_dim, act_dim=cfg.act_dim,
                   sigma_scale=0.2 if cfg.act_dim == 1 else cfg.init_noise)
        jb = {k: jnp.asarray(v) for k, v in b.items()}
        tb = {k: torch.from_numpy(v) for k, v in b.items()}
        jts = jv.observe_episodes(cfg, jts, jb)
        ts = tv.observe_episodes(tcfg, ts, tb)
        jrep = jv.flat_insert(cfg, jts, jrep, jb)
        trep = tv.flat_insert(tcfg, ts, trep, tb)
        _assert_replay(trep, jrep)
    assert trep.cursor == 24 and trep.cursor - trep.live == 8
    return jts, jrep, ts, trep


CASES = [
    dict(),
    dict(trust_region="forward", n_updates=3_000_000),
    dict(mu_param="sigma_relative", sigma_max=0.15),
    dict(reward_scale_source="cumulative", multi_agent_correlation=True),
    dict(multi_agent_relationship="cooperation", cutoff_dim_norm=True,
         multi_agent_correlation=True, gamma=0.95),
    dict(reward_rescaling=False, state_rescaling=False),
    # the burger-fd learner (run-vracer-burger-fd.py): obs 256, 256 actions,
    # width 32, iex 0.005; its importance weights are products over 256
    # dimensions, so every sample is far-policy and the KL term dominates
    dict(obs_dim=256, act_dim=256, width=32, init_noise=0.005, sigma_max=0.05),
]


@pytest.mark.parametrize("case", CASES, ids=[",".join(c) or "default" for c in CASES])
def test_flat_insert_then_one_update(case, monkeypatch):
    case = dict(case)
    n_updates = case.pop("n_updates", 0)
    cfg, jts, tcfg, ts = _states(**case)
    wide = cfg.act_dim > 1
    jts, jrep, ts, trep = _insert_both(cfg, jts, tcfg, ts)
    jts = jts.replace(n_updates=jnp.asarray(n_updates, jnp.int32))
    ts = train_state_from_jax(tcfg, jts)

    monkeypatch.setattr(jflat, "sample_ids", lambda rep, key, n: jnp.asarray(IDS))
    monkeypatch.setattr(tflat, "sample_ids", lambda rep, gen, n: torch.from_numpy(IDS))

    # the JAX update's own steps, for its gradients
    g = jnp.asarray(IDS)
    rows = jflat.gather(jrep, g)
    cutoff = cfg.cutoff_scale / (1.0 + cfg.annealing_rate * jnp.asarray(n_updates, jnp.float32))
    if not cfg.reward_rescaling:
        scale = jnp.asarray(1.0, jnp.float32)
    elif cfg.reward_scale_source == "cumulative":
        scale = jrs.second_moment(jts.rew_stats)
    else:
        scale = jflat.reward_scale(jrep, cfg.reward_floor)
    V, mu, sigma = jv.make_net(cfg).apply(jts.params, jv._prep_obs(cfg, jts, rows["obs"]))
    rho, _ = jv._joint_rho(cfg, rows["actions"], mu, sigma, rows["mu"], rows["sigma"])
    off = ~((rho > 1.0 / cutoff) & (rho < cutoff))
    boot = (jv._sanitized_final_V(cfg, jts.params, jts, rows["fin_obs"])
            * rows["truncated"].astype(V.dtype)[..., None])
    jr = jflat.refresh_metadata(jrep, g, V, rho, off, boot)
    jr, vtg_next = jflat.refresh_retrace(jr, g, cfg.episode_length, cfg.gamma, scale,
                                         cfg.reward_floor, scaled_floor=cfg.scaled_reward_floor)
    jgrads, _ = jax.grad(lambda p: jv._loss_experience(cfg, p, jts, rows, vtg_next, scale,
                                                       cutoff), has_aux=True)(jts.params)
    jgrads, _ = optax.clip_by_global_norm(cfg.max_grad_norm).update(jgrads, None)

    jts1, jrep1, jm = jv.update_experience(cfg, jts, jrep, jax.random.key(0))
    ts1, trep1, tm = tv.update_experience(tcfg, ts, trep, None)

    want = tnet.params_from_flax(np_tree(jgrads))
    for name, p in ts1.net.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), rtol=RTOL, atol=ATOL,
                                   err_msg=f"grad {name}")
    back = train_state_to_jax(tcfg, ts1, jts1)
    for a, b in zip(jax.tree.leaves(back.params), jax.tree.leaves(jts1.params)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=RTOL, atol=ATOL)
    for a, b in zip(jax.tree.leaves(back.opt_state), jax.tree.leaves(jts1.opt_state)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=RTOL, atol=ATOL)
    assert ts1.n_updates == int(jts1.n_updates) == n_updates + 1
    np.testing.assert_allclose(ts1.beta.numpy(), np.asarray(jts1.beta), rtol=1e-14)
    assert set(tm) == set(jm)
    for k, v in tm.items():
        np.testing.assert_allclose(np.asarray(v), np.asarray(jm[k]), rtol=RTOL, atol=ATOL,
                                   err_msg=k)
    _assert_replay(trep1, jrep1)
    # the sample made some of the stored flags off-policy, or none: either way
    # the replay-wide fraction is the JAX one
    assert tm["frac_off_replay"].item() == float(jm["frac_off_replay"])
    if wide:
        assert tm["frac_far"].item() == float(jm["frac_far"]) == 1.0


@pytest.mark.parametrize("frac_off,rises", [(0.0, True), (1.0, False)])
def test_beta_anneals_against_the_replay_fraction(frac_off, rises, monkeypatch):
    """beta moves toward 1 by the annealed lr while the replay-wide off-policy
    fraction is under target and down when over, clipped to [0, 1]."""
    cfg, jts, tcfg, ts = _states(lr=1e-2)
    jts, jrep, ts, trep = _insert_both(cfg, jts, tcfg, ts)
    monkeypatch.setattr(tflat, "sample_ids", lambda rep, gen, n: torch.from_numpy(IDS[:1]))
    trep.off.fill_(bool(frac_off))
    # a sample of one experience refreshes only its own flags
    ts1, _, m = tv.update_experience(tcfg, train_state_from_jax(tcfg, jts), trep, None)
    beta0 = cfg.refer_beta
    want = (1 - cfg.lr) * beta0 + cfg.lr if rises else (1 - cfg.lr) * beta0
    assert ts1.beta.item() == pytest.approx(want, rel=1e-12)
    assert (m["frac_off_replay"].item() <= cfg.offpolicy_target) == rises


def test_fifty_updates_in_lockstep(monkeypatch):
    """50 sequential experience-mode updates from one state, the minibatch
    ids of each drawn from one numpy stream over the live range and patched
    into both packages' ``sample_ids``: every 10 updates the parameters,
    Adam's state, beta, the counter and every replay field match JAX's at
    the 1e-9 relative tolerance, so no drift builds up over updates that one
    update's comparison would not show."""
    cfg, jts, tcfg, ts = _states(lr=1e-2)
    jts, jrep, ts, trep = _insert_both(cfg, jts, tcfg, ts)
    ts = train_state_from_jax(tcfg, jts)
    rng = np.random.default_rng(12)
    ids = rng.integers(trep.cursor - trep.live, trep.cursor, size=(50, len(IDS)))
    # the ids ride in the key argument, so that one jitted JAX update takes them all
    monkeypatch.setattr(jflat, "sample_ids", lambda rep, key, n: key)
    draw = iter(ids)
    monkeypatch.setattr(tflat, "sample_ids", lambda rep, gen, n: torch.from_numpy(next(draw)))
    jupdate = jax.jit(lambda ts_, rep_, g: jv.update_experience(cfg, ts_, rep_, g))
    for k, g in enumerate(ids, 1):
        jts, jrep, jm = jupdate(jts, jrep, jnp.asarray(g))
        ts, trep, tm = tv.update_experience(tcfg, ts, trep, None)
        if k % 10:
            continue
        back = train_state_to_jax(tcfg, ts, jts)
        for a, b in zip(jax.tree.leaves((back.params, back.opt_state)),
                        jax.tree.leaves((jts.params, jts.opt_state))):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=RTOL, atol=ATOL,
                                       err_msg=f"after update {k}")
        np.testing.assert_allclose(ts.beta.numpy(), np.asarray(jts.beta), rtol=1e-14)
        assert int(ts.n_updates) == int(jts.n_updates) == k
        _assert_replay(trep, jrep)
        for name, v in tm.items():
            np.testing.assert_allclose(np.asarray(v), np.asarray(jm[name]), rtol=RTOL,
                                       atol=ATOL, err_msg=f"{name} after update {k}")


# fault F2 (run 926 at seed 7, generation 103, update 994 of the generation,
# on the card): KS's learner (sigma_relative, sigma_max 5, the dimension
# temper) where one sampled row's sigma was 1.06e-4 against a mean of
# 5.8e-3, so z = (bound - mu) / sigma reached 4.7e4.  Here every row's sigma
# is 9.9e-5 (mu 0, |z| = 5.05e4, a value where torch.special.log_ndtr's
# float32 backward is inf), some sampled actions at a bound (run 918's
# first non-finite row) and the rest inside (run 926's), so every log-ratio
# is clipped at -20 and every row is far-policy
F2_SIGMA_BIAS = -5.086
F2_CFG = dict(obs_dim=3, act_dim=4, width=8, init_noise=0.01, sigma_max=5.0,
              mu_param="sigma_relative", cutoff_dim_norm=True)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_an_update_with_sigma_far_below_the_bounds_stays_finite_as_in_jax(dtype, monkeypatch):
    """Fault F2: with the current policy's sigma 9.9e-5 under bounds of +-5,
    z = (bound - mu) / sigma is about -5.05e4 in both tails of every sampled
    action's log-probability.  torch.special.log_ndtr's backward loses
    exp(-(log_ndtr(z) + z^2/2)) there in float32 (0 or inf), and
    ``log_prob``'s unselected bound branch turned its zero cotangent into
    0 * inf = NaN; JAX's log_ndtr (its value and its derivative rule, which
    the port now computes) stays finite.  One update of each package from
    the same state: every parameter, Adam moment and beta finite, the log-
    ratios clipped at -20, and the two packages equal (float64 at 1e-9,
    float32 at 1e-5 relative)."""
    cfg, jts, tcfg, ts = _states(**F2_CFG)
    jts, jrep, ts, trep = _insert_both(cfg, jts, tcfg, ts)
    p = jts.params["params"]
    heads = {"Dense_3": 0.0, "Dense_4": F2_SIGMA_BIAS}     # mu, sigma: constant outputs
    p = {**p, **{k: dict(kernel=jnp.zeros_like(p[k]["kernel"]),
                         bias=jnp.full_like(p[k]["bias"], b)) for k, b in heads.items()}}
    jts = jts.replace(params={"params": p})
    # half the sampled experiences act at a bound, as a clipped sample does
    s = IDS % 16
    jrep = jrep.replace(actions=jrep.actions.at[s[::2], :, ::2].set(-5.0)
                        .at[s[1::2], :, 1::2].set(5.0))
    if dtype == "float32":
        jts = jax.tree.map(lambda a: a.astype(jnp.float32) if a.dtype == jnp.float64 else a, jts)
        jrep = jax.tree.map(lambda a: a.astype(jnp.float32) if a.dtype == jnp.float64 else a,
                            jrep)
        jts = jts.replace(opt_state=jv.make_optimizer(cfg).init(jts.params))
    ts = train_state_from_jax(tcfg, jts)
    trep = flat_from_jax(jrep)
    monkeypatch.setattr(jflat, "sample_ids", lambda rep, key, n: jnp.asarray(IDS))
    monkeypatch.setattr(tflat, "sample_ids", lambda rep, gen, n: torch.from_numpy(IDS))

    _, mu, sigma = ts.net(tv._prep_obs(tcfg, ts, tflat.gather(trep, torch.from_numpy(IDS))["obs"]))
    assert sigma.dtype == getattr(torch, dtype)
    assert 4e4 < ((5.0 - mu.abs()) / sigma).min().item() < 6e4
    jts1, jrep1, jm = jv.update_experience(cfg, jts, jrep, jax.random.key(0))
    ts1, trep1, tm = tv.update_experience(tcfg, ts, trep, None)

    back = train_state_to_jax(tcfg, ts1, jts1)
    leaves = jax.tree.leaves((back.params, back.opt_state, back.beta))
    jleaves = jax.tree.leaves((jts1.params, jts1.opt_state, jts1.beta))
    assert all(np.isfinite(np.asarray(a)).all() for a in jleaves)
    assert all(np.isfinite(np.asarray(a)).all() for a in leaves)
    rtol = RTOL if dtype == "float64" else 1e-5
    for a, b in zip(leaves, jleaves):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol, atol=rtol * 1e-3)
    assert tm["mean_rho"].item() == pytest.approx(float(jm["mean_rho"]), rel=rtol)
    assert tm["frac_far"].item() == float(jm["frac_far"]) == 1.0
    for k in ("loss", "kl_loss", "v_loss"):
        assert np.isfinite(tm[k].item())
        np.testing.assert_allclose(tm[k].item(), float(jm[k]), rtol=rtol, err_msg=k)
