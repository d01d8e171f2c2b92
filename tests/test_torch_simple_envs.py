"""Port parity: envs/diffusion_env.py, envs/advection_env.py,
envs/laplace_env.py and their five registry presets against the JAX package,
in float64; the constant-action yardsticks of results/diffusion_oracle_r5.json
at a small N.

Tolerances: 1e-10 for states, observations, rewards and returns (the same
float64 arithmetic; the policy's forward adds float64 rounding only); flags and
episode lengths exactly.  The reset draws (diffusion's and advection's offset
noise*N(0,1), Laplace's L*noise*N(0,1) and the random forces' uniform) are
taken from JAX's keys and injected into the port's ``reset_at``.  The JAX
registry's envs reset in float32; the JAX side here resets its env modules
in float64."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from marlpde_tpu.envs import advection_env as jadv
from marlpde_tpu.envs import diffusion_env as jdif
from marlpde_tpu.envs import laplace_env as jlap
from marlpde_tpu.envs import registry as jreg
from marlpde_tpu.envs import rollout as jroll
from marlpde_tpu.rl import vracer as jv
from marlpde_tpu.train import trainer as jtr
from marlpde_tpu_torch.envs import advection_env as tadv
from marlpde_tpu_torch.envs import diffusion_env as tdif
from marlpde_tpu_torch.envs import laplace_env as tlap
from marlpde_tpu_torch.envs import registry as treg
from marlpde_tpu_torch.envs import rollout as troll
from marlpde_tpu_torch.train import trainer as ttr
from test_torch_interop import params64, train_state_from_jax

torch.set_num_threads(1)

TOL = 1e-10
# each preset at a small size: (registry name, overrides, JAX module, port module)
CASES = {
    "diffusion-simple": ("diffusion-simple", dict(N=16, episode_length=12), jdif, tdif),
    "diffusion-simple-4agents": ("diffusion-simple", dict(N=16, num_agents=4,
                                                         episode_length=12), jdif, tdif),
    "diffusion-error": ("diffusion-error", dict(N=16, episode_length=12), jdif, tdif),
    "diffusion-stencil3": ("diffusion-stencil3", dict(N=16, episode_length=12, ic_case="box"),
                           jdif, tdif),
    "diffusion-gaussian": ("diffusion-simple", dict(N=16, episode_length=12,
                                                    ic_case="gaussian"), jdif, tdif),
    "advection-simple": ("advection-simple", dict(N=8, episode_length=12, noise=0.3), jadv,
                         tadv),
    "advection-simple-2agents": ("advection-simple", dict(N=8, num_agents=2, episode_length=12,
                                                          noise=0.3), jadv, tadv),
    "laplace-fourier": ("laplace", dict(num_agents=6, episode_length=12, sforce="fourier",
                                        noise=0.2), jlap, tlap),
    "laplace-sincos": ("laplace", dict(num_agents=6, episode_length=12, sforce="sincos"),
                       jlap, tlap),
}
B = 4


def _case(name):
    preset, kw, jmod, tmod = CASES[name]
    jenv = jreg.make_env(preset, **kw)
    tenv = treg.make_env(preset, device="cpu", dtype=torch.float64, **kw)
    # the JAX env's reset in float64 (its registry binds the float32 default)
    jenv = dataclasses.replace(jenv, reset=lambda c, k, n: jmod.reset(jenv.cfg, k, n,
                                                                      dtype=jnp.float64))
    return jenv, tenv, jmod, tmod


def _keys(seed=0):
    return jax.random.split(jax.random.key(seed), B)


def _reset_both(jenv, tenv, tmod, seed=0):
    """JAX's vmapped reset on B keys; the port's reset_at on the same draws."""
    keys = _keys(seed)
    jst, jobs = jax.vmap(lambda k, c: jenv.reset(jenv.consts, k, c))(keys, jnp.arange(B))
    if tmod is tlap:
        cfg = tenv.cfg
        offset, r = np.zeros(B), np.zeros(B)
        for i, key in enumerate(keys):
            k_off, k_force = jax.random.split(key)
            if cfg.noise > 0.0:
                offset[i] = cfg.L * cfg.noise * float(jax.random.normal(k_off, dtype=jnp.float64))
            r[i] = float(jax.random.uniform(k_force))
        tst, tobs = tlap.reset_at(cfg, torch.from_numpy(offset), torch.from_numpy(r))
    else:
        tst, tobs = tmod.reset_at(tenv.cfg, torch.from_numpy(np.array(jst.solver.offset)))
    return jst, jobs, tst, tobs


def _close(got, want, msg=""):
    want = np.asarray(want)
    if want.dtype == bool or np.issubdtype(want.dtype, np.integer):
        np.testing.assert_array_equal(got.numpy(), want, err_msg=msg)
    else:
        assert got.dtype == torch.float64, msg
        np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL, err_msg=msg)


def _state_close(tst, jst, msg=""):
    """Every field of a port state (nested dataclasses) against the JAX one."""
    for f in dataclasses.fields(tst):
        got, want = getattr(tst, f.name), getattr(jst, f.name)
        if dataclasses.is_dataclass(got):
            _state_close(got, want, f"{msg}{f.name}.")
        else:
            _close(got, want, msg + f.name)


def _actions(tenv, rng, scale):
    return rng.standard_normal((B, tenv.num_agents, tenv.act_dim)) * scale


@pytest.mark.parametrize("name", list(CASES))
def test_reset_and_steps_match_jax(name):
    """Reset, then steps of random actions, with the draws injected; large
    actions late blow some envs up or stop them early, and from then on their
    state is frozen and their reward zero, as in JAX."""
    jenv, tenv, jmod, tmod = _case(name)
    jst, jobs, tst, tobs = _reset_both(jenv, tenv, tmod)
    _state_close(tst, jst, "reset ")
    _close(tobs, jobs, "reset obs")
    rng = np.random.default_rng(1)
    jstep = jax.vmap(lambda s, a: jenv.step(jenv.consts, s, a))
    dones = []
    for i in range(12):
        scale = 0.3 if i < 4 else 30.0
        a = _actions(tenv, rng, scale)
        jst, jobs, jrew, jdone, jinfo = jstep(jst, jnp.asarray(a))
        tst, tobs, trew, tdone, tinfo = tenv.step(tenv.consts, tst, torch.from_numpy(a))
        _state_close(tst, jst, f"step {i} ")
        _close(tobs, jobs, f"step {i} obs")
        _close(trew, jrew, f"step {i} reward")
        _close(tdone, jdone, f"step {i} done")
        _close(tinfo["blown"], jinfo["blown"], f"step {i} blown")
        assert trew.shape == (B, tenv.num_agents)
        dones.append(tdone.clone())
    # diffusion and advection episodes stop early (blowups or cum_reward < 0);
    # Laplace's only by blowing up
    assert bool(dones[-2].any()) or tmod is tlap


@pytest.mark.parametrize("name,push", [("diffusion-simple", 100.0), ("advection-simple", 1.0)])
def test_early_stop_freezes_the_state_and_zeroes_the_reward(name, push):
    """cum_reward < 0 ends the episode (diffusion_environment_simple.py:70-71);
    the next steps keep every field and give reward 0."""
    jenv, tenv, jmod, tmod = _case(name)
    jst, _, tst, _ = _reset_both(jenv, tenv, tmod)
    a = np.zeros((B, tenv.num_agents, tenv.act_dim))
    a[0] = push                    # env 0 is pushed off the analytical solution
    jstep = jax.vmap(lambda s, a_: jenv.step(jenv.consts, s, a_))
    stopped = None
    for i in range(6):
        jst, _, jrew, jdone, _ = jstep(jst, jnp.asarray(a))
        before = tst
        tst, _, trew, tdone, _ = tenv.step(tenv.consts, tst, torch.from_numpy(a))
        _state_close(tst, jst, f"step {i} ")
        _close(trew, jrew, f"step {i} reward")
        if stopped is not None:
            assert trew[0].abs().max() == 0.0
            assert torch.equal(tst.solver.u[0], before.solver.u[0])
            assert tst.macro_step[0] == stopped and tst.cum_reward[0] == before.cum_reward[0]
        elif bool(tdone[0]):
            stopped = int(tst.macro_step[0])
            assert tst.cum_reward[0] < 0.0 and torch.isfinite(tst.solver.u[0]).all()
            assert not tdone[1:].any()
    assert stopped is not None and stopped < 6


@pytest.mark.parametrize("name", ["diffusion-simple", "diffusion-error", "diffusion-stencil3",
                                  "advection-simple", "laplace"])
def test_registry_presets_match_jax(name):
    """Dims, bounds and config of each preset at its defaults, and the port's
    consts: where (the CPU here) and in which dtype its envs live."""
    jenv = jreg.make_env(name)
    tenv = treg.make_env(name, device="cpu")
    assert dataclasses.asdict(tenv.cfg) == dataclasses.asdict(jenv.cfg)
    for f in ("name", "obs_dim", "num_agents", "act_dim", "episode_length", "action_low",
              "action_high"):
        assert getattr(tenv, f) == getattr(jenv, f), f
    assert not tenv.whole_batch
    assert tenv.device == torch.device("cpu") and tenv.dtype == torch.float32
    st, obs = tenv.reset(tenv.consts, torch.Generator().manual_seed(0), torch.arange(3))
    assert obs.shape == (3, tenv.num_agents, tenv.obs_dim) and obs.dtype == torch.float32
    assert st.done.shape == (3,) and not st.done.any()


@pytest.mark.parametrize("name", ["diffusion-simple-4agents", "diffusion-error",
                                  "diffusion-stencil3", "advection-simple-2agents",
                                  "laplace-fourier"])
def test_deterministic_collection_matches_jax(name):
    """rollout.collect_episodes of the deterministic policy, the same weights
    carried across, without reset noise (the draws cannot be injected through
    collect_episodes); episodes that end early leave masked steps."""
    jenv, tenv, _, _ = _case(name)
    noiseless = dict(noise=0.0, **(dict(sforce="sin") if name.startswith("laplace") else {}))
    jenv = dataclasses.replace(jenv, cfg=dataclasses.replace(jenv.cfg, **noiseless))
    jmod = CASES[name][2]
    jenv = dataclasses.replace(
        jenv, reset=lambda c, k, n: jmod.reset(jenv.cfg, k, n, dtype=jnp.float64),
        step=lambda c, s, a: jmod.step(jenv.cfg, s, a))
    tenv = treg.make_env(CASES[name][0], device="cpu", dtype=torch.float64,
                         **{**CASES[name][1], **noiseless})
    kw = dict(width=16, sigma_max=5.0)
    if name.startswith("diffusion"):
        kw.update(mu_param="sigma_relative", cutoff_dim_norm=True)
    jcfg_rl = jtr.default_rl_config(jenv, **kw)
    jts = params64(jcfg_rl, jv.init_train(jcfg_rl, jax.random.key(1), dtype=jnp.float64))
    rng = np.random.default_rng(5)
    jts = jts.replace(params=jax.tree.map(
        lambda a: a + jnp.asarray(rng.standard_normal(a.shape) * 0.3), jts.params))
    ts = train_state_from_jax(ttr.default_rl_config(tenv, **kw), jts)
    tcfg_rl = ttr.default_rl_config(tenv, **kw)
    jtraj, jfinal = jroll.collect_episodes(jenv, jcfg_rl, jts, jax.random.key(2), 3,
                                           deterministic=True)
    traj, final = troll.collect_episodes(tenv, tcfg_rl, ts, None, 3, deterministic=True)
    for k in ("obs", "actions", "mu", "sigma", "rewards", "mask", "final_obs", "truncated"):
        want = np.asarray(jtraj[k])
        np.testing.assert_allclose(traj[k].numpy(), want, rtol=TOL, atol=TOL, err_msg=k)
    np.testing.assert_allclose(final.cum_reward.numpy(), np.asarray(jfinal.cum_reward),
                               rtol=TOL, atol=TOL)
    assert np.abs(np.asarray(jtraj["actions"])).max() > 0.05


def _constant_action_episode(tenv, offsets, value):
    """Every env of the batch acting ``value`` on every point until the
    episode ends; returns (returns, episode lengths) as numpy."""
    st, obs = tdif.reset_at(tenv.cfg, offsets)
    a = torch.full((len(offsets), tenv.num_agents, tenv.act_dim), value, dtype=offsets.dtype)
    live = torch.zeros(len(offsets))
    for _ in range(tenv.episode_length):
        live += (~st.done).to(live.dtype)
        st, obs, _, _, _ = tenv.step(tenv.consts, st, a)
    return st.cum_reward.numpy(), live.numpy()


def test_oracle_and_zero_policy_yardsticks_at_a_small_N():
    """results/diffusion_oracle_r5.json's constant actions at N=16, 100
    macro-steps: at -2 (the exact explicit stencil) every episode runs to
    its end with return 100*bonus less the summed MSE against the analytical
    solution; at 0 the episode length does not depend on the offset (the
    sinus MSE is shift-invariant); both equal JAX's."""
    kw = dict(N=16, episode_length=100)
    jenv = jreg.make_env("diffusion-simple", **kw)
    tenv = treg.make_env("diffusion-simple", device="cpu", dtype=torch.float64, **kw)
    offsets = torch.tensor([0.0, 0.37, -0.81, 1.9], dtype=torch.float64)
    jstep = jax.vmap(lambda s, a: jdif.step(jenv.cfg, s, a))
    for value in (-2.0, 0.0):
        ret, eplen = _constant_action_episode(tenv, offsets, value)
        # the JAX env on the same offsets
        jst = jax.vmap(lambda k: jdif.reset(jenv.cfg, k, 0, dtype=jnp.float64)[0])(_keys())
        jst = jst.replace(solver=jst.solver.replace(
            offset=jnp.asarray(offsets.numpy()),
            u=jnp.sin((jnp.asarray(jenv.cfg.solver.grid.x)[None] - offsets.numpy()[:, None])
                      * 2.0 * np.pi / jenv.cfg.L)))
        jst = jst.replace(solver=jst.solver.replace(u0=jst.solver.u))
        a = jnp.full((4, 1, 16), value)
        for _ in range(100):
            jst, *_ = jstep(jst, a)
        np.testing.assert_allclose(ret, np.asarray(jst.cum_reward), rtol=TOL, atol=TOL)
        np.testing.assert_array_equal(eplen, np.asarray(jst.macro_step))
        if value == -2.0:
            assert (eplen == 100).all()
            bonus = tenv.cfg.survival_bonus
            # return = 100 * bonus - sum_t mse_t, the MSE of the exact stencil
            st, _ = tdif.reset_at(tenv.cfg, offsets)
            mse = 0.0
            act = torch.full((4, 1, 16), -2.0, dtype=torch.float64)
            for _ in range(100):
                st, _, rew, _, _ = tenv.step(tenv.consts, st, act)
                mse = mse + (bonus - rew[:, 0])
            np.testing.assert_allclose(ret, 100 * bonus - mse.numpy(), rtol=1e-12, atol=1e-15)
            assert (ret > 0).all() and (ret < 100 * bonus).all()
        else:
            assert (eplen == eplen[0]).all() and eplen[0] < 100 and (ret < 0).all()
            np.testing.assert_allclose(ret, ret[0], rtol=1e-9)


def test_short_episodes_insert_into_the_flat_replay_as_in_jax():
    """Episodes of the diffusion env that stop early (cum_reward < 0) from a
    deterministic collection on both packages, then the experience-mode
    normalizers and flat insert: the same replay, every field; only the live
    steps are inserted."""
    from marlpde_tpu.rl import replay_flat as jflat
    from marlpde_tpu_torch.rl import vracer as tv
    from test_torch_interop import flat_from_jax, flat_to_jax

    name = "diffusion-stencil3"
    jenv, tenv, jmod, _ = _case(name)
    jenv = dataclasses.replace(jenv, cfg=dataclasses.replace(jenv.cfg, noise=0.0))
    jenv = dataclasses.replace(
        jenv, reset=lambda c, k, n: jmod.reset(jenv.cfg, k, n, dtype=jnp.float64),
        step=lambda c, s, a: jmod.step(jenv.cfg, s, a))
    tenv = treg.make_env(CASES[name][0], device="cpu", dtype=torch.float64,
                         **{**CASES[name][1], "noise": 0.0})
    kw = dict(width=16, sigma_max=5.0, mu_param="sigma_relative", cutoff_dim_norm=True,
              minibatch_mode="experience", replay_max_experiences=64, mini_batch_size=8)
    jcfg_rl = jtr.default_rl_config(jenv, **kw)
    jts = params64(jcfg_rl, jv.init_train(jcfg_rl, jax.random.key(1), dtype=jnp.float64))
    rng = np.random.default_rng(2)
    jts = jts.replace(params=jax.tree.map(
        lambda a: a + jnp.asarray(rng.standard_normal(a.shape) * 2.0), jts.params))
    tcfg_rl = ttr.default_rl_config(tenv, **kw)
    ts = train_state_from_jax(tcfg_rl, jts)
    jrep = jflat.init_flat(64, jcfg_rl.flat_episode_capacity, 1, jenv.obs_dim, jenv.act_dim,
                           dtype=jnp.float64)
    trep = flat_from_jax(jrep)
    for seed in range(2):
        jtraj, _ = jroll.collect_episodes(jenv, jcfg_rl, jts, jax.random.key(seed), 4,
                                          deterministic=True)
        ttraj, _ = troll.collect_episodes(tenv, tcfg_rl, ts, None, 4, deterministic=True)
        np.testing.assert_array_equal(ttraj["mask"].numpy(), np.asarray(jtraj["mask"]))
        jts = jv.observe_episodes(jcfg_rl, jts, jtraj)
        ts = tv.observe_episodes(tcfg_rl, ts, ttraj)
        jrep = jv.flat_insert(jcfg_rl, jts, jrep, jtraj)
        trep = tv.flat_insert(tcfg_rl, ts, trep, ttraj)
        back = flat_to_jax(trep)
        for f in dataclasses.fields(jflat.FlatReplay):
            a, b = np.asarray(getattr(back, f.name)), np.asarray(getattr(jrep, f.name))
            if a.dtype == np.float64:
                np.testing.assert_allclose(a, b, rtol=1e-9, atol=1e-12, err_msg=f.name)
            else:
                np.testing.assert_array_equal(a, b, err_msg=f.name)
    live = int(ttraj["mask"].sum())
    assert live < 4 * tenv.episode_length
    assert trep.cursor == int(np.asarray(jrep.cursor))


def test_experience_ledger_counts_live_steps_of_short_episodes():
    """The experience-mode trainer on the diffusion env, whose episodes stop
    early: each generation's updates are korali's ledger over the live steps
    (marlpde_tpu/train/trainer.py:349-373), and the experience count is the
    live steps."""
    tenv = treg.make_env("diffusion-simple", device="cpu", N=16, episode_length=30)
    rl_cfg = ttr.default_rl_config(tenv, width=8, minibatch_mode="experience",
                                   mini_batch_size=8, replay_start_experiences=20,
                                   replay_max_experiences=400,
                                   experiences_between_updates=1.0)
    tc = ttr.TrainerConfig(num_envs=4, max_experiences=120, seed=2, max_updates_per_gen=15,
                           count_real_experiences=True)
    _, rep, hist = ttr.train(tenv, rl_cfg, tc, verbose=False)
    exps = np.asarray(hist["experiences"])
    lens = np.asarray(hist["mean_ep_len"])
    assert (lens < 30).any() and ((lens >= 1) & (lens <= 30)).all()
    np.testing.assert_allclose(np.diff(exps, prepend=0), lens * 4)
    done = 0
    for total, n in zip(exps, hist["updates"]):
        target = int(max(0.0, (total - 20) / 1.0)) if total >= 20 else 0
        want = min(15, max(0, target - done)) if total >= 20 else 0
        assert n == want, (total, n, want)
        done += n
    assert rep.cursor == exps[-1]
