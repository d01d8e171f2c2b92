"""Run 918's whole training loop in lockstep with the JAX package, on the CPU
in float64 (scripts/torch_lockstep.py): the same numpy-made action noise and
minibatch draws through both packages' ``trainer.train``, from the same
weights and flags through both ``run.make_workload``, 5 generations, updates
from generation 2 on (20 a generation in experience mode, 16 in episode
mode).  Cases: experience mode on korali's real-experience ledger (the CLI's
run 918 at a small size), episode mode at the static count (the fused
flagship's loop) and KS (run 926's flags at a small size, ``--fused``, the
JAX package's DNS pool carried into the port's).

Compared, as the normwise relative gap max|port - JAX| / max|JAX| of each
recorded array: each generation's mean return, ep_len, updates, blow-ups,
reward scale, replay cursor, last update's metrics and the generation's
replay rows (obs, actions, mu, sigma, rewards); the metrics of every update;
the final parameters, Adam moments and normalizers.  Tolerance 1e-9; the
worst measured gap is below 1e-13 in every case (float64 sums taken in other
orders).  Counters and draw counts are exact.

Both trainers are handed a replay in float64 (``init_replay``): the JAX
package's own replay is float32 whatever the run's dtype, so a float64 run
computes the behaviour policy's log-probabilities and the retrace products
in float32, where XLA's and torch's float32 functions part by an ulp.  The
trainer's float32 replay and its float64 reward scale are held against the
JAX package's by the last two tests (fault F3).

KS's macro-step is cut to run 926's length (1 time unit: --episodelength 500
over the default 500), by ``t_end``: at the CLI's 10 macro-steps over 500
time units a rounding difference grows about 100-fold a macro-step (the
chaotic KS dynamics), so no two float64 codes agree past the first episode.
"""

import dataclasses
import functools
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from marlpde_tpu import run as jrun
from marlpde_tpu.envs import registry as jreg
from marlpde_tpu.rl import replay_flat as jflat
from marlpde_tpu.rl import running_stats as jrs
from marlpde_tpu.rl import vracer as jv
from marlpde_tpu.train import trainer as jtr
from marlpde_tpu_torch.envs import registry as treg
from marlpde_tpu_torch.rl import vracer_loss as tvl
from marlpde_tpu_torch.rl import replay_flat as tflat
from marlpde_tpu_torch.rl import running_stats as trs
from marlpde_tpu_torch.rl import vracer as tv
from marlpde_tpu_torch.train import trainer as ttr
from test_torch_interop import flat_from_jax

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location(
    "torch_lockstep", os.path.join(ROOT, "scripts", "torch_lockstep.py"))
L = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(L)

RTOL = 1e-9
N_GENS = 5
T = 10
# run 918's learner flags (scripts/tpu_flagship_918.sh) at a small size
BURGER = ("burger-marl --nagents 4 --specreward --dforce --ic turbulence --NDNS 64 --dt 0.01 "
          "--T 0.2 --episodelength 10 --numenvs 2 --width 16 --iex 0.1 --rscale cumulative "
          "--trust forward --mbsize 8 --maxupd 20 --NE 1000000 ")
CASES = {
    "experience-ledger": (BURGER + "--rstart 20 --diag", None),
    "episode-static": (BURGER + "--minibatch episode --fused --rstart 40", None),
    # run 926 (scripts/tpu_ks_926.sh) at a small size; t_end: see the docstring
    "ks-fused": ("ks --NDNS 64 --N 16 --NA 16 --ndns 2 --sigma-max 5 --iex 0.01 "
                 "--episodelength 10 --numenvs 2 --width 16 --mbsize 8 --rstart 40 "
                 "--maxupd 20 --fused --NE 1000000", dict(t_end=60.0)),
}
UPDATES = {"experience-ledger": [0, 20, 20, 20, 20], "episode-static": [0, 16, 16, 16, 16],
           "ks-fused": [0, 20, 20, 20, 20]}
EXACT = ("gen/n_upd", "gen/cursor", "gen/blowups", "gen/n_updates", "final/adam_count")


@functools.lru_cache(maxsize=None)
def lockstep(case):
    """(JAX records, port records) of ``case``, run once per test process."""
    flags, overrides = CASES[case]
    argv = flags.split()
    _, cfg, _ = jrun.make_workload(jrun.build_parser().parse_args(argv))
    params = jax.tree.map(np.asarray, jv.init_train(cfg, jax.random.key(3)).params)
    kw = dict(n_gens=N_GENS, dtype="float64", rows_per_gen=1000, n_upd_rec=1000,
              replay_in_dtype=True, env_overrides=overrides)
    jrec, jenv, _ = L.jax_run(argv, params, **kw)
    pool = None
    if case.startswith("ks"):
        pool = {f.name: np.asarray(getattr(jenv.consts, f.name))
                for f in dataclasses.fields(jenv.consts)}
    trec, _, _ = L.torch_run(argv, params, device="cpu", pool=pool, **kw)
    return L.strip(jrec, "jax"), L.strip(trec, "torch")


@pytest.mark.parametrize("case", list(CASES))
def test_the_whole_loop_agrees_with_jax_in_lockstep(case):
    """Every recorded number of 5 generations, 3 or more of them with
    updates, and the final train state, within 1e-9 of the JAX package."""
    want, got = lockstep(case)
    assert list(want["gen/n_upd"]) == list(got["gen/n_upd"]) == UPDATES[case]
    for k in EXACT:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    keys = [k for k in want if not k.startswith("draws/")]
    assert {k for k in got if not k.startswith("draws/")} == set(keys)
    assert any(k.startswith("final/params/") for k in keys)
    assert any(k.startswith("final/adam_nu/") for k in keys)
    assert {"final/obs_stats/m2", "final/rew_stats/m2", "final/beta"} <= set(keys)
    assert len(want["upd/loss"]) == sum(UPDATES[case])
    gaps = L.gaps(got, want, keys)
    worst = max(gaps, key=gaps.get)
    assert gaps[worst] <= RTOL, (worst, gaps[worst])


@pytest.mark.parametrize("case", list(CASES))
def test_every_draw_came_from_the_tape(case):
    """The tape guard: both packages drew as often at each site (an action
    noise a macro-step, a minibatch an update), and the port's generator is
    where its seed put it, so no draw of the port went around the tape."""
    want, got = lockstep(case)
    episode_mode = "episode" in case
    expected = dict(noise=N_GENS * T, ids=0 if episode_mode else sum(UPDATES[case]),
                    episodes=sum(UPDATES[case]) if episode_mode else 0)
    for site, n in expected.items():
        assert int(want[f"draws/{site}"]) == int(got[f"draws/{site}"]) == n, site
    assert int(got["draws/generators"]) == 1
    assert int(got["draws/generator_unmoved"]) == 1


def _env64():
    return treg.make_env("burger", dtype=torch.float64, device="cpu", N_dns=64, grid_size=32,
                         num_actions=32, num_agents=4, dt=0.01, T=0.1, episode_length=5,
                         ic_case="turbulence", spectral_reward=True)


@pytest.mark.parametrize("mode", ["experience", "episode"])
def test_a_float64_run_keeps_its_replay_in_float32_as_jax_does(mode):
    """Fault F3: the JAX trainer's replay is float32 whatever the env's dtype
    (its ``init``/``init_flat`` defaults); the port's was the env's dtype,
    so a float64 lockstep parted at the first generation's stored rows."""
    tenv = _env64()
    jenv = jreg.make_env("burger", dtype=jnp.float64, **dataclasses.asdict(tenv.cfg))
    cfg = ttr.default_rl_config(tenv, minibatch_mode=mode, replay_max_experiences=40)
    jcfg = jtr.default_rl_config(jenv, minibatch_mode=mode, replay_max_experiences=40)
    trep, jrep = ttr.make_replay(tenv, cfg), jtr.make_replay(jenv, jcfg)
    for name, v in vars(trep).items():
        if torch.is_tensor(v) and v.is_floating_point() and name != "counters":
            assert v.dtype == torch.float32, name
            assert np.asarray(getattr(jrep, name)).dtype == np.float32, name


def _f32_replay(rng, T_, NA):
    """A float32 flat replay (the trainer's) of two episodes, one truncated,
    with importance weights whose products are exact in any order."""
    jrep = jflat.init_flat(16, 4, NA, 3, 1)
    batch = dict(obs=rng.standard_normal((2, T_, NA, 3)), actions=np.zeros((2, T_, NA, 1)),
                 mu=np.zeros((2, T_, NA, 1)), sigma=np.ones((2, T_, NA, 1)),
                 rewards=rng.standard_normal((2, T_, NA)) * 0.05, mask=np.ones((2, T_)),
                 final_obs=rng.standard_normal((2, NA, 3)), truncated=np.array([False, True]))
    jrep = jflat.add_episodes(jrep, {k: jnp.asarray(v) for k, v in batch.items()},
                              sv=jnp.asarray(rng.standard_normal((2, T_, NA))),
                              vtg=jnp.zeros((2, T_, NA)),
                              boot=jnp.asarray(rng.standard_normal((2, NA))))
    return jrep.replace(rho=jnp.asarray(rng.choice([0.25, 0.5, 1.0], jrep.rho.shape),
                                        jnp.float32))


@pytest.mark.parametrize("site", ["loss-rescaling", "normalizer-scale", "retrace-refresh"])
def test_float32_replay_rewards_meet_a_float64_scale_in_float64_as_in_jax(site):
    """Fault F3: JAX divides the float32 replay's rewards by the float64
    reward scale in float64 (a 0-d array takes part in its promotion); torch
    leaves a 0-d tensor out, so the port divided in float32 and its one-step
    targets and retrace values parted from JAX's at 1e-7.  Held at each
    site: experience mode's rescaling, episode mode's normalizer scale, and
    the retrace refresh on a float32 replay."""
    T_, NA = 4, 2
    rng = np.random.default_rng(5)
    scale = np.float64(0.3711)
    r32 = (rng.standard_normal((6, NA)) * 0.05).astype(np.float32)
    if site == "loss-rescaling":
        cfg = jv.VracerConfig(obs_dim=3, act_dim=1, num_agents=NA, episode_length=T_)
        want = jv._rescale_rewards(cfg, jnp.asarray(r32), jnp.asarray(scale))
        got = tvl.rescale_rewards(tv.VracerConfig(**dataclasses.asdict(cfg)),
                                  torch.from_numpy(r32), torch.tensor(scale))
    elif site == "normalizer-scale":
        stats = dict(mean=np.float64(0.01), m2=np.float64(0.4), count=np.float64(2000.0))
        want = jrs.scale(jrs.RunningStats(**{k: jnp.asarray(v) for k, v in stats.items()}),
                         jnp.asarray(r32))
        got = trs.scale(trs.RunningStats(**{k: torch.tensor(v) for k, v in stats.items()}),
                        torch.from_numpy(r32))
    else:
        jrep = _f32_replay(rng, T_, NA)
        trep = flat_from_jax(jrep)
        assert trep.rewards.dtype == torch.float32
        g = np.array([0, 2, 5, 7])
        _, want = jflat.refresh_retrace(jrep, jnp.asarray(g, jnp.int32), T_, 1.0,
                                        jnp.asarray(scale))
        _, got = tflat.refresh_retrace(trep, torch.from_numpy(g), T_, 1.0, torch.tensor(scale))
    assert want.dtype == jnp.float64 and got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12)
