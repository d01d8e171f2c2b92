"""The port's trainer in experience mode on the small Burgers env: korali's
real-experience update ledger against JAX ``trainer.train``,
``build_fused_generation`` against ``train``'s generations, resume
bitwise equal to an uninterrupted run, testing with the ``best/``
checkpoint, the decay diagnostics, the config fingerprint, and ``evaluate``
against JAX ``trainer.evaluate`` on the same weights (float64, 1e-10)."""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from marlpde_tpu.envs import registry as jreg
from marlpde_tpu.rl import vracer as jv
from marlpde_tpu.train import trainer as jtr
from marlpde_tpu_torch.envs import registry as treg
from marlpde_tpu_torch.rl import replay_flat
from marlpde_tpu_torch.rl import vracer as tv
from marlpde_tpu_torch.train import trainer as ttr
from marlpde_tpu_torch.utils import checkpoint as ckpt
from test_torch_interop import params64, train_state_from_jax

torch.set_num_threads(1)

ENV_KW = dict(N_dns=64, grid_size=32, num_actions=32, num_agents=4, dt=0.01, T=0.5,
              nu=0.05, episode_length=5, ic_case="turbulence", spectral_reward=True,
              noise=0.1)
B = 2


@pytest.fixture(scope="module")
def tenv():
    return treg.make_env("burger", dtype=torch.float64, device="cpu", **ENV_KW)


def _rl(env, **kw):
    base = dict(width=16, minibatch_mode="experience", mini_batch_size=8,
                experiences_between_updates=0.5, replay_start_experiences=30,
                replay_max_experiences=40, replay_episode_capacity=6)
    return ttr.default_rl_config(env, **{**base, **kw})


def test_real_experience_ledger(tenv):
    """korali's ledger, updates(gen) = min(cap, (live experiences - start) /
    expperu - updates already taken), 0 until the start size, against JAX
    ``trainer.train`` with the same configs.  Every episode runs to full
    length, so the ledger does not depend on the RNG streams (which differ)."""
    rl_kw = dict(width=16, minibatch_mode="experience", mini_batch_size=8,
                 experiences_between_updates=0.5, replay_start_experiences=30,
                 replay_max_experiences=40, replay_episode_capacity=6)
    tc_kw = dict(num_envs=B, max_experiences=80, max_updates_per_gen=15, seed=0,
                 count_real_experiences=True)
    rl_cfg = ttr.default_rl_config(tenv, **rl_kw)
    ts, rep, hist = ttr.train(tenv, rl_cfg, ttr.TrainerConfig(**tc_kw), verbose=False)
    jenv = jreg.make_env("burger", dtype=jnp.float64, **ENV_KW)
    jcfg = jtr.default_rl_config(jenv, **rl_kw)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(rl_cfg)
    jts, jrep, jhist = jtr.train(
        jenv, jcfg, jtr.TrainerConfig(**tc_kw), verbose=False,
        init_ts=params64(jcfg, jv.init_train(jcfg, jax.random.key(0), dtype=jnp.float64)))
    assert hist["mean_ep_len"] == jhist["mean_ep_len"] == [5.0] * 8
    assert hist["experiences"] == jhist["experiences"] == list(range(10, 90, 10))
    # the cap leaves a shortfall that later generations do not make up past it
    assert hist["updates"] == jhist["updates"] == [0, 0, 0, 15, 15, 15, 15, 15]
    assert ts.n_updates == int(jts.n_updates) == 75
    assert rep.cursor == int(jrep.cursor) == 80 and rep.live == 40
    # the generation's experiences over its span
    assert hist["metrics"][1] == {} and all(r > 0.0 for r in hist["env_steps_per_s"])
    assert all(np.isfinite(v) for v in hist["metrics"][-1].values())
    assert 0.0 <= hist["metrics"][-1]["beta"] <= 1.0


def test_fused_matches_unfused_experience_mode(tenv):
    """``build_fused_generation``, driven by hand from the trainer's seed,
    gives ``train``'s generations bitwise."""
    rl_cfg = _rl(tenv)
    tc = ttr.TrainerConfig(num_envs=B, max_experiences=60, max_updates_per_gen=4, seed=7,
                           fused=True)
    ts_a, rep_a, h_a = ttr.train(tenv, rl_cfg, tc, verbose=False)
    generator = torch.Generator().manual_seed(tc.seed)
    ts_b = tv.init_train(rl_cfg, generator, dtype=torch.float64, device="cpu")
    rep_b = ttr.make_replay(tenv, rl_cfg)
    gen_fn = ttr.build_fused_generation(
        tenv, rl_cfg, tc, ttr.updates_per_generation(rl_cfg, tc, tenv.episode_length))
    h_b = dict(updates=[], mean_return=[])
    for g in range(6):
        ts_b, rep_b, _, final, _, stats = gen_fn(ts_b, rep_b, generator, g * B, tenv.consts)
        h_b["updates"].append(stats["n_upd"])
        h_b["mean_return"].append(float(final.cum_reward.mean()))
    assert h_a["updates"] == h_b["updates"] == [0, 0, 4, 4, 4, 4]
    for pa, pb in zip(ts_a.net.parameters(), ts_b.net.parameters()):
        assert torch.equal(pa, pb)
    for f in dataclasses.fields(replay_flat.FlatReplay):
        a, b = getattr(rep_a, f.name), getattr(rep_b, f.name)
        assert (torch.equal(a, b) if torch.is_tensor(a) else a == b), f.name
    assert h_a["mean_return"] == h_b["mean_return"]


def _strip(hist):
    return {k: v for k, v in hist.items() if k not in ("wall_time", "env_steps_per_s")}


def test_resume_is_bitwise_and_testing_writes_best(tenv, tmp_path):
    rl_cfg = _rl(tenv)

    def tc(d, ne):
        return ttr.TrainerConfig(num_envs=B, max_experiences=ne, max_updates_per_gen=6,
                                 seed=3, count_real_experiences=True, testing_frequency=2,
                                 testing_episodes=2, checkpoint_dir=str(d),
                                 checkpoint_every=2, serialize_replay=True,
                                 decay_diagnostics=True)

    ts_a, rep_a, h_a = ttr.train(tenv, rl_cfg, tc(tmp_path / "a", 70), verbose=False)
    ttr.train(tenv, rl_cfg, tc(tmp_path / "b", 40), verbose=False)
    d = str(tmp_path / "b")
    ckpt.check_fingerprint(d, rl_cfg)
    meta = ckpt.load_meta(d)
    assert (meta["gen"], meta["total_exp"], meta["real_in_replay"]) == (4, 40.0, 40)
    ts_b, rep_b, h_b = ttr.train(
        tenv, rl_cfg, tc(d, 70), verbose=False, init_ts=ckpt.load_train_state(d, rl_cfg),
        init_history=ckpt.load_history(d),
        init_replay=ckpt.load_replay(d, ttr.make_replay(tenv, rl_cfg)),
        init_generator_state=meta["generator"],
        init_counters={k: meta[k] for k in ("gen", "total_exp", "episode_base",
                                            "real_in_replay")})
    for pa, pb in zip(ts_a.net.parameters(), ts_b.net.parameters()):
        assert torch.equal(pa, pb)
    for sa, sb in zip(ts_a.opt.state.values(), ts_b.opt.state.values()):
        assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert torch.equal(ts_a.beta, ts_b.beta) and ts_a.n_updates == ts_b.n_updates > 0
    for f in dataclasses.fields(replay_flat.FlatReplay):
        a, b = getattr(rep_a, f.name), getattr(rep_b, f.name)
        assert (torch.equal(a, b) if torch.is_tensor(a) else a == b), f.name
    ha, hb = _strip(h_a), _strip(h_b)
    # the drift probe's references restart with the process (as in JAX);
    # everything else continues
    drift = ("mu_drift_rms", "mu_from_init_rms")
    for h in (ha, hb):
        h["diag"] = [{k: v for k, v in row.items() if k not in drift} for row in h["diag"]]
    assert ha == hb and len(ha["test_return"]) == 3 and ha["gen"] == list(range(1, 8))

    # testing: the best deterministic return's policy and its generation
    with open(tmp_path / "a" / "best" / "best.json") as f:
        best = json.load(f)
    assert best["test_return"] == max(h_a["test_return"])
    assert best["gen"] == 2 * (1 + h_a["test_return"].index(best["test_return"]))
    assert ckpt.load_train_state(str(tmp_path / "a" / "best"), rl_cfg) is not None
    assert set(h_a["diag"][0]) == {"v0_scaled", "return_scaled", "rew_scale", "mu_drift_rms",
                                   "mu_from_init_rms", "mu_rms", "sigma_probe",
                                   "replay_occupancy"}
    assert [r["replay_occupancy"] for r in h_a["diag"]] == [10, 20, 30, 40, 40, 40, 40]
    assert os.path.exists(tmp_path / "a" / "replay.pt")


def test_check_fingerprint_refuses_a_mismatch(tenv, tmp_path, capsys):
    rl_cfg = _rl(tenv)
    ckpt.check_fingerprint(str(tmp_path), rl_cfg)              # no meta: a warning
    assert "no config fingerprint" in capsys.readouterr().out
    ckpt.save_meta(str(tmp_path), torch.Generator(), 1, 10.0, 2, rl_cfg=rl_cfg)
    ckpt.check_fingerprint(str(tmp_path), rl_cfg)
    for change in (dict(mu_param="sigma_relative"), dict(cutoff_dim_norm=True)):
        with pytest.raises(SystemExit, match=next(iter(change))):
            ckpt.check_fingerprint(str(tmp_path), dataclasses.replace(rl_cfg, **change))


def test_evaluate_matches_jax():
    kw = dict(ENV_KW, noise=0.0)
    jenv = jreg.make_env("burger", dtype=jnp.float64, **kw)
    tenv = treg.make_env("burger", dtype=torch.float64, device="cpu", **kw)
    cfg = jtr.default_rl_config(jenv, width=16)
    jts = params64(cfg, jv.init_train(cfg, jax.random.key(4), dtype=jnp.float64))
    rng = np.random.default_rng(1)
    jts = jts.replace(params=jax.tree.map(
        lambda a: a + jnp.asarray(rng.standard_normal(a.shape) * 0.3), jts.params))
    tcfg = ttr.default_rl_config(tenv, width=16)
    want = jtr.evaluate(jenv, cfg, jts, jax.random.key(0), 3)
    got = ttr.evaluate(tenv, tcfg, train_state_from_jax(tcfg, jts), None, 3)
    assert got.shape == np.asarray(want).shape == (3, 4)
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-10)


def test_trace_writes_a_chrome_trace(tmp_path):
    """``trace`` writes the profiler's Chrome trace with the program's spans
    merged in as a host track, on the trace's own clock: the span encloses
    the operation run inside it."""
    import json

    from marlpde_tpu_torch.utils import profiling as tprof

    with tprof.trace(str(tmp_path)):
        with tprof.span("sum"):
            torch.ones(8).sum()
    with open(tmp_path / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    span = next(e for e in events if e.get("cat") == "program_span" and e["name"] == "sum")
    op = next(e for e in events if e.get("name") == "aten::sum")
    assert span["ts"] <= op["ts"] and op["ts"] + op["dur"] <= span["ts"] + span["dur"]
