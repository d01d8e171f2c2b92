"""The port's CLI on the rest of the Burgers family against the JAX CLI:
``make_workload`` for burger-fd, burger-jax, coupled-burger and burger with
--forcing, --ssm and --dsm, field by field; then a tiny CPU training run and
--test of burger-fd, coupled-burger and burger-jax, whose JSON lines must
carry the JAX CLI's keys in its order, with finite values.  The values of two
trained runs are not compared: the action noise comes from different
generators.  Last, burger-fd's blowups without --dforce, in both packages."""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from marlpde_tpu import run as jrun
from marlpde_tpu.envs import rollout as jroll
from marlpde_tpu.rl import vracer as jv
from marlpde_tpu_torch import run as trun
from marlpde_tpu_torch.envs import burger_env as tbe
from marlpde_tpu_torch.envs import rollout as troll
from test_torch_analysis import _skip_drawing
from test_torch_interop import train_state_from_jax

torch.set_num_threads(1)

SMALL = "--NDNS 64 --N 16 --NA 16 --dt 0.01 --T 0.1 --episodelength 5".split()


@pytest.fixture(autouse=True)
def fast_figures(monkeypatch):
    _skip_drawing(monkeypatch)


@pytest.mark.parametrize("argv", [
    ["burger-fd", "--T", "0.1"],
    ["burger-jax", "--T", "0.1", "--version", "2"],
    ["coupled-burger", "--T", "0.1"],
    ["burger", "--T", "0.1", "--forcing", "--stepper", "2", "--ic", "forced"],
    ["burger", "--T", "0.1", "--ssm", "--noise", "0.1"],
    ["burger-marl", "--T", "0.1", "--dsm", "--specreward", "--save-episodes"]],
    ids=lambda a: " ".join(a[:1] + a[3:4]))
def test_make_workload_matches_jax(argv):
    jenv, jrl, jtc = jrun.make_workload(jrun.build_parser().parse_args(argv))
    tenv, trl, ttc = trun.make_workload(trun.build_parser().parse_args(argv), device="cpu")
    assert dataclasses.asdict(tenv.cfg) == dataclasses.asdict(jenv.cfg)
    assert dataclasses.asdict(trl) == dataclasses.asdict(jrl)
    # the episode dump's folder included
    assert dataclasses.asdict(ttc) == dataclasses.asdict(jtc)
    assert (jtc.save_episodes_dir is not None) == ("--save-episodes" in argv)
    for f in ("name", "obs_dim", "num_agents", "act_dim", "episode_length", "action_low",
              "action_high"):
        assert getattr(tenv, f) == getattr(jenv, f), f
    assert not tenv.whole_batch and tenv.step.func is tbe.step
    for f in dataclasses.fields(tbe.DnsPool):
        want, got = getattr(jenv.consts, f.name), getattr(tenv.consts, f.name)
        assert (got is None) == (want is None), f.name
        if want is not None:
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7,
                                       err_msg=f.name)


def test_burger_fd_defaults_are_the_run_script_s():
    """run-vracer-burger-fd.py: N = NA = 256, turbulence IC, explicit-Euler
    FD, the MSE reward, width 32, iex 0.005.  The CLI builds it through the
    'burger' maker, as the JAX CLI does, so without the 'burger-fd' preset's
    state bound of 1e6."""
    tenv, trl, _ = trun.make_workload(trun.build_parser().parse_args(
        ["burger-fd", "--T", "0.01"]), device="cpu")
    cfg = tenv.cfg
    assert (cfg.grid_size, cfg.num_actions, cfg.ic_case, cfg.scheme) == (256, 256, "turbulence",
                                                                         "fd")
    assert not cfg.spectral_reward and np.isinf(cfg.state_bound) and tenv.name == "burger-fd"
    assert (trl.width, trl.init_noise, tenv.obs_dim, tenv.act_dim) == (32, 0.005, 256, 256)
    assert tenv.consts.truth_les.shape == (1, 11, 256)


def _json_lines(out):
    return [json.loads(ln) for ln in out.splitlines() if ln.startswith("{")]


@pytest.mark.parametrize("workload", ["burger-fd", "coupled-burger", "burger-jax"])
def test_tiny_train_then_test_has_the_jax_summary(workload, tmp_path, monkeypatch, capsys):
    argv = [workload] + SMALL + "--numenvs 2 --mbsize 8 --rstart 10 --width 8 --run 5".split()
    if workload == "coupled-burger":
        argv += ["--NA", "1"]
    summaries = {}
    for name, cli in (("jax", jrun), ("port", trun)):
        d = tmp_path / name
        d.mkdir()
        monkeypatch.chdir(d)
        kw = dict(device="cpu") if cli is trun else {}
        cli.main(argv + ["--NE", "20"], **kw)
        train = _json_lines(capsys.readouterr().out)
        assert len(train) == 1 and train[0]["generations"] == 2
        assert np.isfinite(train[0]["final_mean_return"])
        cli.main(argv + ["--test", "--testepisodes", "2"], **kw)
        test = _json_lines(capsys.readouterr().out)
        assert len(test) == 1
        summaries[name] = test[0]
    got, want = summaries["port"], summaries["jax"]
    assert list(got) == list(want)
    assert got["workload"] == workload and len(got["test_returns"]) == 2
    for k, v in got.items():
        if k not in ("workload", "nus"):
            assert np.isfinite(v).all(), k
    if workload != "burger-jax":
        res = f"_result_{workload}_5"
        assert (sorted(p.name for p in (tmp_path / "port" / res).glob("*.npy"))
                == sorted(p.name for p in (tmp_path / "jax" / res).glob("*.npy")))


@pytest.mark.parametrize("dforce", [False, True], ids=["d2udx2", "dforce"])
def test_burger_fd_blows_up_without_dforce_as_in_jax(dforce):
    """With the CLI's default (the actions scale d2u/dx2) an untrained
    policy's burger-fd episodes blow up in their first macro-step, in both
    packages; with --dforce they run to the end.  Same weights, deterministic
    actions, run-vracer-burger-fd.py's widths cut to 5 macro-steps."""
    argv = "burger-fd --T 0.05 --episodelength 5".split() + (["--dforce"] if dforce else [])
    jenv, jrl, _ = jrun.make_workload(jrun.build_parser().parse_args(argv))
    tenv, trl, _ = trun.make_workload(trun.build_parser().parse_args(argv), device="cpu")
    jts = jv.init_train(jrl, jax.random.key(0))
    ts = train_state_from_jax(trl, jts)
    jtraj, _ = jroll.collect_episodes(jenv, jrl, jts, jax.random.key(1), 2, deterministic=True)
    ttraj, _ = troll.collect_episodes(tenv, trl, ts, None, 2, deterministic=True)
    assert np.asarray(jtraj["truncated"]).tolist() == ttraj["truncated"].tolist() == [
        not dforce] * 2
    want_len = 1.0 if not dforce else 5.0
    assert np.asarray(jtraj["mask"]).sum(1).tolist() == ttraj["mask"].sum(1).tolist() == [
        want_len] * 2
    assert np.abs(np.asarray(jtraj["actions"])).max() > 0.3
