"""The port's --test stage and its KS workload through the CLI
(marlpde_tpu_torch/run.py) against the JAX CLI.

Both CLIs test the same weights: a JAX train state is saved as the JAX
checkpoint and, carried across by ``networks.params_from_flax``, as the port's.
The summaries must carry the JAX keys in the JAX order and the result
directories the same files.  The Burgers values agree to float32 (both CLIs
build float32 envs; 1e-3 relative).  The KS values are only checked finite:
a CLI episode spans 500 time units, over which float32 KS trajectories of two
implementations decorrelate (the float64 parity of the KS sweep is in
tests/test_torch_analysis.py).  Then a tiny ks --fused training run with
--resume, ``make_workload`` for the run-926 flags, and the refusals."""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from marlpde_tpu import run as jrun
from marlpde_tpu.rl import vracer as jv
from marlpde_tpu.utils import checkpoint as jckpt
from marlpde_tpu_torch import run as trun
from marlpde_tpu_torch.utils import checkpoint as tckpt
from test_torch_analysis import _skip_drawing
from test_torch_interop import train_state_from_jax

torch.set_num_threads(1)

BURGER = ("burger --specreward --dforce --ic turbulence --NDNS 32 --N 8 --NA 8 --dt 0.01 "
          "--T 0.05 --episodelength 5 --width 8 --ndns 3 --run 4").split()
KS = ("ks --NDNS 64 --N 16 --NA 16 --ndns 2 --episodelength 5 --width 8 --sigma-max 5 "
      "--iex 0.01 --run 6").split()
RUN_926 = ("ks --N 16 --NA 16 --ndns 2 --sigma-max 5 --iex 0.01 --NDNS 64 --numenvs 16 "
           "--maxupd 1000 --fused --testfreq 10 --testepisodes 16").split()


@pytest.fixture(autouse=True)
def fast_figures(monkeypatch):
    """Both CLIs save their figures as empty files without drawing them
    (tests/test_torch_analysis.py draws the port's)."""
    _skip_drawing(monkeypatch)


def _json_lines(out):
    return [json.loads(ln) for ln in out.splitlines() if ln.startswith("{")]


def _checkpoints(argv, jdir, tdir, monkeypatch):
    """The same perturbed weights as the JAX CLI's checkpoint in ``jdir`` and
    as the port CLI's in ``tdir``, each also under best/."""
    args = jrun.build_parser().parse_args(argv)
    res = f"_result_{args.workload}_{args.run}"
    monkeypatch.chdir(jdir)
    _, jcfg, _ = jrun.make_workload(args)
    jts = jv.init_train(jcfg, jax.random.key(1))
    rng = np.random.default_rng(0)
    jts = jts.replace(params=jax.tree.map(
        lambda a: a + jnp.asarray(rng.standard_normal(a.shape) * 0.3, a.dtype), jts.params))
    for d in (res, os.path.join(res, "best")):
        jckpt.save_train_state(d, jts)
    jckpt.save_meta(res, jax.random.key(0), 0, 0, 0, rl_cfg=jcfg)
    monkeypatch.chdir(tdir)
    _, tcfg, _ = trun.make_workload(trun.build_parser().parse_args(argv), device="cpu")
    ts = train_state_from_jax(tcfg, jts)
    for d in (res, os.path.join(res, "best")):
        tckpt.save_train_state(d, ts)
    tckpt.save_meta(res, torch.Generator(), 0, 0, 0, rl_cfg=tcfg)
    return res


def _both(argv, jdir, tdir, monkeypatch, capsys):
    monkeypatch.chdir(jdir)
    jrun.main(argv)
    want = _json_lines(capsys.readouterr().out)
    monkeypatch.chdir(tdir)
    got = trun.main(argv, device="cpu")
    lines = _json_lines(capsys.readouterr().out)
    assert len(want) == 1 and lines == [got]
    assert list(got) == list(want[0])
    return got, want[0]


def _files(d):
    return sorted(p.name for p in d.iterdir() if p.suffix != ".pkl" and p.suffix != ".pt")


def _assert_close(got, want):
    for k, w in want.items():
        if isinstance(w, str):
            assert got[k] == w
        else:
            np.testing.assert_allclose(got[k], w, rtol=1e-3, atol=1e-7, err_msg=k)


def test_burger_cli_test_ids_nus_and_best_match_jax(tmp_path, monkeypatch, capsys):
    jdir, tdir = tmp_path / "j", tmp_path / "t"
    jdir.mkdir()
    tdir.mkdir()
    res = _checkpoints(BURGER, jdir, tdir, monkeypatch)
    got, want = _both(BURGER + ["--test", "--ids", "0,2", "--nus", "0.02,0.05",
                                "--testepisodes", "2"], jdir, tdir, monkeypatch, capsys)
    assert got["nus"] == [0.02, 0.05] and len(got["test_returns"]) == 2
    _assert_close(got, want)
    files = _files(tdir / res)
    assert files == _files(jdir / res)
    assert {"relError_4_nu0.05.npy", "sgsTerms_4_nu0.02.npy", "dnsSgsTerms_4_nu0.02.npy",
            "test_nu0.05.png", "test_nu0.02_action_closeup.png"} <= set(files)
    rel = np.load(tdir / res / "relError_4_nu0.02.npy")
    assert rel.shape == (2, 5)
    np.testing.assert_allclose(rel, np.load(jdir / res / "relError_4_nu0.02.npy"), rtol=1e-3,
                               atol=1e-7)
    got, want = _both(BURGER + ["--test", "--best", "--testepisodes", "3"], jdir, tdir,
                      monkeypatch, capsys)
    assert got["nus"] == [] and len(got["test_returns"]) == 3
    _assert_close(got, want)
    assert _files(tdir / res) == _files(jdir / res)
    assert np.load(tdir / res / "dnsSgsTerms_4.npy").shape == (3, 6, 8)


def test_ks_cli_test_and_best_match_jax_keys_and_files(tmp_path, monkeypatch, capsys):
    jdir, tdir = tmp_path / "j", tmp_path / "t"
    jdir.mkdir()
    tdir.mkdir()
    res = _checkpoints(KS, jdir, tdir, monkeypatch)
    for extra in (["--testepisodes", "2"], ["--best", "--ids", "1", "--testepisodes", "1"]):
        got, want = _both(KS + ["--test"] + extra, jdir, tdir, monkeypatch, capsys)
        for k in ("sample_ids", "workload"):
            assert got[k] == want[k]
        for k in ("test_returns", "baseline_per_id", "controlled_per_id"):
            assert len(got[k]) == len(want[k]) and np.isfinite(got[k]).all(), k
        assert _files(tdir / res) == _files(jdir / res)
    assert {"sgs_6_s0.npz", "dnsSgs_6_s1.npz", "ks_6_s1_action.png", "sgs_6.npz",
            "ks_6.png"} <= set(_files(tdir / res))
    with np.load(tdir / res / "sgs_6_s0.npz") as d, np.load(jdir / res / "sgs_6_s0.npz") as j:
        assert d.files == j.files and d["uu"].shape == j["uu"].shape == (5, 16)
    with np.load(tdir / res / "dnsSgs_6.npz") as d:
        assert d["sgs"].shape == (2001, 64) and np.isfinite(d["sgs"]).all()


def test_ks_fused_training_resumes_exactly(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    argv = KS + ["--fused", "--numenvs", "2", "--rstart", "10", "--rmax", "100", "--mbsize",
                 "8", "--testfreq", "1", "--serialize-replay"]
    ts, rep, hist = trun.main(argv + ["--NE", "20"], device="cpu")
    assert hist["updates"] == [20, 20] and len(hist["test_return"]) == 2
    ts2, rep2, hist2 = trun.main(argv + ["--NE", "30", "--resume"], device="cpu")
    assert "[run] continuing from previous run" in capsys.readouterr().out
    assert hist2["gen"] == [1, 2, 3] and ts2.n_updates == 60
    ts3, _, hist3 = trun.main(argv[:-1] + ["--run", "7", "--serialize-replay", "--NE", "30"],
                              device="cpu")
    assert hist3["mean_return"] == hist2["mean_return"]
    assert np.isfinite(hist3["mean_return"]).all() and hist3["blowups"] == [0, 0, 0]
    for a, b in zip(ts2.net.parameters(), ts3.net.parameters()):
        assert torch.equal(a, b)
    assert ts3.net.mu_param == "sigma_relative"


@pytest.mark.parametrize("extra", [[], ["--muparam", "absolute", "--no-dimnorm"]],
                         ids=["run-926", "korali-exact"])
def test_make_workload_ks_matches_jax(extra):
    argv = RUN_926 + extra
    jenv, jrl, jtc = jrun.make_workload(jrun.build_parser().parse_args(argv))
    tenv, trl, ttc = trun.make_workload(trun.build_parser().parse_args(argv), device="cpu")
    want_cfg = dataclasses.asdict(jenv.cfg)
    assert want_cfg.pop("fft_impl") == "auto"
    assert dataclasses.asdict(tenv.cfg) == want_cfg
    assert dataclasses.asdict(trl) == dataclasses.asdict(jrl)
    assert dataclasses.asdict(ttc) == dataclasses.asdict(jtc)
    assert (trl.mu_param, trl.cutoff_dim_norm) == (("absolute", False) if extra
                                                   else ("sigma_relative", True))
    for f in ("name", "obs_dim", "num_agents", "act_dim", "episode_length", "action_low",
              "action_high"):
        assert getattr(tenv, f) == getattr(jenv, f), f
    assert tenv.cfg.N_dns == 64 and tenv.consts.uu.shape == (2, 2001, 64)
    np.testing.assert_allclose(tenv.consts.ek_ktt.numpy(), np.asarray(jenv.consts.ek_ktt),
                               rtol=1e-6)


@pytest.mark.parametrize("flag", [["--mesh"], ["--learner", "apg"], ["--save-episodes"]],
                         ids=lambda f: f[-1])
def test_training_only_flags_are_ignored_by_the_test_stage_as_in_jax(flag, tmp_path,
                                                                     monkeypatch, capsys):
    """The JAX CLI skips its mesh and apg branches under --test, and its test
    stage never reads --save-episodes' directory (marlpde_tpu/run.py:388-390,
    458,498): the port's summary equals the JAX one.  --bf16 is taken by the
    test stage too.  Training with --mesh (the JAX CLI on its 8 devices, the
    port at a world of 1) and with --learner apg writes a checkpoint that
    --test reads, as the JAX CLI does (the same keys and generation or
    iteration count: the weights are drawn by each package's own
    generator); --save-episodes has no more to check here."""
    jdir, tdir = tmp_path / "j", tmp_path / "t"
    jdir.mkdir()
    tdir.mkdir()
    res = _checkpoints(BURGER, jdir, tdir, monkeypatch)
    got, want = _both(BURGER + ["--test", "--testepisodes", "2"] + flag, jdir, tdir,
                      monkeypatch, capsys)
    assert got["nus"] == [] and len(got["test_returns"]) == 2
    _assert_close(got, want)
    assert _files(tdir / res) == _files(jdir / res)
    got_bf16, _ = _both(BURGER + ["--test", "--testepisodes", "2", "--bf16"] + flag, jdir,
                        tdir, monkeypatch, capsys)
    assert got_bf16 == got
    if flag[0] == "--save-episodes":
        return
    # 8 episodes a generation divide the JAX CLI's 8 devices; 2 generations
    train = BURGER + flag + (["--NE", "80", "--numenvs", "8"] if flag[0] == "--mesh"
                             else ["--NE", "20", "--numenvs", "2"]) + ["--run", "5"]
    monkeypatch.chdir(jdir)
    jrun.main(train)
    want = _json_lines(capsys.readouterr().out)
    monkeypatch.chdir(tdir)
    ts, rep, hist = trun.main(train, device="cpu")
    got = _json_lines(capsys.readouterr().out)
    assert len(want) == len(got) == 1 and list(got[0]) == list(want[0])
    if flag[0] == "--mesh":
        assert got[0] == {"workload": "burger", "mesh_devices": 1, "generations": 2,
                          "final_mean_return": hist["mean_return"][-1]}
        assert want[0]["generations"] == 2 and rep.obs.shape[0] > 0
    else:
        assert rep is None and got[0] == {"workload": "burger", "learner": "apg",
                                          "iterations": 2,
                                          "final_mean_return": hist["mean_return"][-1]}
        assert want[0]["iterations"] == 2
    assert np.isfinite(got[0]["final_mean_return"])
    got, want = _both(BURGER + ["--run", "5", "--test", "--testepisodes", "2"], jdir, tdir,
                      monkeypatch, capsys)
    assert len(got["test_returns"]) == 2 and np.isfinite(got["test_mean_return"])
    assert _files(tdir / "_result_burger_5") == _files(jdir / "_result_burger_5")


@pytest.mark.parametrize("argv", [["diffusion-simple", "--test"], ["laplace", "--test"],
                                  ["advection-simple", "--test"]], ids=lambda a: a[0])
def test_test_stage_of_unported_workloads_raises(argv, tmp_path, monkeypatch):
    """These workloads' test stages are ported (tests/test_torch_run_simple.py
    runs them); without a checkpoint they exit as every test stage does, and
    cmaes-burger, now ported, runs CMA-ES under --test too, as the JAX CLI
    does (tests/test_torch_cmaes.py holds it against the JAX CLI)."""
    monkeypatch.chdir(tmp_path)
    with pytest.raises(SystemExit, match="no checkpoint"):
        trun.main(argv, device="cpu")
    out = trun.main("cmaes-burger --test --NDNS 32 --N 8 --dt 0.01 --T 0.05 --episodelength 5 "
                    "--numgen 1".split(), device="cpu")
    assert out["workload"] == "cmaes-burger" and out["generations"] == 1


def test_test_without_a_checkpoint_exits(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    with pytest.raises(SystemExit, match="no checkpoint"):
        trun.main(BURGER + ["--test"], device="cpu")
