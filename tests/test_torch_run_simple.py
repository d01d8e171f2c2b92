"""The diffusion, advection and Laplace workloads, --save-episodes, --bf16
and rlview through the port's CLI (marlpde_tpu_torch/run.py) against the JAX
CLI, on the CPU at a tiny size.

``make_workload`` must build the JAX configs exactly.  Training runs are
checked for the JAX summary keys and result files (their returns depend on
draws, whose streams differ).  The --test stage runs both CLIs on the same
weights (tests/test_torch_run_test.py's checkpoints): advection (noise 0) and
Laplace (the zero force) draw nothing, so their returns and curves agree to
float32 (both CLIs build float32 envs; 1e-3 relative); diffusion's offset
falls back to noise 0.5, so only its keys and files are compared.  The
episode dumps carry JAX's keys, shapes and dtypes.  Under --bf16 the JAX CLI
on the CPU computes in float32 (XLA:CPU ignores the matmul precision), and so
does the port on the CPU, whose library matmuls run at the lowered precision
only on the card."""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from marlpde_tpu import run as jrun
from marlpde_tpu.analysis import rlview as jrlview
from marlpde_tpu_torch import device as tdevice
from marlpde_tpu_torch import run as trun
from marlpde_tpu_torch.analysis import plotting as tplot
from marlpde_tpu_torch.analysis import rlview as trlview
from test_torch_analysis import _skip_drawing
from test_torch_run_test import _assert_close, _both, _checkpoints, _files, _json_lines

torch.set_num_threads(1)

TINY = "--episodelength 10 --numenvs 2 --width 8 --rstart 10 --run 5".split()
WORKLOADS = {
    "diffusion-simple": ["diffusion-simple", "--N", "16"] + TINY,
    "diffusion-error": ["diffusion-error", "--N", "16", "--nagents", "2"] + TINY,
    "diffusion-stencil3": ["diffusion-stencil3", "--N", "16", "--ic", "gaussian"] + TINY,
    "advection-simple": ["advection-simple", "--N", "8"] + TINY,
    "laplace": ["laplace", "--nagents", "4"] + TINY,
}
# the test stages that draw nothing: their values agree with JAX's
DETERMINISTIC = ("advection-simple", "laplace")


@pytest.fixture(autouse=True)
def fast_figures(monkeypatch):
    _skip_drawing(monkeypatch)


@pytest.fixture
def dirs(tmp_path):
    jdir, tdir = tmp_path / "j", tmp_path / "t"
    jdir.mkdir()
    tdir.mkdir()
    return jdir, tdir


@pytest.fixture
def jax_precision():
    """The JAX CLI's --bf16 sets a process-wide flag; put it back after."""
    yield
    jax.config.update("jax_default_matmul_precision", None)


def _train_both(argv, jdir, tdir, monkeypatch, capsys):
    """Training through both CLIs; returns (the port's summary line, JAX's)."""
    monkeypatch.chdir(jdir)
    jrun.main(argv)
    want = _json_lines(capsys.readouterr().out)
    monkeypatch.chdir(tdir)
    trun.main(argv, device="cpu")
    got = _json_lines(capsys.readouterr().out)
    assert len(want) == len(got) == 1
    return got[0], want[0]


@pytest.mark.parametrize("argv", [
    ["diffusion-simple"], ["diffusion-simple", "--noise", "0.2", "--nagents", "4"],
    ["diffusion-error", "--gamma", "0.9"], ["diffusion-stencil3", "--save-episodes"],
    ["advection-simple", "--noise", "0.1"], ["laplace"],
    ["laplace", "--episodelength", "40", "--force", "fourier", "--save-episodes"]],
    ids=lambda a: " ".join(a))
def test_make_workload_matches_jax(argv):
    """Env config, learner config and trainer config of the run scripts: the
    gamma defaults (1.0 for diffusion-stencil3, else 0.95), diffusion's offset
    noise falling back to 0.5 at --noise 0, Laplace's 100 macro-steps, the
    scale-robust learner of the diffusion family, the episode dump's folder."""
    jenv, jrl, jtc = jrun.make_workload(jrun.build_parser().parse_args(argv))
    tenv, trl, ttc = trun.make_workload(trun.build_parser().parse_args(argv), device="cpu")
    assert dataclasses.asdict(tenv.cfg) == dataclasses.asdict(jenv.cfg)
    assert dataclasses.asdict(trl) == dataclasses.asdict(jrl)
    assert dataclasses.asdict(ttc) == dataclasses.asdict(jtc)
    for f in ("name", "obs_dim", "num_agents", "act_dim", "episode_length", "action_low",
              "action_high"):
        assert getattr(tenv, f) == getattr(jenv, f), f
    assert tenv.device == torch.device("cpu") and tenv.dtype == torch.float32
    if argv[0].startswith("diffusion") and "--noise" not in argv:
        assert tenv.cfg.noise == 0.5


@pytest.mark.parametrize("name", list(WORKLOADS))
def test_training_and_test_stage_match_jax(name, dirs, monkeypatch, capsys):
    """A short training run through each CLI (the JAX summary keys and
    result files), then --test on the same weights in both."""
    jdir, tdir = dirs
    argv = WORKLOADS[name]
    got, want = _train_both(argv + ["--NE", "40"], jdir, tdir, monkeypatch, capsys)
    assert list(got) == list(want) == ["workload", "final_mean_return", "generations"]
    res = f"_result_{name}_5"
    assert _files(tdir / res) == _files(jdir / res) == ["history.json", "meta.npz"]
    with open(tdir / res / "history.json") as f:
        hist = json.load(f)
    assert hist["gen"][-1] == got["generations"] and np.isfinite(hist["mean_return"]).all()
    # each generation's live steps: whole episodes for Laplace, the early stop
    # elsewhere
    lens = np.asarray(hist["mean_ep_len"])
    assert ((lens == 10) if name == "laplace" else (lens >= 1) & (lens <= 10)).all()

    _checkpoints(argv, jdir, tdir, monkeypatch)
    got, want = _both(argv + ["--test", "--testepisodes", "2"], jdir, tdir, monkeypatch,
                      capsys)
    assert list(got) == ["workload", "test_mean_return", "test_returns"]
    assert len(got["test_returns"]) == 2 and np.isfinite(got["test_returns"]).all()
    files = _files(tdir / res)
    assert files == _files(jdir / res)
    if name in DETERMINISTIC:
        _assert_close(got, want)
    if name == "laplace":
        assert {"evolution.png", "actions.png", "hessian.png", "actiondist.png",
                "field.png"} <= set(files)
        return
    n = 8 if name.startswith("advection") else 16
    assert {"evolution.png", "actionfield.png", "actiondist.png", "field.png", "compare.png",
            "compare_evolution.png", f"error_rl_{n}.json"} <= set(files)
    with open(tdir / res / f"error_rl_{n}.json") as f, open(jdir / res / f"error_rl_{n}.json") as g:
        tcurves, jcurves = json.load(f), json.load(g)
    assert list(tcurves) == list(jcurves) == ["t", "mse", "linf", "mass", "survived_steps",
                                              "episode_length"]
    assert len(tcurves["mse"]) == tcurves["survived_steps"] <= tcurves["episode_length"] == 10
    if name in DETERMINISTIC:
        assert tcurves["survived_steps"] == jcurves["survived_steps"]
        for k in ("t", "mse", "linf", "mass"):
            np.testing.assert_allclose(tcurves[k], jcurves[k], rtol=1e-3, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("argv", [
    "burger --specreward --dforce --ic turbulence --NDNS 32 --N 8 --NA 8 --dt 0.01 "
    "--T 0.05 --episodelength 5 --width 8 --ndns 2 --numenvs 2 --NE 20 --rstart 10 --run 3",
    "diffusion-simple --N 16 --episodelength 10 --numenvs 3 --width 8 --NE 30 --rstart 10 "
    "--run 3"], ids=lambda a: a.split()[0])
def test_save_episodes_dumps_what_jax_dumps(argv, dirs, monkeypatch, capsys):
    """The per-generation npz of both CLIs: the same files, keys, shapes and
    dtypes (fields, and for the spectral Burgers env ektt and the pool rows
    ``indeces``); plot_episode_dumps reads the port's and JAX's dumps."""
    jdir, tdir = dirs
    argv = argv.split() + ["--save-episodes"]
    _train_both(argv, jdir, tdir, monkeypatch, capsys)
    eps = f"_result_{argv[0]}_3/episodes"
    tfiles = sorted(p.name for p in (tdir / eps).iterdir())
    assert tfiles == sorted(p.name for p in (jdir / eps).iterdir())
    for fname in tfiles:
        with np.load(tdir / eps / fname) as t, np.load(jdir / eps / fname) as j:
            assert sorted(t.files) == sorted(j.files), fname
            for k in j.files:
                if argv[0] == "burger" or k not in ("rewards", "obs", "actions", "fields",
                                                   "cumreward"):
                    assert t[k].shape == j[k].shape, (fname, k)
                else:          # episodes that end early: the same layout
                    assert t[k].shape[1:] == j[k].shape[1:], (fname, k)
                assert t[k].dtype == j[k].dtype, (fname, k)
    with np.load(tdir / eps / tfiles[0]) as t:
        want = {"actions", "rewards", "obs", "cumreward", "fields"}
        want |= {"ektt", "indeces"} if argv[0] == "burger" else set()
        assert set(t.files) == want
        n, T = t["actions"].shape[:2]
        assert t["fields"].shape[:2] == (n, T) and np.isfinite(t["fields"]).all()
    monkeypatch.chdir(tdir)
    for d in (tdir, jdir):
        fq, fk = tplot.plot_episode_dumps(str(d / eps / "*.npz"), str(tdir / d.name))
        assert fq.endswith("_quantiles.png") and fk.endswith("_action_kde.png")


def test_bf16_is_set_for_the_run_and_restored(dirs, monkeypatch, capsys, jax_precision):
    """--bf16 in training and in --test: the lowered precision holds through
    the run (every resolve_device of it included) and is gone after; on the
    CPU the results equal the JAX CLI's --bf16 results to float32."""
    jdir, tdir = dirs
    argv = WORKLOADS["laplace"] + ["--NE", "40", "--bf16"]
    seen = []

    def probe(gen, ts, rep, hist):
        tdevice.resolve_device("cpu")
        seen.append((tdevice.reduced(), torch.backends.cuda.matmul.allow_tf32,
                     torch.backends.cudnn.allow_tf32))

    monkeypatch.chdir(tdir)
    trun.main(argv, callback=probe, device="cpu")
    assert seen and all(s == (True, True, True) for s in seen)
    assert not tdevice.reduced() and not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32
    assert torch.get_float32_matmul_precision() == "highest"
    capsys.readouterr()
    _checkpoints(WORKLOADS["laplace"], jdir, tdir, monkeypatch)
    got, want = _both(WORKLOADS["laplace"] + ["--test", "--testepisodes", "2", "--bf16"], jdir,
                      tdir, monkeypatch, capsys)
    _assert_close(got, want)
    assert not tdevice.reduced()
    got_plain, _ = _both(WORKLOADS["laplace"] + ["--test", "--testepisodes", "2"], jdir, tdir,
                         monkeypatch, capsys)
    assert got_plain == got


def test_rlview_prints_jax_s_stats_line(dirs, monkeypatch, capsys):
    """rlview over a port run's history.json: JAX's stats line; --out writes
    the curves (two folders: one figure)."""
    _, tdir = dirs
    monkeypatch.chdir(tdir)
    argv = WORKLOADS["laplace"] + ["--NE", "60"]
    trun.main(argv, device="cpu")
    trun.main(argv[:-4] + ["--run", "6", "--NE", "40"], device="cpu")
    capsys.readouterr()
    dirs_ = ["_result_laplace_5", "_result_laplace_6"]
    trlview.main(["--dir"] + dirs_)
    got = _json_lines(capsys.readouterr().out)
    jrlview.main(["--dir"] + dirs_)
    assert got == _json_lines(capsys.readouterr().out)
    assert [g["generations"] for g in got] == [3, 2]
    for out, d in (("one.png", dirs_[:1]), ("two.png", dirs_)):
        trlview.main(["--dir"] + d + ["--out", out])
        assert (tdir / out).exists()
    with pytest.raises(SystemExit):
        trlview.main(["--dir", "no-such-dir"])
