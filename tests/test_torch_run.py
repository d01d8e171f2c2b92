"""The port's CLI (marlpde_tpu_torch/run.py) against the JAX CLI: the parser's
flags, ``make_workload`` field by field, a tiny training run through ``main``
with resume, and the presets and flags ported after the first slices."""

import argparse
import dataclasses
import json

import numpy as np
import pytest
import torch

from marlpde_tpu import run as jrun
from marlpde_tpu_torch import run as trun

torch.set_num_threads(1)

RUN_918 = ("burger-marl --nagents 32 --specreward --dforce --ic turbulence --width 128 "
           "--iex 0.1 --NE 1000000 --numenvs 10 --mbsize 8 --maxupd 2500 --testfreq 10 "
           "--testepisodes 8 --rscale cumulative --trust forward --diag").split()
BARE = "burger-marl --specreward --dforce --ic turbulence".split()
TINY = ("burger-marl --nagents 4 --specreward --dforce --ic turbulence --NDNS 64 --dt 0.01 "
        "--T 0.1 --episodelength 5 --numenvs 2 --mbsize 8 --rstart 10 --testfreq 2 --diag "
        "--run 999 --serialize-replay").split()


# the flags that cut the ported surfaces of test_unported_presets_and_flags_raise
# to a tiny run: burger-marl with 2 agents for 2 APG iterations of 2 episodes,
# the same for 2 --mesh generations at world 1, and 2 CMA-ES generations
TINY_RUNS = {
    "apg": ("--nagents 2 --NDNS 32 --N 8 --NA 8 --dt 0.01 --T 0.05 --episodelength 5 "
            "--numenvs 2 --NE 20 --width 8").split(),
    "mesh": ("--nagents 2 --NDNS 32 --N 8 --NA 8 --dt 0.01 --T 0.05 --episodelength 5 "
             "--numenvs 2 --NE 20 --width 8").split(),
    "cmaes-burger": "--NDNS 32 --N 8 --dt 0.01 --T 0.05 --episodelength 5 --numgen 2".split(),
}


def _actions(parser):
    return {a.dest: a for a in parser._actions if a.dest != "help"}


def test_parser_flags_defaults_and_choices_match_jax():
    want, got = _actions(jrun.build_parser()), _actions(trun.build_parser())
    assert set(got) == set(want)
    for dest, a in want.items():
        b = got[dest]
        for field in ("option_strings", "default", "choices", "type", "nargs", "const"):
            assert getattr(b, field) == getattr(a, field), (dest, field)
        assert type(b) is type(a), dest
    assert trun.RL_DEFAULTS == jrun.RL_DEFAULTS
    for argv in (RUN_918, BARE, "burger --episodelength 100 --rmax 7".split()):
        assert (trun.resolve_rl_defaults(trun.build_parser().parse_args(argv))
                == jrun.resolve_rl_defaults(jrun.build_parser().parse_args(argv)))


@pytest.mark.parametrize("argv", [RUN_918, BARE], ids=["run-918", "bare"])
def test_make_workload_matches_jax(argv):
    jenv, jrl, jtc = jrun.make_workload(jrun.build_parser().parse_args(argv))
    tenv, trl, ttc = trun.make_workload(trun.build_parser().parse_args(argv), device="cpu")
    assert dataclasses.asdict(tenv.cfg) == dataclasses.asdict(jenv.cfg)
    assert dataclasses.asdict(trl) == dataclasses.asdict(jrl)
    assert dataclasses.asdict(ttc) == dataclasses.asdict(jtc)
    for f in ("name", "obs_dim", "num_agents", "act_dim", "episode_length", "action_low",
              "action_high"):
        assert getattr(tenv, f) == getattr(jenv, f), f
    assert tenv.whole_batch and jenv.batch_step is not None
    np.testing.assert_allclose(tenv.consts.ek_ktt.numpy(), np.asarray(jenv.consts.ek_ktt),
                               rtol=1e-6)


def _json_lines(out):
    return [json.loads(ln) for ln in out.splitlines() if ln.startswith("{")]


def test_tiny_main_trains_resumes_and_prints_one_json_line(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    ts, rep, hist = trun.main(TINY + ["--NE", "40"], device="cpu")
    out = capsys.readouterr().out
    assert _json_lines(out) == [{"workload": "burger-marl",
                                 "final_mean_return": hist["mean_return"][-1],
                                 "generations": 4}]
    assert out.count("[trainer] gen ") == 4
    # rstart 10, expperu 0.5: the ledger runs 0 then 20 per 10 new experiences
    assert hist["updates"] == [0, 20, 20, 20] and len(hist["test_return"]) == 2
    res = tmp_path / "_result_burger-marl_999"
    assert {p.name for p in res.iterdir()} >= {"latest.pt", "history.json", "meta.npz",
                                               "replay.pt", "best"}

    ts2, rep2, hist2 = trun.main(TINY + ["--NE", "60", "--resume"], device="cpu")
    out = capsys.readouterr().out
    assert "[run] continuing from previous run" in out and len(_json_lines(out)) == 1
    assert hist2["gen"] == [1, 2, 3, 4, 5, 6] and hist2["updates"][4:] == [20, 20]
    assert ts2.n_updates == 100 and rep2.cursor == 60
    # the resumed run continues the uninterrupted one exactly
    ts3, rep3, hist3 = trun.main(TINY[:-3] + ["--run", "998", "--serialize-replay",
                                              "--NE", "60"], device="cpu")
    assert hist3["mean_return"] == hist2["mean_return"]
    for a, b in zip(ts2.net.parameters(), ts3.net.parameters()):
        assert torch.equal(a, b)

    with pytest.raises(SystemExit, match="mu_param"):
        trun.main(TINY + ["--NE", "70", "--resume", "--muparam", "sigma_relative"],
                  device="cpu")


@pytest.mark.parametrize("argv", [
    ["advection-simple", "--ic", "turbulence", "--test"], BARE + ["--mesh"],
    BARE + ["--learner", "apg"], BARE + ["--save-episodes"], BARE + ["--bf16"],
    ["cmaes-burger"], ["laplace"],
    ["diffusion-error"], ["diffusion-simple"], ["diffusion-stencil3"], ["advection-simple"],
    BARE + ["--test", "--bf16"], ["cmaes-burger", "--test"]],
    ids=lambda a: " ".join(a[:1] + a[-2:]))
def test_unported_presets_and_flags_raise(argv, tmp_path, monkeypatch, capsys):
    """Nothing is refused any more: the presets and flags ported after the
    first slices (the diffusion, advection and Laplace presets,
    --save-episodes, --bf16) parse, and --mesh, --learner apg and
    cmaes-burger (also under --test) run, here at a tiny size (TINY_RUNS),
    each printing its one JSON line; --mesh's has the JAX CLI's keys
    (marlpde_tpu/run.py:493-495), at a world of 1."""
    monkeypatch.chdir(tmp_path)
    trun.build_parser().parse_args(argv)
    assert argv[0] in trun.RL_DEFAULTS or argv[0] == "cmaes-burger"
    kind = "apg" if "apg" in argv else "mesh" if "--mesh" in argv else argv[0]
    if kind not in TINY_RUNS:
        assert list(tmp_path.iterdir()) == []
        return
    trun.main(argv + TINY_RUNS[kind], device="cpu")
    lines = _json_lines(capsys.readouterr().out)
    assert len(lines) == 1 and lines[0]["workload"] == argv[0]
    if kind == "mesh":
        assert list(lines[0]) == ["workload", "mesh_devices", "final_mean_return",
                                  "generations"]
        assert lines[0]["mesh_devices"] == 1 and lines[0]["generations"] == 2
        assert np.isfinite(lines[0]["final_mean_return"])
        assert {p.name for p in (tmp_path / "_result_burger-marl_0").iterdir()} == {
            "latest.pt", "history.json", "meta.npz"}
    elif kind == "apg":
        assert lines[0]["learner"] == "apg" and lines[0]["iterations"] == 2
        assert np.isfinite(lines[0]["final_mean_return"])
        assert {p.name for p in (tmp_path / "_result_burger-marl_0").iterdir()} == {
            "latest.pt", "history.json"}
    else:
        assert lines[0]["generations"] == 2 and 0.0 <= lines[0]["best_cs"] <= 1.0
        assert list(tmp_path.iterdir()) == []


def test_parser_accepts_the_jax_flag_surface():
    ns = trun.build_parser().parse_args(BARE + ["--no-dimnorm", "--fast", "off",
                                                "--policy-impl", "pallas", "--tf", "3"])
    assert isinstance(ns, argparse.Namespace)
    assert (ns.dimnorm, ns.fast, ns.policy_impl, ns.testfreq) == (False, "off", "pallas", 3)
