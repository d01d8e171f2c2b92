"""Port parity: ``rl/cmaes.py`` (the host CMA-ES and the batched
Smagorinsky-constant objective) and the CLI's 'cmaes-burger' workload against
the JAX package.

Tolerances: the CMA-ES history bit for bit (the same numpy code and
``default_rng`` stream on the same costs); the objective 1e-10 relative in
float64 (the same ABCN episodes on torch.fft and jnp.fft); the CLI, whose
episodes are float32 in both packages, the same keys, generations and best
cs bits where the float32 costs order the population alike (the seeds
below), the best objective to 1e-5 relative (float32 sums of MSE rewards).
The graphed objective (one CUDA graph a macro-step on the card) runs here
through tests/graph_standins.py, bit for bit against direct calls, with its
own graph for each population size (fault F1)."""

import contextlib
import io
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from marlpde_tpu import run as jrun
from marlpde_tpu.rl import cmaes as jcmaes
from marlpde_tpu_torch import run as trun
from marlpde_tpu_torch.rl import cmaes as tcmaes
from marlpde_tpu_torch.utils import graphs

import graph_standins as standins

torch.set_num_threads(1)
OBJ = dict(N_dns=64, grid_size=16, dt=0.01, T=0.2, nu=0.05, episode_length=10,
           ic_case="turbulence")
CLI = ("cmaes-burger --NDNS 64 --N 16 --dt 0.01 --T 0.1 --nu 0.05 --episodelength 5 "
       "--ic turbulence --numgen 10").split()


@pytest.mark.parametrize("dim,seed", [(2, 1), (1, 42), (3, 7)])
def test_cmaes_history_is_jax_bit_for_bit(dim, seed):
    """The quadratic of tests/test_extras.py::TestCmaes."""
    target = np.linspace(-0.3, 0.7, dim)

    def f(xs):
        return ((xs - target) ** 2).sum(1)

    kw = dict(dim=dim, population=8, max_generations=40, lower=-2.0, upper=2.0, sigma0=0.3,
              seed=seed)
    jx, jcost, jhist = jcmaes.cmaes_minimize(f, jcmaes.CmaesConfig(**kw))
    tx, tcost, thist = tcmaes.cmaes_minimize(f, tcmaes.CmaesConfig(**kw))
    assert thist == jhist and tcost == jcost and np.array_equal(tx, jx)
    np.testing.assert_allclose(tx, target, atol=0.05)


@pytest.mark.parametrize("cs", [[0.0, 0.2, 1.0], [0.5, 0.05, 0.9, 0.31]], ids=["3", "4"])
def test_burger_cs_objective_matches_jax(cs):
    xs = np.asarray(cs)[:, None]
    want = jcmaes.make_burger_cs_objective(dtype=jnp.float64, **OBJ)(xs)
    got = tcmaes.make_burger_cs_objective(dtype=torch.float64, device="cpu", **OBJ)(xs)
    assert got.shape == (len(cs),) and got.dtype == np.float64
    assert np.abs(got - want).max() <= 1e-10 * np.abs(want).max()
    assert np.isfinite(got).all() and not np.allclose(got[0], got[-1])


def test_blown_episodes_cost_1e6_as_in_jax():
    """dt = 0.05 blows up the DNS and every LES episode: cost +1e6 (-1e6
    return, burger_cmaes.py:116)."""
    kw = dict(OBJ, dt=0.05, T=1.0)
    xs = np.array([[0.0], [0.7]])
    want = jcmaes.make_burger_cs_objective(dtype=jnp.float64, **kw)(xs)
    got = tcmaes.make_burger_cs_objective(dtype=torch.float64, device="cpu", **kw)(xs)
    assert got.tolist() == want.tolist() == [1e6, 1e6]


def _json_line(main, argv, **kw):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = main(argv, **kw)
    lines = [json.loads(ln) for ln in buf.getvalue().splitlines() if ln.startswith("{")]
    assert len(lines) == 1
    return lines[0], out


@pytest.mark.parametrize("extra", [["--seed", "42"], ["--seed", "7", "--pop", "6"],
                                   ["--seed", "3", "--test"]],
                         ids=["seed42", "seed7-pop6", "test"])
def test_cmaes_cli_matches_jax(extra, tmp_path, monkeypatch):
    """The JAX CLI dispatches cmaes-burger before make_workload, under --test
    too (marlpde_tpu/run.py:449-450); neither writes a result directory."""
    monkeypatch.chdir(tmp_path)
    want, _ = _json_line(jrun.main, CLI + extra)
    got, ret = _json_line(trun.main, CLI + extra, device="cpu")
    assert ret == got and list(got) == list(want)
    assert got["workload"] == "cmaes-burger" and got["generations"] == want["generations"] == 10
    assert got["best_cs"] == want["best_cs"] and 0.0 <= got["best_cs"] <= 1.0
    assert abs(got["best_objective"] - want["best_objective"]) <= 1e-5 * abs(want["best_objective"])
    assert list(tmp_path.iterdir()) == []


def test_graphed_objective_gives_the_direct_bits_and_matches_jax(monkeypatch):
    """On the card the objective replays one graph per macro-step
    (utils/graphs.py); tests/graph_standins.py's Replayed stands in for it
    here.  Three cs, the last of which blows up (cost 1e6): the graphed
    objective gives the direct bits, over two generations of one capture, and
    the JAX package's costs at 1e-10."""
    xs = np.array([[0.2], [0.9], [10.0]])
    want = jcmaes.make_burger_cs_objective(dtype=jnp.float64, **OBJ)(xs)
    direct = tcmaes.make_burger_cs_objective(dtype=torch.float64, device="cpu", **OBJ)
    d = [direct(xs), direct(xs[::-1].copy())]
    standins.use(monkeypatch, standins.Replayed)
    graphed = tcmaes.make_burger_cs_objective(dtype=torch.float64, device="cpu", **OBJ)
    got = [graphed(xs), graphed(xs[::-1].copy())]
    assert all(np.array_equal(a, b) for a, b in zip(got, d))
    assert np.array_equal(got[1], got[0][::-1])
    assert got[0][2] == want[2] == 1e6 and np.isfinite(got[0][:2]).all()
    assert np.abs(got[0] - want).max() <= 1e-10 * np.abs(want[:2]).max()


def test_a_second_population_size_gets_its_own_graph(monkeypatch):
    """Fault F1's rule: the population size is in the graph's key.  One
    objective evaluated graphed at 3, then 2, then 3 candidates gives the
    bits of its direct evaluations, from two captures."""
    xss = [np.array([[0.2], [0.5], [0.8]]), np.array([[0.3], [0.7]]),
           np.array([[0.1], [0.4], [0.6]])]
    direct = tcmaes.make_burger_cs_objective(dtype=torch.float64, device="cpu", **OBJ)
    want = [direct(xs) for xs in xss]
    standins.use(monkeypatch, standins.Replayed)
    before = graphs.replays
    graphed = tcmaes.make_burger_cs_objective(dtype=torch.float64, device="cpu", **OBJ)
    got = [graphed(xs) for xs in xss]
    assert all(np.array_equal(a, b) for a, b in zip(got, want))
    # the first macro-step of each capture is its warm-up, not a replay
    assert graphs.replays - before == 3 * OBJ["episode_length"] - 2
