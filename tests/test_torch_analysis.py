"""Port parity: analysis/diagnostics.py, analysis/plotting.py (makePlot's panel
data and file set), utils/async_sink.py, and analysis/evaluation.py
(``evaluate_policy``, ``compare_with_uncontrolled``, ``ks_testing``) against
the JAX package.

Tolerances: the diagnostics in float64 at 1e-12 relative to each array's max
|value|; makePlot's panel data at rtol 1e-12 (the same numpy and scipy on the
same inputs); the sweeps with the same weights in float64 at 1e-8; the sink's
files byte for byte."""

import dataclasses
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from marlpde_tpu.analysis import diagnostics as jdiag
from marlpde_tpu.analysis import evaluation as jeval
from marlpde_tpu.analysis import plotting as jplot
from marlpde_tpu.core import spectral as jsp
from marlpde_tpu.envs import burger_env as jbe
from marlpde_tpu.envs import ks_env as jke
from marlpde_tpu.rl import vracer as jv
from marlpde_tpu.train import trainer as jtr
from marlpde_tpu_torch.analysis import diagnostics as tdiag
from marlpde_tpu_torch.analysis import evaluation as teval
from marlpde_tpu_torch.analysis import plotting as tplot
from marlpde_tpu_torch.core import spectral as tsp
from marlpde_tpu_torch.envs import burger_env as tbe
from marlpde_tpu_torch.rl import vracer as tv
from marlpde_tpu_torch.utils.async_sink import AsyncSink
from test_torch_interop import params64, pool_from_jax, train_state_from_jax
from test_torch_ks import SMALL, tcfg
from test_torch_ks import pool_from_jax as ks_pool_from_jax

torch.set_num_threads(1)

BURGER = jbe.BurgerEnvConfig(N_dns=32, grid_size=8, num_actions=8, dt=0.01, T=0.05,
                             nu=0.02, episode_length=5, ic_case="turbulence",
                             spectral_reward=True, noise=0.0)


def _skip_drawing(monkeypatch):
    import matplotlib
    matplotlib.use("Agg")
    from matplotlib.figure import Figure
    monkeypatch.setattr(Figure, "savefig", lambda self, fname, *a, **k: open(fname, "wb").close())
    monkeypatch.setattr(Figure, "tight_layout", lambda self, *a, **k: None)


@pytest.fixture
def fast_figures(monkeypatch):
    """Figures saved as empty files without drawing: for the tests that check
    the file set but not the images (drawing takes seconds a figure)."""
    _skip_drawing(monkeypatch)


def _close(got, want, tol, msg=""):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=tol * max(1.0, np.abs(want).max()), err_msg=msg)


# ------------------------------------------------------------------ diagnostics

def _trajectory(seed, frames=9, N=32):
    rng = np.random.default_rng(seed)
    x = np.linspace(0, 2 * np.pi, N, endpoint=False)
    return (np.sin(x)[None] * np.cos(0.3 * np.arange(frames))[:, None]
            + 0.2 * rng.standard_normal((frames, N)))


def test_compute_ek_matches_jax_per_row():
    uu = np.stack([_trajectory(s) for s in range(3)])
    dx = 2 * np.pi / 32
    got = tdiag.compute_ek(tsp.fft(torch.from_numpy(uu)), dx)
    for i in range(3):
        want = jdiag.compute_ek(jsp.fft(jnp.asarray(uu[i])), dx)
        for k in want:
            _close(got[k][i].numpy(), want[k], 1e-12, k)


@pytest.mark.parametrize("n_urg", [8, 7])
def test_compute_sgs_burger_matches_jax_per_row(n_urg):
    uu = np.stack([_trajectory(s) for s in range(2)])
    nu = np.array([0.02, 0.05])
    grid_k = np.fft.fftfreq(32, 1 / 32)
    got = tdiag.compute_sgs_burger(torch.from_numpy(uu), grid_k, 2 * np.pi / 32, 0.01,
                                   torch.from_numpy(nu), n_urg)
    for i in range(2):
        want = jdiag.compute_sgs_burger(jnp.asarray(uu[i]), grid_k, 2 * np.pi / 32, 0.01,
                                        nu[i], n_urg)
        for k in ("sgs", "sgs_alt", "sgs_alt2"):
            assert got[k][i].shape == want[k].shape
            _close(got[k][i].numpy(), want[k], 1e-12, k)


def test_compute_sgs_ks_and_the_numpy_helpers_match_jax(tmp_path):
    uu = np.stack([_trajectory(s, N=64) for s in range(2)])
    k = np.fft.fftfreq(64, 22.0 / (2 * np.pi * 64))
    got = tdiag.compute_sgs_ks(torch.from_numpy(uu), k, 22.0 / 64, 16)
    for i in range(2):
        _close(got[i].numpy(), jdiag.compute_sgs_ks(jnp.asarray(uu[i]), k, 22.0 / 64, 16), 1e-12)
    a, b, tt = uu[0], uu[1], np.arange(9) * 0.1
    assert tdiag.sgs_correlation(a, b) == jdiag.sgs_correlation(a, b)
    assert tdiag.error_curves(a, b, tt) == jdiag.error_curves(a, b, tt)
    tdiag.write_error_json(str(tmp_path / "t.json"), tdiag.error_curves(a, b, tt))
    jdiag.write_error_json(str(tmp_path / "j.json"), jdiag.error_curves(a, b, tt))
    assert (tmp_path / "t.json").read_bytes() == (tmp_path / "j.json").read_bytes()


# ------------------------------------------------------------------ makePlot

def _plot_inputs(seed, N=64, g=16, T=12, Td=40):
    rng = np.random.default_rng(seed)
    x_d = np.linspace(0, 2 * np.pi, N, endpoint=False)
    x_l = np.linspace(0, 2 * np.pi, g, endpoint=False)
    tt_d = np.arange(Td) * 0.01
    tt_l = np.arange(1, T + 1) * (0.01 * 3)
    ek = lambda n, t: np.abs(rng.standard_normal((t, n))) + 0.5
    dns = dict(x=x_d, tt=tt_d, uu=np.sin(x_d)[None] * np.cos(tt_d)[:, None],
               ek_ktt=ek(N, Td), sgs_history=rng.standard_normal((Td, N)))
    base = dict(x=x_l, tt=tt_l, uu=np.sin(x_l)[None] * np.cos(tt_l)[:, None] * 0.9,
                ek_ktt=ek(g, T), action_fields=rng.standard_normal((T, 4)))
    sgs = dict(x=x_l, tt=tt_l, uu=np.sin(x_l)[None] * np.cos(tt_l)[:, None] * 0.99,
               ek_ktt=ek(g, T), action_fields=rng.standard_normal((T, 4)),
               sgs_history=rng.standard_normal((T, g)))
    return dns, base, sgs


def _assert_panels(got, want):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-12, atol=0, err_msg=k)


@pytest.mark.parametrize("spectral", [True, False])
def test_make_plot_panel_data_and_files_match_jax(tmp_path, spectral, monkeypatch):
    """The port's figures are drawn once, in the spectral case."""
    dns, base, sgs = _plot_inputs(0)
    (tmp_path / "t").mkdir()
    (tmp_path / "j").mkdir()
    with monkeypatch.context() as m:
        if not spectral:
            _skip_drawing(m)
        got = tplot.make_plot(dns, base, sgs, str(tmp_path / "t" / "cmp"), spectral=spectral)
    _skip_drawing(monkeypatch)
    want = jplot.make_plot(dns, base, sgs, str(tmp_path / "j" / "cmp"), spectral=spectral)
    _assert_panels(got, want)
    names = {p.name for p in (tmp_path / "t").iterdir()}
    assert names == {p.name for p in (tmp_path / "j").iterdir()}
    assert names == {"cmp.png", "cmp_evolution.png", "cmp_action.png",
                     "cmp_action_closeup.png"}
    if spectral:
        assert all((tmp_path / "t" / n).read_bytes()[:8] == b"\x89PNG\r\n\x1a\n" for n in names)


def test_make_plot_writes_panels_npz_without_matplotlib(tmp_path, monkeypatch, capsys,
                                                         fast_figures):
    dns, base, sgs = _plot_inputs(1)
    del sgs["sgs_history"]                       # no KDE panels: the 3x6 data only
    with monkeypatch.context() as m:
        m.setitem(sys.modules, "matplotlib", None)
        got = tplot.make_plot(dns, base, sgs, str(tmp_path / "cmp"))
    assert [p.name for p in tmp_path.iterdir()] == ["cmp_panels.npz"]
    assert "matplotlib is not installed" in capsys.readouterr().out
    with np.load(tmp_path / "cmp_panels.npz") as d:
        _assert_panels({k: d[k] for k in d.files}, got)
    _assert_panels(got, jplot.make_plot(dns, base, sgs, str(tmp_path / "j")))


def test_make_plot_of_a_policy_that_acts_zero(tmp_path, fast_figures):
    """An SGS forcing without spread (a policy acting 0 everywhere, as an
    untrained sigma-relative one does) has no KDE: the port's panel reads NaN
    and the rest equals JAX's; the JAX function raises (a fault of the
    reference, ROADMAP.md section 3)."""
    dns, base, sgs = _plot_inputs(2)
    sgs["sgs_history"] = np.zeros_like(sgs["sgs_history"])
    got = tplot.make_plot(dns, base, sgs, str(tmp_path / "cmp"))
    assert np.isnan(got["sgs_sgs_kde"]).all() and np.isfinite(got["dns_sgs_kde"]).all()
    with pytest.raises(np.linalg.LinAlgError):
        jplot.make_plot(dns, base, sgs, str(tmp_path / "j"))
    del sgs["sgs_history"]
    want = jplot.make_plot(dns, base, sgs, str(tmp_path / "j"))
    _assert_panels({k: got[k] for k in want}, want)
    from scipy.stats import gaussian_kde
    xi = np.arange(64) % 4 == 0
    np.testing.assert_allclose(got["dns_sgs_kde"], gaussian_kde(
        dns["sgs_history"][:, xi].ravel())(got["sgs_kde_grid"]), rtol=1e-12)
    assert {p.name for p in tmp_path.iterdir() if p.name.startswith("cmp")} == {
        "cmp.png", "cmp_evolution.png", "cmp_action.png", "cmp_action_closeup.png"}


# ------------------------------------------------------------------ async sink

def test_async_sink_writes_the_bytes_np_save_writes(tmp_path):
    rng = np.random.default_rng(0)
    arrays = dict(f32=rng.standard_normal((3, 4, 5)).astype(np.float32),
                  f64=rng.standard_normal(7), i32=rng.integers(-9, 9, (2, 2), dtype=np.int32),
                  i64=rng.integers(-9, 9, 6), u8=rng.integers(0, 255, 5, dtype=np.uint8),
                  scalar=np.float64(3.5), strided=rng.standard_normal((6, 4))[::2, 1:])
    sink = AsyncSink(str(tmp_path / "sink"))
    for name, a in arrays.items():
        sink.write(name, a)
    buf = arrays["f32"]
    buf[:] = 0.0                                  # the sink wrote a copy
    sink.flush()
    assert sink.pending() == 0
    (tmp_path / "ref").mkdir()
    arrays["f32"] = None
    for name, a in arrays.items():
        if a is None:
            continue
        np.save(tmp_path / "ref" / f"{name}.npy", a)
        assert ((tmp_path / "sink" / f"{name}.npy").read_bytes()
                == (tmp_path / "ref" / f"{name}.npy").read_bytes()), name
    assert np.load(tmp_path / "sink" / "f32.npy").any()
    sink.close()
    with pytest.raises(RuntimeError, match="after close"):
        sink.write("late", np.zeros(2))


def test_async_sink_drains_and_casts_as_jax(tmp_path):
    sink = AsyncSink(str(tmp_path))
    for i in range(50):
        sink.write(f"chunk_{i}", np.full(256, i, np.float32))
    sink.write("half", np.arange(4, dtype=np.float16))
    sink.close()
    assert sink.pending() == 0 and len(list(tmp_path.glob("chunk_*.npy"))) == 50
    assert np.load(tmp_path / "chunk_49.npy")[0] == 49
    assert np.load(tmp_path / "half.npy").dtype == np.float32


# ------------------------------------------------------------------ evaluation

def _weights(jenv_cfg, obs_dim, act_dim, num_agents, episode_length, width=16, **kw):
    """A float64 JAX train state with perturbed weights, and the port's copy."""
    cfg = jv.VracerConfig(obs_dim=obs_dim, act_dim=act_dim, num_agents=num_agents,
                          episode_length=episode_length, width=width, **kw)
    jts = params64(cfg, jv.init_train(cfg, jax.random.key(1), dtype=jnp.float64))
    rng = np.random.default_rng(0)
    jts = jts.replace(params=jax.tree.map(
        lambda a: a + jnp.asarray(rng.standard_normal(a.shape) * 0.3), jts.params))
    tcfg_rl = tv.VracerConfig(**dataclasses.asdict(cfg))
    return cfg, jts, tcfg_rl, train_state_from_jax(tcfg_rl, jts)


@pytest.fixture(scope="module")
def burger():
    jpool = jbe.make_dns_pool(BURGER, 3, dtype=jnp.float64)
    cfg, jts, tcfg_rl, ts = _weights(BURGER, BURGER.obs_dim, BURGER.actions_per_agent, 1, 5)
    return jpool, pool_from_jax(jpool), cfg, jts, tcfg_rl, ts


def test_evaluate_policy_matches_jax(burger, tmp_path):
    """Two pool rows, batched in the port and one episode each in JAX; the
    .npy dumps hold the same arrays."""
    jpool, tpool, cfg, jts, tcfg_rl, ts = burger
    want = jeval.evaluate_policy(BURGER, jpool, cfg, jts, out_dir=str(tmp_path / "j"),
                                 run_tag=3, sample_ids=[0, 2], file_suffix="_nu0.02")
    got = teval.evaluate_policy(tbe.BurgerEnvConfig(**dataclasses.asdict(BURGER)), tpool,
                                tcfg_rl, ts, out_dir=str(tmp_path / "t"), run_tag=3,
                                sample_ids=[0, 2], file_suffix="_nu0.02")
    assert set(got) == set(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
        _close(got[k], want[k], 1e-8, k)
    assert np.abs(want["actions"]).max() > 0.05
    names = sorted(p.name for p in (tmp_path / "j").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "t").iterdir()) == [
        "dnsSgsTerms_3_nu0.02.npy", "relError_3_nu0.02.npy", "sgsTerms_3_nu0.02.npy"]
    for n in names:
        a, b = np.load(tmp_path / "t" / n), np.load(tmp_path / "j" / n)
        assert a.shape == b.shape and a.dtype == b.dtype
        _close(a, b, 1e-8, n)


def test_compare_with_uncontrolled_matches_jax(burger, tmp_path, fast_figures):
    jpool, tpool, cfg, jts, tcfg_rl, ts = burger
    want = jeval.compare_with_uncontrolled(BURGER, jpool, cfg, jts, sidx=1,
                                           file_prefix=str(tmp_path / "jtest"))
    got = teval.compare_with_uncontrolled(tbe.BurgerEnvConfig(**dataclasses.asdict(BURGER)),
                                          tpool, tcfg_rl, ts, sidx=1,
                                          file_prefix=str(tmp_path / "ttest"))
    assert set(got) == set(want)
    for k in set(want) - {"panels"}:
        assert got[k].shape == want[k].shape
        _close(got[k], want[k], 1e-8, k)
    assert set(got["panels"]) == set(want["panels"])
    for k in want["panels"]:
        _close(got["panels"][k], want["panels"][k], 1e-8, k)
    names = lambda p: sorted(f.name[len(p):] for f in tmp_path.iterdir() if f.name.startswith(p))
    assert names("ttest") == names("jtest") and len(names("ttest")) == 4


def test_ks_testing_batched_rows_match_jax_row_by_row(tmp_path, fast_figures):
    jcfg = jke.KSEnvConfig(**SMALL)
    jpool = jke.make_dns_pool(jcfg, 3, dtype=jnp.float64)
    cfg, jts, tcfg_rl, ts = _weights(jcfg, jcfg.obs_dim, jcfg.actions_per_agent, 1, 5,
                                     mu_param="sigma_relative", sigma_max=5.0)
    got = teval.ks_testing(tcfg(jcfg), ks_pool_from_jax(jpool), tcfg_rl, ts,
                           str(tmp_path / "t"), run_tag=["7_s0", "7_s2"], sidx=[0, 2])
    for r, sidx in enumerate((0, 2)):
        want = jeval.ks_testing(jcfg, jpool, cfg, jts, str(tmp_path / "j"),
                                run_tag=f"7_s{sidx}", sidx=sidx)
        for k in want:
            assert got[k][r].shape == want[k].shape, k
            _close(got[k][r], want[k], 1e-8, f"row {sidx} {k}")
    assert np.abs(got["controlled_cumreward"] - got["baseline_cumreward"]).max() > 1e-6
    names = sorted(p.name for p in (tmp_path / "j").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "t").iterdir())
    assert len(names) == 12          # sgs, dnsSgs and 4 figures per row
    for n in (n for n in names if n.endswith(".npz")):
        with np.load(tmp_path / "t" / n) as a, np.load(tmp_path / "j" / n) as b:
            assert a.files == b.files
            for k in b.files:
                assert a[k].shape == b[k].shape, (n, k)
                _close(a[k], b[k], 1e-8, f"{n} {k}")
    one = teval.ks_testing(tcfg(jcfg), ks_pool_from_jax(jpool), tcfg_rl, ts,
                           str(tmp_path / "one"), run_tag=5, sidx=2)
    for k in one:
        _close(one[k], got[k][1], 1e-12, k)
    assert (tmp_path / "one" / "sgs_5.npz").exists()


@pytest.mark.parametrize("fn", [teval.simple_env_testing, teval.laplace_testing])
def test_unported_testing_branches_raise(fn, tmp_path, fast_figures):
    """The testing branches of the diffusion/advection and Laplace families,
    ported since: on the same weights and env (float64, no reset noise) the
    port returns JAX's arrays at 1e-10 and writes JAX's files; simple-env
    testing also the error_rl_{N}.json curves, equal to JAX's."""
    import json

    from marlpde_tpu.envs import diffusion_env as jdif
    from marlpde_tpu.envs import laplace_env as jlap
    from marlpde_tpu.envs import registry as jreg
    from marlpde_tpu_torch.envs import registry as treg

    simple = fn is teval.simple_env_testing
    name, kw, jmod = (("diffusion-simple", dict(N=16, num_agents=2, noise=0.0), jdif) if simple
                      else ("laplace", dict(num_agents=6, sforce="sin"), jlap))
    kw["episode_length"] = 20
    jenv = jreg.make_env(name, **kw)
    jenv = dataclasses.replace(jenv, reset=lambda c, k, n: jmod.reset(jenv.cfg, k, n,
                                                                      dtype=jnp.float64))
    tenv = treg.make_env(name, device="cpu", dtype=torch.float64, **kw)
    jcfg_rl = jtr.default_rl_config(jenv, width=16, sigma_max=5.0)
    jts = params64(jcfg_rl, jv.init_train(jcfg_rl, jax.random.key(1), dtype=jnp.float64))
    rng = np.random.default_rng(5)
    jts = jts.replace(params=jax.tree.map(
        lambda a: a + jnp.asarray(rng.standard_normal(a.shape) * 0.3), jts.params))
    tcfg_rl = tv.VracerConfig(**dataclasses.asdict(jcfg_rl))
    ts = train_state_from_jax(tcfg_rl, jts)
    jfn = jeval.simple_env_testing if simple else jeval.laplace_testing
    want = jfn(jenv, jcfg_rl, jts, str(tmp_path / "j"), key=jax.random.key(0))
    got = fn(tenv, tcfg_rl, ts, str(tmp_path / "t"))
    assert list(got) == list(want)
    for k in want:
        _close(got[k], np.asarray(want[k]), 1e-10, k)
    assert np.abs(got["uu"] - got["uu"][:1]).max() > 1e-6
    files = sorted(p.name for p in (tmp_path / "t").iterdir())
    assert files == sorted(p.name for p in (tmp_path / "j").iterdir())
    if simple:
        with open(tmp_path / "t" / "error_rl_16.json") as f, \
                open(tmp_path / "j" / "error_rl_16.json") as g:
            tcurves, jcurves = json.load(f), json.load(g)
        assert tcurves["survived_steps"] == jcurves["survived_steps"]
        for k in ("t", "mse", "linf", "mass"):
            _close(np.asarray(tcurves[k]), np.asarray(jcurves[k]), 1e-10, k)
        assert {"compare.png", "compare_evolution.png", "evolution.png"} <= set(files)
    else:
        assert {"hessian.png", "actions.png", "evolution.png"} <= set(files)


PLOTS = {
    "plot_field": lambda x, tt, uu, a: (x, uu[0]),
    "plot_error": lambda x, tt, uu, a: (x, np.abs(uu[0]) + 1e-3),
    "plot_avg_spectrum": lambda x, tt, uu, a: ([np.abs(np.fft.fft(uu[0])) ** 2,
                                                np.abs(np.fft.fft(uu[1])) ** 2], ["a", "b"]),
    "make_diffusion_plot": lambda x, tt, uu, a: (x, tt, uu, uu * 0.9),
    "plot_action_field": lambda x, tt, uu, a: (x, a),
    "plot_evolution_panels": lambda x, tt, uu, a: (x, tt, uu, uu * 0.9),
    "plot_action_contour": lambda x, tt, uu, a: (x, tt, a),
    "plot_field_contour": lambda x, tt, uu, a: (x, tt, uu),
    "plot_action_distribution": lambda x, tt, uu, a: (a,),
}


@pytest.mark.parametrize("name", list(PLOTS))
def test_remaining_plots_write_jax_s_figure_or_their_data(name, tmp_path, monkeypatch,
                                                          fast_figures):
    """Each figure of the rest of plotting.py: the same file as JAX's; where
    matplotlib is missing, an .npz of the numbers it shows, which are the
    numbers the JAX figure draws."""
    rng = np.random.default_rng(3)
    x, tt = np.linspace(0, 2 * np.pi, 16, endpoint=False), np.arange(1, 9) * 0.01
    uu, a = rng.standard_normal((8, 16)), rng.standard_normal((8, 16))
    args = PLOTS[name](x, tt, uu, a)
    jfile, tfile = str(tmp_path / "j.png"), str(tmp_path / "t.png")
    getattr(jplot, name)(*args, fname=jfile)
    data = getattr(tplot, name)(*args, fname=tfile)
    assert (tmp_path / "j.png").exists() and (tmp_path / "t.png").exists()
    monkeypatch.setattr(tplot, "_plt", lambda: None)
    nodraw = getattr(tplot, name)(*args, fname=str(tmp_path / "n.png"))
    with np.load(tmp_path / "n.npz") as saved:
        assert sorted(saved.files) == sorted(data)
        for k in data:
            np.testing.assert_array_equal(saved[k], data[k])
            np.testing.assert_array_equal(nodraw[k], data[k])
    if name == "make_diffusion_plot":
        np.testing.assert_allclose(data["mse"], np.mean((uu - uu * 0.9) ** 2, axis=1))
        np.testing.assert_allclose(data["mass"], uu.sum(1))
    if name == "plot_action_field":
        np.testing.assert_allclose(data["q90"], np.quantile(a, 0.9, 0))


def test_movies_and_training_curves(tmp_path, monkeypatch):
    """The two movies (a few frames each, drawn) and the rlview curves: JAX's
    files; the frames' data where matplotlib is missing."""
    rng = np.random.default_rng(4)
    x, tt = np.linspace(0, 2 * np.pi, 16, endpoint=False), np.arange(6) * 0.1
    uu = rng.standard_normal((6, 16))
    ek = np.abs(rng.standard_normal((6, 16))) + 1e-3
    k = np.fft.fftfreq(16, 1.0 / 16)
    hist = dict(experiences=[10, 20, 30], mean_return=[-1.0, -0.5, -0.2],
                mean_ep_len=[5, 5, 5], metrics=[{}, {"beta": 0.3}, {"beta": 0.29}])
    for mod, d in ((jplot, "j"), (tplot, "t")):
        mod.make_movie_field([x, x], [uu, uu * 0.5], tt, str(tmp_path / f"{d}_f.gif"),
                             num_frames=3)
        mod.make_movie_spectrum([k], [ek], tt, str(tmp_path / f"{d}_s.gif"), num_frames=3)
        mod.plot_training_curves(hist, str(tmp_path / f"{d}_c.png"))
    for f in ("f.gif", "s.gif", "c.png"):
        assert (tmp_path / f"t_{f}").stat().st_size > 0 and (tmp_path / f"j_{f}").exists()
    monkeypatch.setattr(tplot, "_plt", lambda: None)
    frames = tplot.make_movie_field([x], [uu], tt, str(tmp_path / "n.gif"), num_frames=3)
    np.testing.assert_array_equal(frames["uu0"], uu[[0, 2, 5]])
    spec = tplot.make_movie_spectrum([k], [ek], tt, str(tmp_path / "m.gif"), num_frames=3)
    np.testing.assert_array_equal(spec["ek0"], ek[[0, 2, 5], 1:8])
    curves = tplot.plot_training_curves(hist, str(tmp_path / "n.png"))
    np.testing.assert_array_equal(curves["beta"], [np.nan, 0.3, 0.29])
    assert (tmp_path / "n.npz").exists() and (tmp_path / "m.npz").exists()
