"""Port parity: ``solvers/burger.step``/``simulate`` for every scheme (abcn,
fd, rk3, cfd_rk3) with the stochastic forcing, the ssm and dsm closures,
dforce=False, ssmforce and filter_state_quirk, against the JAX package in
float64.  The inputs are numpy-made and seeded; the forcing tables and the
phase offsets are injected on both sides.

Tolerance: 1e-10 relative to each field's max |value| (the same float64
math on torch.fft and jnp.fft)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from marlpde_tpu.solvers import burger as jburger
from marlpde_tpu.solvers import closures as jclosures
from marlpde_tpu_torch.solvers import burger as tburger
from marlpde_tpu_torch.solvers import closures as tclosures

torch.set_num_threads(1)
REL = 1e-10
B, STEPS = 3, 20

VARIANTS = {
    "plain": dict(),
    "forcing": dict(forcing=True, stepper=2),
    "ssm": dict(ssm=True),
    "dsm": dict(dsm=True),
    "dsm-quirk": dict(dsm=True, filter_state_quirk=True),
    "forcing-over-ssm": dict(forcing=True, ssm=True, stepper=3),
    "d2udx2": dict(dforce=False),
    "ssmforce": dict(ssmforce=True),
}


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-300)


def _states(cfg, seed, u0=None):
    """The same solver state on both sides: a random IC, per-env viscosities,
    phase offsets and forcing tables."""
    rng = np.random.default_rng(seed)
    if u0 is None:
        u0 = 1.0 + 0.5 * rng.standard_normal((B, cfg.N))
    nu = rng.uniform(0.01, 0.05, B)
    offset = rng.uniform(-1.0, 1.0, B)
    rf1, rf2 = rng.standard_normal((2, B, 4, cfg.stepper))
    js = jburger.init(cfg, u0=jnp.asarray(u0), nu=jnp.asarray(nu), offset=jnp.asarray(offset),
                      randfac1=jnp.asarray(rf1), randfac2=jnp.asarray(rf2))
    tcfg = tburger.BurgerConfig(**dataclasses.asdict(cfg))
    ts = tburger.init(tcfg, u0=torch.from_numpy(u0), nu=torch.from_numpy(nu),
                      offset=torch.from_numpy(offset), randfac1=torch.from_numpy(rf1),
                      randfac2=torch.from_numpy(rf2))
    return tcfg, js, ts


def _assert_solver(ts, js, where):
    for f in dataclasses.fields(tburger.BurgerState):
        assert _rel(getattr(ts, f.name).numpy(), getattr(js, f.name)) <= REL, (where, f.name)


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("scheme,N", [("abcn", 32), ("fd", 32), ("rk3", 16), ("cfd_rk3", 16)])
def test_step_and_simulate_match_jax(scheme, N, variant):
    """Two steps with their forcing aux (sgs, forcing_phys, v_filtered), then
    20 steps of simulate with per-step action fields."""
    cfg = jburger.BurgerConfig(N=N, nu=0.03, dt=1e-3, scheme=scheme, **VARIANTS[variant])
    tcfg, js, ts = _states(cfg, N + len(variant))
    af = np.random.default_rng(7).standard_normal((STEPS, B, N)) * 0.5
    for i in range(2):
        js, jaux = jburger.step(cfg, js, jnp.asarray(af[i]))
        ts, taux = tburger.step(tcfg, ts, torch.from_numpy(af[i]))
        _assert_solver(ts, js, f"step {i}")
        for k in ("sgs", "forcing_phys"):
            assert _rel(taux[k].numpy(), jaux[k]) <= REL, k
        assert (taux["v_filtered"] is None) == (jaux["v_filtered"] is None)
        if jaux["v_filtered"] is not None:
            assert _rel(taux["v_filtered"].numpy(), jaux["v_filtered"]) <= REL
    jfin, juu, jvv = jburger.simulate(cfg, js, STEPS, action_fields=jnp.asarray(af))
    tfin, tuu, tvv = tburger.simulate(tcfg, ts, STEPS, action_fields=torch.from_numpy(af))
    _assert_solver(tfin, jfin, "simulate")
    assert tuu.shape == (STEPS + 1, B, N) and np.isfinite(tuu.numpy()).all()
    assert _rel(tuu.numpy(), juu) <= REL and _rel(tvv.numpy(), jvv) <= REL


@pytest.mark.parametrize("stepper", [1, 3])
def test_stochastic_forcing_cycles_its_table_columns(stepper):
    """``ridx = ioutnum % s`` and the [1:4] rows, with x + offset
    (Burger.py:410-421); three step counts per env."""
    cfg = jburger.BurgerConfig(N=16, dt=1e-3, forcing=True, stepper=stepper)
    tcfg, js, ts = _states(cfg, 11)
    for n in (0, 1, 5):
        js = js.replace(ioutnum=jnp.full((B,), n, jnp.int32))
        ts = dataclasses.replace(ts, ioutnum=torch.full((B,), n, dtype=torch.int64))
        want = jburger.stochastic_forcing(cfg, js)
        assert _rel(tburger.stochastic_forcing(tcfg, ts).numpy(), want) <= REL


def test_closures_match_jax():
    rng = np.random.default_rng(3)
    u = 1.0 + 0.5 * rng.standard_normal((B, 32))
    v = np.fft.fft(u)
    dx = 2 * np.pi / 32
    k = np.fft.fftfreq(32, 1.0 / 32)
    want = jclosures.ssm_forcing(jnp.asarray(u), dx, 32, 0.17)
    assert _rel(tclosures.ssm_forcing(torch.from_numpy(u), dx, 32, 0.17).numpy(), want) <= REL
    jsgs, jvh = jclosures.dsm_forcing(jnp.asarray(u), jnp.asarray(v), jnp.asarray(k), dx, 32)
    tsgs, tvh = tclosures.dsm_forcing(torch.from_numpy(u), torch.from_numpy(v), k, dx, 32)
    assert _rel(tsgs.numpy(), jsgs) <= REL and _rel(tvh.numpy(), jvh) <= REL
    assert (tvh.numpy()[:, np.abs(k) > 8] == 0).all()


def test_dsm_of_a_constant_field_is_nan_as_in_jax():
    """csd2alt divides by mean(Malt^2), 0 for a constant field: NaN on both
    sides, left for the env's blowup detection."""
    cfg = jburger.BurgerConfig(N=16, dsm=True)
    tcfg, js, ts = _states(cfg, 5, u0=np.ones((B, 16)))
    js, jaux = jburger.step(cfg, js)
    ts, taux = tburger.step(tcfg, ts)
    assert np.isnan(np.asarray(jaux["sgs"])).all() and torch.isnan(taux["sgs"]).all()
    assert torch.isnan(ts.u).all() and np.isnan(np.asarray(js.u)).all()


def test_draw_forcing_tables_shape_and_stream():
    g = torch.Generator().manual_seed(0)
    rf1, rf2 = tburger.draw_forcing_tables(g, 3, torch.float64, (5,))
    assert rf1.shape == rf2.shape == (5, 4, 3) and rf1.dtype == torch.float64
    assert not torch.equal(rf1, rf2)
    again = tburger.draw_forcing_tables(torch.Generator().manual_seed(0), 3, torch.float64, (5,))
    assert torch.equal(again[0], rf1) and torch.equal(again[1], rf2)
