"""Port parity: the diffusion and Laplace ICs and source terms (core/ic.py),
solvers/analytical.py, solvers/diffusion.py, solvers/advection.py and
solvers/laplace.py against the JAX package, in float64.

Tolerances: 1e-10 for every field, step and reward (the same float64
arithmetic in both packages); the analytical Burgers solution (numpy in both)
exactly.  The random Laplace forces' uniform draw is taken from JAX's key and
injected into the port."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from marlpde_tpu.core import ic as jic
from marlpde_tpu.solvers import advection as jadv
from marlpde_tpu.solvers import analytical as jana
from marlpde_tpu.solvers import diffusion as jdif
from marlpde_tpu.solvers import laplace as jlap
from marlpde_tpu_torch.core import ic as tic
from marlpde_tpu_torch.solvers import advection as tadv
from marlpde_tpu_torch.solvers import analytical as tana
from marlpde_tpu_torch.solvers import diffusion as tdif
from marlpde_tpu_torch.solvers import laplace as tlap

torch.set_num_threads(1)

TOL = 1e-10
L = 2.0 * np.pi


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, want, tol=TOL, msg=""):
    np.testing.assert_allclose(got.numpy() if isinstance(got, torch.Tensor) else got,
                               np.asarray(want), rtol=tol, atol=tol, err_msg=msg)


def _state_close(st, jst, msg=""):
    for f in dataclasses.fields(st):
        got, want = getattr(st, f.name), np.asarray(getattr(jst, f.name))
        _close(got, want, msg=f"{msg} {f.name}")


@pytest.fixture
def data():
    rng = np.random.default_rng(7)
    return dict(x=np.linspace(0.0, L, 16, endpoint=False),
                offset=rng.standard_normal((3, 1)) * 0.5,
                u=rng.standard_normal((3, 16)), a=rng.standard_normal((3, 16)) * 0.5,
                a1=rng.standard_normal((3, 16)) * 0.5, nu=0.05 + rng.random(3) * 0.1)


@pytest.mark.parametrize("name", ["diffusion_box", "diffusion_sinus", "diffusion_gaussian"])
def test_diffusion_ics(name, data):
    x, off = data["x"], data["offset"]
    want = getattr(jic, name)(jnp.asarray(off), jnp.asarray(x), L)
    got = getattr(tic, name)(_t(off), _t(x), L)
    assert got.dtype == torch.float64 and got.shape == (3, 16)
    _close(got, want, msg=name)


@pytest.mark.parametrize("kind", ["zero", "one", "sin", "cos"])
def test_laplace_ics(kind, data):
    _close(tic.laplace_ic(kind, _t(data["x"])), jic.laplace_ic(kind, jnp.asarray(data["x"])))


@pytest.mark.parametrize("kind", ["zero", "sin", "cos", "sincos", "fourier", "gaussian"])
def test_laplace_forces_with_the_draw_injected(kind, data):
    """Every branch of the random forces: keys whose uniform draws span (0, 1)."""
    x, off = data["x"], data["offset"][0, 0]
    for seed in range(8):
        key = jax.random.key(seed)
        r = float(jax.random.uniform(key))
        want = jic.laplace_force(kind, key, off, jnp.asarray(x), L)
        got = tic.laplace_force(kind, torch.tensor(r, dtype=torch.float64),
                                torch.tensor(off), _t(x), L)
        _close(got, want, msg=f"{kind} r={r}")
    with pytest.raises(ValueError):
        tic.laplace_force("no-such-force", None, 0.0, _t(x), L)


def test_analytical_burgers_is_the_jax_package_s_numpy():
    x, t = np.linspace(-1.0, 1.0, 33), np.linspace(0.0, 0.5, 6)
    np.testing.assert_array_equal(tana.burgers_viscous_exact(0.01 / np.pi, x, t),
                                  jana.burgers_viscous_exact(0.01 / np.pi, x, t))


def _diffusion(implicit, data):
    cfg = dict(N=16, L=L, dt=0.01, nu=0.1, implicit=implicit)
    u0, off = data["u"], data["offset"][:, 0]
    jst = jdif.init(jdif.DiffusionConfig(**cfg), jnp.asarray(u0), offset=jnp.asarray(off))
    jst = jst.replace(nu=jnp.asarray(data["nu"]))
    tst = tdif.init(tdif.DiffusionConfig(**cfg), _t(u0), offset=_t(off))
    tst = dataclasses.replace(tst, nu=_t(data["nu"]))
    return jdif.DiffusionConfig(**cfg), tdif.DiffusionConfig(**cfg), jst, tst


@pytest.mark.parametrize("implicit", [False, True], ids=["explicit", "implicit"])
def test_diffusion_uncontrolled_steps_and_simulate(implicit, data):
    jcfg, tcfg, jst, tst = _diffusion(implicit, data)
    _state_close(tst, jst, "init")
    _close(tdif.fd_step(tcfg, tst), jdif.fd_step(jcfg, jst), msg="fd_step")
    jfin, juu = jdif.simulate(jcfg, jst, 7)
    tfin, tuu = tdif.simulate(tcfg, tst, 7)
    assert tuu.shape == (8, 3, 16)
    _close(tuu, juu, msg="simulate")
    _state_close(tfin, jfin, "final")
    _close(tdif.analytical_sinus(tfin, tcfg), jdif.analytical_sinus(jfin, jcfg))
    _close(tdif.analytical_sinus(tfin, tcfg, t=_t(np.full(3, 0.3))),
           jdif.analytical_sinus(jfin, jcfg, t=jnp.full(3, 0.3)))
    assert tcfg.cfl_violated == jcfg.cfl_violated


@pytest.mark.parametrize("error_mode", [False, True], ids=["stencil", "error"])
def test_diffusion_action_steps(error_mode, data):
    jcfg, tcfg, jst, tst = _diffusion(False, data)
    for _ in range(3):
        jst, jaux = jdif.step(jcfg, jst, jnp.asarray(data["a"]), error_mode=error_mode)
        tst, taux = tdif.step(tcfg, tst, _t(data["a"]), error_mode=error_mode)
        _state_close(tst, jst, "step")
        for k in ("gradient", "action_diag"):
            _close(taux[k], jaux[k], msg=k)


def _advection(data):
    cfg = dict(N=16, L=L, dt=0.01, nu=0.5)
    u0, off = data["u"], data["offset"][:, 0]
    jst = jadv.init(jadv.AdvectionConfig(**cfg), jnp.asarray(u0), offset=jnp.asarray(off))
    tst = tadv.init(tadv.AdvectionConfig(**cfg), _t(u0), offset=_t(off))
    return jadv.AdvectionConfig(**cfg), tadv.AdvectionConfig(**cfg), jst, tst


def test_advection_lax_step_analytical_and_simulate(data):
    jcfg, tcfg, jst, tst = _advection(data)
    assert tcfg.alpha == jcfg.alpha
    _close(tadv.lax_step(tcfg, tst), jadv.lax_step(jcfg, jst))
    jfin, juu = jadv.simulate(jcfg, jst, 6)
    tfin, tuu = tadv.simulate(tcfg, tst, 6)
    _close(tuu, juu, msg="simulate")
    _state_close(tfin, jfin, "final")
    _close(tadv.analytical_sinus(tfin, tcfg), jadv.analytical_sinus(jfin, jcfg))


@pytest.mark.parametrize("pointwise", [True, False], ids=["pointwise", "global"])
def test_advection_action_modes(pointwise, data):
    """Both modes, whose (a0, a1) go to opposite neighbours in the reference."""
    jcfg, tcfg, jst, tst = _advection(data)
    a0, a1 = (data["a"], data["a1"]) if pointwise else (data["a"][:, 0], data["a1"][:, 0])
    for _ in range(3):
        jst, jaux = jadv.step(jcfg, jst, (jnp.asarray(a0), jnp.asarray(a1)), pointwise)
        tst, taux = tadv.step(tcfg, tst, (_t(a0), _t(a1)), pointwise)
        _state_close(tst, jst, "step")
        _close(taux["gradient"], jaux["gradient"])
    # the opposite neighbours: constant per-point weights (c0, c1) are the
    # global mode's (c1, c0)
    c0, c1 = _t(data["a"][:, :1]), _t(data["a1"][:, :1])
    _, pw = tadv.step(tcfg, tst, (c0.expand(3, 16), c1.expand(3, 16)), True)
    _, gl = tadv.step(tcfg, tst, (c1[:, 0], c0[:, 0]), False)
    _, gl_same = tadv.step(tcfg, tst, (c0[:, 0], c1[:, 0]), False)
    _close(pw["gradient"], gl["gradient"].numpy(), 1e-14)
    assert (pw["gradient"] - gl_same["gradient"]).abs().max() > 1e-3


def test_laplace_step_reward_and_state():
    rng = np.random.default_rng(3)
    na = 7
    jcfg, tcfg = jlap.LaplaceConfig(num_agents=na), tlap.LaplaceConfig(num_agents=na)
    assert tcfg.N == jcfg.N == na + 1 and tcfg.grid.dx == jcfg.grid.dx
    u0, f = rng.standard_normal((2, na + 1)), rng.standard_normal((2, na + 1))
    jst, tst = jlap.init(jcfg, jnp.asarray(u0), jnp.asarray(f)), tlap.init(tcfg, _t(u0), _t(f))
    _close(tlap.get_state(tcfg, tst), jlap.get_state(jcfg, jst), msg="get_state")
    for i in range(4):
        a = rng.standard_normal((2, na, 3))
        jst, jaux = jlap.step(jcfg, jst, jnp.asarray(a))
        tst, taux = tlap.step(tcfg, tst, _t(a))
        _state_close(tst, jst, f"step {i}")
        _close(taux["gradient"], jaux["gradient"], msg="gradient")
        assert (tst.u[:, 0] == 1.0).all()
        _close(tlap.direct_reward(tcfg, tst), jlap.direct_reward(jcfg, jst), msg="reward")
        _close(tlap.get_state(tcfg, tst), jlap.get_state(jcfg, jst), msg="get_state")
    assert tlap.direct_reward(tcfg, tst).shape == (2, na)
