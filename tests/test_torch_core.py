"""Port parity: core/spectral.py on torch.fft and the numpy helpers copied into
marlpde_tpu_torch, against the JAX package, in float64 (atol 1e-10)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from marlpde_tpu.core import basis as jbasis
from marlpde_tpu.core import grids as jgrids
from marlpde_tpu.core import ic as jic
from marlpde_tpu.core import spectral as jsp
from marlpde_tpu.envs import features as jfeat
from marlpde_tpu_torch.core import basis as tbasis
from marlpde_tpu_torch.core import grids as tgrids
from marlpde_tpu_torch.core import ic as tic
from marlpde_tpu_torch.core import spectral as tsp
from marlpde_tpu_torch.envs import features as tfeat

torch.set_num_threads(1)
ATOL = 1e-10


def _field(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape)


def _spectrum(seed, shape):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)


def test_fft_and_irfft_real():
    u = _field(0, (3, 32))
    np.testing.assert_allclose(tsp.fft(torch.from_numpy(u)).numpy(),
                               np.asarray(jsp.fft(jnp.asarray(u))), atol=ATOL)
    v = _spectrum(1, (3, 32))
    np.testing.assert_allclose(tsp.irfft_real(torch.from_numpy(v)).numpy(),
                               np.asarray(jsp.irfft_real(jnp.asarray(v))), atol=ATOL)


def test_energy_spectrum_and_cumulative_mean():
    v = _spectrum(2, (5, 16))
    dx = 2 * np.pi / 16
    ek_t = tsp.energy_spectrum(torch.from_numpy(v), dx)
    ek_j = jsp.energy_spectrum(jnp.asarray(v), dx)
    np.testing.assert_allclose(ek_t.numpy(), np.asarray(ek_j), atol=ATOL)
    for axis in (0, 1):
        np.testing.assert_allclose(
            tsp.cumulative_mean(ek_t, axis=axis).numpy(),
            np.asarray(jsp.cumulative_mean(ek_j, axis=axis)), atol=ATOL)


@pytest.mark.parametrize("g", [8, 32, 31])
def test_restrict_modes(g):
    v = _spectrum(3, (2, 64))
    np.testing.assert_allclose(tsp.restrict_modes(torch.from_numpy(v), g).numpy(),
                               np.asarray(jsp.restrict_modes(jnp.asarray(v), g)),
                               atol=ATOL)


def test_phase_shift():
    v = _spectrum(4, (3, 64))
    k = jgrids.Grid(64).k
    offset = np.array([0.0, 0.3, -1.7])
    got = tsp.phase_shift(torch.from_numpy(v), torch.from_numpy(offset)[:, None],
                          torch.from_numpy(k))
    want = jsp.phase_shift(jnp.asarray(v), jnp.asarray(offset)[:, None], jnp.asarray(k))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_copied_numpy_helpers_match():
    for N, L in ((32, 2 * np.pi), (17, 3.0)):
        a, b = tgrids.Grid(N, L), jgrids.Grid(N, L)
        for name in ("x", "k", "k1", "k2"):
            np.testing.assert_array_equal(getattr(a, name), getattr(b, name))
        assert a.dx == b.dx
    for M, N, kind in ((32, 32, "hat"), (4, 32, "hat"), (4, 32, "uniform"), (1, 8, "hat")):
        np.testing.assert_array_equal(tbasis.make_basis(M, N, 2 * np.pi, kind),
                                      jbasis.make_basis(M, N, 2 * np.pi, kind))
    for nk in (1, 31, 511):
        for x, y in zip(tic._lcg_closed_form(nk), jic._lcg_closed_form(nk)):
            np.testing.assert_array_equal(x, y)
    x = np.linspace(0, 2 * np.pi, 64, endpoint=False)
    for seed in (42, 43):
        np.testing.assert_array_equal(tic.burger_turbulence_numpy(seed, 0.1, x, 2 * np.pi),
                                      jic.burger_turbulence_numpy(seed, 0.1, x, 2 * np.pi))
    for N, na in ((32, 32), (32, 4), (16, 1)):
        np.testing.assert_array_equal(tfeat.halo_indices(N, na), jfeat.halo_indices(N, na))
        for version in range(5):
            assert tfeat.obs_dim(version, N, na) == jfeat.obs_dim(version, N, na)
