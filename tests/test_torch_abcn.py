"""Port parity: the ABCN macro-step op (kernels/abcn.py).

On CPU tensors the op runs its plain version; it is held against the JAX
Pallas kernel run in interpret mode (float32, atol 2e-6 as
tests/test_pallas.py) and against the JAX plain reference (float64, 1e-10).
The CUDA kernel itself is checked on the card by tests/test_torch_gpu.py and
chip_smoke.py."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from marlpde_tpu.ops import abcn_pallas
from marlpde_tpu.ops import dft as jdft
from marlpde_tpu_torch.kernels import abcn

torch.set_num_threads(1)
NAMES = ["u", "u_prev", "v_re", "v_im", "fn_re", "fn_im", "ek"]


@pytest.fixture(autouse=True)
def interpret_pallas(monkeypatch):
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))


def _inputs(B, N, seed, dtype):
    """The input scales of tests/test_pallas.py, with the solver's seeded
    nonlinear-term memory fn_old = k1*fft(u^2/2) (Burger.py:320)."""
    rng = np.random.default_rng(seed)
    u = rng.standard_normal((B, N)) * 0.1
    v = np.fft.fft(u, axis=-1)
    k = np.fft.fftfreq(N, 1.0 / N)
    D = np.fft.fft(0.5 * u * u, axis=-1)
    args = dict(u=u, v_re=v.real, v_im=v.imag, fn_re=-k * D.imag, fn_im=k * D.real,
                nu=np.full((B, 1), 0.02),
                af_re=rng.standard_normal((B, N)) * 0.01,
                af_im=rng.standard_normal((B, N)) * 0.01)
    return {k_: a.astype(dtype) for k_, a in args.items()}


KW = dict(n_intermediate=10, dt=1e-3, dx=float(2 * np.pi / 32))


def test_plain_version_matches_pallas_kernel_float32():
    args = _inputs(8, 32, 0, np.float32)
    out_j = abcn_pallas.abcn_macro_step(**{k: jnp.asarray(a) for k, a in args.items()},
                                        **KW, tile_b=8)
    out_t = abcn.abcn_macro_step(**{k: torch.from_numpy(a) for k, a in args.items()}, **KW)
    for name, a, b in zip(NAMES, out_t, out_j):
        assert a.dtype == torch.float32 and np.asarray(b).dtype == np.float32
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=2e-6, err_msg=name)


@pytest.mark.parametrize("B,N", [(4, 32), (3, 16), (2, 64)])
def test_plain_version_matches_jax_reference_float64(B, N):
    args = _inputs(B, N, N, np.float64)
    kw = dict(KW, dx=float(2 * np.pi / N))
    out_j = abcn_pallas.abcn_macro_step_reference(
        **{k: jnp.asarray(a) for k, a in args.items()}, **kw)
    out_t = abcn.abcn_macro_step(**{k: torch.from_numpy(a) for k, a in args.items()}, **kw)
    for name, a, b in zip(NAMES, out_t, out_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-10, err_msg=name)
        assert a.is_contiguous()


def test_kernel_tables_follow_the_dft_convention():
    N, dx = 32, float(2 * np.pi / 32)
    tab = abcn._tables(N, dx, torch.device("cpu")).numpy()
    C, S = jdft._dft_mats(N, "float32")
    m = np.outer(np.arange(N), np.arange(N)) % N
    # equal up to the rounding of the unreduced angle near the zeros of cos/sin
    np.testing.assert_allclose(tab[0][m], C, atol=1e-7)
    np.testing.assert_allclose(tab[1][m], S, atol=1e-7)
    np.testing.assert_array_equal(
        tab[2], np.fft.fftfreq(N, (dx * N) / (2 * np.pi * N)).astype(np.float32))


def test_wrapper_rejects_what_the_kernel_does_not_take():
    args = {k: torch.from_numpy(a) for k, a in _inputs(4, 32, 1, np.float32).items()}
    bad_nu = dict(args, nu=args["nu"][:, 0])
    with pytest.raises(ValueError, match="nu"):
        abcn.abcn_macro_step(**bad_nu, **KW)
    with pytest.raises(ValueError, match="contiguous"):
        abcn.abcn_macro_step(**dict(args, u=args["u"].t().contiguous().t()), **KW)
    with pytest.raises(ValueError, match="v_re"):
        abcn.abcn_macro_step(**dict(args, v_re=args["v_re"].double()), **KW)
    with pytest.raises(ValueError, match="no kernel"):
        abcn.abcn_macro_step(**{k: a.to("meta") for k, a in args.items()}, **KW)


def test_plain_version_does_not_count_as_a_launch():
    before = abcn.launches
    args = {k: torch.from_numpy(a) for k, a in _inputs(2, 32, 2, np.float32).items()}
    abcn.abcn_macro_step(**args, **KW)
    assert abcn.launches == before
