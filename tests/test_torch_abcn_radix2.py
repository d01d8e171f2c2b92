"""The ABCN kernel's FFT schedule (kernels/abcn.py: radix2_plan, _lane_tables,
abcn_macro_step_radix2) against the JAX package.

``abcn_macro_step_radix2`` runs the CUDA kernel's stage order, lane pairs,
twiddles and bit-reversed wavenumber order in torch, reading the tables the
kernel reads.  It is held against the JAX plain reference in float64 (1e-10)
and against the Pallas kernel in interpret mode in float32 (atol 2e-6, as
tests/test_torch_abcn.py), with forcing spectra that are not Hermitian.  The
kernel itself is held against this schedule on the card
(tests/test_torch_gpu.py)."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from marlpde_tpu.ops import abcn_pallas
from marlpde_tpu_torch.kernels import abcn

torch.set_num_threads(1)
NAMES = ["u", "u_prev", "v_re", "v_im", "fn_re", "fn_im", "ek"]
KW = dict(n_intermediate=10, dt=1e-3)


@pytest.fixture(autouse=True)
def interpret_pallas(monkeypatch):
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))


def _inputs(B, N, seed, dtype, hermitian_af=False, mean=1.0, scale=0.3, af_scale=0.1):
    """A field u = mean + scale * noise, its spectrum, the solver's seeded
    fn_old (Burger.py:320) and a forcing spectrum af with independent real and
    imaginary parts (not Hermitian: Re IDFT(v) then differs from the
    real-to-complex shortcut), or the spectrum of a real forcing field."""
    rng = np.random.default_rng(seed)
    u = rng.standard_normal((B, N)) * scale + mean
    v = np.fft.fft(u, axis=-1)
    k = np.fft.fftfreq(N, 1.0 / N)
    D = np.fft.fft(0.5 * u * u, axis=-1)
    if hermitian_af:
        af = np.fft.fft(rng.standard_normal((B, N)) * af_scale, axis=-1)
    else:
        af = (rng.standard_normal((B, N)) + 1j * rng.standard_normal((B, N))) * af_scale
    args = dict(u=u, v_re=v.real, v_im=v.imag, fn_re=-k * D.imag, fn_im=k * D.real,
                nu=rng.uniform(0.01, 0.05, (B, 1)), af_re=af.real, af_im=af.imag)
    return {k_: np.ascontiguousarray(a).astype(dtype) for k_, a in args.items()}


@pytest.mark.parametrize("N", [1, 2, 4, 8, 16, 32, 64, 128, 1024])
def test_bit_reversal_is_a_permutation_and_its_own_inverse(N):
    twiddle, rev = abcn.radix2_plan(N)
    L = N.bit_length() - 1
    assert sorted(rev.tolist()) == list(range(N))
    np.testing.assert_array_equal(rev[rev], np.arange(N))
    assert all(int(format(j, f"0{L}b")[::-1] or "0", 2) == rev[j] for j in range(N))
    assert twiddle.shape == (L, N)


@pytest.mark.parametrize("N", [2, 8, 32, 64])
def test_twiddle_indices(N):
    """Stage s pairs lane j with j ^ h, h = N >> (s + 1); an upper lane's index
    is (j mod h) * N / (2h), a lower lane's 0 (the factor 1)."""
    twiddle, _ = abcn.radix2_plan(N)
    for s in range(N.bit_length() - 1):
        h = N >> (s + 1)
        for j in range(N):
            assert twiddle[s, j] == ((j % h) * (N // (2 * h)) if j & h else 0), (s, j)
            assert 0 <= twiddle[s, j] < N and (j ^ h) < N


@pytest.mark.parametrize("N", [4, 32])
def test_lane_tables_are_what_the_plan_indexes(N):
    dx = float(2 * np.pi / N)
    lanes, rev = abcn._lane_tables(N, dx, torch.device("cpu"))
    tab = abcn._tables(N, dx, torch.device("cpu"))
    twiddle, rev_np = abcn.radix2_plan(N)
    L = twiddle.shape[0]
    assert lanes.dtype == torch.float32 and rev.dtype == torch.int32
    assert lanes.shape == (2 * L + 1, N) and lanes.is_contiguous()
    np.testing.assert_array_equal(rev.numpy(), rev_np)
    np.testing.assert_array_equal(lanes[:L].numpy(), tab[0].numpy()[twiddle])
    np.testing.assert_array_equal(lanes[L:2 * L].numpy(), tab[1].numpy()[twiddle])
    np.testing.assert_array_equal(lanes[2 * L].numpy(), tab[2].numpy()[rev_np])
    # twiddle factor 1 on the lower lanes
    lower = twiddle == 0
    assert (lanes[:L].numpy()[lower] == 1.0).all()
    assert (lanes[L:2 * L].numpy()[lower] == 0.0).all()


@pytest.mark.parametrize("hermitian_af", [False, True], ids=["af-free", "af-of-real-field"])
@pytest.mark.parametrize("N", [2, 4, 8, 16, 32, 64])
def test_radix2_schedule_matches_jax_reference_float64(N, hermitian_af):
    args = _inputs(3, N, N, np.float64, hermitian_af)
    kw = dict(KW, dx=float(2 * np.pi / N))
    out_j = abcn_pallas.abcn_macro_step_reference(
        **{k: jnp.asarray(a) for k, a in args.items()}, **kw)
    out_t = abcn.abcn_macro_step_radix2(**{k: torch.from_numpy(a) for k, a in args.items()},
                                        **kw)
    for name, a, b in zip(NAMES, out_t, out_j):
        assert a.dtype == torch.float64 and a.is_contiguous()
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-10, err_msg=name)


def test_radix2_schedule_at_the_largest_n_float64():
    args = _inputs(2, 1024, 7, np.float64)
    kw = dict(KW, dx=float(2 * np.pi / 1024))
    out_j = abcn_pallas.abcn_macro_step_reference(
        **{k: jnp.asarray(a) for k, a in args.items()}, **kw)
    out_t = abcn.abcn_macro_step_radix2(**{k: torch.from_numpy(a) for k, a in args.items()},
                                        **kw)
    for name, a, b in zip(NAMES, out_t, out_j):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, atol=1e-10 * max(1.0, np.abs(b).max()),
                                   err_msg=name)


@pytest.mark.parametrize("B,N", [(8, 32), (8, 16), (16, 8)])
def test_radix2_schedule_matches_pallas_kernel_float32(B, N):
    """At the input scales of tests/test_pallas.py, where atol 2e-6 is its
    tolerance."""
    args = _inputs(B, N, B + N, np.float32, mean=0.0, scale=0.1, af_scale=0.01)
    kw = dict(KW, dx=float(2 * np.pi / N))
    out_j = abcn_pallas.abcn_macro_step(**{k: jnp.asarray(a) for k, a in args.items()},
                                        **kw, tile_b=8)
    out_t = abcn.abcn_macro_step_radix2(**{k: torch.from_numpy(a) for k, a in args.items()},
                                        **kw)
    for name, a, b in zip(NAMES, out_t, out_j):
        assert a.dtype == torch.float32
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=2e-6, err_msg=name)


def test_non_hermitian_forcing_reaches_the_nyquist_mode():
    """With independent af_re/af_im the field's spectrum stops being Hermitian
    after one sub-step, and fn at the Nyquist wavenumber (k = -N/2) is purely
    imaginary: a real-to-complex shortcut would get both wrong; the schedule
    does not."""
    N = 32
    args = {k: torch.from_numpy(a) for k, a in _inputs(2, N, 3, np.float64).items()}
    kw = dict(KW, dx=float(2 * np.pi / N))
    u, _, v_re, v_im, fn_re, fn_im, _ = abcn.abcn_macro_step_radix2(**args, **kw)
    ref = abcn.abcn_macro_step_reference(**args, **kw)
    v = torch.complex(v_re, v_im)
    mirrored = torch.conj(v[:, (-torch.arange(N)) % N])
    assert (v - mirrored).abs().max() > 1e-3                 # not Hermitian
    assert fn_re[:, N // 2].abs().max() < 1e-12 < fn_im[:, N // 2].abs().max()
    for a, b in zip((u, v_re, v_im, fn_re, fn_im), (ref[0], *ref[2:6])):
        torch.testing.assert_close(a, b, atol=1e-12, rtol=0)


def test_radix2_schedule_is_not_a_launch():
    before = abcn.launches
    args = {k: torch.from_numpy(a) for k, a in _inputs(2, 32, 2, np.float32).items()}
    abcn.abcn_macro_step_radix2(**args, **KW, dx=0.2)
    assert abcn.launches == before
