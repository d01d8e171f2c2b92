"""ABCN macro-step op: the CUDA kernel ``csrc/abcn.cu`` and its plain version.

Port of marlpde_tpu/ops/abcn_pallas.py.  ``abcn_macro_step`` advances a batch
of envs through ``n_intermediate`` ABCN sub-steps.  On CPU tensors it runs
``abcn_macro_step_reference`` (torch.fft); on CUDA tensors it launches the
kernel or raises.  The tensor's device alone picks between them.

Real-arithmetic layout: v = v_re + i*v_im, Fn = i*k*DFT(q) so
  Fn_re = -k * DFT_im(q),  Fn_im = k * DFT_re(q)
and the Crank-Nicolson factor C = 0.5*k^2*nu*dt is real.

The kernel transforms by radix-2 FFTs across the lanes of an env.
``radix2_plan`` is its schedule (which lane pairs with which at each stage,
each lane's twiddle, the bit-reversal map), ``_lane_tables`` what it reads,
and ``abcn_macro_step_radix2`` runs that schedule in torch, for the tests.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import numpy as np
import torch

from marlpde_tpu_torch.device import constant
from marlpde_tpu_torch.kernels import build
from marlpde_tpu_torch.utils import profiling

# kernel launches since the last reset; incremented only where the CUDA kernel
# is launched (the tracer also counts them by shape: launches/<kernel> <shape>)
launches = 0

_FIELDS = ("u", "v_re", "v_im", "fn_re", "fn_im", "af_re", "af_im")


def wavenumbers(N: int, dx: float) -> np.ndarray:
    """k = fftfreq(N, L/(2*pi*N)) with L = N*dx (abcn_pallas.py:96)."""
    return np.fft.fftfreq(N, (dx * N) / (2 * np.pi * N))


def abcn_macro_step_reference(u, v_re, v_im, fn_re, fn_im, nu, af_re, af_im,
                              *, n_intermediate: int, dt: float, dx: float):
    """Plain PyTorch version on torch.fft (abcn_pallas.py:121-141)."""
    N = u.shape[-1]
    k = constant(wavenumbers, N, dx, dtype=u.dtype, device=u.device)
    Cc = 0.5 * (k * k) * nu * dt
    inv = 1.0 / (1.0 + Cc)
    ek = torch.zeros_like(u)
    u_prev = u
    for _ in range(n_intermediate):
        u_prev = u
        q = 0.5 * u * u
        d = torch.fft.fft(q, dim=-1)
        new_fn_re = -k * d.imag
        new_fn_im = k * d.real
        v_re = ((1.0 - Cc) * v_re - 0.5 * dt * (3.0 * new_fn_re - fn_re) + dt * af_re) * inv
        v_im = ((1.0 - Cc) * v_im - 0.5 * dt * (3.0 * new_fn_im - fn_im) + dt * af_im) * inv
        fn_re, fn_im = new_fn_re, new_fn_im
        u = torch.fft.ifft(torch.complex(v_re, v_im), dim=-1).real.contiguous()
        ek = ek + 0.5 * (v_re**2 + v_im**2) / N * dx
    return u, u_prev, v_re, v_im, fn_re, fn_im, ek


@lru_cache(maxsize=None)
def _library():
    lib = build.load("abcn")
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.abcn_macro_step.argtypes = [ptr] * 17 + [i32, i32, i32, f32, f32, ptr]
    lib.abcn_macro_step.restype = ctypes.c_int
    lib.error_string.argtypes = [ctypes.c_int]
    lib.error_string.restype = ctypes.c_char_p
    return lib


@lru_cache(maxsize=32)
def _tables(N: int, dx: float, device: torch.device, dtype=torch.float32) -> torch.Tensor:
    """(3, N): cos and sin of -2*pi*m/N (the ops/dft.py:23-27 sign
    convention, one period), then the wavenumbers k; computed in float64 and
    rounded to ``dtype``."""
    ang = -2.0 * np.pi * np.arange(N) / N
    tab = np.stack([np.cos(ang), np.sin(ang), wavenumbers(N, dx)])
    return torch.from_numpy(tab).to(dtype).to(device)


@lru_cache(maxsize=None)
def radix2_plan(N: int) -> tuple[np.ndarray, np.ndarray]:
    """The kernel's FFT schedule for N = 2**L: (twiddle, rev).

    Lane j of an env holds grid point j.  Stage s = 0 .. L-1 of the forward
    transform (decimation in frequency) pairs lane j with lane j ^ h,
    h = N >> (s + 1): the lower lane (j & h == 0) keeps x_j + x_partner, the
    upper one (x_partner - x_j) * w, w = exp(-2*pi*i * twiddle[s, j] / N), with
    twiddle[s, j] = (j mod h) * N / (2h) on an upper lane and 0 (w = 1) on a
    lower one.  Lane j then holds wavenumber rev[j], the bit reversal of j over
    L bits.  The inverse (decimation in time) runs the stages in reverse order
    with the conjugate twiddles and ends in natural order."""
    if N < 1 or N & (N - 1):
        raise ValueError(f"radix2_plan: N must be a power of two, got {N}")
    L = N.bit_length() - 1
    j = np.arange(N)
    twiddle = np.zeros((L, N), np.int64)
    rev = np.zeros(N, np.int64)
    for s in range(L):
        h = N >> (s + 1)
        twiddle[s] = np.where(j & h, (j % h) * (N // (2 * h)), 0)
        rev |= ((j >> s) & 1) << (L - 1 - s)
    return twiddle, rev


@lru_cache(maxsize=None)       # unbounded: a CUDA graph reads these by address
def _lane_tables(N: int, dx: float, device: torch.device, dtype=torch.float32):
    """What the kernel reads besides the fields: a (2L + 1, N) table of lane
    j's twiddle at each stage, cos rows then sin rows, taken from the
    one-period tables at ``radix2_plan``'s indices, then k at rev[j]; and
    rev as int32."""
    twiddle, rev = radix2_plan(N)
    tab = _tables(N, dx, torch.device("cpu"), dtype)
    tw, rv = torch.from_numpy(twiddle), torch.from_numpy(rev)
    lanes = torch.cat([tab[0][tw], tab[1][tw], tab[2][rv][None]])
    return lanes.to(device), rv.to(torch.int32).to(device)


def abcn_macro_step_radix2(u, v_re, v_im, fn_re, fn_im, nu, af_re, af_im,
                           *, n_intermediate: int, dt: float, dx: float):
    """The CUDA kernel's schedule in torch, step for step: the stage order,
    lane pairs, twiddles and bit-reversed wavenumber order of ``radix2_plan``
    read from ``_lane_tables``.  The oracle of the kernel's bookkeeping, used
    by the tests only; same arguments and outputs as
    ``abcn_macro_step_reference``."""
    N = u.shape[-1]
    L = N.bit_length() - 1
    lanes, rev = _lane_tables(N, float(dx), u.device, u.dtype)
    rev = rev.long()
    cos_t, sin_t, k = lanes[:L], lanes[L:2 * L], lanes[2 * L]
    j = torch.arange(N, device=u.device)
    # (partner, upper) of each stage, h = N >> (s + 1)
    pairs = [(j ^ (N >> (s + 1)), (j & (N >> (s + 1))) != 0) for s in range(L)]
    # lane j holds wavenumber rev[j]
    v_re, v_im, fn_re, fn_im, af_re, af_im = (t[:, rev] for t in
                                              (v_re, v_im, fn_re, fn_im, af_re, af_im))
    Cc = 0.5 * (k * k) * nu * dt
    inv = 1.0 / (1.0 + Cc)
    ek = torch.zeros_like(u)
    u_prev = u
    for _ in range(n_intermediate):
        u_prev = u
        x_re, x_im = 0.5 * u * u, torch.zeros_like(u)
        for s, (partner, upper) in enumerate(pairs):           # forward, h = N/2 .. 1
            p_re, p_im = x_re[:, partner], x_im[:, partner]
            d_re = torch.where(upper, p_re - x_re, x_re + p_re)
            d_im = torch.where(upper, p_im - x_im, x_im + p_im)
            x_re = d_re * cos_t[s] - d_im * sin_t[s]
            x_im = d_re * sin_t[s] + d_im * cos_t[s]
        new_fn_re = -k * x_im
        new_fn_im = k * x_re
        v_re = ((1.0 - Cc) * v_re - 0.5 * dt * (3.0 * new_fn_re - fn_re) + dt * af_re) * inv
        v_im = ((1.0 - Cc) * v_im - 0.5 * dt * (3.0 * new_fn_im - fn_im) + dt * af_im) * inv
        fn_re, fn_im = new_fn_re, new_fn_im
        ek = ek + 0.5 * (v_re**2 + v_im**2) / N * dx
        x_re, x_im = v_re, v_im
        for s in reversed(range(L)):                           # inverse, h = 1 .. N/2
            partner, upper = pairs[s]
            y_re = x_re * cos_t[s] + x_im * sin_t[s]
            y_im = x_im * cos_t[s] - x_re * sin_t[s]
            p_re, p_im = y_re[:, partner], y_im[:, partner]
            x_re = torch.where(upper, p_re - y_re, y_re + p_re)
            x_im = torch.where(upper, p_im - y_im, y_im + p_im)
        u = x_re / N
    # back to natural order: rev is its own inverse
    return (u, u_prev, *(t[:, rev] for t in (v_re, v_im, fn_re, fn_im, ek)))


def _check(fields, nu):
    u = fields[0]
    if u.ndim != 2:
        raise ValueError(f"abcn_macro_step: u must be (B, N), got {tuple(u.shape)}")
    for name, t in zip(_FIELDS, fields):
        if t.shape != u.shape or t.dtype != u.dtype or t.device != u.device:
            raise ValueError(f"abcn_macro_step: {name} is {tuple(t.shape)} {t.dtype} "
                             f"on {t.device}; expected {tuple(u.shape)} {u.dtype} on {u.device}")
        if not t.is_contiguous():
            raise ValueError(f"abcn_macro_step: {name} is not contiguous")
    if nu.shape != (u.shape[0], 1) or nu.dtype != u.dtype or nu.device != u.device:
        raise ValueError(f"abcn_macro_step: nu is {tuple(nu.shape)} {nu.dtype} on "
                         f"{nu.device}; expected ({u.shape[0]}, 1) {u.dtype} on {u.device}")
    if not nu.is_contiguous():
        raise ValueError("abcn_macro_step: nu is not contiguous")
    if not u.dtype.is_floating_point:
        raise TypeError(f"abcn_macro_step: floating inputs required, got {u.dtype}")


def abcn_macro_step(u, v_re, v_im, fn_re, fn_im, nu, af_re, af_im,
                    *, n_intermediate: int, dt: float, dx: float):
    """Fused macro-step over a batch of envs.

    u, v_*, fn_*, af_*: (B, N); nu: (B, 1); all contiguous, one dtype, one
    device.  Returns (u, u_prev, v_re, v_im, fn_re, fn_im, ek_sum_delta) with
    u_prev the field before the last sub-step (the env's dudt feature,
    Burger.py:616-621).  CUDA tensors must be float32 with N a power of two
    up to 1024.
    """
    global launches
    fields = (u, v_re, v_im, fn_re, fn_im, af_re, af_im)
    _check(fields, nu)
    kw = dict(n_intermediate=n_intermediate, dt=dt, dx=dx)
    if u.device.type == "cpu":
        return abcn_macro_step_reference(u, v_re, v_im, fn_re, fn_im, nu,
                                         af_re, af_im, **kw)
    if u.device.type != "cuda":
        raise ValueError(f"abcn_macro_step: no kernel for device {u.device}")
    if u.dtype != torch.float32:
        raise TypeError(f"abcn_macro_step: the CUDA kernel takes float32, got {u.dtype}")
    B, N = u.shape
    if B == 0 or N > 1024 or N & (N - 1):
        raise ValueError(f"abcn_macro_step: the CUDA kernel takes B >= 1 and N a "
                         f"power of two up to 1024, got B={B}, N={N}")
    lib = _library()
    outs = [torch.empty_like(u) for _ in range(7)]
    lanes, rev = _lane_tables(N, float(dx), u.device)
    with torch.cuda.device(u.device):
        status = lib.abcn_macro_step(
            *(t.data_ptr() for t in (u, v_re, v_im, fn_re, fn_im, nu, af_re, af_im,
                                     lanes, rev, *outs)),
            B, N, int(n_intermediate), float(dt), float(dx),
            torch.cuda.current_stream().cuda_stream)
    if status != 0:
        raise RuntimeError(f"abcn_macro_step: launch failed: "
                           f"{lib.error_string(status).decode()} ({status})")
    launches += 1
    profiling.count(f"launches/abcn {B}x{N}x{int(n_intermediate)}")
    return tuple(outs)
