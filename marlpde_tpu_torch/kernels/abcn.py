"""ABCN macro-step op: the CUDA kernel ``csrc/abcn.cu`` and its plain version.

Port of marlpde_tpu/ops/abcn_pallas.py.  ``abcn_macro_step`` advances a batch
of envs through ``n_intermediate`` ABCN sub-steps.  On CPU tensors it runs
``abcn_macro_step_reference`` (torch.fft); on CUDA tensors it launches the
kernel or raises.  The tensor's device alone picks between them.

Real-arithmetic layout: v = v_re + i*v_im, Fn = i*k*DFT(q) so
  Fn_re = -k * DFT_im(q),  Fn_im = k * DFT_re(q)
and the Crank-Nicolson factor C = 0.5*k^2*nu*dt is real.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import numpy as np
import torch

from marlpde_tpu_torch.kernels import build

# kernel launches since the last reset; incremented only where the CUDA kernel
# is launched
launches = 0

_FIELDS = ("u", "v_re", "v_im", "fn_re", "fn_im", "af_re", "af_im")


def wavenumbers(N: int, dx: float) -> np.ndarray:
    """k = fftfreq(N, L/(2*pi*N)) with L = N*dx (abcn_pallas.py:96)."""
    return np.fft.fftfreq(N, (dx * N) / (2 * np.pi * N))


def abcn_macro_step_reference(u, v_re, v_im, fn_re, fn_im, nu, af_re, af_im,
                              *, n_intermediate: int, dt: float, dx: float):
    """Plain PyTorch version on torch.fft (abcn_pallas.py:121-141)."""
    N = u.shape[-1]
    k = torch.as_tensor(wavenumbers(N, dx), dtype=u.dtype, device=u.device)
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
    lib.abcn_macro_step.argtypes = [ptr] * 16 + [i32, i32, i32, f32, f32, ptr]
    lib.abcn_macro_step.restype = ctypes.c_int
    lib.error_string.argtypes = [ctypes.c_int]
    lib.error_string.restype = ctypes.c_char_p
    return lib


@lru_cache(maxsize=32)
def _tables(N: int, dx: float, device: torch.device) -> torch.Tensor:
    """(3, N) float32: cos and sin of -2*pi*m/N (the ops/dft.py:23-27 sign
    convention, one period), then the wavenumbers k."""
    ang = -2.0 * np.pi * np.arange(N) / N
    tab = np.stack([np.cos(ang), np.sin(ang), wavenumbers(N, dx)]).astype(np.float32)
    return torch.from_numpy(tab).to(device)


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
    tables = _tables(N, float(dx), u.device)
    with torch.cuda.device(u.device):
        status = lib.abcn_macro_step(
            *(t.data_ptr() for t in (u, v_re, v_im, fn_re, fn_im, nu, af_re, af_im,
                                     tables, *outs)),
            B, N, int(n_intermediate), float(dt), float(dx),
            torch.cuda.current_stream().cuda_stream)
    if status != 0:
        raise RuntimeError(f"abcn_macro_step: launch failed: "
                           f"{lib.error_string(status).decode()} ({status})")
    launches += 1
    return tuple(outs)
