"""Policy-MLP acting forward op: the CUDA kernel ``csrc/mlp.cu`` and its plain
version.

Port of marlpde_tpu/ops/mlp_pallas.py.  ``mlp_forward(obs, net)`` returns
``net(obs)`` for a two-hidden-layer ``VracerNet``: on CPU tensors by calling
the module (the plain version), on CUDA tensors by launching the kernel, or
raising.  The tensor's device alone picks between them.  The kernel computes
the full acting forward, including the sigma cap's forward value and the
``sigma_relative`` mean; the losses differentiate the module itself, so the
op needs no backward.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import torch

from marlpde_tpu_torch.kernels import build

# kernel launches since the last reset; incremented only where the CUDA kernel
# is launched
launches = 0

MAX_WIDTH = 256     # csrc/mlp.cu kMaxWidth: 4 * width threads, at most 1024 a block


@lru_cache(maxsize=None)
def _library():
    lib = build.load("mlp")
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.mlp_forward.argtypes = [ptr] * 14 + [i32] * 4 + [f32] * 3 + [i32, ptr]
    lib.mlp_forward.restype = ctypes.c_int
    lib.error_string.argtypes = [ctypes.c_int]
    lib.error_string.restype = ctypes.c_char_p
    return lib


def mlp_forward(obs, net):
    """obs (R, obs_dim) -> (V (R,), mu (R, A), sigma (R, A)) of ``net``."""
    global launches
    if obs.ndim != 2 or obs.shape[1] != net.obs_dim:
        raise ValueError(f"mlp_forward: obs must be (R, {net.obs_dim}), got {tuple(obs.shape)}")
    params = [t for lin in net.layers() for t in (lin.weight, lin.bias)]
    for t in params:
        if t.device != obs.device or t.dtype != obs.dtype:
            raise ValueError(f"mlp_forward: parameter {t.dtype} on {t.device} does not "
                             f"match obs {obs.dtype} on {obs.device}")
    if obs.device.type == "cpu":
        return net(obs)
    if obs.device.type != "cuda":
        raise ValueError(f"mlp_forward: no kernel for device {obs.device}")
    if obs.dtype != torch.float32:
        raise TypeError(f"mlp_forward: the CUDA kernel takes float32, got {obs.dtype}")
    R, D = obs.shape
    W, A = net.width, net.act_dim
    if net.n_hidden != 2 or W % 32 or not 32 <= W <= MAX_WIDTH or R == 0:
        raise ValueError(f"mlp_forward: the CUDA kernel takes n_hidden=2, a width that "
                         f"is a multiple of 32 up to {MAX_WIDTH}, and R >= 1; got "
                         f"n_hidden={net.n_hidden}, width={W}, R={R}")
    if not obs.is_contiguous() or not all(t.is_contiguous() for t in params):
        raise ValueError("mlp_forward: obs and parameters must be contiguous")
    lib = _library()
    V = torch.empty(R, dtype=obs.dtype, device=obs.device)
    mu = torch.empty(R, A, dtype=obs.dtype, device=obs.device)
    sigma = torch.empty(R, A, dtype=obs.dtype, device=obs.device)
    with torch.cuda.device(obs.device):
        status = lib.mlp_forward(
            obs.data_ptr(), *(t.data_ptr() for t in params),
            V.data_ptr(), mu.data_ptr(), sigma.data_ptr(), R, D, W, A,
            net.sigma_scale, net.sigma_floor, float(net.sigma_max),
            int(net.mu_param == "sigma_relative"),
            torch.cuda.current_stream().cuda_stream)
    if status != 0:
        raise RuntimeError(f"mlp_forward: launch failed: "
                           f"{lib.error_string(status).decode()} ({status})")
    launches += 1
    return V, mu, sigma
