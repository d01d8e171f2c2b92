"""Device resolution and float32 matmul precision for the port.

A float32 matmul on the card runs in full float32 only while TF32 is off, and
cuDNN enables TF32 by default; the JAX reference computes in full float32, so
both switches are set explicitly before any work is placed on a device.

The CLI's --bf16 (the JAX CLI's ``jax_default_matmul_precision="bfloat16"``,
marlpde_tpu/run.py:436-438) lowers the library matmuls of one run to the
nearest that torch offers: ``reduced_matmul_precision`` sets float32 matmul
precision "medium" on the card (cuBLAS may take TF32 for it) and turns both
TF32 switches on, keeps them on through every ``resolve_device`` of the run,
and restores what was set before when the run ends.  On the CPU it turns the
switches on but keeps float32 matmuls exact, as XLA:CPU ignores the JAX flag.
The MLP kernel is unaffected: it runs layer 2 in 3xTF32 either way.
"""

from __future__ import annotations

import contextlib
import functools

import torch

# inside reduced_matmul_precision: the run asked for --bf16
_reduced = False


def set_float32_precision() -> None:
    """Full float32 matmuls on the card, unless a --bf16 run is under way."""
    if _reduced:
        return
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def reduced() -> bool:
    """Whether the library matmuls run at reduced precision now (--bf16)."""
    return _reduced


@contextlib.contextmanager
def reduced_matmul_precision(device: torch.device):
    """The --bf16 precision for the run on ``device``, restored on exit."""
    global _reduced
    saved = (_reduced, torch.get_float32_matmul_precision(), torch.backends.cudnn.allow_tf32)
    torch.set_float32_matmul_precision("medium" if device.type == "cuda" else "high")
    torch.backends.cudnn.allow_tf32 = True
    _reduced = True
    try:
        yield
    finally:
        _reduced = saved[0]
        torch.set_float32_matmul_precision(saved[1])
        torch.backends.cudnn.allow_tf32 = saved[2]
        set_float32_precision()


@functools.lru_cache(maxsize=None)
def constant(make, *args, dtype=None, device=None) -> torch.Tensor:
    """``torch.as_tensor(make(*args), dtype=dtype, device=device)``, made once
    per arguments (hashable: configs, grids, ints).  The env steps take the
    constants they build with numpy (bases, grids, wavenumbers) from here: a
    CUDA graph can capture no host-to-device copy, and it reads a constant at
    the address it saw, so the cache is unbounded and frees none of them."""
    return torch.as_tensor(make(*args), dtype=dtype, device=device)


def grid_array(grid, name: str, dtype, device) -> torch.Tensor:
    """``grid.<name>`` (``x``, ``k``, ``k1``, ``k2``) as a ``constant``."""
    return constant(getattr, grid, name, dtype=dtype, device=device)


def resolve_device(device=None) -> torch.device:
    """``None`` means the card.  Without one it raises, as does a CUDA device
    asked for by name: nothing moves to the CPU quietly.  A caller that wants
    the CPU passes ``device="cpu"``."""
    set_float32_precision()
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("torch.cuda is not available: the port runs on the card; "
                               'pass device="cpu" to run on the CPU')
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but torch.cuda is not available")
    return device
