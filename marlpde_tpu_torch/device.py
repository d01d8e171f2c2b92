"""Device resolution and float32 matmul precision for the port.

A float32 matmul on the card runs in full float32 only while TF32 is off, and
cuDNN enables TF32 by default; the JAX reference computes in full float32, so
both switches are set explicitly before any work is placed on a device.
"""

from __future__ import annotations

import torch


def set_float32_precision() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


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
