"""marlpde_tpu_torch: the PyTorch + CUDA (Hopper) port of marlpde_tpu.

The package mirrors ``marlpde_tpu/`` file for file, so each module's
counterpart is found under the same path.  It covers the flagship slice: the
fused ``burger-marl`` training generation (whole-batch spectral Burgers LES,
VRACER in episode mode).  The two TPU kernels of that path are CUDA kernels
written for ``sm_90a`` (``csrc/``), wrapped in ``kernels/``; each wrapper runs
its plain PyTorch version on CPU tensors and launches the kernel, or raises, on
CUDA tensors.

The port imports torch and numpy only: never jax, flax, optax or marlpde_tpu.
State is dataclasses of tensors, the device is passed explicitly, and
``torch.Generator``s take the place of ``jax.random`` keys.
"""

__version__ = "0.1.0"

# tail of the NotImplementedError raised by what the slice does not cover yet
NOT_PORTED = ("is not ported to marlpde_tpu_torch yet; see ROADMAP.md queue 1 "
              "for the order of the remaining slices")
