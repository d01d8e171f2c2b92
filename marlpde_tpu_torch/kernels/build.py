"""Build the CUDA sources under ``marlpde_tpu_torch/csrc/`` and load them.

Each ``<name>.cu`` compiles with nvcc into a shared library with a plain C
interface, bound with ctypes:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -o build/marlpde_tpu_torch/lib<name>_<hash>.so <name>.cu

The library is built at first use and cached under ``build/`` at the root of
the checkout, keyed by a hash of the source and the flags, so a fresh checkout
builds everything on its first call and an edited source is rebuilt.  Nothing
is compiled while a module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "marlpde_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}
# ptxas report (registers, shared memory, spills) of each library built in
# this process, by name
build_logs: dict[str, str] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels of marlpde_tpu_torch "
                       "are built with the CUDA toolkit's nvcc")


def library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{digest.hexdigest()[:16]}.so"


def load(name: str) -> ctypes.CDLL:
    """Build (if its cached library is missing) and load ``csrc/<name>.cu``."""
    with _lock:
        if name in _loaded:
            return _loaded[name]
        so = library_path(name)
        if not so.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
            res = subprocess.run(cmd, capture_output=True, text=True)
            if res.returncode != 0:
                raise RuntimeError(f"nvcc failed for {name}.cu "
                                   f"(exit {res.returncode}):\n{res.stderr}")
            build_logs[name] = res.stderr
            os.replace(tmp, so)
        lib = ctypes.CDLL(str(so))
        _loaded[name] = lib
        return lib

