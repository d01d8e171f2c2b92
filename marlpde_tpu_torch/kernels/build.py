"""Build the CUDA sources under ``marlpde_tpu_torch/csrc/`` and load them.

Each ``<name>.cu`` compiles with nvcc into a shared library with a plain C
interface, bound with ctypes:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -o build/marlpde_tpu_torch/lib<name>_<hash>.so <name>.cu

The library is built at first use and cached under ``build/`` at the root of
the checkout, keyed by a hash of the source, every header under ``csrc/`` and
the flags, so a fresh checkout builds everything on its first call and an
edited source or header is rebuilt.  Nothing is compiled while a module is
imported.  ``build_all`` starts one nvcc per missing source at once, so a
cold checkout pays for the slowest source only.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

from marlpde_tpu_torch.utils import profiling

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
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.name.encode() + header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{digest.hexdigest()[:16]}.so"


def _compile(names) -> None:
    """Start one nvcc for each source whose cached library is missing, all at
    once, then wait for every one of them.  The caller holds ``_lock``."""
    jobs = []
    for name in names:
        so = library_path(name)
        if so.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        jobs.append((name, so, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    failed = []
    for name, so, tmp, proc in jobs:
        _, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name}.cu (exit {proc.returncode}):\n{err}")
            continue
        build_logs[name] = err
        os.replace(tmp, so)
    if failed:
        raise RuntimeError("\n".join(failed))


def build_all(names) -> None:
    """Build the missing libraries of ``csrc/<name>.cu`` for every name, in
    parallel (one nvcc each); ``load`` then only loads them."""
    with _lock, profiling.span("setup.kernels", attr=",".join(names)):
        _compile(names)


def load(name: str) -> ctypes.CDLL:
    """Build (if its cached library is missing) and load ``csrc/<name>.cu``:
    a ``setup.kernels`` span of the tracer, once a library and process."""
    with _lock:
        if name in _loaded:
            return _loaded[name]
        with profiling.span("setup.kernels", attr=name):
            _compile([name])
            lib = ctypes.CDLL(str(library_path(name)))
        _loaded[name] = lib
        return lib
