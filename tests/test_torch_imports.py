"""The port imports nothing of JAX and nothing of the JAX package: in a fresh
interpreter where ``import jax`` and ``import marlpde_tpu`` fail, every module
of marlpde_tpu_torch (``parallel/`` too) and chip_smoke.py import."""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

GUARD = """
import importlib, pkgutil, sys
for name in ("jax", "jaxlib", "flax", "optax", "marlpde_tpu"):
    sys.modules[name] = None          # any import of them raises ImportError
import marlpde_tpu_torch
names = sorted(m.name for m in pkgutil.walk_packages(marlpde_tpu_torch.__path__,
                                                      "marlpde_tpu_torch."))
for name in names + ["chip_smoke"]:
    importlib.import_module(name)
assert {"marlpde_tpu_torch.parallel.mesh", "marlpde_tpu_torch.parallel.dryrun"} <= set(names)
leaked = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax")
                and sys.modules[m] is not None)
assert not leaked, leaked
print(len(names))
"""


def test_port_and_chip_smoke_import_without_jax():
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", GUARD], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    # every subpackage and module of the port was imported
    assert int(out.stdout.split()[-1]) >= 30
