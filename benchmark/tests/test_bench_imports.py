"""Nothing the benchmark runs imports JAX or the JAX package, by the whole
top-level name of every module; the reference imports nothing of the port."""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


def load_run():
    import importlib.util
    spec = importlib.util.spec_from_file_location("bench_run_script", BENCH / "run.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("modules, found", [
    (["marlpde_tpu_torch", "marlpde_tpu_torch.rl.vracer"], []),
    (["marlpde_tpu.rl.vracer"], ["marlpde_tpu"]),
    (["jax", "jax.numpy", "jaxlib.xla_client"], ["jax", "jaxlib"]),
    (["flax.linen", "optax"], ["flax", "optax"]),
    (["jaxtyping", "marlpde_tpu_tools", "jax_like"], []),
])
def test_forbidden_modules_by_whole_top_level_name(modules, found):
    assert load_run().forbidden_modules(modules) == found


def _modules_after(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + "\nimport json, sys\n"
                          "print(json.dumps(sorted(sys.modules)))"],
                         capture_output=True, text=True, cwd=ROOT, check=True,
                         env={"PYTHONPATH": f"{BENCH}:{ROOT}", "PATH": "/usr/bin:/bin"})
    return {m.split(".")[0] for m in json.loads(out.stdout.strip().splitlines()[-1])}


def test_harness_and_port_import_no_jax():
    code = ("import bench_session, bench_check, bench_faults, bench_trace, yardstick\n"
            "import bench_spec\n"
            "for kind in ('runners', 'metrics'):\n"
            "    for p in sorted((bench_spec.HERE / kind).glob('*.py')):\n"
            "        bench_spec.load_module(kind, p.stem)\n"
            "from marlpde_tpu_torch import run\n"
            "from marlpde_tpu_torch.train import trainer\n")
    top = _modules_after(code)
    assert not top & {"jax", "jaxlib", "flax", "optax", "marlpde_tpu"}
    assert "marlpde_tpu_torch" in top


def test_reference_imports_nothing_of_the_port():
    code = ("import bench_check, yardstick\n"
            "from reference.envs import burger_abcn, ks_etdrk4\n"
            "from reference.learner import vracer, replay, replay_flat\n")
    top = _modules_after(code)
    assert not top & {"marlpde_tpu_torch", "marlpde_tpu", "jax", "jaxlib", "flax"}


def test_reference_sources_import_no_program_module():
    import ast
    for path in (BENCH / "reference").rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            assert not any(n.split(".")[0].startswith("marlpde_tpu") for n in names), path
