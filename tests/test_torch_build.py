"""The kernel build layer on the CPU, with a stand-in for nvcc: ``build_all``
starts one compiler per missing source at once, keeps each ptxas report,
reuses the hash-keyed cache, and names the source that failed."""

import time

import pytest

from marlpde_tpu_torch.kernels import build

FAKE_NVCC = """#!/bin/sh
src=""; out=""
while [ $# -gt 0 ]; do
  case "$1" in -o) out="$2"; shift;; *.cu) src="$1";; esac
  shift
done
sleep 1
if grep -q BROKEN "$src"; then echo "error in $src" >&2; exit 2; fi
echo "ptxas info    : Used 8 registers" >&2
: > "$out"
"""


@pytest.fixture
def fake_build(tmp_path, monkeypatch):
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(FAKE_NVCC)
    nvcc.chmod(0o755)
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    monkeypatch.setattr(build, "CSRC", csrc)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(build, "_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(build, "build_logs", {})
    return csrc


def test_build_all_compiles_in_parallel_then_reuses_the_cache(fake_build):
    names = ("a", "b", "c")
    for n in names:
        (fake_build / f"{n}.cu").write_text(f"// kernel {n}\n")
    t0 = time.perf_counter()
    build.build_all(names)
    took = time.perf_counter() - t0
    assert took < 2.5, f"three 1 s compiles took {took:.2f} s: not started together"
    assert all(build.library_path(n).exists() for n in names)
    assert set(build.build_logs) == set(names)
    assert all("Used 8 registers" in log for log in build.build_logs.values())
    assert not list(build.BUILD_DIR.glob("*.tmp"))
    t0 = time.perf_counter()
    build.build_all(names)                       # cached: nothing to compile
    assert time.perf_counter() - t0 < 0.5
    (fake_build / "b.cu").write_text("// kernel b, edited\n")
    assert not build.library_path("b").exists()  # an edited source builds anew


def test_build_all_names_the_source_that_failed(fake_build):
    (fake_build / "good.cu").write_text("// fine\n")
    (fake_build / "bad.cu").write_text("// BROKEN\n")
    with pytest.raises(RuntimeError, match=r"nvcc failed for bad\.cu \(exit 2\)"):
        build.build_all(("good", "bad"))
    assert build.library_path("good").exists() and not build.library_path("bad").exists()
