"""The kernel build layer on the CPU, with a stand-in for nvcc: ``build_all``
starts one compiler per missing source at once, keeps each ptxas report,
reuses the hash-keyed cache (rebuilding after an edit of the source or of a
header under ``csrc/``), and names the source that failed."""

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


def test_an_edited_header_builds_anew(fake_build):
    """A header under csrc/ (the MLP kernel includes wgmma_tf32.cuh) is part of
    every library's cache key."""
    (fake_build / "k.cu").write_text('#include "common.cuh"\n')
    (fake_build / "common.cuh").write_text("// v1\n")
    build.build_all(("k",))
    first = build.library_path("k")
    assert first.exists()
    (fake_build / "common.cuh").write_text("// v2\n")
    second = build.library_path("k")
    assert second != first and not second.exists()
    build.build_all(("k",))
    assert second.exists()
    (fake_build / "other.cuh").write_text("// a new header\n")
    assert build.library_path("k") not in (first, second)
