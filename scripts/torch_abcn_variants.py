"""Time the port's ABCN kernel (marlpde_tpu_torch/csrc/abcn.cu) against
variants of itself and against an earlier design, on one NVIDIA card.

    git show <rev>:marlpde_tpu_torch/csrc/abcn.cu > build/abcn_baseline.cu
    python3 scripts/torch_abcn_variants.py --baseline build/abcn_baseline.cu

Each variant is the committed source with text substituted (the forward
transform left out, the inverse left out, both, an empty kernel body), built
by its own nvcc into build/abcn_variants/: a way to see what the time is
made of, not a switch of the kernel.  ``--baseline`` adds the first design
(the direct-DFT kernel, whose C function takes the one-period (3, N) table).
Every library is timed with chip_smoke.median_ms (CUDA events while a spin
kernel holds the stream, median of 25 calls) in rounds whose order reverses
each time, at B=1024 and B=10 (N=32, 10 sub-steps, the fused flagship's and
the run-918 CLI's batches), B=1024 at N=64 and B=64 at N=1024; the committed
kernel also at n_intermediate 0, 1, 2, 5, 10 and 20.  Prints the card, then
one line per shape with each library's median over the rounds, in ms.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
from chip_smoke import median_ms  # noqa: E402
from marlpde_tpu_torch.kernels import abcn, build  # noqa: E402

OUT = os.path.join(ROOT, "build", "abcn_variants")
FWD = "const float2 d = forward_fft<LOG2N>(0.5f * u * u, 0.5f * uh * uh, tc, ts, j, buf, parity);"
INV = "const float2 x = inverse_fft<LOG2N>(v_re, v_im, tc, ts, j, buf, parity);"
BODY = "  constexpr int N = 1 << LOG2N;\n  constexpr int THREADS"
NO_FWD = (FWD, "const float2 d = make_float2(0.5f * u * u, 0.5f * uh * uh);")
NO_INV = (INV, "const float2 x = make_float2(v_re + v_im, v_re - v_im);")
VARIANTS = {
    "kernel": [],
    "forward only": [NO_INV],
    "inverse only": [NO_FWD],
    "no transform": [NO_FWD, NO_INV],
    "empty kernel": [(BODY, "  if (p.B > 0) return;\n" + BODY)],
}
SHAPES = [(1024, 32), (10, 32), (1024, 64), (64, 1024)]


def build_libraries(baseline):
    """One nvcc per library, all started at once; returns {name: (lib, interface)}."""
    src = open(build.CSRC / "abcn.cu").read()
    os.makedirs(OUT, exist_ok=True)
    sources = {}
    for i, (name, subs) in enumerate(VARIANTS.items()):
        text = src
        for a, b in subs:
            if a not in text:
                raise RuntimeError(f"variant {name!r}: {a!r} is not in csrc/abcn.cu")
            text = text.replace(a, b)
        sources[name] = (os.path.join(OUT, f"variant{i}.cu"), text, "lanes")
    if baseline:
        sources["baseline"] = (os.path.join(OUT, "baseline.cu"), open(baseline).read(), "table")
    jobs = {}
    for name, (cu, text, interface) in sources.items():
        with open(cu, "w") as f:
            f.write(text)
        so = cu[:-3] + ".so"
        jobs[name] = (so, interface, subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-o", so, cu],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    libs = {}
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    for name, (so, interface, proc) in jobs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{err}")
        lib = ctypes.CDLL(so)
        n_ptr = 17 if interface == "lanes" else 16
        lib.abcn_macro_step.argtypes = [ptr] * n_ptr + [i32, i32, i32, f32, f32, ptr]
        libs[name] = (lib, interface)
    return libs


def inputs(B, N, seed):
    g = torch.Generator().manual_seed(seed)
    u = torch.randn(B, N, generator=g) * 0.5 + 1.0
    v, D = torch.fft.fft(u), torch.fft.fft(0.5 * u * u)
    k = torch.fft.fftfreq(N, 1.0 / N)
    args = [u, v.real, v.imag, -k * D.imag, k * D.real, torch.full((B, 1), 0.02),
            torch.randn(B, N, generator=g) * 0.1, torch.randn(B, N, generator=g) * 0.1]
    return [a.contiguous().cuda() for a in args]


def call(lib, interface, args, n_intermediate, dx):
    B, N = args[0].shape
    outs = [torch.empty_like(args[0]) for _ in range(7)]
    if interface == "lanes":
        tables = abcn._lane_tables(N, dx, args[0].device)
    else:
        tables = (abcn._tables(N, dx, args[0].device),)
    status = lib.abcn_macro_step(*(t.data_ptr() for t in (*args, *tables, *outs)), B, N,
                                 n_intermediate, 1e-3, dx,
                                 torch.cuda.current_stream().cuda_stream)
    if status != 0:
        raise RuntimeError(f"launch failed: {status}")
    return outs


def compare(libs, names, shapes, steps, rounds):
    for B, N in shapes:
        args = inputs(B, N, B + N)
        dx = float(2 * np.pi / N)
        for n in steps:
            times = {name: [] for name in names}
            for r in range(rounds):
                for name in (names if r % 2 == 0 else names[::-1]):
                    lib, interface = libs[name]
                    times[name].append(median_ms(
                        lambda: call(lib, interface, args, n, dx), n=25))
            print(f"B={B} N={N} n_intermediate={n}: " + ", ".join(
                f"{name} {np.median(t):.5f}" for name, t in times.items()), flush=True)


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--baseline", help="an earlier abcn.cu with the (3, N) table interface")
    parser.add_argument("--rounds", type=int, default=4)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit("torch_abcn_variants: needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip())
    libs = build_libraries(args.baseline)
    ab = (["baseline"] if args.baseline else []) + ["kernel"]
    compare(libs, ab, SHAPES, [10], args.rounds)
    compare(libs, ["kernel"], SHAPES[:2], [0, 1, 2, 5, 10, 20], args.rounds)
    compare(libs, list(VARIANTS), SHAPES, [10], args.rounds)


if __name__ == "__main__":
    main()
