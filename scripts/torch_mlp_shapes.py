"""Time the port's policy-MLP kernel (marlpde_tpu_torch/csrc/mlp.cu) over
observation widths and action counts, on one NVIDIA card.

    python3 scripts/torch_mlp_shapes.py

At width 256, ``sigma_relative``, ``sigma_max`` 5, the kernel and the plain
module (``VracerNet`` on cuBLAS) are timed at R in {16, 128, 8000} rows for
obs D in {3, 4, 5, 32} (the kernel keeps up to 4 inputs a row in registers
and reads more from shared memory in a loop over D) and A in {1, 16} actions
(one V head and 2A mean/sigma heads in the epilogue): the run-926 KS policy
is D=32, A=16, the burger-marl one D=3, A=1.  Each time is
chip_smoke.median_ms (CUDA events while a spin kernel holds the stream,
median of 20 calls), the median over 3 rounds whose shape order reverses
each round.  Prints the card, then one line per shape in ms.

    python3 scripts/torch_mlp_shapes.py --paths [--root DIR]

times the kernel and the module instead at the shapes the port's paths give
it (PATH_SHAPES: the flagship, KS, burger-fd, [variants] and the simple-PDE
presets, at their acting and insert rows, and the obs-128/256 shapes at
widths 128/256), with ``marlpde_tpu_torch`` imported from DIR (default: this
checkout), so that two checkouts' kernels can be compared on one card: run
it from each, in the order a, b, b, a.  A shape whose launch the kernel
refuses is reported as such.  The last line is a JSON object of the times.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
from chip_smoke import check, median_ms  # noqa: E402

SHAPES = [(R, D, A) for R in (16, 128, 8000) for D in (3, 4, 5, 32) for A in (1, 16)]
INF = float("inf")
# (label, R, obs, actions, width, mu_param, sigma_max, iex), as chip_smoke.py's
# [kernels] phase gives them
PATH_SHAPES = (
    [(f"flagship W{w} R{R}", R, 3, 1, w, "absolute", INF, 0.1)
     for R in (320, 32768) for w in (128, 256)]
    + [(f"ks R{R}", R, 32, 16, 256, "sigma_relative", 5.0, 0.01) for R in (16, 8000)]
    + [(f"burger-fd R{R}", R, 256, 256, 32, "absolute", 0.05, 0.005) for R in (10, 5000)]
    + [(f"variants A{A} R{R}", R, 32, A, 256, "absolute", 1.0, 0.1) for R in (16, 800)
       for A in (1, 32)]
    + [(f"{name} R{R}", R, *head) for name, head in (
        ("diffusion-simple", (128, 128, 128, "sigma_relative", 5.0, 3.0)),
        ("diffusion-error", (128, 128, 128, "sigma_relative", 0.1, 0.01)),
        ("diffusion-stencil3", (128, 2, 128, "sigma_relative", 5.0, 3.0)),
        ("advection", (32, 64, 128, "absolute", 0.5, 0.05))) for R in (16, 8000)]
    + [(f"laplace R{R}", R, 4, 3, 128, "absolute", 1.0, 0.1) for R in (512, 51200)]
    + [(f"obs256 W{w} R{R}", R, 256, 256, w, "absolute", 0.5, 0.005) for w in (128, 256)
       for R in (10, 5000)]
    + [(f"obs128 W256 R{R}", R, 128, 128, 256, "sigma_relative", 5.0, 0.01) for R in (16, 8000)])


def path_shapes(root: str) -> int:
    """Kernel and module ms at PATH_SHAPES, the package imported from ``root``."""
    sys.path.insert(0, os.path.abspath(root))
    from marlpde_tpu_torch.kernels import mlp
    from marlpde_tpu_torch.rl import networks
    print(f"marlpde_tpu_torch from {os.path.dirname(mlp.__file__)}")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    out = {}
    for label, R, D, A, width, mu_param, sigma_max, iex in PATH_SHAPES:
        net = networks.VracerNet(D, A, width=width, mu_param=mu_param, sigma_max=sigma_max,
                                 init_noise=iex, device=dev, generator=g)
        with torch.no_grad():
            for p in net.parameters():
                p.add_(torch.randn(p.shape, generator=g, device=dev) * 0.1)
            x = torch.randn(R, D, generator=g, device=dev)
            try:
                got = mlp.mlp_forward(x, net)
            except RuntimeError as e:
                print(f"{label}: the kernel refuses: {e}")
                out[label] = None
                continue
            # relative to each output's max |value| where it exceeds 1: the
            # sigma_relative means are sigma (up to 5) times a raw head
            err = max(((o - r).abs().max() / r.abs().max().clamp(min=1.0)).item()
                      for o, r in zip(got, net(x)))
            check(err <= 2e-5, f"mlp kernel disagrees at {label}: {err:.3e}")
            ms = median_ms(lambda: mlp.mlp_forward(x, net))
            plain = median_ms(lambda: net(x))
        print(f"{label} (obs {D}, A {A}, W {width}): kernel {ms:.4f} ms, module {plain:.4f} ms,"
              f" max err {err:.2e}")
        out[label] = dict(ms=ms, plain_ms=plain, err=err)
    print(json.dumps(out))
    return 0


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--paths", action="store_true", help="time PATH_SHAPES")
    ap.add_argument("--root", default=ROOT, help="checkout to import marlpde_tpu_torch from")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_mlp_shapes: needs a CUDA card", file=sys.stderr)
        return 1
    if args.paths:
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"],
                             capture_output=True, text=True, check=True).stdout.strip())
        return path_shapes(args.root)
    from marlpde_tpu_torch.kernels import mlp
    from marlpde_tpu_torch.rl import networks
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    cases = {}
    for R, D, A in SHAPES:
        net = networks.VracerNet(D, A, width=256, mu_param="sigma_relative", sigma_max=5.0,
                                 init_noise=0.01, device=dev, generator=g)
        with torch.no_grad():
            for p in net.parameters():
                p.add_(torch.randn(p.shape, generator=g, device=dev) * 0.05)
            x = torch.randn(R, D, generator=g, device=dev)
            err = max((o - r).abs().max().item() for o, r in zip(mlp.mlp_forward(x, net), net(x)))
        check(err <= 2e-5, f"mlp kernel disagrees at R={R} D={D} A={A}: {err:.3e}")
        cases[R, D, A] = (net, x)
    times = {s: ([], []) for s in SHAPES}
    for rnd in range(3):
        for s in (SHAPES if rnd % 2 == 0 else SHAPES[::-1]):
            net, x = cases[s]
            with torch.no_grad():
                times[s][0].append(median_ms(lambda: mlp.mlp_forward(x, net)))
                times[s][1].append(median_ms(lambda: net(x)))
    print("R, D, A: kernel ms, module ms (width 256, sigma_relative, median of 3 rounds)")
    for s in SHAPES:
        k, m = (float(np.median(t)) for t in times[s])
        print(f"R={s[0]:5d} D={s[1]:2d} A={s[2]:2d}: kernel {k:.4f}, module {m:.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
