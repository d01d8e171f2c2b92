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
"""

from __future__ import annotations

import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
from chip_smoke import check, median_ms  # noqa: E402
from marlpde_tpu_torch.kernels import mlp  # noqa: E402
from marlpde_tpu_torch.rl import networks  # noqa: E402

SHAPES = [(R, D, A) for R in (16, 128, 8000) for D in (3, 4, 5, 32) for A in (1, 16)]


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_mlp_shapes: needs a CUDA card", file=sys.stderr)
        return 1
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
