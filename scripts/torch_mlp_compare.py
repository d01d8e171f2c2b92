"""Time the MLP kernel, and the graphed collections of the paths it acts on,
in the tree this runs against, so that two trees can be compared on one card.

    PYTHONPATH=<tree> python3 scripts/torch_mlp_compare.py --tag <name> [--out DIR]

It imports the tree's ``chip_smoke.py`` for its shapes and its timer and the
tree's ``marlpde_tpu_torch`` (so the tree's kernel, built from its sources):

- every MLP row of ``chip_smoke.py``'s [kernels] phase: the kernel and
  ``VracerNet`` on cuBLAS (CUDA events behind a spin kernel, median of 20
  calls) and their ratio; where the tree's ``mlp_forward`` takes a ``route``,
  also the wide route forced at obs <= 4 (the rows of the narrow route);
- the graphed collection of diffusion-simple (16 envs), run-927 burger-fd
  (10 envs) and run-926 KS (16 envs): one collection that captures its
  macro-step graph, untimed, then three timed ones (seconds, each ended by a
  synchronize), their median.

It prints one JSON line, and writes it to ``DIR/<tag>.json`` too.  Two trees
are compared by running it from each in turns inside one chip call:
``scripts/torch_mlp_compare.sh``.
"""

from __future__ import annotations

import argparse
import inspect
import json
import os
import subprocess
import sys
import time

COLLECTIONS = 3


def mlp_shapes(cs, small):
    """(R, obs, actions, width, mu_param, sigma_max, iex) of [kernels]' MLP rows."""
    import numpy as np
    from marlpde_tpu_torch.parallel import dryrun
    D, A = 3, 1      # the flagship's policy: 3 obs, 1 action an agent
    return ([(cs.NUM_ENVS * 32, D, A, w, m, np.inf, 0.1) for w in (128, 256)
             for m in ("absolute", "sigma_relative")]
            + [(R, D, A, w, "absolute", np.inf, 0.1) for R in (320, 160000) for w in (128, 256)]
            + [(R, 32, 16, 256, "sigma_relative", 5.0, 0.01) for R in (16, 8000)]
            + [(R, 256, 256, 32, "absolute", 0.05, 0.005) for R in (10, 5000)]
            + [(R, 32, A, 256, "absolute", sigma_max, iex) for R in (16, 800)
               for A, sigma_max, iex in cs.VARIANT_HEADS.values()]
            + [(R, D, A, 128, "absolute", np.inf, 0.1) for R in cs.MESH_ROWS]
            + [(R, small.obs_dim, small.act_dim, dryrun.WIDTH, "absolute", np.inf, 0.1)
               for R in cs.DRYRUN_ROWS]
            + [(R, *head) for head, rows in list(cs.SIMPLE_HEADS.values())
               + list(cs.WIDE_INPUTS.values()) + list(cs.APG_HEADS.values()) for R in rows])


def time_rows(cs, dev):
    import torch
    from marlpde_tpu_torch.envs import registry
    from marlpde_tpu_torch.kernels import mlp
    from marlpde_tpu_torch.parallel import dryrun
    from marlpde_tpu_torch.rl import networks

    small = registry.make_env("burger", dtype=torch.float32, device=dev, **dryrun.SMALL_FLAGSHIP)
    routes = "route" in inspect.signature(mlp.mlp_forward).parameters
    g = torch.Generator(device=dev).manual_seed(1)
    rows = []
    for R, D, A, width, mu_param, sigma_max, iex in mlp_shapes(cs, small):
        x = torch.randn(R, D, generator=g, device=dev)
        net = networks.VracerNet(D, A, width=width, mu_param=mu_param, sigma_max=sigma_max,
                                 init_noise=iex, device=dev, generator=g)
        with torch.no_grad():
            for p in net.parameters():
                p.add_(torch.randn(p.shape, generator=g, device=dev) * 0.1)
            ref = net(x)
            err = max((o - r).abs().max().item() for o, r in zip(mlp.mlp_forward(x, net), ref))
            row = dict(R=R, obs=D, A=A, W=width, mu_param=mu_param, err=err,
                       ms=cs.median_ms(lambda: mlp.mlp_forward(x, net)),
                       module_ms=cs.median_ms(lambda: net(x)))
            if routes and D <= mlp.SMALL_OBS:
                wide = mlp.mlp_forward(x, net, route="wide")
                row["wide_err"] = max((o - r).abs().max().item() for o, r in zip(wide, ref))
                row["wide_ms"] = cs.median_ms(lambda: mlp.mlp_forward(x, net, route="wide"))
        row["ratio"] = row["ms"] / row["module_ms"]
        print(f"[compare] R={R} obs={D} A={A} W={width} {mu_param}: kernel {row['ms']:.5f} ms, "
              f"VracerNet on cuBLAS {row['module_ms']:.5f} ms (x{row['ratio']:.3f}), "
              f"max abs err {err:.3e}"
              + (f"; wide route {row['wide_ms']:.5f} ms" if "wide_ms" in row else ""),
              flush=True)
        rows.append(row)
    return rows


def time_collections(cs):
    import torch
    from marlpde_tpu_torch import run
    from marlpde_tpu_torch.envs import rollout
    from marlpde_tpu_torch.rl import vracer

    out = {}
    for label, argv in (("diffusion-simple", ["diffusion-simple"]), ("burger-fd", cs.RUN_927),
                        ("ks", cs.RUN_926)):
        env, rl_cfg, tc = run.make_workload(run.build_parser().parse_args(argv))
        g = torch.Generator(device=env.device).manual_seed(7)
        ts = vracer.init_train(rl_cfg, g, device=env.device)
        B = tc.num_envs
        rollout.collect_episodes(env, rl_cfg, ts, g, B, 0)        # captures the graph
        seconds = []
        for k in range(1, COLLECTIONS + 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rollout.collect_episodes(env, rl_cfg, ts, g, B, k * B)
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t0)
        out[label] = dict(envs=B, seconds=seconds, median_s=sorted(seconds)[COLLECTIONS // 2])
        print(f"[compare] {label} graphed collection ({B} envs): "
              f"{', '.join(f'{s:.4f}' for s in seconds)} s", flush=True)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--tag", required=True)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("torch_mlp_compare: needs a CUDA card", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from marlpde_tpu_torch.kernels import build
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip().splitlines()[0]
    print(f"[compare] {args.tag}: {os.path.abspath(cs.__file__)}, {card}", flush=True)
    build.load("mlp")
    dev = torch.device("cuda")
    result = dict(tag=args.tag, card=card, rows=time_rows(cs, dev),
                  collections=time_collections(cs))
    line = json.dumps(result)
    print(line)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, f"{args.tag}.json"), "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
