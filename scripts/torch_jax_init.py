"""Run 918 on the port from the JAX package's own initial weights.

The two packages draw their initial weights from different generators, so a
seed starts each from other weights.  This script carries the JAX package's
draw across: its ``jax`` half writes the weights that ``marlpde_tpu.train.
trainer.train`` draws at a seed (``split(key(seed))``, then
``vracer.init_train``, trainer.py:197-200) for run 918's config
(scripts/tpu_flagship_918.sh's flags through ``marlpde_tpu.run.make_workload``),
flax layout flattened, into scripts/jax_init_918.npz; its ``torch`` half
trains the port from them on the card (``trainer.train(init_ts=...)`` through
``run.make_workload``, run 918's other flags at the same seed, checkpoints in
``_result_burger-marl_<run>``), then runs ``--test`` and ``--test --best``.
The pool and the weights are then the JAX run's; only the action noise and
the minibatches differ.

    env JAX_PLATFORMS=cpu python3 scripts/torch_jax_init.py jax [--seeds 42 7]
    python3 scripts/torch_jax_init.py torch --out jax_init_out [--seeds 42 7]

The ``torch`` half writes ``918_jax<seed>.log`` (the trainer's lines, then the
JSON line), ``918_jax<seed>_history.json`` and ``918_jax<seed>_test.log`` /
``_test_best.log`` (the ``--test`` summary) under ``--out``.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import sys
import time

import numpy as np

FLAGS_918 = ("burger-marl --nagents 32 --specreward --dforce --ic turbulence --width 128 "
             "--iex 0.1 --rscale cumulative --trust forward").split()
TRAIN_918 = ("--NE 1000000 --numenvs 10 --mbsize 8 --maxupd 2500 --testfreq 10 "
             "--testepisodes 8 --diag").split()
NPZ = os.path.join(os.path.dirname(os.path.abspath(__file__)), "jax_init_918.npz")


def jax_half(args):
    import jax

    from marlpde_tpu import run
    from marlpde_tpu.rl import vracer
    out = {}
    for seed in args.seeds:
        argv = FLAGS_918 + TRAIN_918 + ["--seed", str(seed)]
        _, rl_cfg, tc = run.make_workload(run.build_parser().parse_args(argv))
        _, k_init = jax.random.split(jax.random.key(tc.seed))
        params = vracer.init_train(rl_cfg, k_init).params["params"]
        for layer, leaves in params.items():
            for name, a in leaves.items():
                out[f"seed{seed}/{layer}/{name}"] = np.asarray(a)
    np.savez(NPZ, **out)
    print(f"[jax_init] {NPZ}: {sorted(out)}")


def _params(seed):
    """The JAX package's seed-``seed`` weights as a flax-layout tree."""
    with np.load(NPZ) as d:
        tree = {}
        for key in d.files:
            s, layer, name = key.split("/")
            if s == f"seed{seed}":
                tree.setdefault(layer, {})[name] = d[key]
    if not tree:
        raise SystemExit(f"[jax_init] no seed {seed} in {NPZ}")
    return {"params": tree}


def torch_half(args):
    import torch

    from marlpde_tpu_torch import run
    from marlpde_tpu_torch.rl import networks, vracer
    from marlpde_tpu_torch.train import trainer
    os.makedirs(args.out, exist_ok=True)
    for seed in args.seeds:
        tag = f"918_jax{seed}"
        run_id = 918000 + 900 + seed
        argv = FLAGS_918 + TRAIN_918 + ["--seed", str(seed), "--run", str(run_id)]
        env, rl_cfg, tc = run.make_workload(run.build_parser().parse_args(argv), args.device)
        tc = dataclasses.replace(tc, checkpoint_dir=f"_result_burger-marl_{run_id}")
        ts = vracer.init_train(rl_cfg, torch.Generator(device=env.device).manual_seed(0),
                               device=env.device)
        ts.net.load_state_dict({k: v.to(env.device) for k, v in
                                networks.params_from_flax(_params(seed)).items()})
        t0 = time.time()
        with open(os.path.join(args.out, f"{tag}.log"), "w") as log, \
                contextlib.redirect_stdout(log):
            _, _, history = trainer.train(env, rl_cfg, tc, init_ts=ts)
            print(json.dumps({"workload": "burger-marl", "seed": seed, "init": "jax",
                              "final_mean_return": history["mean_return"][-1],
                              "generations": history["gen"][-1],
                              "seconds": time.time() - t0}))
        with open(os.path.join(args.out, f"{tag}_history.json"), "w") as f:
            json.dump(history, f)
        print(f"[jax_init] seed {seed}: generation 1 return {history['mean_return'][0]:.5f}, "
              f"generation {history['gen'][-1]} {history['mean_return'][-1]:.5f}, "
              f"{time.time() - t0:.1f} s", flush=True)
        for extra, name in ((["--test"], "test"), (["--test", "--best"], "test_best")):
            with open(os.path.join(args.out, f"{tag}_{name}.log"), "w") as log, \
                    contextlib.redirect_stdout(log):
                run.main(FLAGS_918 + ["--seed", str(seed), "--run", str(run_id),
                                      "--testepisodes", "8"] + extra, device=args.device)
            with open(os.path.join(args.out, f"{tag}_{name}.log")) as log:
                print(f"[jax_init] seed {seed} {name}: {log.read().splitlines()[-1]}",
                      flush=True)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = p.add_subparsers(dest="half", required=True)
    j = sub.add_parser("jax")
    j.add_argument("--seeds", type=int, nargs="+", default=[42, 7])
    t = sub.add_parser("torch")
    t.add_argument("--out", required=True)
    t.add_argument("--seeds", type=int, nargs="+", default=[42, 7])
    t.add_argument("--device", default=None, help="default: the card")
    args = p.parse_args(argv)
    return dict(jax=jax_half, torch=torch_half)[args.half](args)


if __name__ == "__main__":
    sys.exit(main())
