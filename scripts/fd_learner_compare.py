"""The burger-fd learner at its published widths, in one package, on the CPU.

    # the JAX package first: it writes its initial weights
    env PYTHONPATH=. JAX_PLATFORMS=cpu python3 scripts/fd_learner_compare.py jax \
        --weights fd_init.npz
    # then the port, from the same weights
    env PYTHONPATH=. python3 scripts/fd_learner_compare.py torch --weights fd_init.npz

Trains the run-vracer-burger-fd.py config (N_dns 1024, N = NA = 256, one
agent, MSE reward, width 32, iex 0.005, mbsize 256, --dforce as in
chip_smoke.py's RUN_927) through the package's own ``run.make_workload`` and
``trainer.train`` at a cut depth: episodes of 100 macro-steps (T 1.0), 10
envs, updates from 2000 experiences on, 4 generations, so the last two run
2000 updates each.  Both runs start from one set of weights: the JAX run
draws them and saves them (flax layout, flattened), the port loads them
through ``networks.params_from_flax``.  The action noise and the minibatches
come from each package's own generator, so the two runs are samples of one
process, not one trajectory.  Prints one JSON line per generation: the
return, episode length, updates, and the last update's metrics
(the far-policy fraction, the KL loss, the mean importance weight, beta).

Each run imports one package only.
"""

from __future__ import annotations

import argparse
import json

import numpy as np

FLAGS = ("burger-fd --dforce --NDNS 1024 --T 1.0 --episodelength 100 --numenvs 10 "
         "--rstart 2000 --NE 4000 --maxupd 2500 --seed 0").split()
METRICS = ("frac_far", "kl_loss", "mean_rho", "mean_sigma", "beta", "v_loss", "pg_loss")


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        out.update(_flatten(v, key) if isinstance(v, dict) else {key: np.asarray(v)})
    return out


def _unflatten(flat):
    tree = {}
    for key, v in flat.items():
        node = tree
        *path, leaf = key.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


def _report(package, hist):
    for i, gen in enumerate(hist["gen"]):
        m = hist["metrics"][i]
        print(json.dumps(dict(
            package=package, gen=gen, mean_return=float(hist["mean_return"][i]),
            mean_ep_len=float(hist["mean_ep_len"][i]), updates=int(hist["updates"][i]),
            **{k: float(m[k]) for k in METRICS if k in m})), flush=True)


def run_jax(weights):
    import jax
    from marlpde_tpu import run
    from marlpde_tpu.rl import vracer
    from marlpde_tpu.train import trainer

    env, rl_cfg, tc = run.make_workload(run.build_parser().parse_args(FLAGS))
    ts = vracer.init_train(rl_cfg, jax.random.key(tc.seed))
    np.savez(weights, **_flatten(jax.tree.map(np.asarray, ts.params)))
    _, _, hist = trainer.train(env, rl_cfg, tc, verbose=False, init_ts=ts)
    _report("jax", hist)


def run_torch(weights):
    import torch
    from marlpde_tpu_torch import run
    from marlpde_tpu_torch.rl import networks, vracer
    from marlpde_tpu_torch.train import trainer

    env, rl_cfg, tc = run.make_workload(run.build_parser().parse_args(FLAGS), device="cpu")
    ts = vracer.init_train(rl_cfg, torch.Generator().manual_seed(tc.seed), dtype=env.dtype,
                           device="cpu")
    with np.load(weights) as f:
        ts.net.load_state_dict(networks.params_from_flax(_unflatten(dict(f))))
    _, _, hist = trainer.train(env, rl_cfg, tc, verbose=False, init_ts=ts)
    _report("torch", hist)


def main():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("package", choices=("jax", "torch"))
    p.add_argument("--weights", required=True,
                   help="npz of the initial weights: written by the jax run, read by torch")
    args = p.parse_args()
    (run_jax if args.package == "jax" else run_torch)(args.weights)


if __name__ == "__main__":
    main()
