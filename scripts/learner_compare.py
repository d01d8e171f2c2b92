"""The other learners at their published widths, in one package, on the CPU:
APG on burger-jax (``apg``) and the ddp pipeline at its test's scale
(``ddp``).  Each run imports one package only.

    # APG: the port first, it writes its seed-0 weights (absolute mean);
    # then the JAX package, from the same weights
    env PYTHONPATH=. python3 scripts/learner_compare.py apg torch --file apg_init.npz
    env PYTHONPATH=. JAX_PLATFORMS=cpu python3 scripts/learner_compare.py apg jax \
        --file apg_init.npz
    # ddp: the JAX package first, it writes the draws of its key 7 (the
    # test's); then the port over its own seeds and on JAX's key-7 draws
    env PYTHONPATH=. JAX_PLATFORMS=cpu python3 scripts/learner_compare.py ddp jax \
        --file ddp_key7.npz
    env PYTHONPATH=. python3 scripts/learner_compare.py ddp torch --file ddp_key7.npz

``apg``: the CLI's ``burger-jax --dforce --learner apg --NE 16000`` (N_dns
512, N = NA = 32, RK3, MSE reward, width 256, 16 episodes of 500
macro-steps; ``--dforce``: the actions are the forcing itself), built by the
package's own ``run.make_workload``, in float32.  Prints one JSON line per
reading:

- ``untrained``: the return of the untrained absolute-mean policy of each of
  APG_SEEDS, drawn by the package's own generator (the port's CPU
  ``torch.Generator``, JAX's ``split(key(seed))[0]`` as ``train_apg`` draws
  it), over 16 episodes (one pool row at noise 0: the 16 are one episode);
- ``shared``: two ``train_apg`` iterations from the port's seed-0 weights at
  each of APG_LRS (the weights carried in flax layout, flattened, through
  ``networks.params_from_flax``);
- ``sigma_relative``: three iterations with ``--muparam sigma_relative``
  (zero initial actions) from the package's seed-42 draw.

``ddp``: each of DDP_SEEDS runs tests/test_ddp.py::TestPipelineScale's
steps in float64: the N=1024 stochastic DNS of 4000 steps from the seed's
draws, the filter to n_les=128 at every s-th step, ``train_closure`` for 80
epochs at batch 64 on frames 0-149 (its weights and permutations from seed
1, as the test's key 1), the a-priori score on frames 150-199, static
Smagorinsky's correlation on the same frames, and the a-posteriori rollout
from frame 190.  Prints one JSON line per seed: the correlation, the
Smagorinsky correlation, max |u| of the rollout and whether the test's
limits hold (correlation > 0.45 and > |Smagorinsky's|, max |u| < 50).  The
JAX run saves key 7's IC phase and forcing draws and key 1's initial
weights and permutations; the port then runs those too (``seed: "jax-7"``).
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

APG_FLAGS = "burger-jax --dforce --learner apg --NE 16000".split()
APG_SEEDS = (0, 1, 2, 3, 42)
APG_LRS = (1e-3, 1e-5)


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


def _print(**kw):
    print(json.dumps(kw), flush=True)


def apg_torch(weights: str):
    import torch

    from marlpde_tpu_torch import run
    from marlpde_tpu_torch.rl import apg, networks, vracer

    env, rl_cfg, _ = run.make_workload(run.build_parser().parse_args(APG_FLAGS), device="cpu")
    for seed in APG_SEEDS:
        ts = vracer.init_train(rl_cfg, torch.Generator().manual_seed(seed))
        with torch.no_grad():
            ret = apg.episode_return(env, rl_cfg, ts, env.consts, torch.Generator(), 0, 16)
        _print(package="torch", reading="untrained", seed=seed, ret=ret.item())
        if seed == 0:
            np.savez(weights, **_flatten(networks.params_to_flax(ts.net)))
    init = vracer.init_train(rl_cfg, torch.Generator().manual_seed(0)).net.state_dict()
    for lr in APG_LRS:
        ts = vracer.init_train(rl_cfg, torch.Generator().manual_seed(0))
        ts.net.load_state_dict(init)
        _, hist = apg.train_apg(env, rl_cfg, apg.ApgConfig(iterations=2, batch_size=16, lr=lr),
                                generator=torch.Generator(), init_ts=ts, verbose=False)
        _print(package="torch", reading="shared", lr=lr, returns=hist["mean_return"])
    args = run.build_parser().parse_args(APG_FLAGS + ["--muparam", "sigma_relative"])
    env, rl_cfg, _ = run.make_workload(args, device="cpu")
    _, hist = apg.train_apg(env, rl_cfg, apg.ApgConfig(iterations=3, batch_size=16),
                            generator=torch.Generator().manual_seed(42), verbose=False)
    _print(package="torch", reading="sigma_relative", returns=hist["mean_return"])


def apg_jax(weights: str):
    import jax
    import jax.numpy as jnp

    from marlpde_tpu import run
    from marlpde_tpu.rl import apg, vracer

    env, rl_cfg, _ = run.make_workload(run.build_parser().parse_args(APG_FLAGS))
    for seed in APG_SEEDS:
        k_init, key = jax.random.split(jax.random.key(seed))
        ts = vracer.init_train(rl_cfg, k_init)
        ret = apg.episode_return(env, rl_cfg, ts.params, ts, env.consts, key, 0, 16)
        _print(package="jax", reading="untrained", seed=seed, ret=float(ret))
    with np.load(weights) as d:
        params = jax.tree.map(jnp.asarray, _unflatten(dict(d)))
    ts = vracer.init_train(rl_cfg, jax.random.key(0)).replace(params=params)
    for lr in APG_LRS:
        _, hist = apg.train_apg(env, rl_cfg, apg.ApgConfig(iterations=2, batch_size=16, lr=lr),
                                key=jax.random.key(0), init_ts=ts, verbose=False)
        _print(package="jax", reading="shared", lr=lr, returns=hist["mean_return"])
    args = run.build_parser().parse_args(APG_FLAGS + ["--muparam", "sigma_relative"])
    env, rl_cfg, _ = run.make_workload(args)
    _, hist = apg.train_apg(env, rl_cfg, apg.ApgConfig(iterations=3, batch_size=16),
                            key=jax.random.key(42), verbose=False)
    _print(package="jax", reading="sigma_relative", returns=hist["mean_return"])


DDP_SEEDS = (7, 0, 1, 2, 3)
EPOCHS, BATCH, N_STEPS = 80, 64, 4000


def _report(package, seed, corr, corr_smag, umax):
    print(json.dumps(dict(package=package, seed=seed, correlation=corr,
                          smagorinsky=corr_smag, rollout_max_abs=umax,
                          limits_hold=bool(corr > 0.45 and corr > abs(corr_smag)
                                           and umax < 50.0))), flush=True)


def _score(pipeline, closures, cfg, U, F, model_of):
    """(correlation, Smagorinsky correlation, rollout max |u|) of the test's
    steps after the DNS; ``model_of(u_bar, pi)`` trains the closure."""
    u_bar, pi, f_bar = pipeline.calc_bar(U[::cfg.s], F[::cfg.s], cfg.n_les, cfg.L)
    model = model_of(u_bar[:150], pi[:150])
    ev = pipeline.apriori_eval(model, u_bar[150:200], pi[150:200])
    smag = np.asarray(closures.ssm_forcing(u_bar[150:200], cfg.L / cfg.n_les, cfg.n_les))
    corr_smag = float(np.corrcoef(smag.ravel(), np.asarray(pi[150:200]).ravel())[0, 1])
    uu = pipeline.aposteriori_rollout(model, cfg, u_bar[190], u_bar[189], f_bar[190:],
                                      len(f_bar) - 191)
    return ev["correlation"], corr_smag, float(np.abs(np.asarray(uu)).max())


def ddp_jax(draws: str):
    import jax
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    from marlpde_tpu.ddp import pipeline
    from marlpde_tpu.solvers import closures

    cfg = pipeline.DdpConfig()
    for seed in DDP_SEEDS:
        U, F = pipeline.generate_dns(cfg, N_STEPS, jax.random.key(seed))
        _report("jax", seed, *_score(pipeline, closures, cfg, U, F, lambda u, p: (
            pipeline.train_closure(u, p, jax.random.key(1), epochs=EPOCHS, batch_size=BATCH))))
    # what generate_dns(key 7) and train_closure(key 1) draw
    key, kic = jax.random.split(jax.random.key(7))
    keys = jax.random.split(key, N_STEPS // cfg.s)
    block = np.stack([np.asarray(jax.random.normal(kb, (2, 3))) for kb in keys])
    key, kp = jax.random.split(jax.random.key(1))
    params = pipeline.ClosureNet(n_out=cfg.n_les).init(kp, jnp.zeros((1, cfg.n_les)))
    perms = []
    for _ in range(EPOCHS):
        key, ks = jax.random.split(key)
        perms.append(np.asarray(jax.random.permutation(ks, 150)))
    np.savez(draws, phase=float(jax.random.normal(kic)) * 2.0 * np.pi, block=block,
             perms=np.stack(perms), **_flatten(params["params"]))


def ddp_torch(draws: str):
    import torch

    from marlpde_tpu_torch.ddp import pipeline
    from marlpde_tpu_torch.solvers import closures

    cfg = pipeline.DdpConfig()
    f64 = torch.float64

    def trained(generator=None, net=None, perms=None):
        return lambda u, p: pipeline.train_closure(u, p, generator, epochs=EPOCHS,
                                                   batch_size=BATCH, net=net, perms=perms)

    for seed in DDP_SEEDS:
        U, F = pipeline.generate_dns(cfg, N_STEPS, torch.Generator().manual_seed(seed),
                                     dtype=f64, device="cpu")
        _report("torch", seed, *_score(pipeline, closures, cfg, U, F,
                                       trained(torch.Generator().manual_seed(1))))
    if not os.path.exists(draws):
        return
    with np.load(draws) as d:
        x = np.linspace(0.0, cfg.L, cfg.N, endpoint=False)
        u0 = torch.tensor(np.sin(2.0 * np.pi * 2.0 * x / cfg.L + float(d["phase"])))
        U, F = pipeline.generate_dns(cfg, N_STEPS, u0=u0, draws=torch.tensor(d["block"]),
                                     dtype=f64, device="cpu")
        tree = _unflatten({key: d[key] for key in d.files if "/" in key})
        net = pipeline.ClosureNet(cfg.n_les, dtype=f64)
        net.load_state_dict(pipeline.params_from_flax(tree))
        _report("torch", "jax-7", *_score(pipeline, closures, cfg, U, F,
                                          trained(net=net, perms=list(d["perms"]))))


RUNS = {("apg", "jax"): apg_jax, ("apg", "torch"): apg_torch,
        ("ddp", "jax"): ddp_jax, ("ddp", "torch"): ddp_torch}


def main():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("learner", choices=["apg", "ddp"])
    p.add_argument("package", choices=["jax", "torch"])
    p.add_argument("--file", default=None,
                   help="apg: the port's seed-0 weights, written by torch and read by jax "
                        "(default apg_init.npz); ddp: JAX's key-7 draws, written by jax and "
                        "read by torch where present (default ddp_key7.npz)")
    a = p.parse_args()
    path = a.file or ("apg_init.npz" if a.learner == "apg" else "ddp_key7.npz")
    if (a.learner, a.package) == ("apg", "jax") and not os.path.exists(path):
        raise SystemExit(f"{path} is missing: run the torch package first")
    RUNS[a.learner, a.package](path)


if __name__ == "__main__":
    main()
