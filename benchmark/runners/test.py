"""The ``test`` runner: deterministic evaluations, ``train.trainer.evaluate``
of the traffic's ``episodes`` episodes called back to back on weights drawn
from ``--seed``, as ``run.run_test`` calls it (without the checkpoint load,
the sweep and the plots), each with a generator seeded as ``run_test``
seeds it.  The env and learner come from the port's CLI with the
configuration's and the traffic's flags.

The weights are the initial ones drawn from ``--seed`` with the traffic's
``weights_noise`` added (``bench_check.perturb``), so that the policy's outputs vary as
a trained policy's do.

Set-up is ``setup_units`` evaluations (the first captures the deterministic
macro-step); each later evaluation is a unit of the window, its experiences
the evaluated episodes' live steps.
"""

from __future__ import annotations

import bench_check
import yardstick


def run(session):
    import torch

    from marlpde_tpu_torch import run as cli
    from marlpde_tpu_torch.kernels import abcn, mlp
    from marlpde_tpu_torch.rl import vracer
    from marlpde_tpu_torch.train import trainer
    from marlpde_tpu_torch.utils import graphs

    from bench_session import StopRun

    seed, device = session.args.seed, session.device
    flags = session.config["flags"] + session.traffic["flags"] + ["--seed", str(seed)]
    args = cli.build_parser().parse_args(flags)
    n, T = session.traffic["episodes"], args.episodelength
    work = []

    def count(fn):
        def counted(*a, **kw):
            traj, final = fn(*a, **kw)
            work.append((traj["mask"].sum(), traj["truncated"].sum()))
            return traj, final
        return counted

    session.install(trainer, graphs, abcn, mlp, layers={
        "collect": (trainer, "collect_episodes", lambda a, kw: T)})
    session.patches.wrap(trainer, "collect_episodes", count)
    env_cfg = session.config["env"]
    na = env_cfg["num_agents"]
    P = yardstick.policy_params(env_cfg["obs_dim"], session.config["learner"]["width"],
                                env_cfg["num_actions"] // na)
    flops = yardstick.generation_flops(P, envs=n, T=T, agents=na, updates=0, mode=None)
    try:
        env, rl_cfg, _ = cli.make_workload(args, device)
        ts = vracer.init_train(rl_cfg, torch.Generator(device=device).manual_seed(seed),
                               device=device)
        bench_check.perturb(ts.net.parameters(), seed, session.traffic["weights_noise"], device)
        seeded = lambda: torch.Generator(device=device).manual_seed(seed)
        for _ in range(session.traffic["setup_units"]):
            trainer.evaluate(env, rl_cfg, ts, seeded(), n)
        session.begin()
        while True:
            work.clear()
            trainer.evaluate(env, rl_cfg, ts, seeded(), n)
            live, blown = work[-1]
            session.boundary(dict(live=int(live), episodes=n, blowups=int(blown), flops=flops))
    except StopRun:
        pass
    finally:
        session.patches.restore()
    graphs._CACHE.clear()
