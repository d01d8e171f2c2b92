"""The ``train`` runner: training generations through the port's CLI,
``marlpde_tpu_torch.run.main(argv, callback=...)`` -> ``train.trainer.train``,
with the configuration's and the traffic's flags, ``--seed`` from the command
line and ``--NE`` large enough that the window ends first.

Set-up is every generation up to and including the first that runs the
traffic's ``steady_updates`` updates: by then the collection's macro-step and
the updates' graphs are captured.  Each later generation is a unit of the
window; its experiences are its live (unmasked) env steps.
"""

from __future__ import annotations

import sys
import time

import yardstick

UNBOUNDED_NE = "1e15"
MAX_SETUP_GENERATIONS = 40


def argv(session) -> list:
    return (session.config["flags"] + session.traffic["flags"]
            + ["--NE", UNBOUNDED_NE, "--seed", str(session.args.seed), "--run", "0"])


def run(session):
    from marlpde_tpu_torch import run as cli
    from marlpde_tpu_torch.kernels import abcn, mlp
    from marlpde_tpu_torch.train import trainer
    from marlpde_tpu_torch.utils import graphs

    flags = argv(session)
    args = cli.build_parser().parse_args(flags)
    T = args.episodelength
    session.install(trainer, graphs, abcn, mlp, layers={
        "collect": (trainer, "collect_episodes", lambda a, kw: T),
        "insert": (trainer, "insert_generation", lambda a, kw: 1),
        "updates": (trainer, "run_updates", lambda a, kw: a[4]),
    })
    env = session.config["env"]
    learner = dict(session.config["learner"], **session.traffic.get("learner", {}))
    na = env["num_agents"]
    P = yardstick.policy_params(env["obs_dim"], learner["width"],
                                env["num_actions"] // na)

    def callback(gen, ts, rep, history):
        if session.phase == "setup":
            print(f"[bench] set-up generation {gen} ends at {time.perf_counter() - session.t0:.3f} s",
                  file=sys.stderr)
            if history["updates"][-1] == session.traffic["steady_updates"]:
                session.begin()
            elif gen >= MAX_SETUP_GENERATIONS:
                raise SystemExit(f"[bench] no generation ran {session.traffic['steady_updates']}"
                                 f" updates in {gen} generations")
            return
        n_upd = history["updates"][-1]
        session.boundary(dict(
            live=round(history["mean_ep_len"][-1] * args.numenvs), episodes=args.numenvs,
            blowups=history["blowups"][-1], updates=n_upd,
            flops=yardstick.generation_flops(
                P, envs=args.numenvs, T=T, agents=na, updates=n_upd,
                mode=learner["minibatch_mode"], mini_batch=learner["mini_batch_size"],
                mini_batch_episodes=learner.get("mini_batch_episodes", 2),
                probe_rows=32 * na if args.diag else 0)))

    from bench_session import StopRun
    print(f"[bench] program imported at {time.perf_counter() - session.t0:.3f} s", file=sys.stderr)
    try:
        cli.main(flags, callback=callback, device=session.device)
    except StopRun:
        pass
    finally:
        session.patches.restore()
    # the program's graphs hold its buffers: free them before the reference runs
    graphs._CACHE.clear()
