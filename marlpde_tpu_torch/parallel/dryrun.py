"""Multi-process dry run of data-parallel training (the counterpart of
__graft_entry__.dryrun_multichip and scripts/dist_dryrun.py).

    python -m marlpde_tpu_torch.parallel.dryrun --world N [--device cpu|cuda] [--out DIR]
    python -m marlpde_tpu_torch.parallel.dryrun --world N [--device cpu|cuda] --cli <run.py args> --mesh

Like every entry point of the port it runs on the card unless asked for the
CPU: without ``--device`` it raises where torch.cuda is not available, before
it starts any rank.  The parent starts N ranks (``launch``), each this module
again under torchrun's variables (RANK, WORLD_SIZE, LOCAL_RANK,
LOCAL_WORLD_SIZE, MASTER_ADDR, MASTER_PORT on localhost) and an empty
PYTHONPATH.  It waits for them, kills the others as soon as one fails, writes
each rank's output to standard error and prints one JSON line:
{"ok", "processes", "generations", "global_devices", "device", "launches"},
with each rank's kernel launches (the counters are per process); the dry
run proper adds each rank's experience-mode updates ("experience_updates").

The dry run proper: every rank runs 3 generations of the small flagship
(N_dns 64, 16-point LES, 4 agents, 5 macro-steps, width 32), one env and two
updates a generation, in both minibatch modes, with the replay warm from
generation 1, and checks that updates ran, that the parameter, Adam, beta and normalizer
digests are equal bit for bit across the ranks, that every rank's replay
shard holds experiences, and that an "orbax" (torch.distributed.checkpoint)
checkpoint written by all ranks together restores bit for bit on every rank.

With ``--cli`` every rank runs ``run.main(<args>)`` on the device instead
(the args include --mesh), and the JSON line lists the JSON lines each rank
printed ("json_lines"), the sha256 of each rank's final train state
("digests"), each rank's update count ("n_updates") and its seconds since
the first generation began, after each generation ("wall_time").
"""

from __future__ import annotations

import argparse
import hashlib
import json
import math
import os
import subprocess
import sys
import tempfile
import time

N_GEN = 3
# the small flagship of __graft_entry__._flagship(small=True)
SMALL_FLAGSHIP = dict(N_dns=64, grid_size=16, num_actions=16, num_agents=4, dt=0.01, T=0.2,
                      nu=0.05, episode_length=5, ic_case="turbulence", spectral_reward=True,
                      noise=0.0)
# the JAX dry run's width is 16; 32 is the narrowest the MLP kernel builds
WIDTH = 32
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
REPORT = "[dryrun-report] "


def _wait(procs, timeout: float):
    """Wait for every process; once one fails (or ``timeout`` passes), kill
    the rest.  Returns the exit codes."""
    deadline = time.monotonic() + timeout
    try:
        while True:
            rcs = [p.poll() for p in procs]
            if None not in rcs:
                return rcs
            if any(rc not in (None, 0) for rc in rcs) or time.monotonic() > deadline:
                break
            time.sleep(0.1)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs:
            p.wait()
    return [p.returncode for p in procs]


# a rank of the dry run: this module's main
RANK_CODE = "from marlpde_tpu_torch.parallel.dryrun import main; sys.exit(main())"


def launch(world: int, argv, code: str = RANK_CODE, timeout: float = 900.0):
    """Start ``world`` processes of ``python -c <code> <argv>``, each a rank
    under torchrun's variables on a free localhost port, with an empty
    PYTHONPATH and this checkout first on sys.path; returns (exit codes,
    each rank's output and errors)."""
    from marlpde_tpu_torch.parallel.mesh import free_port

    env = dict(os.environ, PYTHONPATH="", MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(free_port()), WORLD_SIZE=str(world),
               LOCAL_WORLD_SIZE=str(world))
    code = f"import sys; sys.path.insert(0, {ROOT!r})\n{code}"
    logs = [tempfile.TemporaryFile("w+") for _ in range(world)]
    try:
        procs = [subprocess.Popen([sys.executable, "-c", code, *argv],
                                  env=dict(env, RANK=str(r), LOCAL_RANK=str(r)), stdout=logs[r],
                                  stderr=subprocess.STDOUT, text=True) for r in range(world)]
        rcs = _wait(procs, timeout)
        outs = []
        for f in logs:
            f.seek(0)
            outs.append(f.read())
    finally:
        for f in logs:
            f.close()
    return rcs, outs


def parent(args) -> int:
    from marlpde_tpu_torch.device import resolve_device

    device = resolve_device(args.device).type
    with tempfile.TemporaryDirectory() as tmp:
        rank_args = (["--cli", *args.cli] if args.cli
                     else ["--out", args.out or os.path.join(tmp, "ckpt")])
        rcs, outs = launch(args.world, ["--rank", "--device", device, *rank_args],
                           timeout=args.timeout)
    reports = []
    for r, (rc, out) in enumerate(zip(rcs, outs)):
        sys.stderr.write(f"----- rank {r} (rc={rc}) -----\n{out}\n")
        lines = [ln[len(REPORT):] for ln in out.splitlines() if ln.startswith(REPORT)]
        reports.append(json.loads(lines[-1]) if lines else None)
    ok = all(rc == 0 for rc in rcs) and None not in reports
    result = {"ok": ok, "processes": args.world, "global_devices": args.world,
              "device": device, "launches": [r and r["launches"] for r in reports]}
    if args.cli:
        result["json_lines"] = [[json.loads(ln) for ln in out.splitlines() if ln.startswith("{")]
                                for out in outs]
        result["digests"] = [r and r["digest"] for r in reports]
        result["n_updates"] = [r and r["n_updates"] for r in reports]
        result["wall_time"] = [r and r["wall_time"] for r in reports]
    else:
        result["generations"] = N_GEN
        result["experience_updates"] = [r and r["experience_updates"] for r in reports]
    print(json.dumps(result))
    return 0 if ok else 1


def _check(cond, msg):
    if not cond:
        raise RuntimeError(f"[dryrun] {msg}")


def _digest(ts) -> str:
    from marlpde_tpu_torch.utils import checkpoint as ckpt
    h = hashlib.sha256()
    for k, v in sorted(ckpt.dcp_state(ts).items()):
        h.update(k.encode() + v.detach().cpu().numpy().tobytes())
    return h.hexdigest()


def _dryrun(mesh, out: str) -> int:
    """The dry run on this rank; returns its experience-mode updates."""
    import torch

    from marlpde_tpu_torch.envs import registry
    from marlpde_tpu_torch.parallel import mesh as pmesh
    from marlpde_tpu_torch.train import trainer
    from marlpde_tpu_torch.utils import checkpoint as ckpt

    W = mesh.world
    env = registry.make_env("burger", device=mesh.device, **SMALL_FLAGSHIP)
    for mode in ("experience", "episode"):
        rl_cfg = trainer.default_rl_config(
            env, width=WIDTH, replay_start_experiences=W, replay_max_experiences=W * 200,
            mini_batch_episodes=1, minibatch_mode=mode, mini_batch_size=16)
        ts, rep, hist = pmesh.run_generations(env, rl_cfg, mesh, envs_per_device=1,
                                              updates_per_gen=2, n_generations=N_GEN, seed=3)
        _check(all(map(math.isfinite, hist["mean_return"])),
               f"[{mode}] returns {hist['mean_return']}")
        _check(ts.n_updates > 0, f"[{mode}] no gradient updates ran (replay never warmed)")
        if mode == "experience":
            experience_updates = int(ts.n_updates)
        digests = mesh.all_gather_object(_digest(ts))
        _check(len(set(digests)) == 1, f"[{mode}] train state diverged across ranks: {digests}")
        filled = mesh.all_gather_object(rep.cursor if mode == "experience" else rep.filled)
        _check(all(f > 0 for f in filled), f"[{mode}] empty replay shards: {filled}")

        mode_dir = os.path.join(out, mode)
        ckpt.save_train_state(mode_dir, ts, backend="orbax")
        mesh.barrier()
        back = ckpt.load_train_state(mode_dir, rl_cfg, device=mesh.device, backend="orbax")
        live, restored = ckpt.dcp_state(ts), ckpt.dcp_state(back)
        _check(live.keys() == restored.keys() and all(
            live[k].dtype == restored[k].dtype and torch.equal(live[k].cpu(), restored[k].cpu())
            for k in live), f"[{mode}] the checkpoint restored other values on rank {mesh.rank}")
        mesh.barrier()
        print(f"[dryrun] {mode}-mode OK rank {mesh.rank}/{W} on {mesh.device} "
              f"({mesh.backend}): {N_GEN} generations, {int(ts.n_updates)} updates, train state "
              f"equal bit for bit across ranks, replay shards filled {filled}, orbax (DCP) "
              f"checkpoint restored bit for bit, mean_return {hist['mean_return'][-1]:.5f}",
              flush=True)
    return experience_updates


def rank_main(args) -> int:
    import torch
    import torch.distributed as dist

    from marlpde_tpu_torch.kernels import abcn, mlp
    from marlpde_tpu_torch.parallel import mesh as pmesh
    from marlpde_tpu_torch.rl import vracer_loss

    if args.device == "cpu":
        torch.set_num_threads(1)
    report = {"rank": int(os.environ["RANK"])}
    if args.cli:
        from marlpde_tpu_torch import run
        ts, _, hist = run.main(args.cli, device=args.device)
        report.update(digest=_digest(ts), n_updates=int(ts.n_updates), wall_time=hist["wall_time"])
    else:
        try:
            report["experience_updates"] = _dryrun(pmesh.make_mesh(args.device), args.out)
        finally:
            if dist.is_initialized():
                dist.destroy_process_group()
    report["launches"] = {"abcn_macro_step": abcn.launches, "mlp_forward": mlp.launches,
                          "vracer_loss": vracer_loss.launches}
    print(REPORT + json.dumps(report), flush=True)
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="marlpde_tpu_torch.parallel.dryrun")
    p.add_argument("--world", type=int, default=2, help="ranks to start")
    p.add_argument("--device", choices=["cpu", "cuda"], default=None,
                   help="cuda (the default, raising without a card): each rank on "
                        "cuda:(LOCAL_RANK %% cards); cpu: the ranks on the CPU")
    p.add_argument("--out", default=None,
                   help="checkpoint directory of the dry run (default: a temporary one)")
    p.add_argument("--timeout", type=float, default=900.0,
                   help="seconds before the parent kills the ranks")
    p.add_argument("--rank", action="store_true", help=argparse.SUPPRESS)
    p.add_argument("--cli", nargs=argparse.REMAINDER, default=None,
                   help="run marlpde_tpu_torch.run with these arguments on every rank")
    args = p.parse_args(argv)
    if args.cli is not None and "--mesh" not in args.cli:
        p.error("--cli: the run's arguments must include --mesh")
    return rank_main(args) if args.rank else parent(args)


if __name__ == "__main__":
    sys.exit(main())
