"""Profile a CLI generation's two phases on one NVIDIA card.

    python3 scripts/torch_profile.py [ks|burger-fd]

Builds the env and learner of the run-926 KS flags (scripts/tpu_ks_926.sh;
the default) or of the run-927 burger-fd flags (chip_smoke.py's RUN_927)
through ``run.make_workload``, collects two generations into the replay so
that updates can sample it, then times two windows: one generation's
collection (16 or 10 episodes of 500 macro-steps), and 100 experience-mode
updates at mbsize 256.  Each window runs once without the profiler (wall
seconds on the host clock, ended by a sync) and once under torch.profiler
(CPU and CUDA activity), which gives the device seconds (the sum of the
device-side rows of ``key_averages``: kernels and copies, not the device
spans of record_function ranges) and the device launches.  Prints both, the device busy share (device seconds over the
unprofiled wall seconds), the launches per macro-step or per update, and
the five device functions that take the most time.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
from chip_smoke import RUN_926, RUN_927  # noqa: E402
from marlpde_tpu_torch import run  # noqa: E402
from marlpde_tpu_torch.envs import rollout  # noqa: E402
from marlpde_tpu_torch.rl import vracer  # noqa: E402
from marlpde_tpu_torch.train import trainer  # noqa: E402

N_UPDATES = 100


def _device_time(row):
    return getattr(row, "self_device_time_total", None) or getattr(row, "self_cuda_time_total", 0)


def profiled(label, fn, per, unit):
    """Time ``fn`` on the host clock, then run it again under the profiler;
    print wall and device seconds, the busy share, device launches per
    ``unit`` (``per`` of them) and the top five device functions."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    averages = prof.key_averages()
    # device rows: kernels and copies; a record_function range (Adam's step)
    # also shows as a device row spanning its kernels, and is left out
    host = {r.key for r in averages if r.device_type != torch.autograd.DeviceType.CUDA}
    rows = [r for r in averages
            if r.device_type == torch.autograd.DeviceType.CUDA and r.key not in host]
    device_s = sum(_device_time(r) for r in rows) * 1e-6
    launches = sum(r.count for r in rows)
    print(f"[{label}] wall {wall:.3f} s, device {device_s:.4f} s ({100 * device_s / wall:.1f}% "
          f"busy), {launches / per:.1f} device launches per {unit}")
    for r in sorted(rows, key=_device_time, reverse=True)[:5]:
        print(f"[{label}]   {_device_time(r) * 1e-3:9.3f} ms  x{r.count:6d}  {r.key[:90]}")


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_profile: needs a CUDA card", file=sys.stderr)
        return 1
    which = sys.argv[1] if len(sys.argv) > 1 else "ks"
    argv = {"ks": RUN_926, "burger-fd": RUN_927}[which]
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    env, rl_cfg, tc = run.make_workload(run.build_parser().parse_args(argv))
    dev = env.device
    g = torch.Generator(device=dev).manual_seed(0)
    ts = vracer.init_train(rl_cfg, g, device=dev)
    rep = trainer.make_replay(env, rl_cfg)
    for gen in range(2):
        traj, _ = rollout.collect_episodes(env, rl_cfg, ts, g, tc.num_envs, gen * tc.num_envs)
        ts, rep = trainer.insert_generation(rl_cfg, ts, rep, traj)
    # warm-up: the graph of UPDATE_CHUNK updates is captured here, unprofiled
    trainer.run_updates(rl_cfg, ts, rep, g, trainer.UPDATE_CHUNK)
    T = env.episode_length
    profiled(f"{which} collect",
             lambda: rollout.collect_episodes(env, rl_cfg, ts, g, tc.num_envs, 2 * tc.num_envs),
             T, "macro-step")
    profiled(f"{which} updates", lambda: trainer.run_updates(rl_cfg, ts, rep, g, N_UPDATES),
             N_UPDATES, "update")
    return 0


if __name__ == "__main__":
    sys.exit(main())
