"""Drive the PyTorch port's flagship training generation on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing its lines; any failure raises and exits non-zero:

1. the card (nvidia-smi name and power limit) and the torch/CUDA versions;
2. build both CUDA kernels from marlpde_tpu_torch/csrc (nvcc, sm_90a);
3. each kernel against its plain PyTorch version on the card at the shapes of
   the flagship path, with CUDA-event times (median of 20 calls) of both;
4. the main path: three generations of the flagship burger-marl training
   (1024 episodes of 500 macro-steps, 32 agents, 200 VRACER updates each)
   through registry.make_env / trainer.train, with the kernels' launch counts;
5. a time breakdown of one more generation's phases (collect, normalizer
   update and replay insert, updates), and a small deterministic collection
   on the card against the same collection on the CPU (plain versions).

Standard output ends with one JSON line of kernel results, then the contract
line {"ok": true, "device": {...}}.  Without a CUDA card, or without the
package beside it, the script exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

FLAGSHIP = dict(N_dns=512, grid_size=32, num_actions=32, num_agents=32, dt=1e-3,
                T=5.0, nu=0.02, episode_length=500, ic_case="turbulence",
                spectral_reward=True, noise=0.0)
NUM_ENVS = 1024
GENERATIONS = 3
ABCN_TOL = 1e-5     # relative to each field's max |value|
MLP_TOL = 2e-5      # absolute, as tests/test_pallas.py holds the Pallas MLP


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def median_ms(fn, n=20):
    """Device time of one call of ``fn``: CUDA events, median of ``n`` calls.
    A spin kernel holds the stream while the call is enqueued, so the events
    time the device work alone, not the host's launch overhead."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    enqueue_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    spin_cycles = int(4 * max(enqueue_s, 1e-4) * 2e9)   # 4x the enqueue time at <= 2 GHz
    times = []
    for _ in range(n):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(spin_cycles)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[n // 2]


def phase_kernels(env, dev):
    """Each kernel against its plain version at flagship shapes."""
    import torch
    from marlpde_tpu_torch.envs import burger_env, burger_fast
    from marlpde_tpu_torch.kernels import abcn, mlp
    from marlpde_tpu_torch.rl import networks

    cfg = env.cfg
    g = torch.Generator(device=dev).manual_seed(1)
    st, _ = burger_fast.reset(cfg, env.consts, g, torch.arange(NUM_ENVS, device=dev))
    actions = torch.randn(NUM_ENVS, cfg.num_agents, cfg.actions_per_agent, generator=g,
                          device=dev) * 0.5
    basis = torch.as_tensor(burger_env.action_basis(cfg), dtype=torch.float32, device=dev)
    af = torch.fft.fft(actions.reshape(NUM_ENVS, -1) @ basis)
    args = (st.u, st.v_re, st.v_im, st.fn_re, st.fn_im, st.nu,
            af.real.contiguous(), af.imag.contiguous())
    kw = dict(n_intermediate=cfg.n_intermediate, dt=cfg.dt, dx=cfg.les_solver.grid.dx)
    out = abcn.abcn_macro_step(*args, **kw)
    ref = abcn.abcn_macro_step_reference(*args, **kw)
    torch.cuda.synchronize()
    check(all(o.shape == (NUM_ENVS, cfg.grid_size) for o in out), "abcn output shape")
    abs_err = max((o - r).abs().max().item() for o, r in zip(out, ref))
    rel_err = max(((o - r).abs().max() / r.abs().max().clamp(min=1.0)).item()
                  for o, r in zip(out, ref))
    ms = median_ms(lambda: abcn.abcn_macro_step(*args, **kw))
    plain_ms = median_ms(lambda: abcn.abcn_macro_step_reference(*args, **kw))
    print(f"[kernels] abcn_macro_step B={NUM_ENVS} N={cfg.grid_size} "
          f"n_intermediate={cfg.n_intermediate}: max abs err {abs_err:.3e}, "
          f"{rel_err:.3e} relative to each field's max |value| (tolerance {ABCN_TOL:g} "
          f"relative: float32 direct DFT sums in another order than torch.fft); "
          f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    check(rel_err <= ABCN_TOL, f"abcn kernel disagrees with its plain version: {rel_err:.3e}")
    results = [dict(name="abcn_macro_step", route="cuda",
                    source="marlpde_tpu_torch/csrc/abcn.cu",
                    replaces="marlpde_tpu/ops/abcn_pallas.py:105",
                    max_abs_err=abs_err, ms=ms, plain_ms=plain_ms)]

    R = NUM_ENVS * cfg.num_agents
    x = torch.randn(R, cfg.obs_dim, generator=g, device=dev)
    mlp_errs, mlp_ms, mlp_plain = [], [], []
    for mu_param in ("absolute", "sigma_relative"):
        net = networks.VracerNet(cfg.obs_dim, cfg.actions_per_agent, width=128,
                                 mu_param=mu_param, device=dev, generator=g)
        with torch.no_grad():
            for p in net.parameters():      # non-zero heads, so every output is tested
                p.add_(torch.randn(p.shape, generator=g, device=dev) * 0.1)
            out = mlp.mlp_forward(x, net)
            ref = net(x)
            torch.cuda.synchronize()
            err = max((o - r).abs().max().item() for o, r in zip(out, ref))
            check(out[0].shape == (R,) and out[1].shape == out[2].shape == (R, 1),
                  "mlp output shape")
            ms = median_ms(lambda: mlp.mlp_forward(x, net))
            plain_ms = median_ms(lambda: net(x))
        print(f"[kernels] mlp_forward R={R} obs={cfg.obs_dim} W=128 A=1 "
              f"mu_param={mu_param}: max abs err {err:.3e} (tolerance {MLP_TOL:g}: "
              f"float32 sums of 128 terms in another order than cuBLAS); "
              f"kernel {ms:.4f} ms, plain module {plain_ms:.4f} ms")
        check(err <= MLP_TOL, f"mlp kernel disagrees with VracerNet ({mu_param}): {err:.3e}")
        mlp_errs.append(err)
        mlp_ms.append(ms)
        mlp_plain.append(plain_ms)
    results.append(dict(name="mlp_forward", route="cuda",
                        source="marlpde_tpu_torch/csrc/mlp.cu",
                        replaces="marlpde_tpu/ops/mlp_pallas.py:71",
                        max_abs_err=max(mlp_errs), ms=mlp_ms[0], plain_ms=mlp_plain[0]))
    return results


def phase_main_path(env):
    """Three generations of the flagship training through trainer.train."""
    import numpy as np
    import torch
    from marlpde_tpu_torch.kernels import abcn, mlp
    from marlpde_tpu_torch.train import trainer

    rl_cfg = trainer.default_rl_config(env, width=128)
    tc = trainer.TrainerConfig(num_envs=NUM_ENVS, fused=True, seed=0,
                               max_experiences=GENERATIONS * NUM_ENVS * env.episode_length)
    upd = trainer.updates_per_generation(rl_cfg, tc, env.episode_length)
    check(upd == 200, f"updates_per_generation is {upd}, expected 200")
    counts = [(0, 0)]
    substeps = NUM_ENVS * env.episode_length * env.cfg.n_intermediate

    def report(gen, ts, rep, hist):
        torch.cuda.synchronize()
        counts.append((abcn.launches, mlp.launches))
        dt = hist["wall_time"][-1] - (hist["wall_time"][-2] if gen > 1 else 0.0)
        d_abcn = counts[-1][0] - counts[-2][0]
        d_mlp = counts[-1][1] - counts[-2][1]
        print(f"[main] gen {gen}: {dt:.3f} s ({substeps / dt:.1f} LES-substeps/s), "
              f"mean_return {hist['mean_return'][-1]:.6f}, blowups {hist['blowups'][-1]}, "
              f"ep_len {hist['mean_ep_len'][-1]:.1f}, rew_scale {hist['rew_scale'][-1]:.6g}, "
              f"n_upd {hist['updates'][-1]}, launches abcn +{d_abcn} mlp +{d_mlp}",
              flush=True)
        check(d_abcn == env.episode_length,
              f"gen {gen}: abcn kernel launched {d_abcn} times, expected {env.episode_length}")
        check(d_mlp >= env.episode_length,
              f"gen {gen}: mlp kernel launched {d_mlp} times, expected >= {env.episode_length}")

    abcn.launches = 0
    mlp.launches = 0
    ts, rep, hist = trainer.train(env, rl_cfg, tc, verbose=False, callback=report)
    launches = dict(abcn_macro_step=abcn.launches, mlp_forward=mlp.launches)

    check(len(hist["gen"]) == GENERATIONS, f"ran {len(hist['gen'])} generations")
    check(hist["blowups"][0] == 0, f"generation 1 had {hist['blowups'][0]} blowups")
    check(np.isfinite(hist["mean_return"][0]), "generation 1 return is not finite")
    check(hist["mean_ep_len"][0] == env.episode_length, "generation 1 episodes were cut")
    check(all(n == 200 for n in hist["updates"]), f"n_upd per generation {hist['updates']}")
    check(ts.n_updates == 200 * GENERATIONS, f"n_updates {ts.n_updates}")
    check(all(torch.isfinite(p).all() for p in ts.net.parameters()), "params not finite")
    for m in hist["metrics"]:
        check(m and all(np.isfinite(v) for v in m.values()), f"metrics not finite: {m}")
    check(rep.filled == rl_cfg.replay_capacity_episodes, f"replay filled {rep.filled}")
    check(rep.obs.shape == (rep.capacity, env.episode_length, env.num_agents, env.obs_dim),
          f"replay obs shape {tuple(rep.obs.shape)}")
    print(f"[main] last update metrics: {json.dumps(hist['metrics'][-1])}")
    return ts, rep, rl_cfg, launches


def phase_breakdown(env, ts, rep, rl_cfg):
    """Host-clock times of one more generation's phases, each ended by a sync."""
    import torch
    from marlpde_tpu_torch.envs import rollout
    from marlpde_tpu_torch.rl import replay, vracer

    g = torch.Generator(device=ts.beta.device).manual_seed(7)

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    (traj, _), t_collect = timed(lambda: rollout.collect_episodes(
        env, rl_cfg, ts, g, NUM_ENVS, GENERATIONS * NUM_ENVS))
    (ts, rep), t_observe = timed(lambda: (vracer.observe_episodes(rl_cfg, ts, traj),
                                          replay.add_episodes(rep, traj)))

    def updates():
        t = ts
        for _ in range(200):
            t, _ = vracer.update(rl_cfg, t, replay.sample_episodes(
                rep, g, rl_cfg.mini_batch_episodes))
        return t
    _, t_update = timed(updates)
    print(f"[breakdown] collect {t_collect:.3f} s, normalizers + replay insert "
          f"{t_observe:.3f} s, 200 updates {t_update:.3f} s")


def phase_small_agreement(dev):
    """A small deterministic collection through the kernels on the card against
    the same collection through the plain versions on the CPU."""
    import torch
    from marlpde_tpu_torch.envs import registry, rollout
    from marlpde_tpu_torch.train import trainer
    from marlpde_tpu_torch.rl import vracer

    kw = dict(N_dns=64, grid_size=32, num_actions=32, num_agents=4, dt=0.01, T=0.5,
              nu=0.05, episode_length=5, ic_case="turbulence", spectral_reward=True)
    trajs, weights = {}, None
    for d in ("cpu", dev):
        env = registry.make_env("burger", device=d, **kw)
        rl_cfg = trainer.default_rl_config(env, width=128)
        ts = vracer.init_train(rl_cfg, torch.Generator(device=d).manual_seed(3), device=d)
        if weights is None:
            weights = ts.net.state_dict()
        ts.net.load_state_dict(weights)         # the CPU net's weights on both sides
        trajs[d] = rollout.collect_episodes(env, rl_cfg, ts, None, 6, deterministic=True)[0]
    worst = 0.0
    for name in ("obs", "actions", "rewards", "mask"):
        a, b = trajs[dev][name].cpu(), trajs["cpu"][name]
        check(a.shape == b.shape and torch.isfinite(a).all(), f"small {name}")
        worst = max(worst, ((a - b).abs().max() / b.abs().max().clamp(min=1.0)).item())
    print(f"[small] deterministic collection, card vs CPU: max err {worst:.3e} relative "
          f"to each tensor's max |value| (tolerance 1e-4: float32 kernels against the "
          f"CPU's plain versions over 5 macro-steps)")
    check(worst <= 1e-4, f"card and CPU collections disagree: {worst:.3e}")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda is not available; this script needs a CUDA card",
              file=sys.stderr)
        return 1
    from marlpde_tpu_torch.device import resolve_device
    from marlpde_tpu_torch.envs import registry
    from marlpde_tpu_torch.kernels import build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(smi)
    print(f"[env] python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    dev = resolve_device("cuda")

    t0 = time.perf_counter()
    for name in ("abcn", "mlp"):
        build.load(name)
    print(f"[build] abcn.cu and mlp.cu built and loaded in {time.perf_counter() - t0:.2f} s")
    for name, log in build.build_logs.items():
        regs = [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln]
        print(f"[build] {name}: {' | '.join(regs)}")

    t0 = time.perf_counter()
    env = registry.make_env("burger", dtype=torch.float32, device=dev, **FLAGSHIP)
    print(f"[setup] flagship env (host DNS pool {tuple(env.consts.uu.shape)}) in "
          f"{time.perf_counter() - t0:.2f} s; obs_dim {env.obs_dim}")

    kernels = phase_kernels(env, dev)
    ts, rep, rl_cfg, launches = phase_main_path(env)
    for k in kernels:
        k["launches"] = launches[k["name"]]
    phase_breakdown(env, ts, rep, rl_cfg)
    phase_small_agreement(dev)

    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
