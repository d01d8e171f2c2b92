"""Policy evaluation sweeps and the testing-mode comparisons (port of
marlpde_tpu/analysis/evaluation.py:23-406).

Parity targets: burger_testing_environment.py — sweep DNS pool rows with the
deterministic policy, collect the spectral relative-error trajectories, the
learned actions and the DNS a-priori SGS terms, and dump relError_*.npy /
sgsTerms_*.npy / dnsSgsTerms_*.npy (:168-179); the uncontrolled-baseline
comparison + makePlot of the single-episode testing branch
(burger_environment.py:241-329); the KS testing branch (ks_environment.py:
122-183); the testing plots of the diffusion and advection families
(diffusion_environment_simple.py:76-81, the error_rl_{N}.json convergence
curves of plotting_diffusion.py:60-78) and of Laplace
(plotting_laplace.py:13-90).

The JAX package runs one episode per pool row.  Here every row of a sweep is
one batch on the per-env env's leading axis (``reset_at`` on the given rows,
then ``step``), controlled and zero-action baseline rows together: the
policy's MLP op runs on the controlled rows only, and each row's results
equal the JAX row's.  The general per-env envs step on torch.fft, as the JAX
functions step the general vmapped env.  The files keep the JAX names, shapes
and keys.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from marlpde_tpu_torch.analysis import diagnostics, plotting
from marlpde_tpu_torch.core import spectral
from marlpde_tpu_torch.envs import advection_env, burger_env, diffusion_env, ks_env
from marlpde_tpu_torch.envs.burger_env import _draw_offset
from marlpde_tpu_torch.rl import vracer
from marlpde_tpu_torch.solvers import advection, diffusion
from marlpde_tpu_torch.utils.async_sink import AsyncSink


def _episodes(env_mod, cfg, pool, rl_cfg, ts, ids, offsets, n_ctrl: int):
    """One episode on each pool row of ``ids`` (B,), as one batch: rows
    [0, n_ctrl) act by the deterministic policy, the others take zero actions.
    Returns (traj, final state); traj holds (B, T, ...) tensors u, actions,
    reward, rel_err (the state's prev_rel_err) and ektt (the cumulative-mean
    LES spectrum)."""
    state, obs = env_mod.reset_at(cfg, pool, offsets, ids)
    dtype = state.solver.u.dtype
    zero = torch.zeros(ids.shape[0], cfg.num_agents, cfg.actions_per_agent, dtype=dtype,
                       device=obs.device)
    out = dict(u=[], actions=[], reward=[], rel_err=[], ektt=[])
    for _ in range(cfg.episode_length):
        a = zero
        if n_ctrl:
            a = torch.cat([vracer.act_deterministic(rl_cfg, ts, obs[:n_ctrl]), zero[n_ctrl:]])
        state, obs, rew, _done, _info = env_mod.step(cfg, pool, state, a)
        count = (state.solver.ioutnum + 1).to(dtype)
        out["u"].append(state.solver.u)
        out["actions"].append(a)
        out["reward"].append(rew)
        out["rel_err"].append(state.prev_rel_err)
        out["ektt"].append(state.ek_sum / count[:, None])
    return {k: torch.stack(v, dim=1) for k, v in out.items()}, state


def _rows(pool, ids, cfg, generator, repeat: int = 1):
    """Pool rows (the ids ``repeat`` times over) and their reset offsets: one
    draw per id, shared by its repeats (the JAX comparison resets the
    controlled and the baseline episode from one key)."""
    device, dtype = pool.uu.device, pool.uu.dtype
    offsets = _draw_offset(cfg, generator, len(ids), dtype, device)
    idt = torch.as_tensor(list(ids) * repeat, dtype=torch.int64, device=device)
    return idt, offsets.repeat(repeat)


def _np(x):
    return x.detach().cpu().numpy()


def evaluate_policy(cfg: burger_env.BurgerEnvConfig, pool, rl_cfg, ts,
                    out_dir: str = None, run_tag=0, generator=None, sample_ids=None,
                    file_suffix: str = ""):
    """Sweep the DNS pool with the deterministic policy.

    ``sample_ids`` restricts the sweep to specific pool rows (korali
    e["Solver"]["Testing"]["Sample Ids"], run-vracer-burger.py:203-210);
    default is the whole pool (burger_testing_environment.py behavior).
    ``file_suffix`` tags the .npy dumps (the run script's viscosity sweep
    writes one set per nu).  ``generator`` draws the reset offsets of noisy
    configs.

    Returns numpy relError (P, T), actions (P, T, NA), cumreward (P, na),
    dnsSgsTerms (P, T+1, g), sample_ids; writes the reference's .npy dumps when
    out_dir is given (burger_testing_environment.py:168-179)."""
    n_pool = int(pool.nu.shape[0])
    ids = (list(range(n_pool)) if sample_ids is None
           else [int(i) % n_pool for i in sample_ids])
    idt, offsets = _rows(pool, ids, cfg, generator)
    traj, final = _episodes(burger_env, cfg, pool, rl_cfg, ts, idt, offsets, len(ids))

    # DNS a-priori SGS terms (burger_environment.py:244), every row and frame at once
    dcfg = cfg.dns_solver
    dns_sgs = diagnostics.compute_sgs_burger(pool.uu[idt], dcfg.grid.k, dcfg.grid.dx, cfg.dt,
                                             pool.nu[idt], cfg.grid_size)["sgs_alt2"]
    out = dict(relError=_np(traj["rel_err"]),
               actions=_np(traj["actions"]).reshape(len(ids), cfg.episode_length, -1),
               cumreward=_np(final.cum_reward), dnsSgsTerms=_np(dns_sgs),
               sample_ids=np.asarray(ids))
    if out_dir:
        sink = AsyncSink(out_dir)
        sink.write(f"relError_{run_tag}{file_suffix}", out["relError"])
        sink.write(f"sgsTerms_{run_tag}{file_suffix}", out["actions"])
        sink.write(f"dnsSgsTerms_{run_tag}{file_suffix}", out["dnsSgsTerms"])
        sink.close()
    return out


def _dns_panels(cfg, pool, idt, sgs_history):
    """The DNS row of makePlot for each pool row of ``idt``: numpy x, tt, uu,
    ek_t, ek_ktt, sgs_history (spectra on the pool's device, all rows at once)."""
    dcfg = cfg.dns_solver
    ek = diagnostics.compute_ek(spectral.fft(pool.uu[idt]), dcfg.grid.dx)
    uu, ek_t, ek_ktt, sgs = (_np(a) for a in (pool.uu[idt], ek["Ek_t"], ek["Ek_ktt"],
                                               sgs_history))
    tt = np.arange(uu.shape[1]) * cfg.dt
    return [dict(x=dcfg.grid.x, tt=tt, uu=uu[i], ek_t=ek_t[i], ek_ktt=ek_ktt[i],
                 sgs_history=sgs[i]) for i in range(len(uu))]


def compare_with_uncontrolled(cfg: burger_env.BurgerEnvConfig, pool, rl_cfg, ts,
                              generator=None, sidx: int = 0, file_prefix: str = None):
    """The testing-mode branch (burger_environment.py:241-329): the controlled
    episode AND a zero-action baseline on pool row ``sidx`` (one batch of
    two); with ``file_prefix``, makePlot."""
    idt, offsets = _rows(pool, [sidx], cfg, generator, repeat=2)
    traj, final = _episodes(burger_env, cfg, pool, rl_cfg, ts, idt, offsets, 1)
    result = dict(controlled_cumreward=_np(final.cum_reward[0]),
                  baseline_cumreward=_np(final.cum_reward[1]),
                  controlled_rel_err=_np(traj["rel_err"][0]),
                  baseline_rel_err=_np(traj["rel_err"][1]))
    if not file_prefix:
        return result

    dcfg, lcfg = cfg.dns_solver, cfg.les_solver
    T, g = cfg.episode_length, cfg.grid_size
    tt = np.arange(1, T + 1) * cfg.dt * cfg.n_intermediate
    # DNS a-priori SGS terms — dns.sgsHistory for the 2x2 KDE figure
    # (plotting.py:346-407; terms from Burger.compute_Sgs)
    row = idt[:1]
    dns_sgs = diagnostics.compute_sgs_burger(pool.uu[row], dcfg.grid.k, dcfg.grid.dx, cfg.dt,
                                             pool.nu[row], g)["sgs"]
    dns = _dns_panels(cfg, pool, row, dns_sgs)[0]
    basis = np.asarray(burger_env.action_basis(cfg))   # (NA, N)
    a = _np(traj["actions"][0]).reshape(T, -1)
    ektt = _np(traj["ektt"][0])
    ctrl = dict(x=lcfg.grid.x, tt=tt, uu=_np(traj["u"][0]), ek_t=ektt.sum(-1), ek_ktt=ektt,
                # applied SGS forcing on the grid — sgs.sgsHistory
                action_fields=a, sgs_history=a @ basis)
    # the JAX baseline episode records no spectrum: its panels read zeros
    base = dict(x=lcfg.grid.x, tt=tt, uu=_np(traj["u"][1]), ek_t=np.zeros(T),
                ek_ktt=np.zeros((T, g)))
    return dict(result, panels=plotting.make_plot(dns, base, ctrl, file_prefix,
                                                  cfg.spectral_reward))


def ks_testing(cfg: ks_env.KSEnvConfig, pool, rl_cfg, ts, out_dir: str, run_tag=0,
               generator=None, sidx=0):
    """KS testing-mode branch (ks_environment.py:122-183): run the controlled
    episode, store the LES fields npz (x, t, uu, vv, L, N, dt, nu, tEnd —
    :122-127), compute the DNS a-priori SGS terms (:129-130 compute_Sgs), run
    the uncontrolled (zero-action) baseline (:132-178) and makePlot the
    three-way comparison (:183).

    ``sidx`` is one pool row, or a list of rows run as one batch with
    ``run_tag`` then a list of their tags (one file set per row).  Returns
    controlled/baseline cumrewards (na,) and rel errors (T,) of the row, with
    a leading row axis for a list."""
    many = not np.isscalar(sidx)
    ids = list(sidx) if many else [sidx]
    tags = list(run_tag) if many else [run_tag]
    if len(tags) != len(ids):
        raise ValueError(f"[evaluation] ks_testing: {len(ids)} rows but tags {tags}")
    n = len(ids)
    idt, offsets = _rows(pool, ids, cfg, generator, repeat=2)
    traj, final = _episodes(ks_env, cfg, pool, rl_cfg, ts, idt, offsets, n)

    os.makedirs(out_dir, exist_ok=True)
    lcfg, dcfg = cfg.les_solver, cfg.dns_solver
    T = cfg.episode_length
    tt = np.arange(1, T + 1) * cfg.dt * cfg.n_intermediate
    # DNS a-priori SGS terms (ks_environment.py:129-130 dns.compute_Sgs)
    sgs_terms = diagnostics.compute_sgs_ks(pool.uu[idt[:n]], dcfg.grid.k, dcfg.grid.dx,
                                           cfg.grid_size)
    dns_rows = _dns_panels(cfg, pool, idt[:n], sgs_terms)
    basis = np.asarray(ks_env.action_basis(cfg))         # (NA, g)
    u, actions, ektt = (_np(traj[k]) for k in ("u", "actions", "ektt"))

    def mk(r, with_sgs=False):
        d = dict(x=lcfg.grid.x, tt=tt, uu=u[r], ek_t=ektt[r].sum(-1), ek_ktt=ektt[r],
                 action_fields=actions[r].reshape(T, -1))
        if with_sgs:
            d["sgs_history"] = d["action_fields"] @ basis
        return d

    for i, tag in enumerate(tags):
        # the reference's controlled-LES dump (ks_environment.py:125-127)
        np.savez(os.path.join(out_dir, f"sgs_{tag}.npz"), x=np.asarray(lcfg.grid.x), t=tt,
                 uu=u[i], vv=np.fft.fft(u[i], axis=-1), L=cfg.L, N=cfg.grid_size, dt=cfg.dt,
                 nu=1.0, tEnd=cfg.t_sim)
        np.savez(os.path.join(out_dir, f"dnsSgs_{tag}.npz"), sgs=dns_rows[i]["sgs_history"])
        plotting.make_plot(dns_rows[i], mk(n + i), mk(i, with_sgs=True),
                           os.path.join(out_dir, f"ks_{tag}"), spectral=True)
    cum, rel = _np(final.cum_reward), _np(traj["rel_err"])
    out = dict(controlled_cumreward=cum[:n], baseline_cumreward=cum[n:],
               controlled_rel_err=rel[:n], baseline_rel_err=rel[n:])
    return out if many else {k: v[0] for k, v in out.items()}


def _simple_episode(env, rl_cfg, ts, state, obs, n_ctrl: int, truth=None):
    """One episode of every env of ``state``: rows [0, n_ctrl) act by the
    deterministic policy, the others take zero actions.  Returns numpy (B, T,
    ...) u, actions, reward, done (and truth, the analytical solution of each
    state, where ``truth`` gives it) and the final state."""
    B = obs.shape[0]
    zero = torch.zeros(B, env.num_agents, env.act_dim, dtype=obs.dtype, device=obs.device)
    out = dict(u=[], actions=[], reward=[], done=[], truth=[])
    for _ in range(env.episode_length):
        a = zero
        if n_ctrl:
            a = torch.cat([vracer.act_deterministic(rl_cfg, ts, obs[:n_ctrl]), zero[n_ctrl:]])
        state, obs, rew, done, _info = env.step(env.consts, state, a)
        out["u"].append(state.solver.u)
        out["actions"].append(a)
        out["reward"].append(rew)
        out["done"].append(done)
        if truth is not None:
            out["truth"].append(truth(state.solver))
    return {k: _np(torch.stack(v, dim=1)) for k, v in out.items() if v}, state


# the env module and solver of each family with an analytical solution
_SIMPLE_FAMILIES = {"diffusion": (diffusion_env, diffusion), "advection": (advection_env, advection)}


def simple_env_testing(env, rl_cfg, ts, out_dir: str, generator=None):
    """Testing-mode plots for the diffusion and advection families
    (diffusion_environment_simple.py:76-81: plotEvolution, plotActionField,
    plotActionDistribution, plotDiffusionField).  Runs ONE deterministic
    episode and, from the same offset (one draw of ``generator``), the
    uncontrolled zero-action episode, as one batch of two; records the solved
    field, the analytical solution and the expanded action fields; writes the
    evolution/actionfield/actiondist/field figures, makePlot's comparison
    (``compare``, spectral=False) and the error_rl_{N}.json convergence
    curves into out_dir."""
    cfg = env.cfg
    family = env.name.split("-")[0]
    if family not in _SIMPLE_FAMILIES:
        raise ValueError(f"[evaluation] simple_env_testing: no analytical solution for "
                         f"{env.name!r}")
    module, solver = _SIMPLE_FAMILIES[family]
    truth = lambda s: solver.analytical_sinus(s, cfg.solver)
    offset = diffusion_env.draw_offset(cfg.noise, generator, 1, env.dtype, env.device)
    state, obs = module.reset_at(cfg, offset.repeat(2))
    traj, final = _simple_episode(env, rl_cfg, ts, state, obs, 1, truth)

    os.makedirs(out_dir, exist_ok=True)
    x = np.asarray(cfg.solver.grid.x)
    uu, sol = traj["u"][0], traj["truth"][0]
    T = len(uu)
    tt = np.arange(1, T + 1) * cfg.solver.dt
    # actions -> fields on the grid (uniform per-agent blocks)
    a = traj["actions"][0].reshape(T, -1)
    afield = np.repeat(a, max(1, len(x) // a.shape[1]), axis=1)[:, : len(x)]
    plotting.plot_evolution_panels(x, tt, uu, sol, os.path.join(out_dir, "evolution.png"))
    plotting.plot_action_contour(x, tt, afield, os.path.join(out_dir, "actionfield.png"))
    plotting.plot_action_distribution(a, os.path.join(out_dir, "actiondist.png"))
    plotting.plot_field_contour(x, tt, uu, os.path.join(out_dir, "field.png"))

    # the older inline-plot variant's 3x6 truth/uncontrolled/controlled panel
    # (advection_environment.py:121-223, makePlot's family): field contours,
    # error traces, end spectra, action trajectories
    fields = torch.as_tensor(np.stack([sol, traj["u"][1], uu]), device=env.device)
    ek = _np(diagnostics.compute_ek(spectral.fft(fields), cfg.solver.grid.dx)["Ek_ktt"])
    panels = [dict(x=x, tt=tt, uu=f, ek_ktt=e) for f, e in zip(_np(fields), ek)]
    for d, r in zip(panels[1:], (1, 0)):
        d["action_fields"] = traj["actions"][r].reshape(T, -1)
    plotting.make_plot(*panels, os.path.join(out_dir, "compare"), spectral=False)

    # the reference's learned-policy convergence artifact
    # (plotting_diffusion.py:60-78 plotConvergence -> error_{N}.json, the only
    # checked-in learned-RL results of the reference repo,
    # diffusion_errors/error_{8,16,32,128}.json): mse/linf/mass curves of the
    # deterministic policy against the analytical solution, and how long it
    # survived the early-stop rule, counted to the first done
    done = traj["done"][0]
    survived = int(done.argmax()) + 1 if done.any() else T
    curves = diagnostics.error_curves(uu[:survived], sol[:survived], tt[:survived])
    curves["survived_steps"] = survived
    curves["episode_length"] = int(cfg.episode_length)
    diagnostics.write_error_json(os.path.join(out_dir, f"error_rl_{len(x)}.json"), curves)
    return dict(cumreward=_np(final.cum_reward[0]), uu=uu, solution=sol)


def laplace_testing(env, rl_cfg, ts, out_dir: str, generator=None):
    """Laplace testing plots (plotting_laplace.py:13-90) of one deterministic
    episode: evolution panels with the FD laplacian ("gradient") dashed, the 3
    stencil-channel action contours, the gradient-field contour (hessian),
    the per-channel action distribution and the field contour."""
    cfg = env.cfg
    state, obs = env.reset(env.consts, generator, torch.arange(1, device=env.device))
    traj, final = _simple_episode(env, rl_cfg, ts, state, obs, 1)
    os.makedirs(out_dir, exist_ok=True)
    x = np.asarray(cfg.solver.grid.x)
    dx = float(cfg.solver.grid.dx)
    uu = traj["u"][0]                               # (T, N)
    tt = np.arange(1, len(uu) + 1) * cfg.solver.dt
    # the reference's gradientHistory: centered-FD laplacian of u
    grad = (np.roll(uu, -1, 1) - 2 * uu + np.roll(uu, 1, 1)) / dx**2
    a = traj["actions"][0]                          # (T, na, 3)
    join = lambda name: os.path.join(out_dir, name)
    plotting.plot_evolution_panels(x, tt, uu, None, join("evolution.png"), second=grad)
    # agents act on rows 1..N-1 (plotting_laplace.py:34-56)
    plotting.plot_action_contour(x[1:], tt, a, join("actions.png"))
    # the gradient-field contour, "hessian.pdf" (plotting_laplace.py:58-72)
    plotting.plot_field_contour(x, tt, grad, join("hessian.png"), levels=50)
    plotting.plot_action_distribution(a, join("actiondist.png"))
    plotting.plot_field_contour(x, tt, uu, join("field.png"))
    return dict(cumreward=_np(final.cum_reward[0]), uu=uu, gradient=grad)
