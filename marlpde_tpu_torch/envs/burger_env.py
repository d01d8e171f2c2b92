"""Burgers subgrid-closure environment: DNS ground truth, coarse LES with
per-gridpoint action forcing, MSE, spectral-energy or coupled rewards (port of
marlpde_tpu/envs/burger_env.py).

Parity target: burger_environment.py (episode protocol at :18-204) with the
Burger solver (Burger.py):

  * reset: pick the DNS from the pool (episodeCount % ndns, :54-55), draw the
    random phase offset, transplant the IC (spectral restriction + phase shift,
    or the cubic spline of the truth at the shifted coarse grid, :109-119),
    copy the forcing tables (:99-100);
  * step: n_intermediate solver sub-steps with the action field held fixed
    (:148-149), then the reward:
      - MSE: mean over sub-steps of per-agent -(truth - u)^2 means (:152-153);
      - spectral: decrement of the cumulative-spectrum relative error (:172-176);
      - coupled: baseline MSE minus LES MSE against an uncontrolled re-run of
        the macro-step (coupled_burger_environment.py:76-128);
    NaN/Inf guards set done and the truncation penalty (:164-167, 181-184);
  * lockstep mode: a fresh DNS per episode advanced beside the LES, no pool.

The DNS pool is built once in float64 numpy on the host (the JAX package's
``_make_dns_pool_host``) and placed on the device.  The JAX package vmaps its
per-env (reset, step) pair; here both are written over a leading env axis
(B, ...).  The flagship path's step is the whole-batch ``envs/burger_fast.step``
on the ABCN op; this one runs the torch.fft solver and covers every config.
"""

from __future__ import annotations

import dataclasses
from functools import lru_cache

import numpy as np
import torch

from marlpde_tpu_torch.core import basis as basis_mod
from marlpde_tpu_torch.device import constant, grid_array
from marlpde_tpu_torch.core import ic, interp, spectral
from marlpde_tpu_torch.envs import features
from marlpde_tpu_torch.solvers import burger


@dataclasses.dataclass(frozen=True, eq=True)
class BurgerEnvConfig:
    """Mirrors run-vracer-burger.py:5-34 defaults; fields as in the JAX
    package so configs carry over."""

    N_dns: int = 512
    grid_size: int = 32
    num_actions: int = 32
    num_agents: int = 1
    L: float = 2.0 * np.pi
    dt: float = 0.001
    T: float = 5.0
    nu: float = 0.02
    episode_length: int = 500
    ic_case: str = "sinus"           # 'sinus' | 'turbulence' | 'zero' | 'forced'
    spectral_reward: bool = False
    forcing: bool = False
    dforce: bool = True
    ssmforce: bool = False
    noise: float = 0.0               # offset stddev in units of L (Burger.py:54)
    seed: int = 42
    stepper: int = 1
    nunoise: bool = False
    version: int = 0
    ssm: bool = False
    dsm: bool = False
    basis_kind: str = "hat"          # burger_environment.py:9
    scheme: str = "abcn"             # 'fd' gives the Burger_fd env
    reward_factor: float = 1.0
    truncation_penalty: float = -np.inf   # burger_environment.py:200
    coupled: bool = False            # baseline-relative reward (coupled_burger_environment.py)
    dns_mode: str = "pool"           # 'pool' | 'lockstep' (fresh DNS per episode,
                                     # advanced alongside the LES — the nunoise
                                     # path of burger_environment.py:57-75)
    state_bound: float = np.inf      # |state| sanity bound; the FD env truncates
                                     # at 1e6 (burger_fd_environment.py:165)
    # Kept for config compatibility; the port always transforms with torch.fft.
    fft_impl: str = "fft"

    @property
    def n_dns_steps(self) -> int:
        return int(self.T / self.dt)

    @property
    def n_intermediate(self) -> int:
        n = int(self.T / self.dt / self.episode_length)
        assert n > 0, "dt or episodeLength too long (burger_environment.py:130)"
        return n

    @property
    def dns_solver(self) -> burger.BurgerConfig:
        return burger.BurgerConfig(N=self.N_dns, L=self.L, dt=self.dt, nu=self.nu,
                                   stepper=self.stepper, forcing=self.forcing)

    @property
    def les_solver(self) -> burger.BurgerConfig:
        return burger.BurgerConfig(N=self.grid_size, L=self.L, dt=self.dt, nu=self.nu,
                                   stepper=self.stepper, forcing=self.forcing,
                                   dforce=self.dforce, ssmforce=self.ssmforce,
                                   ssm=self.ssm, dsm=self.dsm, scheme=self.scheme,
                                   fft_impl=self.fft_impl)

    @property
    def obs_dim(self) -> int:
        return features.obs_dim(self.version, self.grid_size, self.num_agents)

    @property
    def actions_per_agent(self) -> int:
        return self.num_actions // self.num_agents


@dataclasses.dataclass
class DnsPool:
    """Precomputed DNS ground truth shared by all envs (leading axis = pool)."""

    uu: torch.Tensor        # (P, T+1, N_dns) trajectory
    spline_m: torch.Tensor  # (P, T+1, N_dns) periodic-spline coefficients of uu
    v0_re: torch.Tensor     # (P, N_dns) IC spectrum, real part
    v0_im: torch.Tensor     # (P, N_dns) IC spectrum, imaginary part
    ek_ktt: torch.Tensor    # (P, T+1, g//2) cumulative-mean spectrum, cols 0..g/2-1
    nu: torch.Tensor        # (P,)
    randfac1: torch.Tensor  # (P, 4, s)
    randfac2: torch.Tensor  # (P, 4, s)
    # DNS truth pre-restricted to the LES grid (P, T+1, g), the reference's
    # setGroundTruth pattern (Burger.py:322-327).  Built for MSE-reward configs
    # with N_dns % g == 0, where the LES gridpoints coincide with every
    # (N_dns/g)-th DNS point and the cubic spline is exact at its knots: the
    # per-substep reward then gathers g values instead of evaluating a spline.
    truth_les: torch.Tensor | None = None

    @property
    def v0(self):
        return torch.complex(self.v0_re, self.v0_im)

    @property
    def device(self) -> torch.device:
        return self.uu.device

    @property
    def dtype(self) -> torch.dtype:
        return self.uu.dtype


@dataclasses.dataclass(frozen=True)
class LockstepConsts:
    """The lockstep env's consts: no pool, only where and in which dtype its
    envs live."""

    device: torch.device
    dtype: torch.dtype


@dataclasses.dataclass
class BurgerEnvState:
    """Batched env state (leading axis = env)."""

    solver: burger.BurgerState
    u_prev: torch.Tensor        # previous sub-step field (for the dudt feature)
    sidx: torch.Tensor          # int64 DNS pool index
    macro_step: torch.Tensor    # int64
    ek_sum: torch.Tensor        # (B, g) running sum of LES Ek_kt incl. IC frame
    prev_rel_err: torch.Tensor  # (B,)
    done: torch.Tensor          # (B,) bool
    cum_reward: torch.Tensor    # (B, num_agents)


@lru_cache(maxsize=32)
def action_basis(cfg: BurgerEnvConfig) -> np.ndarray:
    return basis_mod.make_basis(cfg.num_actions, cfg.grid_size, cfg.L, cfg.basis_kind)


def _wants_truth_les(cfg: BurgerEnvConfig) -> bool:
    """The pool carries the pre-restricted truth channel (DnsPool.truth_les)
    when the MSE reward needs per-substep truth and the grids nest exactly."""
    return (not cfg.spectral_reward and not cfg.coupled
            and cfg.N_dns % cfg.grid_size == 0)


def make_dns_pool(cfg: BurgerEnvConfig, n_dns: int, dtype=torch.float32,
                  device=None) -> DnsPool:
    """Simulate the DNS pool (burger_environment.py:11-16, seeds seed+i per
    run-vracer-burger.py:47) in float64 numpy on the host, then place it on
    ``device`` in ``dtype``: the JAX package's host build
    (``_make_dns_pool_host``), literal ABCN per Burger.py:482-489, with the
    stepper-cycled stochastic forcing (Burger.py:410-421) where configured."""
    N, L, dt = cfg.N_dns, cfg.L, cfg.dt
    k = np.fft.fftfreq(N, L / (2 * np.pi * N))
    k1 = 1j * k
    x = np.linspace(0, L, N, endpoint=False)
    nsteps = cfg.n_dns_steps
    rows = []
    # tables/nu come from numpy Philox seeded by (seed, i)
    for i in range(n_dns):
        hrng = np.random.default_rng([cfg.seed, i])
        rf1 = hrng.standard_normal((4, cfg.stepper))
        rf2 = hrng.standard_normal((4, cfg.stepper))
        nu = cfg.nu
        if cfg.nunoise:
            nu = 0.01 + 0.02 * float(hrng.uniform())
        if cfg.ic_case == "turbulence":
            u0 = ic.burger_turbulence_numpy(cfg.seed + i, 0.0, x, L)
        elif cfg.ic_case == "sinus":
            u0 = np.sin(4.0 * np.pi * x / L)
        elif cfg.ic_case == "zero":
            u0 = np.zeros(N)
        elif cfg.ic_case == "box":
            # Burger_jax.py:215-216
            u0 = (np.abs(x - L / 2) < L / 8).astype(float)
        elif cfg.ic_case == "gaussian":
            # Burger_jax.py:15-16,208-213: normalized pdf, mean L/2, sigma L/8
            sigma = L / 8
            u0 = (np.exp(-0.5 * ((x - 0.5 * L) / sigma) ** 2)
                  / np.sqrt(2 * np.pi * sigma ** 2))
        elif cfg.ic_case == "forced":
            u0 = ic.burger_forced_numpy(cfg.seed + i, x, L)
        else:
            raise ValueError(f"[burger_env] unknown ic {cfg.ic_case}")
        uu = np.empty((nsteps + 1, N))
        vv = np.empty((nsteps + 1, N), complex)
        u = u0.copy()
        v = np.fft.fft(u0)
        uu[0], vv[0] = u, v
        fn_old = k1 * np.fft.fft(0.5 * u0 * u0)
        C = 0.5 * (k**2) * nu * dt
        if cfg.forcing:
            # the stepper-cycled forcing spectra; the DNS forcing has no phase
            # offset, unlike the LES's stochastic_forcing
            A = np.sqrt(2.0) / L
            fcols = np.zeros((cfg.stepper, N))
            for ridx in range(cfg.stepper):
                for kk in range(1, 4):
                    fcols[ridx] += (rf1[kk, ridx] * A
                                    / np.sqrt(kk * cfg.stepper * dt)
                                    * np.cos(2 * np.pi * kk * x / L
                                             + 2 * np.pi * rf2[kk, ridx]))
            fcols_hat = np.fft.fft(fcols, axis=-1)
        for n in range(nsteps):
            F = fcols_hat[n % cfg.stepper] if cfg.forcing else 0.0
            Fn = k1 * np.fft.fft(0.5 * u * u)
            v = ((1.0 - C) * v - 0.5 * dt * (3.0 * Fn - fn_old) + dt * F) / (1.0 + C)
            fn_old = Fn
            u = np.real(np.fft.ifft(v))
            uu[n + 1], vv[n + 1] = u, v
        ek_kt = 0.5 * np.abs(vv) ** 2 / N * (L / N)
        ek_ktt = (np.cumsum(ek_kt, 0)
                  / np.arange(1, nsteps + 2)[:, None])[:, : cfg.grid_size // 2]
        # periodic-spline coefficients (circulant solve, interp.periodic_spline_m)
        d2 = np.roll(uu, 1, -1) - 2.0 * uu + np.roll(uu, -1, -1)
        eig = 4.0 + 2.0 * np.cos(2.0 * np.pi * np.arange(N) / N)
        m = np.real(np.fft.ifft(np.fft.fft(6.0 * d2, axis=-1) / eig, axis=-1))
        row = dict(uu=uu, spline_m=m, v0_re=vv[0].real, v0_im=vv[0].imag,
                   ek_ktt=ek_ktt, nu=nu, randfac1=rf1, randfac2=rf2)
        if _wants_truth_les(cfg):
            row["truth_les"] = uu[:, :: N // cfg.grid_size]
        rows.append(row)
    # cast in numpy, then one transfer per field
    rtype = np.float64 if dtype == torch.float64 else np.float32
    stacked = {name: torch.from_numpy(np.ascontiguousarray(
        np.stack([r[name] for r in rows]).astype(rtype))).to(device)
        for name in rows[0]}
    return DnsPool(**stacked)


def _draw_offset(cfg: BurgerEnvConfig, generator, batch: int, dtype, device):
    """offset ~ N(0, noise*L) conditioned on |offset| <= L (Burger.py:53-57),
    by inverting the normal CDF on the truncated range."""
    if cfg.noise <= 0.0:
        return torch.zeros(batch, dtype=dtype, device=device)
    sigma = cfg.noise * cfg.L
    lim = torch.tensor(cfg.L / sigma, dtype=torch.float64)
    lo, hi = torch.special.ndtr(-lim).item(), torch.special.ndtr(lim).item()
    p = torch.rand(batch, generator=generator, dtype=torch.float64, device=device)
    return (sigma * torch.special.ndtri(lo + (hi - lo) * p)).to(dtype)


def reset(cfg: BurgerEnvConfig, pool: DnsPool, generator, episode_counts):
    """Start a batch of episodes; returns (state, obs).

    episode_counts: (B,) int tensor; the phase offsets come from ``generator``."""
    offset = _draw_offset(cfg, generator, episode_counts.shape[0],
                          pool.uu.dtype, pool.uu.device)
    return reset_at(cfg, pool, offset, episode_counts)


def reset_at(cfg: BurgerEnvConfig, pool: DnsPool, offset, episode_counts):
    """``reset`` with the phase offsets (B,) given.  Pool fields are indexed
    per field and, where a frame suffices, per frame: never a whole row."""
    n_pool = pool.nu.shape[0]
    sidx = episode_counts.to(torch.int64) % n_pool
    dtype, device = pool.dtype, pool.device
    lcfg = cfg.les_solver
    nu, rf1, rf2 = pool.nu[sidx], pool.randfac1[sidx], pool.randfac2[sidx]
    if cfg.spectral_reward:
        # spectral restriction + phase shift (burger_environment.py:110-112)
        dns_k = grid_array(cfg.dns_solver.grid, "k", dtype, device)
        v0 = torch.complex(pool.v0_re[sidx], pool.v0_im[sidx])
        v0 = spectral.restrict_modes(spectral.phase_shift(v0, offset[:, None], dns_k),
                                     cfg.grid_size)
        st = burger.init(lcfg, v0=v0, nu=nu, offset=offset, randfac1=rf1, randfac2=rf2)
    else:
        # the truth's spline at the shifted coarse grid (burger_environment.py:114-119)
        newx = interp.shifted_query_points(
            grid_array(lcfg.grid, "x", dtype, device), offset[:, None], cfg.L)
        u0 = interp.periodic_spline_eval(pool.uu[sidx, 0], pool.spline_m[sidx, 0], newx,
                                         cfg.L)
        st = burger.init(lcfg, u0=u0, nu=nu, offset=offset, randfac1=rf1, randfac2=rf2)
    B = sidx.shape[0]
    state = BurgerEnvState(
        solver=st, u_prev=st.u, sidx=sidx,
        macro_step=torch.zeros(B, dtype=torch.int64, device=device),
        ek_sum=spectral.energy_spectrum(st.v, lcfg.grid.dx),
        prev_rel_err=torch.zeros(B, dtype=dtype, device=device),
        done=torch.zeros(B, dtype=torch.bool, device=device),
        cum_reward=torch.zeros(B, cfg.num_agents, dtype=dtype, device=device))
    return state, _observe(cfg, state)


def _observe(cfg: BurgerEnvConfig, state: BurgerEnvState):
    return features.burger_features(
        cfg.version, cfg.num_agents, state.solver.u, state.u_prev,
        state.solver.v, cfg.dt, cfg.les_solver.grid.dx)


def _mse_rewards(cfg: BurgerEnvConfig, pool: DnsPool, sidx, solver_state):
    """Per-agent -(truth(x+offset, t) - u)^2 means (Burger.py:578-601).

    Offset-free configs read the pre-restricted truth channel, one (g,) gather
    per substep (DnsPool.truth_les).  With a per-episode offset the queries
    fall between DNS knots, so the frame is gathered and spline-evaluated.  A
    done env's clock runs past the table: ``frame_index`` clamps, as JAX's
    gather does (on the card an index past the table is a device assert)."""
    fidx = interp.frame_index(solver_state.t, cfg.dt, pool.uu.shape[1])
    if cfg.noise == 0.0 and pool.truth_les is not None:
        sq = (pool.truth_les[sidx, fidx] - solver_state.u) ** 2
        return -features.agent_block_mean(sq, cfg.num_agents)
    return _mse_from_frame(cfg, pool.uu[sidx, fidx], pool.spline_m[sidx, fidx],
                           solver_state)


def _mse_from_frame(cfg: BurgerEnvConfig, frame_u, frame_m, solver_state):
    """MSE reward against already gathered DNS frames (B, N_dns): the queries
    are x_coarse + offset, so the spline is evaluated on the uniform grid."""
    truth = interp.periodic_spline_eval_uniform(frame_u, frame_m, solver_state.offset,
                                                cfg.L, cfg.grid_size)
    sq = (truth - solver_state.u) ** 2
    return -features.agent_block_mean(sq, cfg.num_agents)


def _coupled_rewards(cfg: BurgerEnvConfig, pool: DnsPool, state: BurgerEnvState, sol):
    """Baseline-relative reward (coupled_burger_environment.py:76-128): re-run
    the macro-step uncontrolled with explicit-Euler spectral updates from the
    pre-step LES field; reward = reward_factor * (baseMSE - lesMSE), (B,)."""
    lcfg = cfg.les_solver
    v = state.solver.v
    k1 = grid_array(lcfg.grid, "k1", v.dtype, v.device)
    k2 = grid_array(lcfg.grid, "k2", v.dtype, v.device)
    nu = state.solver.nu[:, None]
    ub, vb = state.solver.u, v
    for _ in range(cfg.n_intermediate):
        vb = vb - cfg.dt * 0.5 * k1 * spectral.fft(ub * ub) + cfg.dt * nu * k2 * vb
        ub = spectral.irfft_real(vb)
    newx = grid_array(lcfg.grid, "x", sol.u.dtype, v.device)
    fidx = interp.frame_index(sol.t, cfg.dt, pool.uu.shape[1])
    truth = interp.periodic_spline_eval(pool.uu[state.sidx, fidx],
                                        pool.spline_m[state.sidx, fidx], newx, cfg.L)
    les_mse = torch.mean((truth - sol.u) ** 2, dim=-1)
    base_mse = torch.mean((truth - ub) ** 2, dim=-1)
    return cfg.reward_factor * (base_mse - les_mse)


def _keep(was, new, old):
    """``old`` where the env was already done, else ``new`` (leading env axis)."""
    return torch.where(was.reshape((-1,) + (1,) * (new.ndim - 1)), old, new)


def _keep_solver(was, new, old):
    return burger.BurgerState(**{f.name: _keep(was, getattr(new, f.name), getattr(old, f.name))
                                 for f in dataclasses.fields(burger.BurgerState)})


def step(cfg: BurgerEnvConfig, pool: DnsPool, state: BurgerEnvState, actions):
    """One macro-step of every env.  actions: (B, num_agents, actions_per_agent)
    or (B, num_actions).

    Returns (state, obs, reward (B, na), done (B,), info).  Envs already done
    still step; their results are discarded by selection, never by a mask
    product, since blown envs hold inf/NaN."""
    dtype = state.solver.u.dtype
    device = state.solver.u.device
    lcfg = cfg.les_solver
    dx = lcfg.grid.dx
    g = cfg.grid_size
    B = state.solver.u.shape[0]
    basis = constant(action_basis, cfg, dtype=dtype, device=device)
    action_field = actions.reshape(B, -1) @ basis                 # Burger.py:437,442
    mse = not cfg.spectral_reward and not cfg.coupled

    sol, ek_sum, u_prev = state.solver, state.ek_sum, state.u_prev
    mse_acc = torch.zeros(B, cfg.num_agents, dtype=dtype, device=device)
    for _ in range(cfg.n_intermediate):
        u_prev = sol.u
        sol, _aux = burger.step(lcfg, sol, action_field)
        ek_sum = ek_sum + spectral.energy_spectrum(sol.v, dx)
        if mse:
            mse_acc = mse_acc + _mse_rewards(cfg, pool, state.sidx, sol) / cfg.n_intermediate

    new_prev = state.prev_rel_err
    if cfg.coupled:
        reward = _coupled_rewards(cfg, pool, state, sol)[:, None].expand(B, cfg.num_agents)
    elif cfg.spectral_reward:
        # cumulative-mean spectra at the current LES step (burger_environment.py:172-176);
        # a frozen env's step counter can run past the table: clamp as a JAX gather does
        count = (sol.ioutnum + 1).to(dtype)
        sgs_ektt = ek_sum[:, 1: g // 2] / count[:, None]
        t_idx = sol.ioutnum.clamp(max=pool.ek_ktt.shape[1] - 1)
        dns_ektt = pool.ek_ktt[state.sidx, t_idx, 1: g // 2]
        new_prev = torch.mean(((torch.abs(dns_ektt - sgs_ektt)) / dns_ektt) ** 2, dim=-1)
        reward = (cfg.reward_factor * (state.prev_rel_err - new_prev))[:, None].expand(
            B, cfg.num_agents)
    else:
        reward = cfg.reward_factor * mse_acc

    obs_ok = torch.isfinite(sol.u).all(-1)
    if np.isfinite(cfg.state_bound):
        obs_ok = obs_ok & (sol.u.abs().amax(-1) <= cfg.state_bound)
    blown = ~(obs_ok & torch.isfinite(reward).all(-1))
    reward = torch.where(blown[:, None], torch.full_like(reward, cfg.truncation_penalty),
                         reward)
    macro = state.macro_step + 1
    done = blown | (macro >= cfg.episode_length) | state.done

    was = state.done
    zero = torch.zeros_like(reward)
    new_state = BurgerEnvState(
        solver=_keep_solver(was, sol, state.solver), u_prev=_keep(was, u_prev, state.u_prev),
        sidx=state.sidx, macro_step=_keep(was, macro, state.macro_step),
        ek_sum=_keep(was, ek_sum, state.ek_sum),
        prev_rel_err=_keep(was, new_prev, state.prev_rel_err), done=done,
        cum_reward=state.cum_reward + torch.where(was[:, None], zero, reward))
    reward = torch.where(was[:, None], zero, reward)
    obs = _observe(cfg, new_state)
    obs = torch.where(torch.isfinite(obs), obs, torch.zeros_like(obs))
    return new_state, obs, reward, done, dict(blown=blown)


# ----------------------------------------------------------- lockstep-DNS mode

@dataclasses.dataclass
class BurgerLockstepState:
    """Env state carrying its own DNS, advanced alongside the LES (leading
    axis = env).  The reference rebuilds a full DNS per episode under nunoise
    (burger_environment.py:57-75); running it in lockstep keeps the memory
    O(N_dns) per env and the values exact."""

    les: burger.BurgerState
    dns: burger.BurgerState
    u_prev: torch.Tensor
    macro_step: torch.Tensor
    ek_sum: torch.Tensor          # (B, g) LES running spectrum sum
    dns_ek_sum: torch.Tensor      # (B, g//2) DNS running spectrum sum, first g//2 cols
    prev_rel_err: torch.Tensor
    done: torch.Tensor
    cum_reward: torch.Tensor


def reset_lockstep(cfg: BurgerEnvConfig, consts: LockstepConsts, generator, episode_counts):
    """Fresh DNS per episode: nu ~ U(0.01, 0.03) under nunoise (Burger.py:89),
    the offset and the forcing tables drawn from ``generator``, turbulence
    seed cfg.seed + episode count; in the consts' dtype on their device."""
    B = episode_counts.shape[0]
    dtype, device = consts.dtype, consts.device
    nu = torch.full((B,), cfg.nu, dtype=dtype, device=device)
    if cfg.nunoise:
        nu = 0.01 + 0.02 * torch.rand(B, generator=generator, dtype=dtype, device=device)
    offset = _draw_offset(cfg, generator, B, dtype, device)
    rf1, rf2 = burger.draw_forcing_tables(generator, cfg.stepper, dtype, (B,), device)
    return reset_lockstep_at(cfg, nu, offset, rf1, rf2, episode_counts)


def reset_lockstep_at(cfg: BurgerEnvConfig, nu, offset, rf1, rf2, episode_counts):
    """``reset_lockstep`` with the draws given: nu and offset (B,), the
    forcing tables (B, 4, s); dtype and device are the offset's."""
    dtype, device = offset.dtype, offset.device
    dcfg, lcfg = cfg.dns_solver, cfg.les_solver
    g, B = cfg.grid_size, offset.shape[0]
    x_d = grid_array(dcfg.grid, "x", dtype, device)
    if cfg.ic_case == "turbulence":
        u0_d = ic.burger_turbulence(cfg.seed + episode_counts.to(torch.int64), 0.0, x_d, cfg.L)
    elif cfg.ic_case == "sinus":
        u0_d = ic.burger_sinus(0.0, x_d, cfg.L).expand(B, -1).clone()
    else:
        u0_d = torch.zeros(B, cfg.N_dns, dtype=dtype, device=device)
    dns = burger.init(dcfg, u0=u0_d, nu=nu, randfac1=rf1, randfac2=rf2)
    dns_k = grid_array(dcfg.grid, "k", dtype, device)
    v0 = spectral.restrict_modes(spectral.phase_shift(dns.v, offset[:, None], dns_k), g)
    les = burger.init(lcfg, v0=v0, nu=nu, offset=offset, randfac1=rf1, randfac2=rf2)
    state = BurgerLockstepState(
        les=les, dns=dns, u_prev=les.u,
        macro_step=torch.zeros(B, dtype=torch.int64, device=device),
        ek_sum=spectral.energy_spectrum(les.v, lcfg.grid.dx),
        dns_ek_sum=spectral.energy_spectrum(dns.v, dcfg.grid.dx)[:, : g // 2],
        prev_rel_err=torch.zeros(B, dtype=dtype, device=device),
        done=torch.zeros(B, dtype=torch.bool, device=device),
        cum_reward=torch.zeros(B, cfg.num_agents, dtype=dtype, device=device))
    obs = features.burger_features(cfg.version, cfg.num_agents, les.u, les.u, les.v, cfg.dt,
                                   lcfg.grid.dx)
    return state, obs


def step_lockstep(cfg: BurgerEnvConfig, consts, state: BurgerLockstepState, actions):
    """Macro-step advancing DNS and LES together; rewards as in ``step``.

    The MSE reward interpolates the *current* DNS field (a cubic periodic
    spline built on the fly); the spectral reward uses running cumulative-mean
    spectra on both sides (equal in value to the pool path, since the DNS
    step index always equals the LES one)."""
    dtype = state.les.u.dtype
    device = state.les.u.device
    dcfg, lcfg = cfg.dns_solver, cfg.les_solver
    dx_l, dx_d = lcfg.grid.dx, dcfg.grid.dx
    g = cfg.grid_size
    B = state.les.u.shape[0]
    basis = constant(action_basis, cfg, dtype=dtype, device=device)
    action_field = actions.reshape(B, -1) @ basis
    x_l = grid_array(lcfg.grid, "x", dtype, device)

    les, dns, u_prev = state.les, state.dns, state.u_prev
    ek_sum, dns_ek = state.ek_sum, state.dns_ek_sum
    mse_acc = torch.zeros(B, cfg.num_agents, dtype=dtype, device=device)
    for _ in range(cfg.n_intermediate):
        u_prev = les.u
        les, _ = burger.step(lcfg, les, action_field)
        dns, _ = burger.step(dcfg, dns)
        ek_sum = ek_sum + spectral.energy_spectrum(les.v, dx_l)
        dns_ek = dns_ek + spectral.energy_spectrum(dns.v, dx_d)[:, : g // 2]
        if not cfg.spectral_reward:
            newx = interp.shifted_query_points(x_l, les.offset[:, None], cfg.L)
            sq = (interp.cubic_interp(dns.u, newx, cfg.L) - les.u) ** 2
            mse_acc = mse_acc - features.agent_block_mean(sq, cfg.num_agents) \
                / cfg.n_intermediate

    new_prev = state.prev_rel_err
    if cfg.spectral_reward:
        count = (les.ioutnum + 1).to(dtype)[:, None]
        sgs_ektt = ek_sum[:, 1: g // 2] / count
        dns_ektt = dns_ek[:, 1: g // 2] / count
        new_prev = torch.mean(((torch.abs(dns_ektt - sgs_ektt)) / dns_ektt) ** 2, dim=-1)
        reward = (cfg.reward_factor * (state.prev_rel_err - new_prev))[:, None].expand(
            B, cfg.num_agents)
    else:
        reward = cfg.reward_factor * mse_acc

    blown = ~(torch.isfinite(les.u).all(-1) & torch.isfinite(reward).all(-1))
    reward = torch.where(blown[:, None], torch.full_like(reward, cfg.truncation_penalty),
                         reward)
    macro = state.macro_step + 1
    done = blown | (macro >= cfg.episode_length) | state.done

    was = state.done
    zero = torch.zeros_like(reward)
    new_state = BurgerLockstepState(
        les=_keep_solver(was, les, state.les), dns=_keep_solver(was, dns, state.dns),
        u_prev=_keep(was, u_prev, state.u_prev),
        macro_step=_keep(was, macro, state.macro_step),
        ek_sum=_keep(was, ek_sum, state.ek_sum),
        dns_ek_sum=_keep(was, dns_ek, state.dns_ek_sum),
        prev_rel_err=_keep(was, new_prev, state.prev_rel_err), done=done,
        cum_reward=state.cum_reward + torch.where(was[:, None], zero, reward))
    reward = torch.where(was[:, None], zero, reward)
    les = new_state.les
    obs = features.burger_features(cfg.version, cfg.num_agents, les.u, new_state.u_prev,
                                   les.v, cfg.dt, dx_l)
    obs = torch.where(torch.isfinite(obs), obs, torch.zeros_like(obs))
    return new_state, obs, reward, done, dict(blown=blown)
