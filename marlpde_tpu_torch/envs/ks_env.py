"""Kuramoto-Sivashinsky closure environment (port of
marlpde_tpu/envs/ks_env.py:31-327).

Parity target: ks_environment.py (module constants at :5-12, DNS setup with
transient at :18-34, episode loop, spectral reward identical in form to the
Burgers env at :98-100) with the KS solver (KS.py).

DNS recipe (ks_environment.py:18-34): simulate a transient of tTransient time
units from a noise IC, restart from the final field, then simulate
tEnd-tTransient.  State features (KS.py:369-383): concat(dudx, d2udx2) with
centered differences; several agents see per-agent halo slices of both.
Reward: the spectral cumulative-error decrement (ks_environment.py:98-100) or
the pointwise -(|u - truth|) (KS.py:360-367).

The JAX package vmaps its per-env (reset, step) pair; here both are written
over a leading env axis (B, ...).  The DNS pool is built on the host in
float64 numpy, then placed on the device; it holds the initial spectrum as one
complex tensor.  The TPU workarounds of the JAX pool (the re/im split, the
numpy-side cast, ``fft_impl``) have no counterpart.
"""

from __future__ import annotations

import dataclasses
from functools import lru_cache

import numpy as np
import torch

from marlpde_tpu_torch.core import basis as basis_mod
from marlpde_tpu_torch.core import interp, spectral
from marlpde_tpu_torch.device import constant, grid_array
from marlpde_tpu_torch.envs import features
from marlpde_tpu_torch.envs.burger_env import _draw_offset
from marlpde_tpu_torch.solvers import ks


@dataclasses.dataclass(frozen=True, eq=True)
class KSEnvConfig:
    """Mirrors ks_environment.py:5-12 and run-vracer-ks.py defaults; the JAX
    package's fields without ``fft_impl``."""

    N_dns: int = 1024
    grid_size: int = 32
    num_actions: int = 32
    num_agents: int = 1
    L: float = 22.0
    dt: float = 0.25
    t_transient: float = 50.0
    t_end: float = 550.0
    episode_length: int = 500
    spectral_reward: bool = True
    dforce: bool = True
    noise: float = 0.0
    seed: int = 42
    basis_kind: str = "hat"
    reward_factor: float = 1.0
    truncation_penalty: float = -np.inf

    @property
    def t_sim(self) -> float:
        return self.t_end - self.t_transient

    @property
    def n_dns_steps(self) -> int:
        return int(self.t_sim / self.dt)

    @property
    def n_intermediate(self) -> int:
        n = int(self.t_sim / self.dt / self.episode_length)
        assert n > 0
        return n

    @property
    def dns_solver(self) -> ks.KSConfig:
        return ks.KSConfig(N=self.N_dns, L=self.L, dt=self.dt)

    @property
    def les_solver(self) -> ks.KSConfig:
        return ks.KSConfig(N=self.grid_size, L=self.L, dt=self.dt, dforce=self.dforce)

    @property
    def obs_dim(self) -> int:
        # KS.getState: concat(dudx, d2udx2) over the full grid (KS.py:369-383);
        # several agents: per-agent halo slices of both features
        if self.num_agents == 1:
            return 2 * self.grid_size
        return 2 * (self.grid_size // self.num_agents + 2)

    @property
    def actions_per_agent(self) -> int:
        return self.num_actions // self.num_agents


@dataclasses.dataclass
class KSDnsPool:
    """Precomputed DNS ground truth shared by all envs (leading axis = pool)."""

    uu: torch.Tensor        # (P, T+1, N_dns) trajectory
    spline_m: torch.Tensor  # (P, T+1, N_dns) periodic-spline coefficients of uu
    v0: torch.Tensor        # (P, N_dns) complex full spectrum after the transient
    ek_ktt: torch.Tensor    # (P, T+1, g//2) cumulative-mean spectrum, modes 0..g/2-1
    nu: torch.Tensor        # (P,) placeholder (KS nu == 1)

    @property
    def device(self) -> torch.device:
        return self.uu.device

    @property
    def dtype(self) -> torch.dtype:
        return self.uu.dtype


@dataclasses.dataclass
class KSEnvState:
    """Batched env state (leading axis = env)."""

    solver: ks.KSState
    sidx: torch.Tensor          # int64 DNS pool index
    macro_step: torch.Tensor    # int64
    ek_sum: torch.Tensor        # (B, g) running sum of LES Ek_kt incl. the IC frame
    prev_rel_err: torch.Tensor  # (B,)
    done: torch.Tensor          # (B,) bool
    cum_reward: torch.Tensor    # (B, num_agents)


@lru_cache(maxsize=16)
def action_basis(cfg: KSEnvConfig) -> np.ndarray:
    return basis_mod.make_basis(cfg.num_actions, cfg.grid_size, cfg.L, cfg.basis_kind)


def make_dns_pool(cfg: KSEnvConfig, n_dns: int, dtype=torch.float32,
                  device=None) -> KSDnsPool:
    """Simulate the KS DNS pool (ks_environment.py:18-34) in float64 numpy on
    the host, then place it on ``device`` in ``dtype``: the JAX package's host
    build (``_make_dns_pool_host``), the literal Kassam-Trefethen update per
    KS.py:230-267 on the rfft half-spectrum.  Row i starts from numpy Philox
    seeded [seed, i], scale 1e-3 (KS.py:173-175)."""
    N, L, dt, g = cfg.N_dns, cfg.L, cfg.dt, cfg.grid_size
    dx = L / N
    E, E2, Q, f1, f2, f3, gk = ks.etdrk4_coeffs(cfg.dns_solver)
    nsteps = cfg.n_dns_steps
    n_trans = int(cfg.t_transient / cfg.dt)

    def nl(z):
        uz = np.fft.irfft(z, N)
        return gk * np.fft.rfft(uz * uz)

    def etdrk4(v):
        Nv = nl(v)
        a = E2 * v + Q * Nv
        Na = nl(a)
        b = E2 * v + Q * Na
        Nb = nl(b)
        c = E2 * a + Q * (2.0 * Nb - Nv)
        Nc = nl(c)
        return E * v + Nv * f1 + 2.0 * (Na + Nb) * f2 + Nc * f3

    rows = []
    for i in range(n_dns):
        rng = np.random.default_rng([cfg.seed, i])
        u = 1e-3 * rng.standard_normal(N)
        rv = np.fft.rfft(u)
        for _ in range(n_trans):
            rv = etdrk4(rv)
        # restart from the transient endpoint (ks_environment.py:27-33)
        u0 = np.fft.irfft(rv, N)
        rv = np.fft.rfft(u0)
        uu = np.empty((nsteps + 1, N))
        ek_half = np.empty((nsteps + 1, g // 2))
        uu[0] = u0
        ek_half[0] = 0.5 * np.abs(rv[: g // 2]) ** 2 / N * dx
        for n in range(nsteps):
            rv = etdrk4(rv)
            uu[n + 1] = np.fft.irfft(rv, N)
            # Ek_kt = 0.5*|v|^2/N*dx; modes 0..g/2-1 sit identically in the
            # half spectrum (Burger.py:562 convention via full_spectrum)
            ek_half[n + 1] = 0.5 * np.abs(rv[: g // 2]) ** 2 / N * dx
        ek_ktt = np.cumsum(ek_half, 0) / np.arange(1, nsteps + 2)[:, None]
        # periodic-spline coefficients (circulant solve, interp.periodic_spline_m)
        d2 = np.roll(uu, 1, -1) - 2.0 * uu + np.roll(uu, -1, -1)
        eig = 4.0 + 2.0 * np.cos(2.0 * np.pi * np.arange(N) / N)
        m = np.real(np.fft.ifft(np.fft.fft(6.0 * d2, axis=-1) / eig, axis=-1))
        rows.append(dict(uu=uu, spline_m=m, v0=np.fft.fft(u0), ek_ktt=ek_ktt,
                         nu=np.float64(1.0)))
    cdtype = torch.complex128 if dtype == torch.float64 else torch.complex64
    return KSDnsPool(**{
        name: torch.from_numpy(np.stack([r[name] for r in rows])).to(
            device=device, dtype=cdtype if name == "v0" else dtype)
        for name in rows[0]})


def reset(cfg: KSEnvConfig, pool: KSDnsPool, generator, episode_counts):
    """Start a batch of episodes; returns (state, obs).

    episode_counts: (B,) int tensor; the phase offsets (a normal of stddev
    noise*L truncated to |offset| <= L, as JAX's truncated_normal) come from
    ``generator``."""
    offset = _draw_offset(cfg, generator, episode_counts.shape[0], pool.uu.dtype,
                          pool.uu.device)
    return reset_at(cfg, pool, offset, episode_counts)


def reset_at(cfg: KSEnvConfig, pool: KSDnsPool, offset, episode_counts):
    """``reset`` with the phase offsets (B,) given."""
    n_pool = pool.nu.shape[0]
    sidx = episode_counts.to(torch.int64) % n_pool
    dtype, device = pool.uu.dtype, pool.uu.device
    g = cfg.grid_size
    lcfg = cfg.les_solver
    dns_k = grid_array(cfg.dns_solver.grid, "k", dtype, device)
    v0 = spectral.restrict_modes(spectral.phase_shift(pool.v0[sidx], offset[:, None], dns_k), g)
    st = ks.init(lcfg, v0=v0)
    B = sidx.shape[0]
    state = KSEnvState(
        solver=st, sidx=sidx, macro_step=torch.zeros(B, dtype=torch.int64, device=device),
        ek_sum=spectral.energy_spectrum(ks.full_spectrum(st.rv, g), lcfg.grid.dx),
        prev_rel_err=torch.zeros(B, dtype=dtype, device=device),
        done=torch.zeros(B, dtype=torch.bool, device=device),
        cum_reward=torch.zeros(B, cfg.num_agents, dtype=dtype, device=device))
    return state, _observe(cfg, state)


def _observe(cfg: KSEnvConfig, state: KSEnvState):
    """concat(dudx, d2udx2), centered differences (KS.py:369-383); (B, na, obs)."""
    u = state.solver.u
    dx = cfg.les_solver.grid.dx
    up = torch.roll(u, -1, -1)
    um = torch.roll(u, 1, -1)
    dudx = (up - um) / (2.0 * dx)
    d2udx2 = (up - 2.0 * u + um) / dx**2
    if cfg.num_agents == 1:
        return torch.cat([dudx, d2udx2], dim=-1)[..., None, :]
    # per-agent halo slices of each feature, like the Burgers MARL layout
    idx = features._halo_index_tensor(cfg.grid_size, cfg.num_agents, u.device)
    return torch.cat([dudx[..., idx], d2udx2[..., idx]], dim=-1)


def step(cfg: KSEnvConfig, pool: KSDnsPool, state: KSEnvState, actions):
    """One macro-step of every env.  actions: (B, num_agents, actions_per_agent)
    or (B, num_actions).

    Returns (state, obs, reward (B, na), done (B,), info).  Envs already done
    still step; their results are discarded by selection (a blown env holds
    inf/NaN), and every field of a finished env keeps its value."""
    dtype = state.solver.u.dtype
    device = state.solver.u.device
    lcfg = cfg.les_solver
    dx = lcfg.grid.dx
    g = cfg.grid_size
    B = state.solver.u.shape[0]
    basis = constant(action_basis, cfg, dtype=dtype, device=device)
    action_field = actions.reshape(B, -1) @ basis

    sol, ek_sum = state.solver, state.ek_sum
    for _ in range(cfg.n_intermediate):
        sol, _aux = ks.step(lcfg, sol, action_field)
        ek_sum = ek_sum + spectral.energy_spectrum(ks.full_spectrum(sol.rv, g), dx)

    if cfg.spectral_reward:
        count = (sol.ioutnum + 1).to(dtype)
        sgs_ektt = ek_sum[:, 1: g // 2] / count[:, None]
        # a frozen env's step counter can run past the table: clamp as a JAX gather does
        t_idx = sol.ioutnum.clamp(max=pool.ek_ktt.shape[1] - 1)
        dns_ektt = pool.ek_ktt[state.sidx, t_idx, 1: g // 2]
        rel_err = torch.mean(((torch.abs(dns_ektt - sgs_ektt)) / dns_ektt) ** 2, dim=-1)
        reward = (cfg.reward_factor * (state.prev_rel_err - rel_err))[:, None].expand(
            B, cfg.num_agents)
        new_prev = rel_err
    else:
        # pointwise -(|u - truth|) mean per agent block (KS.py:360-367)
        fidx = interp.frame_index(sol.t, cfg.dt, pool.uu.shape[1])
        x = grid_array(lcfg.grid, "x", dtype, device)
        truth = interp.periodic_spline_eval(pool.uu[state.sidx, fidx],
                                            pool.spline_m[state.sidx, fidx], x, cfg.L)
        reward = -features.agent_block_mean(torch.abs(sol.u - truth), cfg.num_agents)
        new_prev = state.prev_rel_err

    blown = ~(torch.isfinite(sol.u).all(-1) & torch.isfinite(reward).all(-1))
    reward = torch.where(blown[:, None], torch.full_like(reward, cfg.truncation_penalty),
                         reward)
    macro = state.macro_step + 1
    done = blown | (macro >= cfg.episode_length) | state.done

    was = state.done

    def keep(new, old):
        return torch.where(was.reshape((-1,) + (1,) * (new.ndim - 1)), old, new)

    sol = ks.KSState(**{f.name: keep(getattr(sol, f.name), getattr(state.solver, f.name))
                        for f in dataclasses.fields(ks.KSState)})
    zero = torch.zeros_like(reward)
    new_state = KSEnvState(
        solver=sol, sidx=state.sidx, macro_step=keep(macro, state.macro_step),
        ek_sum=keep(ek_sum, state.ek_sum), prev_rel_err=keep(new_prev, state.prev_rel_err),
        done=done, cum_reward=state.cum_reward + torch.where(was[:, None], zero, reward))
    reward = torch.where(was[:, None], zero, reward)
    obs = _observe(cfg, new_state)
    obs = torch.where(torch.isfinite(obs), obs, torch.zeros_like(obs))
    return new_state, obs, reward, done, dict(blown=blown)
