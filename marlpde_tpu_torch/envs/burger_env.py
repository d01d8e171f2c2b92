"""Burgers subgrid-closure environment, spectral-reward path (port of
marlpde_tpu/envs/burger_env.py:43-138,152-154,221-309,325-366).

Parity target: burger_environment.py (episode protocol at :18-204) with the
Burger solver (Burger.py).  This slice ports:

  * the configuration, the DNS pool and the action basis;
  * the host float64 DNS pool build (numpy until the final transfer);
  * ``reset`` on the spectral branch: pick the DNS from the pool
    (episodeCount % ndns, :54-55), draw the random phase offset, and
    transplant the IC by spectral restriction + phase shift (:109-119).

The episode step of the flagship path is the whole-batch
``envs/burger_fast.step``; the general per-env ``step``, the MSE reward and
the lockstep-DNS mode wait for a later slice (ROADMAP queue 1).
"""

from __future__ import annotations

import dataclasses
from functools import lru_cache

import numpy as np
import torch

from marlpde_tpu_torch import NOT_PORTED as _NOT_PORTED
from marlpde_tpu_torch.core import basis as basis_mod
from marlpde_tpu_torch.core import ic, spectral
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
    scheme: str = "abcn"
    reward_factor: float = 1.0
    truncation_penalty: float = -np.inf   # burger_environment.py:200
    coupled: bool = False
    dns_mode: str = "pool"
    state_bound: float = np.inf
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

    @property
    def v0(self):
        return torch.complex(self.v0_re, self.v0_im)


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


def make_dns_pool(cfg: BurgerEnvConfig, n_dns: int, dtype=torch.float32,
                  device=None) -> DnsPool:
    """Simulate the DNS pool (burger_environment.py:11-16, seeds seed+i per
    run-vracer-burger.py:47) in float64 numpy on the host, then place it on
    ``device`` in ``dtype``: the JAX package's host build
    (``_make_dns_pool_host``), literal ABCN per Burger.py:482-489."""
    if cfg.forcing or not cfg.spectral_reward:
        raise NotImplementedError(f"[burger_env] the DNS pool of forced or MSE-reward "
                                  f"configs {_NOT_PORTED}")
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
            raise NotImplementedError(f"[burger_env] ic_case 'forced' {_NOT_PORTED}")
        else:
            raise ValueError(f"[burger_env] unknown ic {cfg.ic_case}")
        uu = np.empty((nsteps + 1, N))
        vv = np.empty((nsteps + 1, N), complex)
        u = u0.copy()
        v = np.fft.fft(u0)
        uu[0], vv[0] = u, v
        fn_old = k1 * np.fft.fft(0.5 * u0 * u0)
        C = 0.5 * (k**2) * nu * dt
        for n in range(nsteps):
            Fn = k1 * np.fft.fft(0.5 * u * u)
            v = ((1.0 - C) * v - 0.5 * dt * (3.0 * Fn - fn_old)) / (1.0 + C)
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
        rows.append(dict(uu=uu, spline_m=m, v0_re=vv[0].real, v0_im=vv[0].imag,
                         ek_ktt=ek_ktt, nu=nu, randfac1=rf1, randfac2=rf2))
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
    """``reset`` with the phase offsets (B,) given."""
    if not cfg.spectral_reward:
        raise NotImplementedError(f"[burger_env] the MSE-reward reset {_NOT_PORTED}")
    n_pool = pool.nu.shape[0]
    sidx = episode_counts.to(torch.int64) % n_pool
    dtype = pool.uu.dtype
    lcfg = cfg.les_solver
    dns_k = torch.as_tensor(cfg.dns_solver.grid.k, dtype=dtype, device=pool.uu.device)
    # spectral restriction + phase shift (burger_environment.py:110-112)
    v0 = torch.complex(pool.v0_re[sidx], pool.v0_im[sidx])
    v0 = spectral.restrict_modes(spectral.phase_shift(v0, offset[:, None], dns_k),
                                 cfg.grid_size)
    st = burger.init(lcfg, v0=v0, nu=pool.nu[sidx], offset=offset,
                     randfac1=pool.randfac1[sidx], randfac2=pool.randfac2[sidx])
    B = sidx.shape[0]
    state = BurgerEnvState(
        solver=st, u_prev=st.u, sidx=sidx,
        macro_step=torch.zeros(B, dtype=torch.int64, device=sidx.device),
        ek_sum=spectral.energy_spectrum(st.v, lcfg.grid.dx),
        prev_rel_err=torch.zeros(B, dtype=dtype, device=sidx.device),
        done=torch.zeros(B, dtype=torch.bool, device=sidx.device),
        cum_reward=torch.zeros(B, cfg.num_agents, dtype=dtype, device=sidx.device))
    return state, _observe(cfg, state)


def _observe(cfg: BurgerEnvConfig, state: BurgerEnvState):
    return features.burger_features(
        cfg.version, cfg.num_agents, state.solver.u, state.u_prev,
        state.solver.v, cfg.dt, cfg.les_solver.grid.dx)
