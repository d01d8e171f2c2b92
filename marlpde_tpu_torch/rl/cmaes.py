"""CMA-ES optimizer + the Smagorinsky-constant calibration workload
(port of marlpde_tpu/rl/cmaes.py).

Parity targets:
  * korali Optimizer/CMAES driving a scalar cs in [0,1], population 8
    (run-cmaes-burger.py:48-52)
  * objective fBurger: LES episode with per-step action field
    a = cs^2*dx^2*|dudx|*d2udx2, cumulative MSE-vs-truth reward, -1e6 on
    blowup (burger_cmaes.py:17-118)

The optimizer is a standard (mu/mu_w, lambda) CMA-ES (Hansen 2016 tutorial
recipe) on the host, a copy of the JAX package's numpy code with the same
``default_rng(seed)`` stream, so the same costs give the same history.  A
candidate's evaluation is one batched tensor program with the population as
the leading axis: the whole population rolls out together on the device.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from marlpde_tpu_torch.core import interp
from marlpde_tpu_torch.device import resolve_device
from marlpde_tpu_torch.solvers import burger, closures
from marlpde_tpu_torch.utils import graphs


@dataclasses.dataclass
class CmaesConfig:
    dim: int = 1
    population: int = 8            # run-cmaes-burger.py:50
    sigma0: float = 0.3
    lower: float = 0.0             # cs in [0, 1] (run-cmaes-burger.py:48-49)
    upper: float = 1.0
    max_generations: int = 50
    seed: int = 42


def cmaes_minimize(f: Callable[[np.ndarray], np.ndarray], cfg: CmaesConfig):
    """Minimize f over [lower, upper]^dim.  f maps (pop, dim) -> (pop,) costs.

    Returns (best_x, best_cost, history)."""
    n, lam = cfg.dim, cfg.population
    mu = lam // 2
    w = np.log(mu + 0.5) - np.log(np.arange(1, mu + 1))
    w /= w.sum()
    mueff = 1.0 / np.sum(w**2)
    cc = (4 + mueff / n) / (n + 4 + 2 * mueff / n)
    cs = (mueff + 2) / (n + mueff + 5)
    c1 = 2 / ((n + 1.3) ** 2 + mueff)
    cmu = min(1 - c1, 2 * (mueff - 2 + 1 / mueff) / ((n + 2) ** 2 + mueff))
    damps = 1 + 2 * max(0, np.sqrt((mueff - 1) / (n + 1)) - 1) + cs
    chiN = np.sqrt(n) * (1 - 1 / (4 * n) + 1 / (21 * n * n))

    rng = np.random.default_rng(cfg.seed)
    xmean = np.full(n, 0.5 * (cfg.lower + cfg.upper))
    sigma = cfg.sigma0 * (cfg.upper - cfg.lower)
    C = np.eye(n)
    pc = np.zeros(n)
    ps = np.zeros(n)
    best_x, best_cost = xmean.copy(), np.inf
    history = []

    for gen in range(cfg.max_generations):
        A = np.linalg.cholesky(C)
        z = rng.standard_normal((lam, n))
        xs = xmean + sigma * z @ A.T
        xs = np.clip(xs, cfg.lower, cfg.upper)
        costs = np.asarray(f(xs))
        order = np.argsort(costs)
        if costs[order[0]] < best_cost:
            best_cost = float(costs[order[0]])
            best_x = xs[order[0]].copy()
        history.append(dict(gen=gen, best=best_cost,
                            mean=float(costs.mean()), xbest=best_x.tolist()))

        xold = xmean
        xmean = w @ xs[order[:mu]]
        y = (xmean - xold) / sigma
        Cinv_sqrt = np.linalg.inv(A)
        ps = (1 - cs) * ps + np.sqrt(cs * (2 - cs) * mueff) * Cinv_sqrt @ y
        hsig = (np.linalg.norm(ps) / np.sqrt(1 - (1 - cs) ** (2 * (gen + 1)))
                < (1.4 + 2 / (n + 1)) * chiN)
        pc = (1 - cc) * pc + hsig * np.sqrt(cc * (2 - cc) * mueff) * y
        artmp = (xs[order[:mu]] - xold) / sigma
        C = ((1 - c1 - cmu) * C
             + c1 * (np.outer(pc, pc) + (not hsig) * cc * (2 - cc) * C)
             + cmu * artmp.T @ (w[:, None] * artmp))
        C = (C + C.T) / 2
        sigma *= np.exp((cs / damps) * (np.linalg.norm(ps) / chiN - 1))

    return best_x, best_cost, history


class _PopulationStep:
    """One macro-step of the population's episodes, in place on the solver
    state ``sol`` and the cumulative rewards ``cum`` (P,): ``n_int`` ABCN
    sub-steps under the SSM forcing a = cs^2 dx^2 |du/dx| d2u/dx2 of each
    row's ``cs`` (P,), then the reward against the DNS spline.  ``graph``
    calls it, as a CUDA graph on the card (utils/graphs.py)."""

    def __init__(self, lcfg, n_int, dt, x, L, uu, spline_m, sol, cs):
        self.lcfg, self.n_int, self.dt, self.x, self.L = lcfg, n_int, dt, x, L
        self.uu, self.spline_m, self.sol, self.cs = uu, spline_m, sol, cs
        self.cum = torch.zeros_like(cs)
        self.graph = graphs.Step("CMA-ES macro-step", self, cs.device)

    def __call__(self):
        dx = self.lcfg.grid.dx
        scale = (self.cs**2 * dx**2)[:, None]
        sol = self.sol
        for _ in range(self.n_int):
            dudx = closures.first_deriv_onesided(sol.u, dx)
            d2udx2 = closures.second_deriv(sol.u, dx)
            sol, _aux = burger.step(self.lcfg, sol, scale * torch.abs(dudx) * d2udx2)
        fidx = interp.frame_index(sol.t, self.dt, self.uu.shape[0])
        truth = interp.periodic_spline_eval(self.uu[fidx], self.spline_m[fidx], self.x, self.L)
        graphs.copy_((self.sol, self.cum),
                     (sol, self.cum - torch.mean((truth - sol.u) ** 2, dim=-1)))


def make_burger_cs_objective(N_dns=512, grid_size=32, L=2 * np.pi, dt=1e-3,
                             T=5.0, nu=0.02, episode_length=500,
                             ic_case="turbulence", seed=42,
                             dtype=torch.float32, device=None):
    """Builds the fBurger objective: cs (pop,1) -> cost (pop,) = -cumreward,
    evaluated on ``device`` (None: the card, raising where there is none).

    DNS precomputed once; each candidate runs the LES episode with the
    cs-parameterized SSM forcing a = cs^2*dx^2*|dudx|*d2udx2 applied as the
    action field (burger_cmaes.py:60-74), cumulative MSE vs the interpolated
    truth as reward (:100-103), -1e6 on blowup (:116)."""
    from marlpde_tpu_torch.envs import burger_env

    device = resolve_device(device)
    cfg = burger_env.BurgerEnvConfig(
        N_dns=N_dns, grid_size=grid_size, num_actions=grid_size, L=L, dt=dt,
        T=T, nu=nu, episode_length=episode_length, ic_case=ic_case, seed=seed,
        spectral_reward=False, noise=0.0)
    pool = burger_env.make_dns_pool(cfg, 1, dtype=dtype, device=device)
    uu, spline_m, row_nu = pool.uu[0], pool.spline_m[0], pool.nu[0]
    lcfg = cfg.les_solver
    n_int = cfg.n_intermediate
    x = torch.as_tensor(lcfg.grid.x, dtype=dtype, device=device)
    # cubic-interpolated IC from the DNS (burger_cmaes.py:31,40)
    u0 = interp.periodic_spline_eval(uu[0], spline_m[0], x, L)

    @torch.no_grad()
    def episodes(cs):
        """The population's episodes, cs (P,) -> cumulative rewards (P,): on
        the card ``episode_length`` replays of the macro-step's graph, kept
        for this objective and P (the first call's first macro-step is the
        capture's warm-up), elsewhere direct calls."""
        P = cs.shape[0]
        sol = burger.init(lcfg, u0=u0.expand(P, -1), nu=row_nu)
        key, objects = ("cmaes", P), (uu,)
        step = graphs.cached(key, objects) if graphs.enabled(device) else None
        if step is None:
            step = _PopulationStep(lcfg, n_int, dt, x, L, uu, spline_m, graphs.clone(sol),
                                   cs.clone())
            if step.graph.graphed:
                graphs.store(key, objects, step)
        else:
            graphs.copy_((step.sol, step.cs), (sol, cs))
            step.cum.zero_()
        for _ in range(episode_length):
            step.graph()
        cum = step.cum
        return torch.where(torch.isfinite(cum), cum, torch.full_like(cum, -1e6))

    def f(xs: np.ndarray) -> np.ndarray:
        cs = torch.as_tensor(np.asarray(xs)[:, 0], dtype=dtype, device=device)
        return -episodes(cs).cpu().numpy()

    return f
