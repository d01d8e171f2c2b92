"""Plain reference of the Burgers LES closure env with the spectral reward, as
the ``burger-marl`` configuration runs it (wadaniel/marlpde
``burger_environment.py`` and ``Burger.py``): ABCN sub-steps on torch.fft,
the hat action basis, the cumulative-spectrum reward and the d2u/dx2 halo
observation of each agent.  It imports nothing of the program.

The DNS pool is the reference's own: the same float64 numpy recipe
(burger_environment.py:11-16, Burger.py:227-259 and 482-489) that the program
runs on the host, so the two pools agree bit for bit.  Only the pieces that
this configuration reads are kept (the initial spectrum and the cumulative
spectrum); no forcing, no closure, no phase noise.  Copied, with those cuts,
from marlpde_tpu_torch/envs/burger_env.py (make_dns_pool, reset_at),
envs/burger_fast.py (step), envs/features.py (burger_features, version 0),
core/ic.py (burger_turbulence_numpy), core/basis.py (make_basis, 'hat') and
kernels/abcn.py (abcn_macro_step_reference).
"""

from __future__ import annotations

import numpy as np
import torch

LCG_A, LCG_C, LCG_M = 1103515245, 12345, 2**13


def turbulence_ic(tseed: int, x, L: float):
    """Burger.py:227-259: the LCG-phase k^-5/3 spectrum, RMS-rescaled."""
    N = x.shape[-1]
    rng = 123456789 + int(tseed)
    u0 = np.ones(N)
    for k in range(1, N):
        rng = (LCG_A * rng + LCG_C) % LCG_M
        phase = rng / LCG_M * 2.0 * np.pi
        Ek = 5.0 ** (-5.0 / 3.0) if k <= 5 else k ** (-5.0 / 3.0)
        u0 += np.sqrt(2 * Ek) * np.sin(k * 2 * np.pi * x / L + phase)
    idx = 0
    criterion = np.sqrt(np.sum((u0 - 1.0) ** 2) / N)
    while criterion < 0.65 or criterion > 0.75:
        u0 *= 0.7 / criterion
        criterion = np.sqrt(np.sum((u0 - 1.0) ** 2) / N)
        idx += 1
        if idx > 100:
            break
    return u0


def hat_basis(M: int, N: int, L: float) -> np.ndarray:
    """Burger.py:12-15 and 177-203: M overlapping hats on N points."""
    x = np.linspace(0.0, L, N, endpoint=False)
    dx = L / (M - 1)
    rows = []
    for i in range(M):
        left = np.clip((x + dx - i * dx) / dx, 0.0, 1.0)
        right = np.clip((dx - x + i * dx) / dx, 0.0, 1.0)
        rows.append(left + right - 1.0)
    return np.stack(rows)


def dns_pool(cfg: dict, seed: int, rows):
    """(v0 (len(rows), N_dns) complex128, ek_ktt (len(rows), n+1, g//2)) of
    the pool rows ``rows``, in float64 numpy."""
    N, L, dt, nu = cfg["N_dns"], cfg["L"], cfg["dt"], cfg["nu"]
    g = cfg["grid_size"]
    nsteps = int(cfg["T"] / dt)
    k = np.fft.fftfreq(N, L / (2 * np.pi * N))
    k1 = 1j * k
    x = np.linspace(0, L, N, endpoint=False)
    v0s, ektts = [], []
    for i in rows:
        u0 = turbulence_ic(seed + i, x, L)
        vv = np.empty((nsteps + 1, N), complex)
        u, v = u0.copy(), np.fft.fft(u0)
        vv[0] = v
        fn_old = k1 * np.fft.fft(0.5 * u0 * u0)
        C = 0.5 * (k**2) * nu * dt
        for n in range(nsteps):
            Fn = k1 * np.fft.fft(0.5 * u * u)
            v = ((1.0 - C) * v - 0.5 * dt * (3.0 * Fn - fn_old) + dt * 0.0) / (1.0 + C)
            fn_old = Fn
            u = np.real(np.fft.ifft(v))
            vv[n + 1] = v
        ek_kt = 0.5 * np.abs(vv) ** 2 / N * (L / N)
        ektts.append((np.cumsum(ek_kt, 0) / np.arange(1, nsteps + 2)[:, None])[:, : g // 2])
        v0s.append(vv[0])
    return np.stack(v0s), np.stack(ektts)


_POOLS: dict = {}


class Env:
    """The env on ``device`` in float32, for the episodes whose counters are
    given to ``reset``.  State is a dict of (B, ...) tensors."""

    def __init__(self, cfg: dict, seed: int, device, n_pool: int):
        self.cfg, self.device = cfg, torch.device(device)
        self.n_pool = n_pool
        self.g, self.L = cfg["grid_size"], cfg["L"]
        self.dx = self.L / self.g
        self.dt = cfg["dt"]
        self.nint = int(cfg["T"] / cfg["dt"] / cfg["episode_length"])
        self.na = cfg["num_agents"]
        self.seed = seed
        f32 = dict(dtype=torch.float32, device=self.device)
        self.basis = torch.as_tensor(hat_basis(cfg["num_actions"], self.g, self.L), **f32)
        self.k = torch.as_tensor(np.fft.fftfreq(self.g, self.L / (2 * np.pi * self.g)), **f32)
        self.k1 = torch.as_tensor(1j * np.fft.fftfreq(self.g, self.L / (2 * np.pi * self.g)),
                                  dtype=torch.complex64, device=self.device)
        per = self.g // self.na
        self.halo = torch.as_tensor(
            np.stack([np.arange(i * per - 1, (i + 1) * per + 1) % self.g
                      for i in range(self.na)]), device=self.device)
        # pool rows, kept for the process: a run's reference and control share them
        self._rows = _POOLS.setdefault((seed, repr(sorted(cfg.items()))), {})

    def _pool_rows(self, sidx):
        missing = sorted(set(sidx.tolist()) - set(self._rows))
        if missing:
            v0, ektt = dns_pool(self.cfg, self.seed, missing)
            for j, r in enumerate(missing):
                self._rows[r] = (v0[j].astype(np.complex64), ektt[j].astype(np.float32))
        v0 = np.stack([self._rows[r][0] for r in sidx.tolist()])
        ektt = np.stack([self._rows[r][1] for r in sidx.tolist()])
        return (torch.as_tensor(v0, device=self.device),
                torch.as_tensor(ektt, device=self.device))

    def reset(self, counts):
        """burger_environment.py:110-112: the pool row's initial spectrum cut
        to the g lowest modes (times g/N); no phase offset (noise 0)."""
        sidx = counts.to(torch.int64).cpu() % self.n_pool
        v0_dns, self.ektt = self._pool_rows(sidx)
        N, g = v0_dns.shape[-1], self.g
        v = torch.cat([v0_dns[:, :(g + 1) // 2], v0_dns[:, N - g // 2:]], -1) * (g / N)
        u = torch.fft.ifft(v, dim=-1).real
        B = u.shape[0]
        st = dict(u=u, u_prev=u, v_re=v.real.contiguous(), v_im=v.imag.contiguous(),
                  fn=self.k1 * torch.fft.fft(0.5 * u * u, dim=-1),
                  nu=torch.full((B, 1), np.float32(self.cfg["nu"]), device=self.device),
                  ioutnum=torch.zeros(B, dtype=torch.int64, device=self.device),
                  ek_sum=0.5 * (torch.conj(v) * v).real / g * self.dx,
                  prev_rel_err=torch.zeros(B, device=self.device),
                  done=torch.zeros(B, dtype=torch.bool, device=self.device))
        return st, self.observe(st["u"])

    def observe(self, u):
        """Burger.py:604-675, version 0: d2u/dx2 on each agent's halo slice."""
        d2 = (torch.roll(u, 1, -1) - 2.0 * u + torch.roll(u, -1, -1)) / self.dx**2
        obs = d2[..., self.halo]
        return torch.where(torch.isfinite(obs), obs, torch.zeros_like(obs))

    def _abcn(self, st, af):
        """n_intermediate ABCN sub-steps (Burger.py:482-489)."""
        k, dt, g = self.k, self.dt, self.g
        Cc = 0.5 * (k * k) * st["nu"] * dt
        inv = 1.0 / (1.0 + Cc)
        u, v_re, v_im = st["u"], st["v_re"], st["v_im"]
        fn_re, fn_im = st["fn"].real, st["fn"].imag
        ek = torch.zeros_like(u)
        u_prev = u
        for _ in range(self.nint):
            u_prev = u
            d = torch.fft.fft(0.5 * u * u, dim=-1)
            new_re, new_im = -k * d.imag, k * d.real
            v_re = ((1.0 - Cc) * v_re - 0.5 * dt * (3.0 * new_re - fn_re) + dt * af.real) * inv
            v_im = ((1.0 - Cc) * v_im - 0.5 * dt * (3.0 * new_im - fn_im) + dt * af.imag) * inv
            fn_re, fn_im = new_re, new_im
            u = torch.fft.ifft(torch.complex(v_re, v_im), dim=-1).real
            ek = ek + 0.5 * (v_re**2 + v_im**2) / g * self.dx
        return u, u_prev, v_re, v_im, torch.complex(fn_re, fn_im), ek

    def step(self, st, actions):
        """One macro-step; returns (state, obs, reward (B, na), blown (B,))."""
        B, g = st["u"].shape[0], self.g
        af = torch.fft.fft(actions.reshape(B, -1) @ self.basis, dim=-1)
        u, u_prev, v_re, v_im, fn, ek = self._abcn(st, af)
        ioutnum = st["ioutnum"] + self.nint
        ek_sum = st["ek_sum"] + ek
        sgs = ek_sum[:, 1: g // 2] / (ioutnum + 1).to(u.dtype)[:, None]
        t_idx = ioutnum.clamp(max=self.ektt.shape[1] - 1)
        dns = self.ektt[torch.arange(B, device=self.device)[:, None], t_idx[:, None],
                        torch.arange(1, g // 2, device=self.device)[None, :]]
        rel_err = torch.mean((torch.abs(dns - sgs) / dns) ** 2, dim=-1)
        reward = ((st["prev_rel_err"] - rel_err) * self.cfg["reward_factor"])[:, None].expand(
            B, self.na)
        blown = ~(torch.isfinite(u).all(-1) & torch.isfinite(reward).all(-1))
        reward = torch.where(blown[:, None], torch.full_like(reward, -np.inf), reward)
        done = blown | (ioutnum // self.nint >= self.cfg["episode_length"]) | st["done"]
        was = st["done"]

        def keep(new, old):
            return torch.where(was.reshape((-1,) + (1,) * (new.ndim - 1)), old, new)

        new = dict(u=keep(u, st["u"]), u_prev=keep(u_prev, st["u_prev"]),
                   v_re=keep(v_re, st["v_re"]), v_im=keep(v_im, st["v_im"]),
                   fn=keep(fn, st["fn"]), nu=st["nu"], ioutnum=keep(ioutnum, st["ioutnum"]),
                   ek_sum=keep(ek_sum, st["ek_sum"]),
                   prev_rel_err=keep(rel_err, st["prev_rel_err"]), done=done)
        reward = torch.where(was[:, None], torch.zeros_like(reward), reward)
        return new, self.observe(new["u"]), reward, blown
