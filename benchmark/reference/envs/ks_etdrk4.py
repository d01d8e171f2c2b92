"""Plain reference of the Kuramoto-Sivashinsky LES closure env, as the ``ks``
configuration runs it (wadaniel/marlpde ``ks_environment.py`` and ``KS.py``):
ETDRK4 sub-steps (Kassam-Trefethen) on the rfft half-spectrum with the action
forcing, the hat action basis, the cumulative-spectrum reward and the
observation concat(du/dx, d2u/dx2).  It imports nothing of the program.

The DNS pool is the reference's own: the same float64 numpy recipe
(ks_environment.py:18-34, KS.py:127-137 and 230-267) that the program runs on
the host, so the two pools agree bit for bit, built only for the rows that
the checked episodes use.  Copied, with the cuts this configuration allows
(spectral reward, forcing as the action field, one agent, no phase noise),
from marlpde_tpu_torch/envs/ks_env.py (make_dns_pool, reset_at, step,
_observe) and solvers/ks.py (etdrk4_coeffs, irfft, step).
"""

from __future__ import annotations

import numpy as np
import torch

from .burger_abcn import hat_basis


def etdrk4_coeffs(N: int, L: float, dt: float):
    """E, E2, Q, f1, f2, f3, g on the half-spectrum, float64 (KS.py:127-137)."""
    half = N // 2 + 1
    k = np.fft.fftfreq(N, L / (2.0 * np.pi * N))[:half]
    lin = k**2 - k**4
    E, E2 = np.exp(dt * lin), np.exp(dt * lin / 2.0)
    MM = 62
    r = np.exp(1j * np.pi * (np.r_[1:MM + 1] - 0.5) / MM)
    LR = dt * np.repeat(lin[:, None], MM, axis=1) + np.repeat(r[None, :], half, axis=0)
    Q = dt * np.real(np.mean((np.exp(LR / 2.0) - 1.0) / LR, 1))
    f1 = dt * np.real(np.mean((-4.0 - LR + np.exp(LR) * (4.0 - 3.0 * LR + LR**2)) / LR**3, 1))
    f2 = dt * np.real(np.mean((2.0 + LR + np.exp(LR) * (-2.0 + LR)) / LR**3, 1))
    f3 = dt * np.real(np.mean((-4.0 - 3.0 * LR - LR**2 + np.exp(LR) * (4.0 - LR)) / LR**3, 1))
    return E, E2, Q, f1, f2, f3, -0.5j * k


def dns_pool(cfg: dict, seed: int, rows):
    """(v0 (len(rows), N_dns) complex128 full spectrum after the transient,
    ek_ktt (len(rows), n+1, g//2)) of the pool rows ``rows``."""
    N, L, dt, g = cfg["N_dns"], cfg["L"], cfg["dt"], cfg["grid_size"]
    dx = L / N
    E, E2, Q, f1, f2, f3, gk = etdrk4_coeffs(N, L, dt)
    nsteps = int((cfg["t_end"] - cfg["t_transient"]) / dt)
    n_trans = int(cfg["t_transient"] / dt)

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

    # every row's transforms at once: each 1-D transform is the row's own
    u = np.stack([1e-3 * np.random.default_rng([seed, i]).standard_normal(N) for i in rows])
    rv = np.fft.rfft(u)
    for _ in range(n_trans):
        rv = etdrk4(rv)
    u0 = np.fft.irfft(rv, N)
    rv = np.fft.rfft(u0)
    ek_half = np.empty((len(rows), nsteps + 1, g // 2))
    ek_half[:, 0] = 0.5 * np.abs(rv[:, : g // 2]) ** 2 / N * dx
    for n in range(nsteps):
        rv = etdrk4(rv)
        ek_half[:, n + 1] = 0.5 * np.abs(rv[:, : g // 2]) ** 2 / N * dx
    ektt = np.cumsum(ek_half, 1) / np.arange(1, nsteps + 2)[None, :, None]
    return np.fft.fft(u0), ektt


_POOLS: dict = {}


class Env:
    """The env on ``device`` in float32, for the episodes whose counters are
    given to ``reset``.  State is a dict of (B, ...) tensors."""

    def __init__(self, cfg: dict, seed: int, device, n_pool: int):
        self.cfg, self.device, self.seed, self.n_pool = cfg, torch.device(device), seed, n_pool
        self.g, self.L, self.dt = cfg["grid_size"], cfg["L"], cfg["dt"]
        self.dx = self.L / self.g
        self.nint = int((cfg["t_end"] - cfg["t_transient"]) / self.dt / cfg["episode_length"])
        E, E2, Q, f1, f2, f3, gk = etdrk4_coeffs(self.g, self.L, self.dt)
        cx = lambda a: torch.as_tensor(np.asarray(a, np.complex128)).to(
            device=self.device, dtype=torch.complex64)
        re = lambda a: torch.as_tensor(np.asarray(a, np.float64)).to(
            device=self.device, dtype=torch.float32)
        self.E, self.E2, self.gk = cx(E), cx(E2), cx(gk)
        self.Q, self.f1, self.f2, self.f3 = re(Q), re(f1), re(f2), re(f3)
        mask = torch.ones(self.g // 2 + 1, 2)
        mask[0, 1] = mask[self.g // 2, 1] = 0.0
        self.herm = mask.to(self.device)
        self.basis = torch.as_tensor(hat_basis(cfg["num_actions"], self.g, self.L),
                                     dtype=torch.float32, device=self.device)
        # pool rows, kept for the process: a run's reference and control share them
        self._rows = _POOLS.setdefault((seed, repr(sorted(cfg.items()))), {})

    def irfft(self, rv):
        """irfft with the imaginary parts of bins 0 and N/2 taken as zero."""
        z = torch.view_as_complex(torch.view_as_real(rv) * self.herm)
        return torch.fft.irfft(z, self.g, dim=-1)

    def spectrum(self, rv):
        """0.5 |v|^2 / N dx over the full fft layout rebuilt from ``rv``."""
        g = self.g
        v = torch.cat([rv, torch.flip(torch.conj(rv[..., 1:g - g // 2]), dims=(-1,))], -1)
        return 0.5 * (torch.conj(v) * v).real / g * self.dx

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
        """ks_environment.py: the pool row's spectrum after the transient, cut to
        the g lowest modes (times g/N); no phase offset (noise 0)."""
        sidx = counts.to(torch.int64).cpu() % self.n_pool
        v0_dns, self.ektt = self._pool_rows(sidx)
        N, g = v0_dns.shape[-1], self.g
        v = torch.cat([v0_dns[:, :(g + 1) // 2], v0_dns[:, N - g // 2:]], -1) * (g / N)
        rv = v[..., : g // 2 + 1]
        B = rv.shape[0]
        st = dict(u=self.irfft(rv), rv=rv,
                  ioutnum=torch.zeros(B, dtype=torch.int64, device=self.device),
                  macro=torch.zeros(B, dtype=torch.int64, device=self.device),
                  ek_sum=self.spectrum(rv),
                  prev_rel_err=torch.zeros(B, device=self.device),
                  done=torch.zeros(B, dtype=torch.bool, device=self.device))
        return st, self.observe(st["u"])

    def observe(self, u):
        """KS.py:369-383: concat(du/dx, d2u/dx2), centered; (B, 1, 2g)."""
        up, um = torch.roll(u, -1, -1), torch.roll(u, 1, -1)
        obs = torch.cat([(up - um) / (2.0 * self.dx), (up - 2.0 * u + um) / self.dx**2],
                        -1)[..., None, :]
        return torch.where(torch.isfinite(obs), obs, torch.zeros_like(obs))

    def _etdrk4(self, v, F):
        """One ETDRK4 step with forcing F entering every phi-term (KS.py:230-267)."""
        g = self.g

        def nl(z):
            uz = self.irfft(z)
            return self.gk * torch.fft.rfft(uz * uz, dim=-1)

        E, E2, Q = self.E, self.E2, self.Q
        Nv = nl(v)
        a = E2 * v + Q * Nv
        Na = nl(a)
        b = E2 * v + Q * Na
        Nb = nl(b)
        c = E2 * a + Q * (2.0 * Nb - Nv)
        Nc = nl(c)
        return (E * v + (Nv + F) * self.f1 + 2.0 * (Na + Nb + 2.0 * F) * self.f2
                + (Nc + F) * self.f3)

    def step(self, st, actions):
        """One macro-step; returns (state, obs, reward (B, 1), blown (B,))."""
        B, g = st["u"].shape[0], self.g
        F = torch.fft.rfft(actions.reshape(B, -1) @ self.basis, dim=-1)
        rv, ek_sum, ioutnum = st["rv"], st["ek_sum"], st["ioutnum"]
        for _ in range(self.nint):
            rv = self._etdrk4(rv, F)
            ioutnum = ioutnum + 1
            ek_sum = ek_sum + self.spectrum(rv)
        u = self.irfft(rv)
        sgs = ek_sum[:, 1: g // 2] / (ioutnum + 1).to(u.dtype)[:, None]
        t_idx = ioutnum.clamp(max=self.ektt.shape[1] - 1)
        dns = self.ektt[torch.arange(B, device=self.device), t_idx, 1: g // 2]
        rel_err = torch.mean((torch.abs(dns - sgs) / dns) ** 2, dim=-1)
        reward = (self.cfg["reward_factor"] * (st["prev_rel_err"] - rel_err))[:, None]
        blown = ~(torch.isfinite(u).all(-1) & torch.isfinite(reward).all(-1))
        reward = torch.where(blown[:, None], torch.full_like(reward, -np.inf), reward)
        macro = st["macro"] + 1
        done = blown | (macro >= self.cfg["episode_length"]) | st["done"]
        was = st["done"]

        def keep(new, old):
            return torch.where(was.reshape((-1,) + (1,) * (new.ndim - 1)), old, new)

        new = dict(u=keep(u, st["u"]), rv=keep(rv, st["rv"]),
                   ioutnum=keep(ioutnum, st["ioutnum"]), macro=keep(macro, st["macro"]),
                   ek_sum=keep(ek_sum, st["ek_sum"]),
                   prev_rel_err=keep(rel_err, st["prev_rel_err"]), done=done)
        reward = torch.where(was[:, None], torch.zeros_like(reward), reward)
        return new, self.observe(new["u"]), reward, blown
