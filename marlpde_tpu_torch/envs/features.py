"""State featurization for the Burgers closure env (port of
marlpde_tpu/envs/features.py:27-93).

Parity target: Burger.getState (Burger.py:604-675).

Versions (Burger.py:617-626):
  0: d2udx2            1: [dudt, d2udx2]       2: [u, u^2]
  3: d2udx2 + lower-half energy spectrum       4: u + lower-half energy spectrum

Outputs have shape (..., num_agents, obs_dim); multi-agent observations are
per-agent halo slices, indices a-1 .. b (wrapped), a = i*N/na, b = (i+1)*N/na
(Burger.py:656-674).  Derivatives replicate the reference:
  up = roll(u, 1), um = roll(u, -1), d2udx2 = (up - 2u + um)/dx^2,
  dudt = (u - u_prev)/dt with u_prev the previous *solver* step's field.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch


@lru_cache(maxsize=64)
def halo_indices(N: int, num_agents: int) -> np.ndarray:
    """(num_agents, N//num_agents + 2) wrapped gather indices (Burger.py:658-660).

    Copied from marlpde_tpu/envs/features.py:27-33 (numpy only)."""
    per = N // num_agents
    idx = np.stack([np.arange(i * per - 1, (i + 1) * per + 1) % N
                    for i in range(num_agents)])
    return idx


@lru_cache(maxsize=None)       # unbounded: a CUDA graph reads these by address
def _halo_index_tensor(N: int, num_agents: int, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(halo_indices(N, num_agents), device=device)


def obs_dim(version: int, N: int, num_agents: int) -> int:
    """Observation length per agent; mirrors run-vracer-burger.py:136-146."""
    if num_agents == 1:
        base = {0: N, 1: 2 * N, 2: 2 * N, 3: N, 4: N}[version]
        return base + (N // 2 if version in (3, 4) else 0)
    per = N // num_agents + 2
    base = {0: per, 1: 2 * per, 2: 2 * per, 3: per, 4: per}[version]
    return base + (N // 2 if version in (3, 4) else 0)


def burger_features(version: int, num_agents: int, u, u_prev, v, dt, dx):
    """(..., num_agents, obs_dim) observation tensor.

    u, u_prev: (..., N) fields; v: (..., N) complex spectrum, read only by
    versions 3/4 (may be None otherwise).
    """
    N = u.shape[-1]
    up = torch.roll(u, 1, -1)
    um = torch.roll(u, -1, -1)
    d2udx2 = (up - 2.0 * u + um) / dx**2

    if version in (0, 3):
        feats = (d2udx2,)
    elif version == 1:
        feats = ((u - u_prev) / dt, d2udx2)
    elif version == 2:
        feats = (u, u * u)
    elif version == 4:
        feats = (u,)
    else:
        raise ValueError(f"[features] unknown version {version}")

    if version in (3, 4):
        ek = 0.5 * (torch.conj(v) * v).real / N * dx
        ek_half = ek[..., : N // 2]

    if num_agents == 1:
        obs = torch.cat(feats, dim=-1)
        if version in (3, 4):
            obs = torch.cat([obs, ek_half], dim=-1)
        return obs[..., None, :]

    idx = _halo_index_tensor(N, num_agents, u.device)         # (na, per+2)
    # feature-major, as the reference's state[:, index].flatten()
    obs = torch.cat([f[..., idx] for f in feats], dim=-1)     # (..., na, per+2)
    if version in (3, 4):
        ek_b = ek_half[..., None, :].expand(ek_half.shape[:-1] + (num_agents, N // 2))
        obs = torch.cat([obs, ek_b], dim=-1)
    return obs


def agent_block_mean(x, num_agents: int):
    """Per-agent means over contiguous blocks (Burger.py:595-599): (..., na)."""
    N = x.shape[-1]
    return x.reshape(x.shape[:-1] + (num_agents, N // num_agents)).mean(dim=-1)
