"""Running mean/std normalizers: korali's State Rescaling + Reward Rescaling
(run-vracer-burger.py:170-171), as Welford-style batch-merged accumulators
(port of marlpde_tpu/rl/running_stats.py)."""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class RunningStats:
    mean: torch.Tensor
    m2: torch.Tensor
    count: torch.Tensor

    @property
    def std(self):
        var = self.m2 / torch.clamp(self.count - 1.0, min=1.0)
        return torch.sqrt(torch.clamp(var, min=1e-12))


def init(shape, dtype=torch.float32, device=None) -> RunningStats:
    return RunningStats(mean=torch.zeros(shape, dtype=dtype, device=device),
                        m2=torch.ones(shape, dtype=dtype, device=device),
                        count=torch.ones((), dtype=dtype, device=device))


def update(rs: RunningStats, batch, weights=None) -> RunningStats:
    """Merge a batch (leading axes collapsed) into the accumulator."""
    flat = batch.reshape((-1,) + tuple(rs.mean.shape))
    if weights is not None:
        w = weights.reshape(-1)
        wc = w[:, None] if rs.mean.ndim else w
        # zero excluded rows BEFORE any arithmetic: with huge/inf excluded
        # values, x*0 or (x-mean)^2*0 would be inf*0 = NaN
        flat = torch.where(wc > 0, flat, torch.zeros_like(flat))
        n_b = torch.clamp(w.sum(), min=1e-8)
        mean_b = (flat * wc).sum(0) / n_b
        diff2 = torch.where(wc > 0, (flat - mean_b) ** 2, torch.zeros_like(flat))
        m2_b = (diff2 * wc).sum(0)
    else:
        n_b = torch.tensor(flat.shape[0], dtype=flat.dtype, device=flat.device)
        mean_b = flat.mean(0)
        m2_b = ((flat - mean_b) ** 2).sum(0)
    delta = mean_b - rs.mean
    tot = rs.count + n_b
    new_mean = rs.mean + delta * n_b / tot
    new_m2 = rs.m2 + m2_b + delta**2 * rs.count * n_b / tot
    return RunningStats(mean=new_mean, m2=new_m2, count=tot)


def normalize(rs: RunningStats, x):
    return (x - rs.mean) / rs.std


def scale(rs: RunningStats, x):
    """Reward rescaling: divide by running std, no centering (korali behavior)."""
    return x / rs.std


def second_moment(rs: RunningStats):
    """sqrt(E[x^2]) of everything ever folded in."""
    ex2 = rs.m2 / torch.clamp(rs.count, min=1.0) + rs.mean**2
    return torch.sqrt(torch.clamp(ex2, min=1e-18))
