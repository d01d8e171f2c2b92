"""Frozen copy of marlpde_tpu_torch/rl/replay.py at the commit that added the
benchmark, the plain version the reference follows: it imports nothing of
the port.  The original docstring follows.

On-device episode replay buffer (REFER storage layer); port of
marlpde_tpu/rl/replay.py.

Whole fixed-length episodes, layout:

  obs      (C, T, na, obs_dim)
  actions  (C, T, na, act_dim)
  mu/sigma (C, T, na, act_dim)   behavior-policy params at sample time
  rewards  (C, T, na)
  mask     (C, T)                1 while the episode was live
  final_obs (C, na, obs_dim)     observation after the last executed step
  truncated (C,)                 True if the episode ended by numeric blowup
  filled, cursor                 host ints: valid slots, ring-buffer write head

Capacity C is in episodes.  Insertion overwrites the oldest episode, and
writes into the buffers in place.  It also writes ``filled`` into
``counters``, a device tensor the sampler reads, so a captured update
(utils/graphs.py) follows every insert without being captured again.
"""

from __future__ import annotations

import dataclasses

import torch

from . import replay_flat

_FIELDS = ("obs", "actions", "mu", "sigma", "rewards", "mask", "final_obs", "truncated")


@dataclasses.dataclass
class Replay:
    obs: torch.Tensor
    actions: torch.Tensor
    mu: torch.Tensor
    sigma: torch.Tensor
    rewards: torch.Tensor
    mask: torch.Tensor
    final_obs: torch.Tensor
    truncated: torch.Tensor
    filled: int = 0
    cursor: int = 0

    def __post_init__(self):
        # (filled,) on the device, for the sampler; set by every insert
        self.counters = torch.tensor([self.filled], dtype=torch.int64, device=self.obs.device)

    @property
    def capacity(self) -> int:
        return self.obs.shape[0]


def init(capacity: int, T: int, na: int, obs_dim: int, act_dim: int,
         dtype=torch.float32, device=None) -> Replay:
    kw = dict(dtype=dtype, device=device)
    return Replay(
        obs=torch.zeros((capacity, T, na, obs_dim), **kw),
        actions=torch.zeros((capacity, T, na, act_dim), **kw),
        mu=torch.zeros((capacity, T, na, act_dim), **kw),
        sigma=torch.ones((capacity, T, na, act_dim), **kw),
        rewards=torch.zeros((capacity, T, na), **kw),
        mask=torch.zeros((capacity, T), **kw),
        final_obs=torch.zeros((capacity, na, obs_dim), **kw),
        truncated=torch.zeros((capacity,), dtype=torch.bool, device=device))


def add_episodes(rep: Replay, batch: dict) -> Replay:
    """Insert a batch of B episodes (leading axis B, time axis T).

    With B > C only the newest C episodes survive a ring insert; they are
    written to the slots their writes would take, so every slot is written
    once and the result does not depend on the order of duplicate writes."""
    B = batch["obs"].shape[0]
    C = rep.capacity
    keep = min(B, C)
    device = rep.obs.device
    idx = (rep.cursor + torch.arange(B - keep, B, device=device)) % C
    for name in _FIELDS:
        buf = getattr(rep, name)
        buf.index_copy_(0, idx, batch[name][B - keep:].to(buf.dtype))
    rep.filled = min(rep.filled + B, C)
    rep.cursor = (rep.cursor + B) % C
    rep.counters.fill_(rep.filled)
    return rep


def sample_episodes(rep: Replay, generator, n: int) -> dict:
    """Uniformly sample n episode slots among the filled ones (their count
    read on the device)."""
    idx = replay_flat.uniform_below(generator, n, torch.clamp(rep.counters[0], min=1))
    return {name: getattr(rep, name)[idx] for name in _FIELDS}


def num_experiences(rep: Replay) -> int:
    return rep.filled * rep.obs.shape[1]
