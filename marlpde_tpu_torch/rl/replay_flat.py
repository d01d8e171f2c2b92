"""Flat per-EXPERIENCE replay ring with korali's REFER metadata (port of
marlpde_tpu/rl/replay_flat.py:53-327).

The storage layer of the korali-faithful uniform-experience minibatch mode
(``VracerConfig.minibatch_mode="experience"``): a FIFO over individual
experiences, each carrying lazily refreshed metadata that REFER reads:

  * ``sv``   stored state value V(s), refreshed whenever it is sampled,
  * ``rho``  stored importance weight, refreshed on sampling (1 when fresh),
  * ``off``  persistent off-policy flag; its replay-wide mean is the
             off-policy fraction REFER's beta tracks,
  * ``vtg``  stored retrace value, recomputed for the WHOLE episode of every
             sampled experience.

Rewards are rescaled by sqrt(mean r^2) over the current replay (korali's
second moment, ``reward_scale``).  Layout: an experience ring of capacity E
(only the live steps of the padded episode batches are stored) and an
episode ring of capacity Eep holding the final observation, the Truncated
flag and the bootstrap V(s_T).  Episode bounds are global experience ids
(int64), immune to episode-ring wraparound; eviction is experience-FIFO, so
an episode's head can be overwritten while its tail lives on.

In PyTorch's idiom the insert and the refreshes write the buffers in place,
and ``cursor``/``n_episodes`` are host ints, the trainer's accounting.  The
insert also writes (cursor, live) into ``counters``, a device tensor: the
update reads the live range, the eviction horizon and the sampler's bound
from there, so a captured update (utils/graphs.py) follows every insert
without being captured again (the cursor moves at every insert for the
whole run, so capturing again instead would cost a warm-up update and a
capture every generation).  The one readback is the live-step count of
each insert.  JAX's ``mode="fill"`` gathers become
a clamped index plus ``torch.where``; its ``mode="drop"`` scatters write only
rows that exist, so nothing reads or writes past a ring.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from marlpde_tpu_torch.rl import running_stats
from marlpde_tpu_torch.utils import profiling


@dataclasses.dataclass
class FlatReplay:
    # experience ring (capacity E)
    obs: torch.Tensor        # (E, na, obs_dim)
    actions: torch.Tensor    # (E, na, act_dim)
    mu: torch.Tensor         # (E, na, act_dim)   behavior-policy params
    sigma: torch.Tensor      # (E, na, act_dim)
    rewards: torch.Tensor    # (E, na)            raw (unscaled) rewards
    sv: torch.Tensor         # (E, na)            stored V(s), lazily refreshed
    vtg: torch.Tensor        # (E, na)            stored retrace value (scaled units)
    rho: torch.Tensor        # (E, na)            stored importance weight
    off: torch.Tensor        # (E, na) bool       persistent off-policy flag
    ep_first: torch.Tensor   # (E,) int64         global id of the episode's first exp
    ep_last: torch.Tensor    # (E,) int64         global id of the episode's last exp
    ep_idx: torch.Tensor     # (E,) int64         global episode id
    # episode ring (capacity Eep)
    fin_obs: torch.Tensor    # (Eep, na, obs_dim) obs after the last executed step
    truncated_ep: torch.Tensor  # (Eep,) bool     numeric-blowup end ("Truncated")
    boot: torch.Tensor       # (Eep, na)          V(s_T) bootstrap, 0 for terminal
    # host counters (global, monotone)
    cursor: int = 0          # experiences ever written
    n_episodes: int = 0      # episodes ever written

    def __post_init__(self):
        # (cursor, live) on the device, for the update; set by every insert
        self.counters = torch.tensor([self.cursor, self.live], dtype=torch.int64,
                                     device=self.obs.device)

    @property
    def capacity(self) -> int:
        return self.obs.shape[0]

    @property
    def ep_capacity(self) -> int:
        return self.fin_obs.shape[0]

    @property
    def live(self) -> int:
        return min(self.cursor, self.capacity)


def init_flat(capacity: int, ep_capacity: int, na: int, obs_dim: int, act_dim: int,
              dtype=torch.float32, device=None) -> FlatReplay:
    E, Eep = int(capacity), int(ep_capacity)
    kw = dict(dtype=dtype, device=device)
    i64 = dict(dtype=torch.int64, device=device)
    return FlatReplay(
        obs=torch.zeros((E, na, obs_dim), **kw),
        actions=torch.zeros((E, na, act_dim), **kw),
        mu=torch.zeros((E, na, act_dim), **kw),
        sigma=torch.ones((E, na, act_dim), **kw),
        rewards=torch.zeros((E, na), **kw),
        sv=torch.zeros((E, na), **kw),
        vtg=torch.zeros((E, na), **kw),
        rho=torch.ones((E, na), **kw),
        off=torch.zeros((E, na), dtype=torch.bool, device=device),
        ep_first=torch.zeros((E,), **i64),
        ep_last=torch.full((E,), -1, **i64),
        ep_idx=torch.zeros((E,), **i64),
        fin_obs=torch.zeros((Eep, na, obs_dim), **kw),
        truncated_ep=torch.zeros((Eep,), dtype=torch.bool, device=device),
        boot=torch.zeros((Eep, na), **kw))


def reward_scale_sums(rep: FlatReplay, reward_floor=-np.inf, extra=None, extra_mask=None):
    """(sum r^2, count) over the live buffer: the pieces of korali's Reward
    Rescaling sigma.  Blowup rewards (at or below the raw floor) are excluded
    from the statistic (see the JAX module).  ``extra``/``extra_mask`` fold in
    a fresh, not yet inserted episode batch.  The live slots are always the
    first ``live`` rows of the ring; their count is read on the device."""
    r = rep.rewards
    m = _live_rows(rep)[:, None] & (r > reward_floor)
    s = torch.where(m, r * r, torch.zeros_like(r)).sum()
    n = m.sum().to(r.dtype)
    if extra is not None:
        me = (extra_mask[..., None].expand(extra.shape) > 0) & (extra > reward_floor)
        s = s + torch.where(me, extra * extra, torch.zeros_like(extra)).sum()
        n = n + me.sum().to(r.dtype)
    return s, n


def scale_from_sums(s, n):
    return torch.sqrt(torch.clamp(s / torch.clamp(n, min=1.0), min=1e-18))


def reward_scale(rep: FlatReplay, reward_floor=-np.inf, extra=None, extra_mask=None):
    """korali Reward Rescaling sigma: sqrt(mean r^2 + eps) over the current
    replay, optionally with a fresh batch folded in."""
    return scale_from_sums(*reward_scale_sums(rep, reward_floor, extra, extra_mask))


def _live_rows(rep: FlatReplay):
    """(E,) bool: the ring's live rows, the first ``live`` ones."""
    return torch.arange(rep.capacity, device=rep.counters.device) < rep.counters[1]


def off_policy_sums(rep: FlatReplay):
    """(n_off, n_live) int64 device tensors over the live buffer."""
    n_off = (rep.off & _live_rows(rep)[:, None]).sum()
    return n_off, rep.counters[1] * rep.off.shape[1]


def off_policy_fraction(rep: FlatReplay):
    """REFER's replay-wide off-policy fraction, in float32 as the JAX package
    computes it (korali's _experienceReplayOffPolicyRatio)."""
    n_off, n = off_policy_sums(rep)
    return n_off.to(torch.float32) / torch.clamp(n, min=1).to(torch.float32)


def num_experiences(rep: FlatReplay) -> int:
    return rep.cursor


def add_episodes(rep: FlatReplay, batch: dict, sv, vtg, boot) -> FlatReplay:
    """Compact a padded episode batch (from collect_episodes) into the ring.

    batch: obs/actions/mu/sigma (B,T,na,.), rewards (B,T,na), mask (B,T),
    final_obs (B,na,obs_dim), truncated (B,); ``sv``/``vtg`` (B,T,na) the
    insert-time state and retrace values, ``boot`` (B,na) the bootstrap.
    Live (mask==1) steps are packed episode after episode.

    When one insert holds more live steps than the ring, JAX's in-order
    scatter leaves the newest E; only those are written here, to the slots
    their writes would take, so no slot is written twice (CUDA's scatter has
    no order among duplicates).  The episode ring likewise takes only the
    newest min(B, Eep) episodes."""
    E, Eep = rep.capacity, rep.ep_capacity
    mask = batch["mask"]
    B, T = mask.shape
    device = rep.obs.device
    valid = mask > 0
    lengths = valid.sum(1)                                       # (B,)
    with profiling.span("wait"):                                 # the insert's one readback
        rows = valid.reshape(-1).nonzero().squeeze(1)            # row-major = packed order
    total = rows.shape[0]
    keep = min(total, E)
    rows = rows[total - keep:]
    slot = (rep.cursor + torch.arange(total - keep, total, device=device)) % E
    b_of_row = rows // T
    first_g = rep.cursor + torch.cumsum(lengths, 0) - lengths      # (B,)
    last_g = first_g + lengths - 1
    ep_gid = rep.n_episodes + torch.arange(B, device=device)

    def put(buf, src):
        src = src.reshape((B * T,) + tuple(buf.shape[1:]))
        buf.index_copy_(0, slot, src[rows].to(buf.dtype))

    put(rep.obs, batch["obs"])
    put(rep.actions, batch["actions"])
    put(rep.mu, batch["mu"])
    put(rep.sigma, batch["sigma"])
    put(rep.rewards, batch["rewards"])
    put(rep.sv, sv)
    put(rep.vtg, vtg)
    rep.rho.index_fill_(0, slot, 1.0)
    rep.off.index_fill_(0, slot, False)
    rep.ep_first.index_copy_(0, slot, first_g[b_of_row])
    rep.ep_last.index_copy_(0, slot, last_g[b_of_row])
    rep.ep_idx.index_copy_(0, slot, ep_gid[b_of_row])

    keep_ep = min(B, Eep)
    es = ep_gid[B - keep_ep:] % Eep
    rep.fin_obs.index_copy_(0, es, batch["final_obs"][B - keep_ep:].to(rep.fin_obs.dtype))
    rep.truncated_ep.index_copy_(0, es, batch["truncated"][B - keep_ep:].to(torch.bool))
    rep.boot.index_copy_(0, es, boot[B - keep_ep:].to(rep.boot.dtype))
    rep.cursor += total
    rep.n_episodes += B
    rep.counters[0].fill_(rep.cursor)
    rep.counters[1].fill_(rep.live)
    return rep


def uniform_below(generator, n: int, bound):
    """n uniform int64 draws from [0, bound) for a device tensor ``bound`` >= 1
    (what torch.randint does for a host bound): 62 random bits modulo the
    bound, whose bias (bound / 2**62) is below 1e-9 for any replay."""
    bits = torch.randint(0, 2 ** 62, (n,), generator=generator, device=bound.device)
    return bits % bound


def sample_ids(rep: FlatReplay, generator, n: int):
    """n uniform draws over the live global-id range [cursor-live, cursor)
    (korali generateMiniBatch: uniform over the buffer, with replacement),
    from the device counters."""
    cursor, live = rep.counters[0], rep.counters[1]
    return (cursor - live) + uniform_below(generator, n, torch.clamp(live, min=1))


def gather(rep: FlatReplay, g):
    """Rows + episode metadata for global experience ids g (n,)."""
    s = g % rep.capacity
    es = rep.ep_idx[s] % rep.ep_capacity
    return dict(obs=rep.obs[s], actions=rep.actions[s], mu=rep.mu[s],
                sigma=rep.sigma[s], rewards=rep.rewards[s],
                ep_first=rep.ep_first[s], ep_last=rep.ep_last[s],
                fin_obs=rep.fin_obs[es], truncated=rep.truncated_ep[es],
                ep_slot=es, g=g, slot=s)


def refresh_metadata(rep: FlatReplay, g, V_new, rho_new, off_new, boot_new) -> FlatReplay:
    """Write refreshed per-experience metadata at sampled ids g, in place
    (korali updateExperienceMetadata part 1), plus the episode-ring bootstrap.

    The minibatch samples with replacement, and several rows of one episode
    write the same bootstrap slot; every such duplicate carries the same
    value (the same row or final observation under the same parameters), so
    the unordered scatter is still deterministic."""
    s = g % rep.capacity
    es = rep.ep_idx[s] % rep.ep_capacity
    rep.sv[s] = V_new.to(rep.sv.dtype)
    rep.rho[s] = rho_new.to(rep.rho.dtype)
    rep.off[s] = off_new
    rep.boot[es] = boot_new.to(rep.boot.dtype)
    return rep


def _affine_prefix(a, b):
    """Inclusive prefix composition along axis 1 of the affine maps
    x -> a_k*x + b_k (later maps applied last), as Hillis-Steele doubling:
    ceil(log2 T) rounds of a few tensor ops.  Returns (A, B) with
    f_k o ... o f_0 (x) = A_k*x + B_k; agrees with jax.lax.associative_scan
    to rounding."""
    T = a.shape[1]
    d = 1
    while d < T:
        a_prev, b_prev = a[:, :-d], b[:, :-d]
        b = torch.cat([b[:, :d], a[:, d:] * b_prev + b[:, d:]], dim=1)
        a = torch.cat([a[:, :d], a[:, d:] * a_prev], dim=1)
        d *= 2
    return a, b


def refresh_retrace(rep: FlatReplay, g, T_window: int, gamma, scale,
                    reward_floor=-np.inf, scaled_floor=-np.inf):
    """korali updateExperienceMetadata part 2: recompute the stored retrace
    values of the WHOLE episode of every sampled experience by the backward
    recursion vtg_t = V_t + min(1,rho_t)*(r_t + gamma*vtg_{t+1} - V_t), seeded
    with the truncated-state bootstrap (0 for terminal episodes), from the
    just-refreshed sv/rho at sampled points and the stored values elsewhere.

    Returns (rep with vtg refreshed in place, vtg_next (n, na)): the refreshed
    retrace value of g+1, or the bootstrap at an episode end.  T_window must
    be >= the longest episode (use cfg.episode_length)."""
    E = rep.capacity
    s = g % E
    ep_first, ep_last = rep.ep_first[s], rep.ep_last[s]                   # (n,)
    es = rep.ep_idx[s] % rep.ep_capacity
    boot0 = torch.where(rep.truncated_ep[es][:, None], rep.boot[es],
                        torch.zeros_like(rep.boot[es]))

    # window of global ids descending from the episode end
    w = ep_last[:, None] - torch.arange(T_window, device=g.device)[None, :]
    horizon = rep.counters[0] - rep.counters[1]
    valid = (w >= ep_first[:, None]) & (w >= horizon)                      # (n, Tw)
    # invalid window slots read (and, below, write) the episode's last
    # experience, which is always live: no index leaves the ring
    ws = torch.where(valid, w % E, (ep_last % E)[:, None])
    val = valid[:, :, None]

    sv_w = torch.where(val, rep.sv[ws], torch.zeros((), dtype=rep.sv.dtype, device=g.device))
    r_w = torch.where(val, rep.rewards[ws], torch.zeros((), dtype=rep.sv.dtype, device=g.device))
    r_w = torch.clamp(torch.clamp(running_stats.promoted(r_w, scale), min=reward_floor) / scale,
                      min=scaled_floor)
    rho_w = torch.where(val, rep.rho[ws], torch.ones((), dtype=rep.sv.dtype, device=g.device))
    rho_bar = torch.clamp(rho_w, max=1.0)

    # vt_k = sv_k + rb_k*(r_k + gamma*vt_{k-1} - sv_k) is the affine map
    # vt_k = a_k*vt_{k-1} + b_k (invalid slots pass the carry through)
    a = torch.where(val, gamma * rho_bar, torch.ones_like(rho_bar))
    b = torch.where(val, sv_w * (1.0 - rho_bar) + rho_bar * r_w, torch.zeros_like(rho_bar))
    A, Bc = _affine_prefix(a, b)
    new_vtg = A * boot0[:, None, :] + Bc                                    # (n, Tw, na)

    # Invalid slots write window slot 0's value (the episode end) to the
    # episode end.  Sampled rows of one episode have identical windows, so
    # every duplicate write to a slot carries the same value.
    src = torch.where(val, new_vtg, new_vtg[:, :1, :])
    rep.vtg.index_put_((ws.reshape(-1),), src.reshape(-1, rep.vtg.shape[1]).to(rep.vtg.dtype))

    # successor value for the sampled experience: refreshed vtg at g+1 (window
    # slot d-1 with d = ep_last - g), or the bootstrap at an episode end
    d = ep_last - g
    idx = torch.clamp(d - 1, min=0)
    nxt = torch.gather(new_vtg, 1, idx[:, None, None].expand(-1, 1, new_vtg.shape[2]))[:, 0]
    vtg_next = torch.where((d == 0)[:, None], boot0, nxt)
    return rep, vtg_next
