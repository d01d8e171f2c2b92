"""V-RACER with REFER, both minibatch modes (port of
marlpde_tpu/rl/vracer.py:59-688).

Algorithm per Novati & Koumoutsakos, "Remember and Forget for Experience
Replay" (ICML 2019), with the configuration surface of the reference run
scripts (run-vracer-burger.py:127-195): one network for V(s), policy mean and stddev;
a clipped-normal policy; state and reward rescaling; V-trace value targets
along stored episodes; the policy gradient for near-policy samples and a KL
attraction for far-policy ones; adaptive beta toward the off-policy target;
cutoff annealing.  Blowup containment and every documented deviation from
korali are as in the JAX package (see its module docstring).

The korali-faithful path is ``minibatch_mode="experience"`` (the CLI
default): uniform-experience minibatches over the flat REFER replay
(replay_flat) with lazily refreshed metadata, whole-episode retrace refresh
per update, the replay-wide off-policy fraction driving beta at the annealed
learning rate, and second-moment reward rescaling over the live buffer.

Data-parallel training (parallel/mesh.py) passes ``group``, the rank's
``Mesh``, to ``flat_insert``, ``update_experience`` and ``update``: the
counterpart of the JAX package's shard_map ``axis``.  The replay is the
rank's own shard; the reward-scale sums and the replay-wide off-policy counts
are summed over the ranks and the gradients averaged before the global-norm
clip, so every rank takes the same step.  With ``group=None`` nothing is
reduced.

In PyTorch's idiom the train state holds the ``VracerNet`` module and its
``torch.optim.Adam``; ``update`` and ``update_experience`` step them, beta,
the update counter and the replay in place, and return the same state.  Every
forward that needs no gradient (acting, the insert-time V(s), the V(s_T)
bootstraps) goes through the MLP op (kernels/mlp.py); the losses
differentiate the module.  The experience-mode loss head, from the module's
outputs to their gradients, is the loss-head op (rl/vracer_loss.py):
``rho_terms`` before the metadata refresh, ``experience_loss`` after the
retrace refresh.  The update counter lives on the device, as in the
JAX package, and the annealed cutoff and learning rate are computed there, so
an update makes no device readback and reads no host value that changes: the
trainer replays it as a CUDA graph (utils/graphs.py).  On the card Adam is
capturable (its step count on the device too).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from marlpde_tpu_torch.kernels import mlp
from marlpde_tpu_torch.rl import distributions as D
from marlpde_tpu_torch.rl import networks, replay_flat, running_stats, vracer_loss
from marlpde_tpu_torch.utils import profiling


@dataclasses.dataclass(frozen=True, eq=True)
class VracerConfig:
    """Fields, defaults and meaning as marlpde_tpu/rl/vracer.py:59-192, so
    configs carry over."""

    obs_dim: int
    act_dim: int
    num_agents: int = 1
    episode_length: int = 500
    gamma: float = 1.0
    lr: float = 1e-4
    width: int = 128
    n_hidden: int = 2
    mini_batch_episodes: int = 2
    minibatch_mode: str = "episode"        # 'episode' | 'experience'
    mini_batch_size: int = 256
    experiences_between_updates: float = 0.5
    replay_start_experiences: int = 20000
    replay_max_experiences: int = 100000
    cutoff_scale: float = 4.0
    annealing_rate: float = 5e-8
    refer_beta: float = 0.3
    offpolicy_target: float = 0.1
    action_low: float = -5.0
    action_high: float = 5.0
    init_noise: float = 0.1       # iex
    state_rescaling: bool = True
    reward_rescaling: bool = True
    multi_agent_relationship: str = "individual"   # 'individual' | 'cooperation'
    multi_agent_correlation: bool = False
    value_coef: float = 1.0
    max_grad_norm: float = 10.0
    reward_floor: float = -1e4
    obs_clip: float = 32.0
    obs_stat_bound: float = 1e6
    sigma_max: float = np.inf
    # Kept for config compatibility and chooses nothing in the port: the
    # acting forward always goes through the MLP op, whose tensor's device
    # picks the kernel (CUDA) or its plain version (CPU).
    policy_impl: str = "xla"
    trust_region: str = "jeffreys"
    scaled_reward_floor: float = -100.0
    freeze_state_rescaling: bool = True
    reward_scale_source: str = "replay"    # experience mode only
    reward_stat_winsor: float = 10.0
    mu_param: str = "absolute"             # 'absolute' | 'sigma_relative'
    cutoff_dim_norm: bool = False
    replay_episode_capacity: int | None = None

    @property
    def replay_capacity_episodes(self) -> int:
        return max(self.replay_max_experiences // self.episode_length, 1)

    @property
    def replay_start_episodes(self) -> int:
        return max(self.replay_start_experiences // self.episode_length, 1)

    @property
    def flat_episode_capacity(self) -> int:
        if self.replay_episode_capacity is not None:
            return self.replay_episode_capacity
        return max(self.replay_max_experiences // 4, 1024)


@dataclasses.dataclass
class TrainState:
    net: networks.VracerNet
    opt: torch.optim.Adam
    beta: torch.Tensor           # 0-d, updated in place
    n_updates: torch.Tensor      # 0-d int64 on beta's device, updated in place (an int is taken)
    obs_stats: running_stats.RunningStats
    rew_stats: running_stats.RunningStats

    def __post_init__(self):
        if not isinstance(self.n_updates, torch.Tensor):
            self.n_updates = torch.tensor(int(self.n_updates), dtype=torch.int64,
                                          device=self.beta.device)


def make_net(cfg: VracerConfig, dtype=torch.float32, device=None,
             generator=None) -> networks.VracerNet:
    return networks.VracerNet(obs_dim=cfg.obs_dim, act_dim=cfg.act_dim,
                              width=cfg.width, n_hidden=cfg.n_hidden,
                              init_noise=cfg.init_noise, sigma_max=cfg.sigma_max,
                              mu_param=cfg.mu_param, dtype=dtype, device=device,
                              generator=generator)


def make_optimizer(cfg: VracerConfig, net: networks.VracerNet) -> torch.optim.Adam:
    """Adam at a constant lr; the global-norm clip that optax chains before it
    is applied in ``update`` (``clip_by_global_norm``).  Capturable on the
    card, where the updates are replayed as CUDA graphs (its step count and
    bias corrections on the device); the plain Adam on the CPU, which
    capturable Adam does not take."""
    on_card = next(net.parameters()).device.type == "cuda"
    return torch.optim.Adam(net.parameters(), lr=cfg.lr, capturable=on_card)


def init_train(cfg: VracerConfig, generator: torch.Generator, dtype=torch.float32,
               device=None) -> TrainState:
    """``generator`` draws the initial weights; it may live on any device."""
    net = make_net(cfg, dtype=dtype, device=device, generator=generator)
    return TrainState(
        net=net, opt=make_optimizer(cfg, net),
        beta=torch.tensor(cfg.refer_beta, dtype=dtype, device=device),
        n_updates=0,
        obs_stats=running_stats.init((cfg.obs_dim,), dtype, device),
        rew_stats=running_stats.init((), dtype, device))


def _prep_obs(cfg: VracerConfig, ts: TrainState, obs):
    x = running_stats.normalize(ts.obs_stats, obs) if cfg.state_rescaling else obs
    if np.isfinite(cfg.obs_clip):
        x = torch.clamp(x, -cfg.obs_clip, cfg.obs_clip)
    return x


@torch.no_grad()
def policy_apply(cfg: VracerConfig, ts: TrainState, obs):
    """obs (..., obs_dim) -> (V, mu, sigma), through the MLP op."""
    x = _prep_obs(cfg, ts, obs)
    lead = obs.shape[:-1]
    V, mu, sigma = mlp.mlp_forward(x.reshape(-1, cfg.obs_dim).contiguous(), ts.net)
    return (V.reshape(lead), mu.reshape(lead + (cfg.act_dim,)),
            sigma.reshape(lead + (cfg.act_dim,)))


def act(cfg: VracerConfig, ts: TrainState, obs, generator):
    """Sample actions; returns (actions, mu, sigma).  obs: (..., na, obs_dim)."""
    _, mu, sigma = policy_apply(cfg, ts, obs)
    a = D.sample(generator, mu, sigma, cfg.action_low, cfg.action_high)
    return a, mu, sigma


def act_deterministic(cfg: VracerConfig, ts: TrainState, obs):
    _, mu, _ = policy_apply(cfg, ts, obs)
    return torch.clamp(mu, cfg.action_low, cfg.action_high)


def _median_abs(r, w):
    """Median of |r| over the entries with w > 0, interpolated as
    jnp.nanquantile(.., 0.5) does; 0 when there are none.  A sort and an
    index, because torch.nanquantile refuses inputs over 2**24 elements."""
    valid = (w > 0).reshape(-1)
    srt = torch.sort(torch.where(valid, r.abs().reshape(-1),
                                 torch.full_like(valid, np.inf, dtype=r.dtype))).values
    n = valid.sum()
    q = 0.5 * (n - 1).to(torch.float64)
    top = torch.clamp(n - 1, min=0)
    lo = torch.minimum(torch.clamp(torch.floor(q), min=0).to(torch.int64), top)
    hi = torch.minimum(torch.clamp(torch.ceil(q), min=0).to(torch.int64), top)
    hw = (q - torch.floor(q)).to(r.dtype)
    with profiling.span("wait"):                    # indexing by a device scalar reads it back
        med = srt[lo] * (1.0 - hw) + srt[hi] * hw
    return torch.where(n > 0, torch.clamp(med, min=1e-30), torch.zeros_like(med))


def observe_episodes(cfg: VracerConfig, ts: TrainState, batch) -> TrainState:
    """Update normalizer statistics from freshly collected episodes
    (vracer.py:278-344).  Observation stats freeze at the first policy update
    (korali State Rescaling).  Whether the reward accumulator is warm decides
    on the host, at the cost of one scalar readback, between the cumulative
    scale and the batch median as the winsorization reference."""
    new_obs = ts.obs_stats
    new_rew = ts.rew_stats
    mask_sa = batch["mask"][..., None].expand(batch["rewards"].shape)
    if cfg.state_rescaling:
        m = batch["mask"][..., None, None].expand(batch["obs"].shape[:-1] + (1,))
        if np.isfinite(cfg.obs_stat_bound):
            ok = batch["obs"].abs().amax(-1, keepdim=True) <= cfg.obs_stat_bound
            m = m * ok.to(m.dtype)
        if cfg.freeze_state_rescaling:
            m = m * (ts.n_updates == 0).to(m.dtype)
        new_obs = running_stats.update(
            new_obs, batch["obs"].reshape(-1, cfg.obs_dim), weights=m.reshape(-1))
    if cfg.reward_rescaling:
        # blowup rewards (raw <= reward_floor) are excluded from the statistic
        w = mask_sa
        if np.isfinite(cfg.reward_floor):
            w = w * (batch["rewards"] > cfg.reward_floor).to(w.dtype)
        r_stat = torch.clamp(batch["rewards"], min=cfg.reward_floor)
        if cfg.reward_stat_winsor > 0:
            # clip at winsor * the current cumulative scale once the
            # accumulator is warm, else at winsor * the batch median |r|
            if profiling.host(ts.rew_stats.count) > 1000.0:
                ref = running_stats.second_moment(ts.rew_stats)
            else:
                ref = _median_abs(r_stat, w)
            lim = cfg.reward_stat_winsor * ref
            r_stat = torch.clamp(r_stat, -lim, lim)
        new_rew = running_stats.update(new_rew, r_stat.reshape(-1),
                                       weights=w.reshape(-1))
    return dataclasses.replace(ts, obs_stats=new_obs, rew_stats=new_rew)


def _vtrace(V, rewards, rho, mask, gamma, bootstrap=None):
    """V-trace targets along T with clipped one-sample IS weights
    (vracer.py:347-391).

    V, rewards, rho, mask: (..., T).  A normal episode end is "Terminal" (no
    bootstrap); a blowup end is "Truncated" and ``bootstrap`` (..., already
    zeroed for non-truncated episodes) is the successor value at the last
    valid step.  Returns (vtg, adv)."""
    rewards = rewards.to(V.dtype)
    mask = mask.to(V.dtype)
    rho_bar = torch.clamp(rho, max=1.0).to(V.dtype)
    zeros = torch.zeros_like(V[..., :1])
    V_next = torch.cat([V[..., 1:], zeros], dim=-1)
    next_valid = torch.cat([mask[..., 1:], zeros], dim=-1)
    V_next = V_next * next_valid
    if bootstrap is not None:
        # 1 exactly at the last valid step of each episode
        last_valid = mask * (1.0 - next_valid)
        bootstrap = bootstrap.to(V.dtype)
        V_next = V_next + last_valid * bootstrap[..., None]
    delta = rho_bar * (rewards + gamma * V_next - V)

    # corr_t = vtg_t - V_t = delta_t + gamma*rho_bar_t*nv_t*corr_{t+1}, backward
    # in time; nv_t is 0 or 1, so folding it into the coefficient changes no bit
    delta_t = delta.movedim(-1, 0).contiguous()
    coef_t = (gamma * rho_bar * next_valid).movedim(-1, 0).contiguous()
    corr_t = torch.empty_like(delta_t)
    carry = torch.zeros_like(delta_t[0])
    for t in range(delta_t.shape[0] - 1, -1, -1):
        carry = torch.addcmul(delta_t[t], coef_t[t], carry, out=corr_t[t])
    vtg = V + corr_t.movedim(0, -1)
    vtg_next = torch.cat([vtg[..., 1:], zeros], dim=-1) * next_valid
    if bootstrap is not None:
        vtg_next = vtg_next + last_valid * bootstrap[..., None]
    adv = rewards + gamma * vtg_next - V
    return vtg, adv


def _loss(cfg: VracerConfig, net: networks.VracerNet, ts: TrainState, batch, cutoff):
    """Episode-minibatch VRACER loss (vracer.py:394-467); differentiates
    ``net`` itself, never the MLP op."""
    obs = _prep_obs(cfg, ts, batch["obs"])
    V, mu, sigma = net(obs)                        # (K, T, na[, A])

    rewards = torch.clamp(batch["rewards"], min=cfg.reward_floor)
    if cfg.reward_rescaling:
        rewards = running_stats.scale(ts.rew_stats, rewards)
    rewards = torch.clamp(rewards, min=cfg.scaled_reward_floor)
    if cfg.multi_agent_relationship == "cooperation":
        rewards = rewards.mean(-1, keepdim=True).expand(rewards.shape)

    logp = D.joint_log_prob(batch["actions"], mu, sigma,
                            cfg.action_low, cfg.action_high)
    logp_b = D.joint_log_prob(batch["actions"], batch["mu"], batch["sigma"],
                              cfg.action_low, cfg.action_high)
    log_ratio = logp - logp_b
    if cfg.multi_agent_correlation and cfg.num_agents > 1:
        log_ratio = log_ratio.sum(-1, keepdim=True).expand(log_ratio.shape)
    log_ratio = torch.clamp(log_ratio * vracer_loss.rho_temper(cfg), -20.0, 20.0)
    rho = torch.exp(log_ratio)
    near = (rho > 1.0 / cutoff) & (rho < cutoff)

    # truncated-episode bootstrap from V(s_T); the pre-blowup final obs can be
    # huge or NaN, so sanitize before the network
    bootstrap = None
    if "final_obs" in batch:
        fin = torch.nan_to_num(batch["final_obs"], nan=0.0,
                               posinf=cfg.obs_stat_bound, neginf=-cfg.obs_stat_bound)
        V_fin, _, _ = net(_prep_obs(cfg, ts, fin))                  # (K, na)
        trunc = batch["truncated"].to(V_fin.dtype)                  # (K,)
        bootstrap = V_fin.detach() * trunc[..., None]

    mask = batch["mask"][..., None]                # (K, T, 1) broadcast over agents
    vtg, adv = _vtrace(V.detach().movedim(1, -1), rewards.movedim(1, -1),
                       rho.detach().movedim(1, -1),
                       mask.expand(rho.shape).movedim(1, -1), cfg.gamma,
                       bootstrap=bootstrap)
    vtg = vtg.movedim(-1, 1)
    adv = adv.movedim(-1, 1)

    w = mask.expand(rho.shape)
    denom = torch.clamp(w.sum(), min=1.0)

    v_loss = 0.5 * torch.sum(w * (V - vtg.detach()) ** 2) / denom
    pg_w = (torch.minimum(rho, cutoff) * adv * near).detach()
    pg_loss = -torch.sum(w * pg_w * logp) / denom

    kl = vracer_loss.trust_kl(cfg, batch["mu"], batch["sigma"], mu, sigma)
    far = (~near).to(kl.dtype)
    kl_loss = torch.sum(w * far * kl) / denom

    loss = cfg.value_coef * v_loss + ts.beta * pg_loss + (1.0 - ts.beta) * kl_loss
    frac_far = torch.sum(w * far) / denom
    metrics = dict(loss=loss, v_loss=v_loss, pg_loss=pg_loss, kl_loss=kl_loss,
                   frac_far=frac_far, mean_rho=torch.sum(w * rho) / denom,
                   mean_sigma=sigma.mean(), mean_mu=mu.mean(),
                   mean_V=torch.sum(w * V) / denom)
    return loss, {k: v.detach() for k, v in metrics.items()}


def _sanitized_final_V(cfg: VracerConfig, ts: TrainState, final_obs):
    """V(s_T) for the truncated-state bootstrap, through the MLP op; the
    pre-blowup observations can be NaN or huge, so sanitize first."""
    fin = torch.nan_to_num(final_obs, nan=0.0, posinf=cfg.obs_stat_bound,
                           neginf=-cfg.obs_stat_bound)
    return policy_apply(cfg, ts, fin)[0]


def _insert_scale(cfg: VracerConfig, ts: TrainState, frep, rewards=None, mask=None,
                  group=None):
    """The reward-rescaling sigma: 1 without rescaling, the cumulative
    second moment (the normalizer, already the same on every rank), or
    korali's live-buffer one (with a fresh batch folded in when ``rewards``
    is given), its sums taken over every rank's shard under ``group``."""
    if not cfg.reward_rescaling:
        return torch.ones((), dtype=ts.beta.dtype, device=ts.beta.device)
    if cfg.reward_scale_source == "cumulative":
        return running_stats.second_moment(ts.rew_stats)
    s, n = replay_flat.reward_scale_sums(frep, cfg.reward_floor, extra=rewards, extra_mask=mask)
    if group is not None:
        s, n = group.psum([s, n])
    return replay_flat.scale_from_sums(s, n)


@torch.no_grad()
def flat_insert(cfg: VracerConfig, ts: TrainState, frep, batch, group=None):
    """korali processEpisode: compute the entering episodes' V(s), on-policy
    (rho=1) retrace values in current scaled-reward units and the
    truncated-state bootstrap V(s_T), then append the live steps to the flat
    ring (in place).  batch: episode tensors (B, T, na, ...) from
    collect_episodes.  With the cumulative scale, ``observe_episodes`` must
    already have folded these episodes in, as both trainer paths do.  Under
    ``group`` (vracer.py:511-547) ``frep`` is the rank's shard and the
    live-buffer scale is that of every rank's shard and batch."""
    V = policy_apply(cfg, ts, batch["obs"])[0]                       # (B, T, na)
    scale = _insert_scale(cfg, ts, frep, batch["rewards"], batch["mask"], group)
    rewards = vracer_loss.rescale_rewards(cfg, batch["rewards"], scale)
    boot = (_sanitized_final_V(cfg, ts, batch["final_obs"])
            * batch["truncated"].to(V.dtype)[..., None])
    mask = batch["mask"][..., None].expand(rewards.shape)
    vtg, _ = _vtrace(V.movedim(1, -1), rewards.movedim(1, -1),
                     torch.ones_like(rewards.movedim(1, -1)), mask.movedim(1, -1),
                     cfg.gamma, bootstrap=boot)
    return replay_flat.add_episodes(frep, batch, sv=V, vtg=vtg.movedim(-1, 1), boot=boot)


def _annealed(cfg: VracerConfig, n_updates):
    """(den, cutoff, 1/cutoff), 0-d float32 tensors on the counter's device:
    den = 1 + annealing_rate * n as the JAX package computes it from its int32
    counter, and the cutoff c0 / den, each operation rounded to float32."""
    den = n_updates.to(torch.float32) * float(np.float32(cfg.annealing_rate)) + 1.0
    cutoff = torch.full_like(den, float(np.float32(cfg.cutoff_scale))) / den
    return den, cutoff, torch.reciprocal(cutoff)


def _adapt_beta_(ts: TrainState, far, lr_t, floor: float):
    """REFER's beta step, in place: beta <- (1 - lr_t) beta, plus lr_t unless
    ``far`` (the off-policy fraction is above target), clipped to
    [floor, 1].  ``lr_t`` is a 0-d tensor; returns the new beta's copy."""
    lr_t = lr_t.to(ts.beta.dtype)
    kept = (1.0 - lr_t) * ts.beta
    beta = torch.clamp(torch.where(far, kept, kept + lr_t), floor, 1.0)
    ts.beta.copy_(beta)
    return beta


def update_experience(cfg: VracerConfig, ts: TrainState, frep, generator,
                      group=None, mini_batch: int | None = None):
    """One korali-faithful VRACER update on the flat experience replay
    (vracer.py:583-666, one device): sample ``mini_batch_size`` experiences
    uniformly; forward the current policy on them and refresh their stored
    metadata and the bootstraps of the touched episodes; recompute the retrace
    values of those episodes' whole chains; take the gradient step with the
    refreshed successor values; anneal beta against the replay-wide
    off-policy fraction at the annealed learning rate, clipped to [0, 1].

    The metadata refresh evaluates the same parameters on the same rows as the
    loss, so it takes the loss forward's detached outputs instead of a second
    forward (equal in exact arithmetic).  Returns (ts, frep, metrics): the
    same ts and frep, whose module, optimizer state, beta, update counter and
    buffers change in place.

    Under ``group`` (vracer.py:583-666 with ``axis``) ``frep`` is the rank's
    shard and ``mini_batch`` the rank's slice of the minibatch: sampling and
    the refreshes stay on the shard, the live-buffer scale and the replay-wide
    off-policy fraction are summed over the ranks, and the gradients are
    averaged before the clip, so every rank takes the same step."""
    den, cutoff, inv_cutoff = _annealed(cfg, ts.n_updates)
    g = replay_flat.sample_ids(frep, generator, mini_batch or cfg.mini_batch_size)
    rows = replay_flat.gather(frep, g)
    scale = _insert_scale(cfg, ts, frep, group=group)

    ts.opt.zero_grad(set_to_none=True)
    out = ts.net(_prep_obs(cfg, ts, rows["obs"]))                    # (n, na[, A])
    V, mu, sigma = (t.detach() for t in out)
    rho_new, off_new, terms = vracer_loss.rho_terms(cfg, rows, mu, sigma, scale, cutoff,
                                                    inv_cutoff)
    boot_new = (_sanitized_final_V(cfg, ts, rows["fin_obs"])
                * rows["truncated"].to(V.dtype)[..., None])
    replay_flat.refresh_metadata(frep, g, V, rho_new, off_new, boot_new)
    _, vtg_next = replay_flat.refresh_retrace(
        frep, g, cfg.episode_length, cfg.gamma, scale, cfg.reward_floor,
        scaled_floor=cfg.scaled_reward_floor)

    metrics, backward = vracer_loss.experience_loss(cfg, ts.beta, out, rows, vtg_next, terms)
    torch.autograd.backward(*backward)
    grads = [p.grad for p in ts.net.parameters()]
    if group is not None:
        _copy_(grads, group.pmean(grads))
    clip_by_global_norm(grads, cfg.max_grad_norm)
    _optimizer_step(ts)

    n_off, n_live = replay_flat.off_policy_sums(frep)
    if group is not None:
        n_off, n_live = group.psum([n_off, n_live])
    frac_off = n_off.to(torch.float32) / torch.clamp(n_live, min=1).to(torch.float32)
    # the annealed learning rate lr / den in beta's dtype
    lr_t = torch.full_like(ts.beta, cfg.lr) / den.to(ts.beta.dtype)
    beta = _adapt_beta_(ts, frac_off > cfg.offpolicy_target, lr_t, 0.0)
    metrics.update(beta=beta, cutoff=cutoff, frac_off_replay=frac_off, rew_scale=scale)
    return ts, frep, metrics


def _optimizer_step(ts: TrainState):
    """Adam's step, the update counter, and the MLP kernel's image of the new
    W2 (which a replayed step must rewrite itself: it changes W2 without
    bumping its version counter)."""
    ts.opt.step()
    ts.n_updates.add_(1)
    mlp.refresh_w2_image(ts.net)


@torch.no_grad()
def _copy_(dst, src):
    for d, s in zip(dst, src):
        d.copy_(s)


@torch.no_grad()
def clip_by_global_norm(grads, max_norm: float):
    """optax.clip_by_global_norm, in place: scale by max_norm/||g|| only when
    ||g|| >= max_norm (torch's clip_grad_norm_ uses max_norm/(||g|| + 1e-6))."""
    g_norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
    keep = g_norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / g_norm * max_norm))
    return g_norm


def update(cfg: VracerConfig, ts: TrainState, batch, group=None):
    """One gradient step on a sampled episode batch; returns (ts, metrics),
    the same ts, whose network, optimizer state, beta and update counter
    change in place.  Under
    ``group`` the rank's gradients and its minibatch's far-policy fraction
    are averaged over the ranks (one collective) before the clip, Adam and
    beta, as the JAX mesh's episode-mode update does
    (marlpde_tpu/parallel/mesh.py:164-185)."""
    _, cutoff, _ = _annealed(cfg, ts.n_updates)
    ts.opt.zero_grad(set_to_none=True)
    loss, metrics = _loss(cfg, ts.net, ts, batch, cutoff)
    loss.backward()
    grads = [p.grad for p in ts.net.parameters()]
    if group is not None:
        *avg, metrics["frac_far"] = group.pmean(grads + [metrics["frac_far"]])
        _copy_(grads, avg)
    clip_by_global_norm(grads, cfg.max_grad_norm)
    _optimizer_step(ts)

    # REFER beta adaptation (paper sec. 3.2): push frac_far toward target
    nu = torch.full_like(ts.beta, cfg.lr * 10.0)
    metrics["beta"] = _adapt_beta_(ts, metrics["frac_far"] > cfg.offpolicy_target, nu, 0.05)
    metrics["cutoff"] = cutoff
    return ts, metrics
