"""V-RACER with REFER, episode-minibatch mode (port of
marlpde_tpu/rl/vracer.py:59-467,505-508,669-688).

Algorithm per Novati & Koumoutsakos, "Remember and Forget for Experience
Replay" (ICML 2019), with the configuration surface of the reference run
scripts (run-vracer-burger.py:127-195): one network for V(s), policy mean and stddev;
a clipped-normal policy; state and reward rescaling; V-trace value targets
along stored episodes; the policy gradient for near-policy samples and a KL
attraction for far-policy ones; adaptive beta toward the off-policy target;
cutoff annealing.  Blowup containment and every documented deviation from
korali are as in the JAX package (see its module docstring).

In PyTorch's idiom the train state holds the ``VracerNet`` module and its
``torch.optim.Adam``; ``update`` steps them in place.  The acting path
(``policy_apply``, ``act``, ``act_deterministic``) goes through the MLP op
(kernels/mlp.py) without autograd; the losses differentiate the module.
The korali-style experience mode (``minibatch_mode='experience'``) waits for
a later slice (ROADMAP queue 1).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from marlpde_tpu_torch.kernels import mlp
from marlpde_tpu_torch.rl import distributions as D
from marlpde_tpu_torch.rl import networks, running_stats


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


@dataclasses.dataclass
class TrainState:
    net: networks.VracerNet
    opt: torch.optim.Adam
    beta: torch.Tensor           # 0-d
    n_updates: int
    obs_stats: running_stats.RunningStats
    rew_stats: running_stats.RunningStats


def make_net(cfg: VracerConfig, dtype=torch.float32, device=None,
             generator=None) -> networks.VracerNet:
    return networks.VracerNet(obs_dim=cfg.obs_dim, act_dim=cfg.act_dim,
                              width=cfg.width, n_hidden=cfg.n_hidden,
                              init_noise=cfg.init_noise, sigma_max=cfg.sigma_max,
                              mu_param=cfg.mu_param, dtype=dtype, device=device,
                              generator=generator)


def _joint_dims(cfg: VracerConfig) -> int:
    return cfg.act_dim * (cfg.num_agents if (cfg.multi_agent_correlation
                                             and cfg.num_agents > 1) else 1)


def _rho_temper(cfg: VracerConfig) -> float:
    """Exponent applied to the joint importance weight under cutoff_dim_norm
    (vracer.py:217-223); 1.0 otherwise."""
    if not cfg.cutoff_dim_norm:
        return 1.0
    return 1.0 / float(np.sqrt(_joint_dims(cfg)))


def make_optimizer(cfg: VracerConfig, net: networks.VracerNet) -> torch.optim.Adam:
    """Adam at a constant lr; the global-norm clip that optax chains before it
    is applied in ``update`` (``clip_by_global_norm``)."""
    return torch.optim.Adam(net.parameters(), lr=cfg.lr)


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
            m = m * float(ts.n_updates == 0)
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
            if float(ts.rew_stats.count) > 1000.0:
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


def _trust_kl(cfg: VracerConfig, mu_b, sigma_b, mu, sigma):
    if cfg.trust_region == "jeffreys":
        return D.kl_jeffreys(mu_b, sigma_b, mu, sigma)
    return D.kl_normal(mu_b, sigma_b, mu, sigma)


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
    log_ratio = torch.clamp(log_ratio * _rho_temper(cfg), -20.0, 20.0)
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

    kl = _trust_kl(cfg, batch["mu"], batch["sigma"], mu, sigma)
    far = (~near).to(kl.dtype)
    kl_loss = torch.sum(w * far * kl) / denom

    loss = cfg.value_coef * v_loss + ts.beta * pg_loss + (1.0 - ts.beta) * kl_loss
    frac_far = torch.sum(w * far) / denom
    metrics = dict(loss=loss, v_loss=v_loss, pg_loss=pg_loss, kl_loss=kl_loss,
                   frac_far=frac_far, mean_rho=torch.sum(w * rho) / denom,
                   mean_sigma=sigma.mean(), mean_mu=mu.mean(),
                   mean_V=torch.sum(w * V) / denom)
    return loss, {k: v.detach() for k, v in metrics.items()}


@torch.no_grad()
def clip_by_global_norm(grads, max_norm: float):
    """optax.clip_by_global_norm, in place: scale by max_norm/||g|| only when
    ||g|| >= max_norm (torch's clip_grad_norm_ uses max_norm/(||g|| + 1e-6))."""
    g_norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
    keep = g_norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / g_norm * max_norm))
    return g_norm


def update(cfg: VracerConfig, ts: TrainState, batch):
    """One gradient step on a sampled episode batch; returns (ts, metrics).
    The network and the optimizer state are updated in place."""
    n_upd = torch.tensor(float(ts.n_updates), dtype=torch.float32, device=ts.beta.device)
    cutoff = cfg.cutoff_scale / (1.0 + cfg.annealing_rate * n_upd)
    ts.opt.zero_grad(set_to_none=True)
    loss, metrics = _loss(cfg, ts.net, ts, batch, cutoff)
    loss.backward()
    clip_by_global_norm([p.grad for p in ts.net.parameters()], cfg.max_grad_norm)
    ts.opt.step()

    # REFER beta adaptation (paper sec. 3.2): push frac_far toward target
    nu = torch.tensor(cfg.lr * 10.0, dtype=ts.beta.dtype, device=ts.beta.device)
    beta = torch.where(metrics["frac_far"] > cfg.offpolicy_target,
                       (1.0 - nu) * ts.beta, (1.0 - nu) * ts.beta + nu)
    beta = torch.clamp(beta, 0.05, 1.0)

    metrics["beta"] = beta
    metrics["cutoff"] = cutoff
    return dataclasses.replace(ts, beta=beta, n_updates=ts.n_updates + 1), metrics
