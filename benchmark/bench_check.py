"""What decides ``correct``: the program's outputs of one generation (or one
evaluation) after the window, held against the plain reference.

The runner snapshots, from outside the program, what the reference needs to
follow that generation from the program's own state: the network and
normalizers before the collection, the replay before the insert, the
parameters, Adam's state and the generator before the updates, and the
parameters and loss after the first graph replay of the updates.  After the
run has stopped, ``numbers`` works every stage out again in plain PyTorch
(``reference/``) and returns one number a stage:

  init_gap     the initial weights drawn from the seed
  mu_gap       the policy mean of every step of every episode, from the
               program's observations (the MLP kernel against the module)
  sigma_gap    the same, of the policy's standard deviation
  obs_gap      the env's observations, teacher-forced: the reference env
               stepped with the program's actions from the same reset, over
               the first ``ENV_STEPS`` macro-steps
               (over a whole episode float32 rounding drifts apart in both
               the program and the control, and the gap measures the drift)
  reward_gap   the env's rewards, the same way
  norm_gap     the state and reward normalizers after the insert
  insert_gap   the replay after the insert (every field)
  loss_gap     the loss of the last update of the first graph replay
  dparam_gap   each leaf's change of the parameters over that replay, by the
               worst leaf

Each gap is max |program - reference| over max |reference| of what it
compares (``rel_gap``); ``dparam_gap`` is the gap of the norms of a leaf's
change over the reference's norm of that leaf, or of the median leaf,
whichever is larger, leaving out leaves whose first gradient in the
reference is under a thousandth of the median leaf's.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib
import math

import numpy as np
import torch

from reference.learner import replay as ref_replay
from reference.learner import replay_flat as ref_flat
from reference.learner import running_stats as ref_stats
from reference.learner import vracer as ref

# the env is compared over the episodes' first 25 macro-steps: past them the
# float32 drift of a whole episode swamps a step's rounding (PERF.md)
ENV_STEPS = 25
NAMES = ("init_gap", "mu_gap", "sigma_gap", "obs_gap", "reward_gap", "norm_gap",
         "insert_gap", "loss_gap", "dparam_gap")


@contextlib.contextmanager
def precision(tf32: bool):
    """float32 matmuls as the configuration states them (TF32 off), or, for
    the control, in TF32."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    torch.set_float32_matmul_precision("high" if tf32 else "highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved[:2]
        torch.set_float32_matmul_precision(saved[2])


def rel_gap(a, b) -> float:
    """max |a - b| / max |b| over the entries where either is finite; inf where
    one is finite and the other not; 0 for no entries."""
    a, b = a.detach().double(), b.detach().double().to(a.device)
    fa, fb = torch.isfinite(a), torch.isfinite(b)
    if bool((fa != fb).any()):
        return math.inf
    both_inf = ~fa
    if bool((a[both_inf] != b[both_inf]).any()):
        return math.inf
    if not bool(fa.any()):
        return 0.0
    d = (a[fa] - b[fa]).abs().max().item()
    scale = b[fb].abs().max().item()
    return d / scale if scale > 0 else d


def exact_gap(a, b) -> float:
    """0 where integer or boolean tensors are equal, inf where not."""
    return 0.0 if torch.equal(a.cpu(), b.cpu()) else math.inf


def tensor_gap(a, b) -> float:
    if a.dtype.is_floating_point or a.is_complex():
        return rel_gap(a, b)
    return exact_gap(a, b)


def rl_config(cfg: dict, traffic: dict, env: dict) -> ref.VracerConfig:
    """The learner's configuration as the configuration and traffic files
    state it."""
    kw = dict(cfg["learner"])
    kw.update(traffic.get("learner", {}))
    kw["sigma_max"] = float(kw["sigma_max"])
    return ref.VracerConfig(
        obs_dim=env["obs_dim"], act_dim=env["num_actions"] // env["num_agents"],
        num_agents=env["num_agents"], episode_length=env["episode_length"],
        action_low=env["action_low"], action_high=env["action_high"], **kw)


def perturb(params, seed: int, scale: float, device):
    """The test traffic's weights: ``scale`` standard normals drawn on the
    device from ``seed + 1`` added to every parameter (the same draws as
    runners/test.py makes for the program)."""
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    with torch.no_grad():
        for p in params:
            p.add_(scale * torch.randn(p.shape, generator=gen, device=device, dtype=p.dtype))


def env_reference(cfg: dict, seed: int, device):
    module = importlib.import_module(f"reference.envs.{cfg['env_reference']}")
    return module.Env(cfg["env"], seed, device, cfg["env"]["n_pool"])


@dataclasses.dataclass
class Snapshot:
    """What the reference takes from one generation of the program."""

    init_params: list = None          # the initial weights
    collect_params: list = None       # network before the collection
    obs_stats: tuple = None           # (mean, m2, count) before the collection
    episode_base: int = 0
    traj: dict = None                 # the program's trajectories
    insert_stats: tuple = None        # ((obs), (rew)) before the insert
    insert_n_updates: int = 0
    replay_before: object = None      # replay before the insert
    stats_after: tuple = None         # ((obs), (rew)) after the insert
    replay_after: object = None       # replay after the insert
    update_params: list = None        # parameters before the updates
    update_opt: list = None           # Adam's state before the updates
    update_beta: float = 0.0
    update_n: int = 0
    update_generator: torch.Tensor = None
    update_k: int = 0                 # updates in the first replay
    params_after: list = None         # parameters after the first replay
    loss_after: float = math.nan


def stats_tuple(rs):
    return tuple(t.detach().clone() for t in (rs.mean, rs.m2, rs.count))


def replay_clone(rep):
    """A detached copy of a program replay: its tensors and host counters."""
    out = {f.name: getattr(rep, f.name) for f in dataclasses.fields(rep)}
    return {k: (v.detach().clone() if torch.is_tensor(v) else v) for k, v in out.items()}


def _ref_replay(kind, fields):
    cls = ref_flat.FlatReplay if kind == "experience" else ref_replay.Replay
    return cls(**{k: (v.clone() if torch.is_tensor(v) else v) for k, v in fields.items()})


def _ref_ts(cfg, params, stats, n_updates, device, opt_state=None, beta=None):
    net = ref.make_net(cfg, device=device)
    with torch.no_grad():
        for p, v in zip(net.parameters(), params):
            p.copy_(v)
    ts = ref.TrainState(
        net=net, opt=ref.make_optimizer(cfg, net),
        beta=torch.tensor(cfg.refer_beta if beta is None else beta, device=device),
        n_updates=int(n_updates),
        obs_stats=ref_stats.RunningStats(*[t.clone() for t in stats[0]]),
        rew_stats=ref_stats.RunningStats(*[t.clone() for t in stats[1]]))
    if opt_state is not None:
        for p, st in zip(net.parameters(), opt_state):
            ts.opt.state[p] = {k: v.clone() for k, v in st.items()}
    return ts


def _policy_gaps(cfg, snap, device, block=64):
    """(mu_gap, sigma_gap) over every live step of every episode."""
    n_ep = snap.traj["obs"].shape[0]
    unit = ref_stats.init((), device=device)
    ts = _ref_ts(cfg, snap.collect_params, (snap.obs_stats, stats_tuple(unit)), 0, device)
    worst = {"mu": [0.0, 0.0], "sigma": [0.0, 0.0]}
    for lo in range(0, n_ep, block):
        sl = slice(lo, lo + block)
        _, mu, sigma = ref.policy_apply(cfg, ts, snap.traj["obs"][sl])
        live = snap.traj["mask"][sl] > 0
        for name, r in (("mu", mu), ("sigma", sigma)):
            p = snap.traj[name][sl][live].double()
            r = r[live].double()
            ok = torch.isfinite(p) & torch.isfinite(r)
            if bool((~ok).any()):
                worst[name][0] = math.inf
                continue
            if p.numel():
                worst[name][0] = max(worst[name][0], (p - r).abs().max().item())
                worst[name][1] = max(worst[name][1], r.abs().max().item())
    return tuple(d / s if s > 0 else d for d, s in (worst["mu"], worst["sigma"]))


def _env_gaps(cfg_file, snap, seed, episodes, steps, device):
    """(obs_gap, reward_gap) over ``steps`` macro-steps of ``episodes``,
    the reference env driven by the program's actions."""
    env = env_reference(cfg_file, seed, device)
    idx = torch.as_tensor(episodes, device=snap.traj["obs"].device)
    tr = {k: snap.traj[k][idx] for k in ("obs", "actions", "rewards", "mask")}
    st, obs = env.reset(snap.episode_base + idx.to(device))
    obs_d = [rel_gap(tr["obs"][:, 0], obs)]
    num, den = 0.0, 0.0
    T = tr["obs"].shape[1]
    for t in range(min(steps, T)):
        st, obs, rew, _ = env.step(st, tr["actions"][:, t])
        live = tr["mask"][:, t] > 0
        p, r = tr["rewards"][:, t][live].double(), rew[live].double()
        if bool((torch.isfinite(p) != torch.isfinite(r)).any()):
            return obs_d[0], math.inf
        fin = torch.isfinite(r)
        if bool(fin.any()):
            num = max(num, (p[fin] - r[fin]).abs().max().item())
            den = max(den, r[fin].abs().max().item())
        if t + 1 < T:
            nxt = tr["mask"][:, t + 1] > 0
            if bool(nxt.any()):
                obs_d.append(rel_gap(tr["obs"][:, t + 1][nxt], obs[nxt]))
    return max(obs_d), (num / den if den > 0 else num)


def _insert(cfg, snap, device):
    """The reference's insert from the program's state before it: (train
    state, replay) after."""
    ts = _ref_ts(cfg, snap.collect_params, snap.insert_stats, snap.insert_n_updates, device)
    rep = _ref_replay(cfg.minibatch_mode, snap.replay_before)
    traj = {k: v for k, v in snap.traj.items()}
    if cfg.minibatch_mode == "experience":
        ts = ref.observe_episodes(cfg, ts, traj)
        rep = ref.flat_insert(cfg, ts, rep, traj)
    else:
        rep = ref_replay.add_episodes(rep, traj)
        ts = ref.observe_episodes(cfg, ts, traj)
    return ts, rep


def _insert_gaps(ts, rep, snap):
    stats = (stats_tuple(ts.obs_stats), stats_tuple(ts.rew_stats))
    norm = max(rel_gap(p, r) for ps, rs in zip(snap.stats_after, stats)
               for p, r in zip(ps, rs))
    ins = 0.0
    for name, p in snap.replay_after.items():
        r = getattr(rep, name)
        if torch.is_tensor(p):
            ins = max(ins, tensor_gap(p, r))
        elif p != r:
            ins = math.inf
    return norm, ins


def _follow(cfg, snap, ts_ins, rep, device):
    """``update_k`` reference updates from the program's parameters, Adam
    state, beta, counter and generator, on the reference's replay and
    normalizers after its own insert; returns (train state, the last
    update's loss, each leaf's first gradient norm)."""
    ts = _ref_ts(cfg, snap.update_params,
                 (stats_tuple(ts_ins.obs_stats), stats_tuple(ts_ins.rew_stats)),
                 snap.update_n, device, opt_state=snap.update_opt, beta=snap.update_beta)
    gen = torch.Generator(device=device)
    gen.set_state(snap.update_generator)
    first_grad = None
    for i in range(snap.update_k):
        if cfg.minibatch_mode == "experience":
            metrics = ref.update_experience(cfg, ts, rep, gen)[2]
        else:
            batch = ref_replay.sample_episodes(rep, gen, cfg.mini_batch_episodes)
            metrics = ref.update(cfg, ts, batch)[1]
        if i == 0:
            first_grad = [p.grad.norm().item() for p in ts.net.parameters()]
    return ts, float(metrics["loss"]), first_grad


def _updates(cfg, snap, ts_ins, rep, device):
    """(loss_gap, dparam_gap) of the first graph replay's updates."""
    ts, loss, first_grad = _follow(cfg, snap, ts_ins, rep, device)
    loss_gap = abs(snap.loss_after - loss) / abs(loss) if loss else abs(snap.loss_after)
    ref_d = [(p.detach() - p0).norm().item()
             for p, p0 in zip(ts.net.parameters(), snap.update_params)]
    prog_d = [(p - p0).norm().item() for p, p0 in zip(snap.params_after, snap.update_params)]
    med_g, med_d = float(np.median(first_grad)), float(np.median(ref_d))
    gaps = [abs(pd - rd) / max(rd, med_d) for pd, rd, g in zip(prog_d, ref_d, first_grad)
            if g >= 1e-3 * med_g]
    return loss_gap, max(gaps) if gaps else math.inf


def numbers(cfg_file: dict, traffic: dict, snap: Snapshot, seed: int, device,
            tf32: bool = False) -> dict:
    """The cell's numbers: the program's snapshot held against the reference
    (``tf32`` False) or, as the control, the reference in TF32 held against
    the same reference in float32 (see ``control_numbers``)."""
    env = cfg_file["env"]
    cfg = rl_config(cfg_file, traffic, env)
    out = {}
    with precision(tf32):
        ref_init = ref.init_train(cfg, torch.Generator(device=device).manual_seed(seed),
                                  device=device)
        if traffic.get("weights_noise"):
            perturb(ref_init.net.parameters(), seed, traffic["weights_noise"], device)
        out["init_gap"] = max(rel_gap(p, r) for p, r in
                              zip(snap.init_params, ref_init.net.parameters()))
        del ref_init
        out["mu_gap"], out["sigma_gap"] = _policy_gaps(cfg, snap, device)
        n_ep = snap.traj["obs"].shape[0]
        k = min(traffic.get("check_episodes", n_ep), n_ep)
        episodes = np.sort(np.random.default_rng(seed).choice(n_ep, k, replace=False))
        out["obs_gap"], out["reward_gap"] = _env_gaps(
            cfg_file, snap, seed, episodes.tolist(), ENV_STEPS, device)
        if snap.replay_before is not None:
            ts_ins, rep = _insert(cfg, snap, device)
            out["norm_gap"], out["insert_gap"] = _insert_gaps(ts_ins, rep, snap)
            out["loss_gap"], out["dparam_gap"] = _updates(cfg, snap, ts_ins, rep, device)
    return out


def control_snapshot(cfg_file: dict, traffic: dict, snap: Snapshot, seed: int, device):
    """The control put in the program's place: the snapshot's outputs
    recomputed by the reference in TF32 from the same inputs (the
    teacher-forced observations and rewards, the policy's mean and sigma on
    them, the insert and the first replay's updates)."""
    env_cfg = cfg_file["env"]
    cfg = rl_config(cfg_file, traffic, env_cfg)
    c = dataclasses.replace(snap, traj=dict(snap.traj))
    with precision(True):
        env = env_reference(cfg_file, seed, device)
        idx = torch.arange(snap.traj["obs"].shape[0], device=device)
        st, obs = env.reset(snap.episode_base + idx)
        obs_l, rew_l = [obs], []
        T = snap.traj["obs"].shape[1]
        for t in range(T):
            st, obs, rew, _ = env.step(st, snap.traj["actions"][:, t])
            rew_l.append(rew)
            obs_l.append(obs)
        c.traj["obs"] = torch.stack(obs_l[:T], 1)
        c.traj["rewards"] = torch.stack(rew_l, 1)
        unit = ref_stats.init((), device=device)
        ts = _ref_ts(cfg, snap.collect_params, (snap.obs_stats, stats_tuple(unit)), 0, device)
        mus, sigmas = [], []
        for lo in range(0, c.traj["obs"].shape[0], 64):
            _, mu, sigma = ref.policy_apply(cfg, ts, c.traj["obs"][lo:lo + 64])
            mus.append(mu)
            sigmas.append(sigma)
        c.traj["mu"], c.traj["sigma"] = torch.cat(mus), torch.cat(sigmas)
        if snap.replay_before is not None:
            ts_ins, rep = _insert(cfg, c, device)
            c.stats_after = (stats_tuple(ts_ins.obs_stats), stats_tuple(ts_ins.rew_stats))
            c.replay_after = replay_clone(rep)
            ts_u, c.loss_after, _ = _follow(cfg, snap, ts_ins, rep, device)
            c.params_after = [p.detach().clone() for p in ts_u.net.parameters()]
    return c

