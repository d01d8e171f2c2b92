"""Fault F2, one update at a time: find the first update of a whole run whose
train state turns non-finite, dump it, and hold it against the JAX package.

Three halves, each importing one package only (``jax`` imports both):

    # the port on the card: run 926 at seed 7 (scripts/torch_acceptance.sh's
    # flags, the replay serialized), a copy of each generation's checkpoint
    # from --keep-from on (in _result_f2_<run>_s<seed>); then from the last finite checkpoint the next
    # generation again under graphs.eager(), every parameter, Adam moment and
    # beta checked after each update; the first non-finite update and the one
    # before it go to <out>/f2_dump.npz (the state before each, its minibatch
    # ids, the replay before the first of the two and the rows the second
    # changed, and the card's intermediates of both)
    python3 scripts/torch_f2.py record --out f2_out [--run 926 --seed 7]
    # the port from the dump, on the CPU or the card, in either dtype
    python3 scripts/torch_f2.py torch --dump f2_out/f2_dump.npz \
        [--dtype float64] [--device cuda]
    # the JAX package from the dump, on the CPU, in either dtype
    env JAX_PLATFORMS=cpu python3 scripts/torch_f2.py jax --dump f2_out/f2_dump.npz \
        [--dtype float64]

``torch`` and ``jax`` print one JSON line per update (k-1, then k): the loss terms,
the global gradient norm before the clip, which parameters, Adam moments and
beta are finite after the update, and the first non-finite gradient of each
loss term with respect to the module's outputs V, mu and sigma.  ``torch``
also names the first backward op that returned a non-finite value (autograd's
anomaly mode).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import shutil
import sys

import numpy as np

FLAGS = {
    926: ("ks --N 16 --NA 16 --ndns 16 --sigma-max 5 --iex 0.01 --NE 1000000 --numenvs 16 "
          "--maxupd 1000 --fused --testfreq 10 --testepisodes 16"),
    918: ("burger-marl --nagents 32 --specreward --dforce --ic turbulence --width 128 "
          "--iex 0.1 --rscale cumulative --trust forward --NE 1000000 --numenvs 10 "
          "--mbsize 8 --maxupd 2500 --testfreq 10 --testepisodes 8 --diag"),
}
SEP = "::"
# a dump keeps the whole replay up to this size, else ``_compact``'s rows
FULL_REPLAY_BYTES = 40e6


# ----------------------------------------------------------------- the port

def _state_tensors(ts, prefix):
    """A train state as a flat dict of detached tensors under ``prefix``."""
    out = {f"{prefix}{SEP}beta": ts.beta, f"{prefix}{SEP}n_updates": ts.n_updates}
    for name, p in ts.net.named_parameters():
        out[f"{prefix}{SEP}net{SEP}{name}"] = p
        for k, v in ts.opt.state.get(p, {}).items():
            out[f"{prefix}{SEP}adam{SEP}{name}{SEP}{k}"] = v
    for s in ("obs_stats", "rew_stats"):
        for f, v in dataclasses.asdict(getattr(ts, s)).items():
            out[f"{prefix}{SEP}{s}{SEP}{f}"] = v
    return {k: v.detach() for k, v in out.items()}


def _state_arrays(ts, prefix):
    return {k: v.cpu().numpy() for k, v in _state_tensors(ts, prefix).items()}


def _clone_state(cfg, ts):
    return _load_state(cfg, _state_tensors(ts, "s"), "s", ts.beta.dtype, ts.beta.device)


def _clone_replay(rep):
    return dataclasses.replace(rep, **{f.name: getattr(rep, f.name).clone()
                                       for f in dataclasses.fields(rep)
                                       if f.name not in ("cursor", "n_episodes")})


def _load_state(cfg, d, prefix, dtype, device):
    """The train state stored under ``prefix`` in ``d`` (numpy arrays or
    tensors), copied to ``device`` in ``dtype``."""
    import torch

    from marlpde_tpu_torch.rl import running_stats, vracer
    tt = lambda a: (a.clone() if torch.is_tensor(a) else torch.from_numpy(np.array(a))).to(
        device=device, dtype=dtype)
    ts = vracer.init_train(cfg, torch.Generator(device=device).manual_seed(0), dtype=dtype,
                           device=device)
    ts.net.load_state_dict({name: tt(d[f"{prefix}{SEP}net{SEP}{name}"])
                            for name, _ in ts.net.named_parameters()})
    cap = ts.opt.param_groups[0]["capturable"]
    for name, p in ts.net.named_parameters():
        key = f"{prefix}{SEP}adam{SEP}{name}{SEP}"
        if key + "step" in d:
            step = torch.tensor(float(d[key + "step"]), dtype=torch.float32,
                                device=device if cap else "cpu")
            ts.opt.state[p] = dict(step=step, exp_avg=tt(d[key + "exp_avg"]),
                                   exp_avg_sq=tt(d[key + "exp_avg_sq"]))
    stats = {s: running_stats.RunningStats(**{f: tt(d[f"{prefix}{SEP}{s}{SEP}{f}"])
                                              for f in ("mean", "m2", "count")})
             for s in ("obs_stats", "rew_stats")}
    return dataclasses.replace(ts, beta=tt(d[f"{prefix}{SEP}beta"]),
                               n_updates=int(d[f"{prefix}{SEP}n_updates"]), **stats)


def _replay_arrays(rep, prefix="rep"):
    out = {f"{prefix}{SEP}{f.name}": getattr(rep, f.name) for f in dataclasses.fields(rep)}
    return {k: (v.detach().cpu().numpy() if hasattr(v, "detach") else np.asarray(v))
            for k, v in out.items()}


def _load_replay(d, dtype, device, prefix="rep"):
    import torch

    from marlpde_tpu_torch.rl import replay_flat
    kw = {}
    for f in dataclasses.fields(replay_flat.FlatReplay):
        a = d[f"{prefix}{SEP}{f.name}"]
        if f.name in ("cursor", "n_episodes"):
            kw[f.name] = int(a)
        else:
            t = torch.from_numpy(np.array(a)).to(device)
            kw[f.name] = t.to(dtype) if t.is_floating_point() else t
    return replay_flat.FlatReplay(**kw)


def _finite_report(ts):
    """{tensor name: False} for every non-finite parameter, Adam moment and beta."""
    import torch
    bad = {}
    for name, p in ts.net.named_parameters():
        for k, v in [("param", p)] + list(ts.opt.state.get(p, {}).items()):
            if not bool(torch.isfinite(v).all()):
                bad[f"{name}.{k}"] = False
    if not bool(torch.isfinite(ts.beta).all()):
        bad["beta"] = False
    return bad


def _plain(x):
    """numpy scalars as the Python numbers json writes."""
    return x.item()


def _first_bad(name, t):
    """(name, flat index, value) of the first non-finite entry of ``t``, or None."""
    import torch
    if t is None:
        return None
    bad = (~torch.isfinite(t)).reshape(-1).nonzero()
    if len(bad) == 0:
        return None
    i = int(bad[0])
    return dict(tensor=name, index=[int(j) for j in np.unravel_index(i, tuple(t.shape))],
                value=float(t.reshape(-1)[i]), count=int(len(bad)))


def trace_update(cfg, ts, frep, ids):
    """The intermediates of ``update_experience`` on copies of ``ts`` and
    ``frep`` with the minibatch ``ids``; then the update itself on other
    copies.  Returns (numpy intermediates, summary dict)."""
    import torch

    from marlpde_tpu_torch.rl import vracer_loss
    from marlpde_tpu_torch.rl import distributions as D
    from marlpde_tpu_torch.rl import replay_flat, vracer
    ts3, rep3 = _clone_state(cfg, ts), _clone_replay(frep)
    ts, frep = _clone_state(cfg, ts), _clone_replay(frep)
    g = torch.as_tensor(np.asarray(ids), device=frep.obs.device)
    den, cutoff, inv_cutoff = vracer._annealed(cfg, ts.n_updates)
    rows = replay_flat.gather(frep, g)
    scale = vracer._insert_scale(cfg, ts, frep)
    x = vracer._prep_obs(cfg, ts, rows["obs"])
    V, mu, sigma = ts.net(x)
    rho_new, _ = vracer_loss.joint_rho(cfg, rows["actions"], mu.detach(), sigma.detach(),
                                   rows["mu"], rows["sigma"])
    off_new = ~((rho_new > inv_cutoff) & (rho_new < cutoff))
    boot_new = (vracer._sanitized_final_V(cfg, ts, rows["fin_obs"])
                * rows["truncated"].to(V.dtype)[..., None])
    replay_flat.refresh_metadata(frep, g, V.detach(), rho_new, off_new, boot_new)
    _, vtg_next = replay_flat.refresh_retrace(
        frep, g, cfg.episode_length, cfg.gamma, scale, cfg.reward_floor,
        scaled_floor=cfg.scaled_reward_floor)
    lb, ub = cfg.action_low, cfg.action_high
    logp = D.joint_log_prob(rows["actions"], mu, sigma, lb, ub)
    logp_b = D.joint_log_prob(rows["actions"], rows["mu"], rows["sigma"], lb, ub)
    log_ratio = (logp - logp_b) * vracer_loss.rho_temper(cfg)
    rho = torch.exp(torch.clamp(log_ratio, -20.0, 20.0))
    loss, metrics = vracer_loss.loss_experience(cfg, ts.beta, (V, mu, sigma), rows, vtg_next,
                                                 scale, cutoff)
    inter = dict(V=V, mu=mu, sigma=sigma, z_lo=(lb - mu) / sigma, z_hi=(ub - mu) / sigma,
                 at_lb=rows["actions"] <= lb, at_ub=rows["actions"] >= ub, logp=logp,
                 logp_b=logp_b, log_ratio=log_ratio, rho=rho, off=off_new,
                 vtg_next=vtg_next,
                 rewards=vracer_loss.rescale_rewards(cfg, rows["rewards"], scale),
                 kl=vracer_loss.trust_kl(cfg, rows["mu"], rows["sigma"], mu, sigma))
    # each loss term's gradient with respect to the module's outputs
    terms = {}
    for k in ("v_loss", "pg_loss", "kl_loss"):
        term = _loss_term(cfg, ts, (V, mu, sigma), rows, vtg_next, scale, cutoff, k)
        grads = torch.autograd.grad(term, (V, mu, sigma), retain_graph=True, allow_unused=True)
        terms[k] = [b for b in (_first_bad(f"d{k}/d{n}", gr)
                                for n, gr in zip(("V", "mu", "sigma"), grads)) if b]
    loss.backward()
    grads = [p.grad for p in ts.net.parameters()]
    gnorm = torch.sqrt(sum(torch.sum(gr * gr) for gr in grads))
    # the first backward op that returns a non-finite value
    anomaly = None
    ts2 = _clone_state(cfg, ts)
    try:
        with torch.autograd.detect_anomaly(check_nan=True):
            out2 = ts2.net(x)
            loss2, _ = vracer_loss.loss_experience(cfg, ts2.beta, out2, rows, vtg_next, scale,
                                                    cutoff)
            loss2.backward()
    except RuntimeError as e:
        anomaly = str(e).splitlines()[0]
    # the update itself, from the same state and ids
    orig = replay_flat.sample_ids
    replay_flat.sample_ids = lambda rep, gen, n: g
    try:
        vracer.update_experience(cfg, ts3, rep3, None)
    finally:
        replay_flat.sample_ids = orig
    summary = dict(
        dtype=str(V.dtype).replace("torch.", ""), device=str(V.device),
        metrics={k: float(v) for k, v in metrics.items()}, grad_norm=float(gnorm),
        grads_finite=all(bool(torch.isfinite(gr).all()) for gr in grads),
        first_bad_grad=[b for b in (_first_bad(n, p.grad)
                                    for n, p in ts.net.named_parameters()) if b][:1],
        term_grads=terms, anomaly=anomaly,
        nonfinite_after=_finite_report(ts3),
        sigma_min=float(inter["sigma"].min()), z_max=float(torch.maximum(
            inter["z_lo"].abs(), inter["z_hi"].abs()).max()))
    return {k: v.detach().cpu().numpy() for k, v in inter.items()}, summary


def _loss_term(cfg, ts, out, rows, vtg_next, scale, cutoff, name):
    """The loss term ``name`` of ``vracer_loss.loss_experience``, still
    attached to ``out`` (the function returns its terms detached)."""
    import torch

    from marlpde_tpu_torch.rl import vracer_loss
    V, mu, sigma = out
    rewards = vracer_loss.rescale_rewards(cfg, rows["rewards"], scale)
    rho, logp = vracer_loss.joint_rho(cfg, rows["actions"], mu, sigma, rows["mu"], rows["sigma"])
    near = (rho > torch.reciprocal(cutoff)) & (rho < cutoff)
    n_tot = float(rho.numel())
    td = rewards + cfg.gamma * vtg_next - V.detach()
    if name == "v_loss":
        vtarget = V.detach() + torch.clamp(rho, max=1.0).detach() * td
        return 0.5 * torch.sum((V - vtarget) ** 2) / n_tot
    if name == "pg_loss":
        pg_w = (torch.minimum(rho, cutoff.to(rho.dtype)) * td * near).detach()
        return -torch.sum(pg_w * logp) / n_tot
    kl = vracer_loss.trust_kl(cfg, rows["mu"], rows["sigma"], mu, sigma)
    return torch.sum((~near).to(kl.dtype) * kl) / n_tot


class _Stop(Exception):
    pass


def record(args):
    import torch

    from marlpde_tpu_torch import run
    from marlpde_tpu_torch.rl import replay_flat, vracer
    from marlpde_tpu_torch.train import trainer
    from marlpde_tpu_torch.utils import checkpoint as ckpt
    from marlpde_tpu_torch.utils import graphs

    os.makedirs(args.out, exist_ok=True)
    argv = FLAGS[args.run].split() + ["--seed", str(args.seed), "--run", str(args.run)]
    env, cfg, tc = run.make_workload(run.build_parser().parse_args(argv), args.device)
    # the checkpoints stay beside the run's, out of <out>
    ckdir = f"_result_f2_{args.run}_s{args.seed}"
    live = os.path.join(ckdir, "live")
    tc = dataclasses.replace(tc, checkpoint_dir=live, checkpoint_every=1,
                             serialize_replay=True)
    log = open(os.path.join(args.out, f"f2_{args.run}_s{args.seed}.jsonl"), "w")

    def keep(gen, ts, rep, history):
        m = history["metrics"][-1]
        bad = _finite_report(ts)
        print(json.dumps(dict(gen=gen, ret=history["mean_return"][-1],
                              eplen=history["mean_ep_len"][-1], finite=not bad, **m)),
              file=log, flush=True)
        if gen >= args.keep_from:
            shutil.copytree(live, os.path.join(ckdir, f"gen{gen}"),
                            ignore=shutil.ignore_patterns("best"))
            old = os.path.join(ckdir, f"gen{gen - 3}")
            shutil.rmtree(old, ignore_errors=True)
        if bad:
            raise _Stop(gen)

    try:
        trainer.train(env, cfg, tc, callback=keep)
        print(f"[f2] run {args.run} seed {args.seed}: no non-finite state to the end")
        return 1
    except _Stop as e:
        gen = e.args[0]
    print(f"[f2] run {args.run} seed {args.seed}: train state non-finite after generation {gen}")
    src = os.path.join(ckdir, f"gen{gen - 1}")
    ts = ckpt.load_train_state(src, cfg, device=env.device)
    rep = ckpt.load_replay(src, trainer.make_replay(env, cfg))
    meta = ckpt.load_meta(src)
    counters = {k: meta[k] for k in ("gen", "total_exp", "episode_base", "real_in_replay")
                if k in meta}
    tc1 = dataclasses.replace(tc, checkpoint_dir=None, testing_frequency=0,
                              max_experiences=meta["total_exp"] + 1)

    orig_update, orig_sample = vracer.update_experience, replay_flat.sample_ids
    seen = dict(k=0, prev=None, ids=None)

    def sample(rep_, gen_, n):
        ids = orig_sample(rep_, gen_, n)
        seen["ids"] = ids.clone()
        return ids

    def checked(cfg_, ts_, rep_, generator, group=None, mini_batch=None):
        before = (_clone_state(cfg_, ts_), _clone_replay(rep_))
        out = orig_update(cfg_, ts_, rep_, generator, group=group, mini_batch=mini_batch)
        seen["k"] += 1
        cur = before + (seen["ids"].cpu().numpy(),)
        bad = _finite_report(ts_)
        if bad:
            vracer.update_experience, replay_flat.sample_ids = orig_update, orig_sample
            _dump(args, cfg_, gen, seen["k"], seen["prev"], cur, bad,
                  {k: float(v) for k, v in out[2].items()})
            raise _Stop(gen)
        seen["prev"] = cur
        return out

    vracer.update_experience, replay_flat.sample_ids = checked, sample
    try:
        with graphs.eager():
            trainer.train(env, cfg, tc1, init_ts=ts, init_history=ckpt.load_history(src),
                          init_replay=rep, init_generator_state=meta["generator"],
                          init_counters=counters, verbose=False)
        print(f"[f2] generation {gen} again under graphs.eager(): every update finite")
        return 1
    except _Stop:
        return 0
    finally:
        vracer.update_experience, replay_flat.sample_ids = orig_update, orig_sample


def _dump(args, cfg, gen, k, prev, cur, bad, metrics):
    """The two updates' states, ids, the replay before the first of them and
    the card's intermediates of both, into <out>/f2_dump.npz."""
    arrays, summaries = {}, {}
    (ts_p, rep_p, ids_p), (ts_c, rep_c, ids_c) = prev, cur
    for tag, ts, rep, ids in (("prev", ts_p, rep_p, ids_p), ("bad", ts_c, rep_c, ids_c)):
        arrays.update(_state_arrays(ts, tag))
        arrays[f"{tag}{SEP}ids"] = ids
        inter, summaries[tag] = trace_update(cfg, ts, rep, ids)
        arrays.update({f"{tag}{SEP}trace{SEP}{n}": v for n, v in inter.items()})
    arrays.update(_replay_arrays(rep_p))
    # the rows that update k-1 changed: enough to rebuild the replay before k
    after = _replay_arrays(rep_c, "after")
    for key, a in after.items():
        field = key.split(SEP)[1]
        b = arrays[f"rep{SEP}{field}"]
        if a.ndim == 0 or a.shape != b.shape:
            arrays[f"next{SEP}{field}"] = a
            continue
        diff = np.flatnonzero((a != b).reshape(len(a), -1).any(-1))
        arrays[f"next{SEP}{field}{SEP}rows"] = diff
        arrays[f"next{SEP}{field}{SEP}vals"] = a[diff]
    if sum(a.nbytes for k, a in arrays.items() if k.startswith(f"rep{SEP}")) > FULL_REPLAY_BYTES:
        _compact(arrays, rep_p, (ids_p, ids_c))
    meta = dict(run=args.run, seed=args.seed, generation=gen, update_in_generation=k,
                n_updates_before=int(ts_c.n_updates), flags=FLAGS[args.run],
                cfg=dataclasses.asdict(cfg), nonfinite_after=sorted(bad),
                metrics_after=metrics, card=summaries)
    arrays["meta"] = np.array(json.dumps(meta, default=_plain))
    np.savez_compressed(os.path.join(args.out, "f2_dump.npz"), **arrays)
    print(f"[f2] generation {gen}, update {k} of the generation (n_updates "
          f"{int(ts_c.n_updates)} before it) makes the state non-finite: {sorted(bad)[:6]}")
    for tag in ("prev", "bad"):
        print(f"[f2] card, update {'k-1' if tag == 'prev' else 'k'}: "
              + json.dumps(summaries[tag], default=_plain))


def _compact(arrays, rep, id_sets):
    """Keep of the experience ring only what the two updates read: the rows
    of every episode they sample (the gathers and the retrace refresh), and
    the whole of ``rewards`` and ``off`` (the reward scale and the
    replay-wide off-policy fraction).  Every other row is stored as 0."""
    E, lo = rep.capacity, rep.cursor - rep.live
    first, last = rep.ep_first.cpu().numpy(), rep.ep_last.cpu().numpy()
    rows = set()
    for ids in id_sets:
        s = np.asarray(ids) % E
        for f, l in zip(first[s], last[s]):
            rows.update(np.arange(max(int(f), lo), int(l) + 1) % E)
    rows = np.array(sorted(rows), dtype=np.int64)
    for f in dataclasses.fields(rep):
        key = f"rep{SEP}{f.name}"
        a = arrays[key]
        if f.name in ("rewards", "off") or a.ndim == 0 or len(a) != E:
            continue
        del arrays[key]
        arrays[f"{key}{SEP}shape"] = np.array(a.shape)
        arrays[f"{key}{SEP}rows"] = rows
        arrays[f"{key}{SEP}vals"] = a[rows]


def _dump_states(path):
    """(cfg dict, the dump's arrays, the replay before update k-1 and before k)."""
    d = dict(np.load(path, allow_pickle=False))
    meta = json.loads(str(d["meta"]))
    for key in [k for k in d if k.startswith(f"rep{SEP}") and k.endswith(f"{SEP}shape")]:
        base = key[:-len(f"{SEP}shape")]
        a = np.zeros(tuple(d[key]), d[f"{base}{SEP}vals"].dtype)
        a[d[f"{base}{SEP}rows"]] = d[f"{base}{SEP}vals"]
        d[base] = a
    nxt = {}
    for key in list(d):
        if key.startswith(f"rep{SEP}") and key.count(SEP) == 1:
            field = key.split(SEP)[1]
            a = d[key]
            if f"next{SEP}{field}{SEP}rows" in d:
                a = a.copy()
                a[d[f"next{SEP}{field}{SEP}rows"]] = d[f"next{SEP}{field}{SEP}vals"]
            else:
                a = d[f"next{SEP}{field}"]
            nxt[f"rep{SEP}{field}"] = a
    return meta, d, nxt


def torch_half(args):
    import torch

    from marlpde_tpu_torch.rl import vracer
    meta, d, nxt = _dump_states(args.dump)
    cfg = vracer.VracerConfig(**meta["cfg"])
    for tag, reps in (("prev", d), ("bad", nxt)):
        ts = _load_state(cfg, d, tag, getattr(torch, args.dtype), args.device)
        rep = _load_replay(reps, getattr(torch, args.dtype), args.device)
        _, summary = trace_update(cfg, ts, rep, d[f"{tag}{SEP}ids"])
        print(json.dumps(dict(package="torch", update=tag, **summary), default=_plain),
              flush=True)


# ------------------------------------------------------------------ JAX half

def jax_half(args):
    import jax
    if args.dtype == "float64":
        jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    import torch

    import marlpde_tpu.rl.replay_flat as jflat
    from marlpde_tpu.rl import vracer as jv
    from marlpde_tpu_torch.rl import vracer as tv
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "tests"))
    from test_torch_interop import flat_to_jax, train_state_to_jax

    meta, d, nxt = _dump_states(args.dump)
    tcfg = tv.VracerConfig(**meta["cfg"])
    cfg = jv.VracerConfig(**meta["cfg"])
    dtype, jdt = getattr(torch, args.dtype), getattr(jnp, args.dtype)
    for tag, reps in (("prev", d), ("bad", nxt)):
        jts0 = jv.init_train(cfg, jax.random.key(0), dtype=jdt)
        if jdt == jnp.float64:
            params = jax.tree.map(lambda a: a.astype(jnp.float64), jts0.params)
            jts0 = jts0.replace(params=params, opt_state=jv.make_optimizer(cfg).init(params))
        jts = train_state_to_jax(tcfg, _load_state(tcfg, d, tag, dtype, "cpu"), jts0)
        jrep = flat_to_jax(_load_replay(reps, dtype, "cpu"))
        ids = jnp.asarray(d[f"{tag}{SEP}ids"].astype(np.int32))
        summary = _jax_trace(cfg, jts, jrep, ids)
        orig = jflat.sample_ids
        jflat.sample_ids = lambda rep, key, n: ids
        try:
            jts1, _, m = jv.update_experience(cfg, jts, jrep, jax.random.key(0))
        finally:
            jflat.sample_ids = orig
        leaves = jax.tree_util.tree_leaves_with_path((jts1.params, jts1.opt_state))
        bad = [jax.tree_util.keystr(p) for p, a in leaves
               if jnp.issubdtype(jnp.asarray(a).dtype, jnp.floating)
               and not bool(jnp.isfinite(a).all())]
        if not bool(jnp.isfinite(jts1.beta)):
            bad.append("beta")
        summary.update(metrics={k: float(v) for k, v in m.items()}, nonfinite_after=bad)
        print(json.dumps(dict(package="jax", update=tag, **summary)), flush=True)


def _jax_trace(cfg, jts, jrep, g):
    """The JAX update's gradient norm, loss terms and each term's gradient
    with respect to V, mu and sigma, from ``jts``/``jrep`` with the ids ``g``."""
    import jax
    import jax.numpy as jnp

    import marlpde_tpu.rl.replay_flat as jflat
    from marlpde_tpu.rl import running_stats as jrs
    from marlpde_tpu.rl import vracer as jv
    n_upd = jts.n_updates.astype(jnp.float32)
    cutoff = cfg.cutoff_scale / (1.0 + cfg.annealing_rate * n_upd)
    rows = jflat.gather(jrep, g)
    if not cfg.reward_rescaling:
        scale = jnp.asarray(1.0, jnp.float32)
    elif cfg.reward_scale_source == "cumulative":
        scale = jrs.second_moment(jts.rew_stats)
    else:
        scale = jflat.scale_from_sums(*jflat.reward_scale_sums(jrep, cfg.reward_floor))
    V, mu, sigma = jv.make_net(cfg).apply(jts.params, jv._prep_obs(cfg, jts, rows["obs"]))
    rho, _ = jv._joint_rho(cfg, rows["actions"], mu, sigma, rows["mu"], rows["sigma"])
    off = ~((rho > 1.0 / cutoff) & (rho < cutoff))
    boot = (jv._sanitized_final_V(cfg, jts.params, jts, rows["fin_obs"])
            * rows["truncated"].astype(V.dtype)[..., None])
    jr = jflat.refresh_metadata(jrep, g, V, rho, off, boot)
    jr, vtg_next = jflat.refresh_retrace(jr, g, cfg.episode_length, cfg.gamma, scale,
                                         cfg.reward_floor, scaled_floor=cfg.scaled_reward_floor)
    grads, metrics = jax.grad(lambda p: jv._loss_experience(cfg, p, jts, rows, vtg_next, scale,
                                                            cutoff), has_aux=True)(jts.params)
    gnorm = jnp.sqrt(sum(jnp.sum(a * a) for a in jax.tree.leaves(grads)))

    def terms(V_, mu_, sigma_):
        rewards = jv._rescale_rewards(cfg, rows["rewards"], scale)
        rho_, logp = jv._joint_rho(cfg, rows["actions"], mu_, sigma_, rows["mu"], rows["sigma"])
        near = (rho_ > 1.0 / cutoff) & (rho_ < cutoff)
        n_tot = rho_.size
        td = rewards + cfg.gamma * vtg_next - jax.lax.stop_gradient(V_)
        vtarget = jax.lax.stop_gradient(V_ + jnp.minimum(rho_, 1.0) * td)
        pg_w = jax.lax.stop_gradient(jnp.minimum(rho_, cutoff) * td * near)
        kl = jv._trust_kl(cfg, rows["mu"], rows["sigma"], mu_, sigma_)
        return dict(v_loss=0.5 * jnp.sum((V_ - vtarget) ** 2) / n_tot,
                    pg_loss=-jnp.sum(pg_w * logp) / n_tot,
                    kl_loss=jnp.sum((~near) * kl) / n_tot)

    term_bad = {}
    for k in ("v_loss", "pg_loss", "kl_loss"):
        gs = jax.grad(lambda a, b, c: terms(a, b, c)[k], argnums=(0, 1, 2))(V, mu, sigma)
        term_bad[k] = [dict(tensor=f"d{k}/d{n}", count=int((~jnp.isfinite(x)).sum()))
                       for n, x in zip(("V", "mu", "sigma"), gs) if not bool(jnp.isfinite(x).all())]
    lb, ub = cfg.action_low, cfg.action_high
    return dict(dtype=str(V.dtype), device="cpu", grad_norm=float(gnorm),
                grads_finite=all(bool(jnp.isfinite(a).all()) for a in jax.tree.leaves(grads)),
                loss_terms={k: float(metrics[k]) for k in ("loss", "v_loss", "pg_loss", "kl_loss")},
                term_grads=term_bad, sigma_min=float(sigma.min()),
                z_max=float((jnp.maximum(jnp.abs(lb - mu), jnp.abs(ub - mu)) / sigma).max()))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = p.add_subparsers(dest="half", required=True)
    r = sub.add_parser("record")
    r.add_argument("--out", required=True)
    r.add_argument("--run", type=int, default=926, choices=sorted(FLAGS))
    r.add_argument("--seed", type=int, default=7)
    r.add_argument("--keep-from", type=int, default=95)
    r.add_argument("--device", default=None)
    for name in ("torch", "jax"):
        s = sub.add_parser(name)
        s.add_argument("--dump", required=True)
        s.add_argument("--dtype", default="float32", choices=("float32", "float64"))
        if name == "torch":
            s.add_argument("--device", default="cpu")
    args = p.parse_args(argv)
    return dict(record=record, torch=torch_half, jax=jax_half)[args.half](args)


if __name__ == "__main__":
    sys.exit(main())
