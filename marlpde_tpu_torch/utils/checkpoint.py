"""Checkpoint/resume: the korali e.loadState / File Output equivalent
(port of marlpde_tpu/utils/checkpoint.py:43-182, on torch.save/torch.load).

A complete checkpoint restores training exactly where it stopped.  Pieces:

  * train state  — module and Adam state_dicts, REFER beta, the update
                   counter and both normalizers (latest.pt, or latest_dcp/)
  * history      — per-generation curves (history.json, the JAX schema)
  * meta         — the trainer's torch.Generator state and the gen /
                   experiences / episode / live-experience counters, plus the
                   mu_param / cutoff_dim_norm fingerprint (meta.npz); with
                   these a killed-and-resumed run continues bitwise
  * replay       — either replay layout (replay.pt), opt-in like korali's
                   "Experience Replay Serialize" because it is large

Backends, per call or by MARLPDE_CKPT_BACKEND as in the JAX package
(checkpoint.py:35-86): "pickle" (the default) writes ``latest.pt`` with
torch.save, so a JAX ``latest.pkl`` is never taken for it; "orbax" selects
the multi-process backend, torch.distributed.checkpoint in ``latest_dcp/``.
Under a process group every rank takes part in its save and its restore (as
in orbax), tensors that every rank holds alike are written once, and rank 0
alone touches the directory around them; without one it runs in the one
process.  Its restore loads into a template built from ``rl_cfg``, as orbax
restores into one, so the Adam moments are written even before the first
step (as zeros, which Adam's first step treats as a fresh state).  Every rank
holds the whole train state, so "orbax" stores what rank 0's ``latest.pt``
stores; it is there so that a run that sets MARLPDE_CKPT_BACKEND=orbax runs
on both packages, and it is the layout a sharded train state would need.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from marlpde_tpu_torch.rl import running_stats, vracer

_DCP_DIR = "latest_dcp"


def resolve_backend(backend: Optional[str] = None) -> str:
    """``backend``, else MARLPDE_CKPT_BACKEND, else "pickle"."""
    backend = backend or os.environ.get("MARLPDE_CKPT_BACKEND", "pickle")
    if backend not in ("pickle", "orbax"):
        raise ValueError(f"[checkpoint] unknown backend {backend!r}")
    return backend


def _primary() -> bool:
    return not dist.is_initialized() or dist.get_rank() == 0


def _save(obj, fname: str):
    """torch.save through a temporary file, so a killed run never leaves a
    half-written checkpoint."""
    tmp = f"{fname}.{os.getpid()}.tmp"
    torch.save(obj, tmp)
    os.replace(tmp, fname)


def dcp_state(ts: vracer.TrainState) -> dict:
    """The train state as the flat dict of tensors the "orbax" backend saves
    and restores in place: the module's, every parameter's Adam step and
    moments (zeros before the first step), beta, the update counter and both
    normalizers."""
    d = {f"net.{k}": v for k, v in ts.net.state_dict().items()}
    for i, p in enumerate(ts.net.parameters()):
        st = ts.opt.state.get(p) or {}
        d[f"adam.{i}.step"] = st.get("step", torch.zeros((), dtype=torch.float32))
        for k in ("exp_avg", "exp_avg_sq"):
            d[f"adam.{i}.{k}"] = st.get(k, torch.zeros_like(p))
    d["beta"] = ts.beta
    d["n_updates"] = torch.tensor(int(ts.n_updates), dtype=torch.int64)
    for name in ("obs_stats", "rew_stats"):
        for f, v in dataclasses.asdict(getattr(ts, name)).items():
            d[f"{name}.{f}"] = v
    return d


def save_train_state(path: str, ts: vracer.TrainState, history: Optional[dict] = None,
                     backend: Optional[str] = None):
    """The train state (and ``history``) under ``path``.  With the "orbax"
    backend every rank of a process group calls this; rank 0 writes the
    history."""
    os.makedirs(path, exist_ok=True)
    if resolve_backend(backend) == "orbax":
        import torch.distributed.checkpoint as dcp
        d = os.path.join(path, _DCP_DIR)
        tmp = d + ".tmp"
        # the save's first collective orders rank 0's removal before any write
        if _primary():
            shutil.rmtree(tmp, ignore_errors=True)
        dcp.save(dcp_state(ts), checkpoint_id=tmp, no_dist=not dist.is_initialized())
        if _primary():
            shutil.rmtree(d, ignore_errors=True)
            os.replace(tmp, d)
    else:
        _save(dict(net=ts.net.state_dict(), opt=ts.opt.state_dict(), beta=ts.beta,
                   n_updates=int(ts.n_updates),
                   obs_stats=dataclasses.asdict(ts.obs_stats),
                   rew_stats=dataclasses.asdict(ts.rew_stats)),
              os.path.join(path, "latest.pt"))
    if history is not None and _primary():
        with open(os.path.join(path, "history.json"), "w") as f:
            json.dump(history, f)


def load_train_state(path: str, rl_cfg, device=None,
                     backend: Optional[str] = None) -> Optional[vracer.TrainState]:
    """The restored TrainState on ``device`` (the CPU by default), or None if
    absent.  The "orbax" backend restores into a template built from
    ``rl_cfg`` in the dtype of the saved beta; under a process group every
    rank calls it."""
    device = device or "cpu"
    odir = os.path.join(path, _DCP_DIR)
    if resolve_backend(backend) == "orbax" and os.path.isdir(odir):
        import torch.distributed.checkpoint as dcp
        meta = dcp.FileSystemReader(odir).read_metadata()
        dtype = meta.state_dict_metadata["beta"].properties.dtype
        ts = _template(rl_cfg, dtype, torch.device(device))
        d = dcp_state(ts)
        dcp.load(d, checkpoint_id=odir, no_dist=not dist.is_initialized())
        ts.net.load_state_dict({k[4:]: v for k, v in d.items() if k.startswith("net.")})
        load_optimizer(ts.opt, dict(
            state={i: {k: d[f"adam.{i}.{k}"] for k in ("step", "exp_avg", "exp_avg_sq")}
                   for i in range(len(list(ts.net.parameters())))},
            param_groups=ts.opt.state_dict()["param_groups"]))
        stats = {name: running_stats.RunningStats(
            **{f: d[f"{name}.{f}"] for f in ("mean", "m2", "count")})
            for name in ("obs_stats", "rew_stats")}
        return dataclasses.replace(ts, beta=d["beta"], n_updates=int(d["n_updates"]), **stats)
    fname = os.path.join(path, "latest.pt")
    if not os.path.exists(fname):
        return None
    d = torch.load(fname, map_location=device, weights_only=True)
    beta = d["beta"]
    ts = _template(rl_cfg, beta.dtype, beta.device)
    ts.net.load_state_dict(d["net"])
    load_optimizer(ts.opt, d["opt"])
    return dataclasses.replace(
        ts, beta=beta, n_updates=int(d["n_updates"]),
        obs_stats=running_stats.RunningStats(**d["obs_stats"]),
        rew_stats=running_stats.RunningStats(**d["rew_stats"]))


def load_optimizer(opt: torch.optim.Optimizer, state_dict: dict):
    """``opt.load_state_dict(state_dict)``, keeping ``opt``'s own
    ``capturable``: torch replaces the param groups with the saved ones, so a
    checkpoint written on the CPU (plain Adam) would leave the card's Adam
    uncapturable, and one written on the card would make the CPU's Adam
    refuse to step.  Each step count goes where that Adam keeps it: beside
    its parameter in float32 when capturable, on the CPU otherwise."""
    capturable = [g.get("capturable", False) for g in opt.param_groups]
    opt.load_state_dict(state_dict)
    for group, cap in zip(opt.param_groups, capturable):
        group["capturable"] = cap
        for p in group["params"]:
            st = opt.state.get(p, {})
            if "step" in st:
                st["step"] = (st["step"].to(dtype=torch.float32, device=p.device) if cap
                              else st["step"].to(device="cpu"))


def _template(rl_cfg, dtype, device) -> vracer.TrainState:
    # the initial draw is overwritten at once; a private generator keeps it
    # off the global stream
    return vracer.init_train(rl_cfg, torch.Generator(device=device).manual_seed(0),
                             dtype=dtype, device=device)


def load_history(path: str) -> Optional[dict]:
    fname = os.path.join(path, "history.json")
    if not os.path.exists(fname):
        return None
    with open(fname) as f:
        return json.load(f)


def save_meta(path: str, generator: torch.Generator, gen: int, total_exp: float,
              episode_base: int, real_in_replay: Optional[int] = None, rl_cfg=None):
    """The trainer's generator state and counters (what korali folds into its
    state file so a resumed run continues the same stream), the cumulative
    live-experience insert count that drives the korali update ledger, and the
    config fingerprint that ``check_fingerprint`` enforces (see the JAX
    module for why each is needed)."""
    os.makedirs(path, exist_ok=True)
    extra = {}
    if real_in_replay is not None:
        extra["real_in_replay"] = np.int64(real_in_replay)
    if rl_cfg is not None:
        extra["mu_param"] = np.str_(rl_cfg.mu_param)
        extra["cutoff_dim_norm"] = np.bool_(rl_cfg.cutoff_dim_norm)
    np.savez(os.path.join(path, "meta.npz"),
             generator=generator_state(generator),
             gen=np.int64(gen), total_exp=np.float64(total_exp),
             episode_base=np.int64(episode_base), **extra)


def generator_state(generator: torch.Generator) -> np.ndarray:
    """The generator's (seed, offset) bytes: ``get_state`` reads the state
    object that a CUDA graph registered with the generator advances at each
    replay, so it is right between replays.  Restore with
    ``generator.set_state``, which writes into that same object, so a graph
    that registered the generator follows it (``graphsafe_set_state`` would
    swap in another object, which the graph does not advance; and
    ``graphsafe_get_state`` hands back a view of the live state, not a
    snapshot)."""
    return generator.get_state().numpy()


def load_meta(path: str) -> Optional[dict]:
    fname = os.path.join(path, "meta.npz")
    if not os.path.exists(fname):
        return None
    with np.load(fname) as d:
        meta = dict(generator=torch.from_numpy(d["generator"].copy()), gen=int(d["gen"]),
                    total_exp=float(d["total_exp"]), episode_base=int(d["episode_base"]))
        if "real_in_replay" in d:
            meta["real_in_replay"] = int(d["real_in_replay"])
        if "mu_param" in d:
            meta["mu_param"] = str(d["mu_param"])
            meta["cutoff_dim_norm"] = bool(d["cutoff_dim_norm"])
    return meta


def check_fingerprint(path: str, rl_cfg, what: str = "resume"):
    """Refuse to marry a checkpoint to a mismatched learner config: the module
    is shape-identical across mu_param modes, so a mismatched resume would
    silently rescale the policy mean.  A checkpoint without the fingerprint
    only gets a warning."""
    meta = load_meta(path)
    if meta is None or "mu_param" not in meta:
        print(f"[checkpoint] WARNING: {path} has no config fingerprint; "
              f"cannot verify mu_param/cutoff_dim_norm match for {what} "
              f"(pre-round-5 checkpoint?)")
        return
    for field in ("mu_param", "cutoff_dim_norm"):
        saved, now = meta[field], getattr(rl_cfg, field)
        if saved != now:
            raise SystemExit(
                f"[checkpoint] {what}: saved {field}={saved!r} but the "
                f"current config has {field}={now!r}.  Loading across modes "
                f"silently rescales the policy mean; pass --muparam/--dimnorm "
                f"matching the original run (see docs/REFER_SCALE.md).")


def _replay_fields(rep):
    return [f.name for f in dataclasses.fields(rep)]


def save_replay(path: str, rep):
    """Either replay layout (episode-slot Replay, flat FlatReplay): the fields
    are introspected from the dataclass, host counters included."""
    os.makedirs(path, exist_ok=True)
    _save({k: getattr(rep, k) for k in _replay_fields(rep)}, os.path.join(path, "replay.pt"))


def load_replay(path: str, template):
    """The saved replay, on ``template``'s device, or None if absent."""
    fname = os.path.join(path, "replay.pt")
    if not os.path.exists(fname):
        return None
    data = torch.load(fname, map_location=template.obs.device, weights_only=True)
    return dataclasses.replace(template, **{k: data[k] for k in _replay_fields(template)})
