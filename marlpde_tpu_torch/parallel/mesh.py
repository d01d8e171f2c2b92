"""Data-parallel training over ranks: env shards and a data-parallel learner
(port of marlpde_tpu/parallel/mesh.py:34-295 on torch.distributed).

The JAX mesh puts one env shard on each device of one program (shard_map over
a 1-D 'env' axis).  The port runs one rank per process.  Each rank collects
its ``envs_per_device`` episodes into its own replay shard, never gathered:
korali's single buffer cut into W pieces.  The learner stays replicated
because every rank applies the same update: the normalizers are averaged leaf
by leaf after each collection, and the gradients are averaged before the
global-norm clip and Adam (``vracer`` with ``group=mesh``).

One generation on each rank, as the JAX ``local_generation``s run it:
  collect (the rank's episode base) -> normalizers, averaged -> insert into
  the rank's shard -> the updates, once the replay is warm.

Backend rule (``make_mesh``): NCCL when every rank owns its own card, gloo
when ranks share a card (NCCL refuses two ranks on one GPU) or run on the
CPU.  The training path's collectives are SUM all_reduces only
(``Mesh.psum``, ``Mesh.pmean``), which both backends serve, on CUDA tensors
too.  Barriers and host-side checks go through a gloo group on CPU tensors
(``Mesh.host_group``).

Random streams: JAX folds the device index into a split key.  The port keeps
one host CPU generator, seeded identically on every rank.  It draws the seed
of the initial weights, then W seeds each generation: rank r reseeds its one
device generator with the r-th, which draws the rank's resets, action noise
and minibatches.  A checkpoint's meta holds the host generator's state.

On the card the JAX package runs a generation as one program
(``jax.jit(shard_map(...))``, marlpde_tpu/parallel/mesh.py:215); the port
replays CUDA graphs (utils/graphs.py).  Every rank's collection replays its
macro-step graph.  On NCCL each rank's updates replay graphs of 50 captured
updates (``trainer.run_updates``), their all_reduces inside the graph
(``Mesh.captures``); gloo ranks run their updates eagerly.  The rank keeps
its device generator for the whole run, so the graphs that registered it
are captured once a run, not once a generation.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import socket
import sys
import time
from typing import Any, Optional

import torch
import torch.distributed as dist

from marlpde_tpu_torch.device import resolve_device
from marlpde_tpu_torch.envs.rollout import Env, collect_episodes
from marlpde_tpu_torch.kernels import build
from marlpde_tpu_torch.rl import replay as replay_mod
from marlpde_tpu_torch.rl import replay_flat, running_stats, vracer
from marlpde_tpu_torch.train import trainer
from marlpde_tpu_torch.utils import checkpoint as ckpt
from marlpde_tpu_torch.utils import graphs

# a rank that waits longer than this in a collective fails the run
TIMEOUT = datetime.timedelta(minutes=10)
_SEED_HIGH = 2**62

# the training path's all_reduces since the last reset (``Mesh.psum`` and
# ``pmean``); a replay adds those its capture saw
all_reduces = 0
graphs.count_per_replay(sys.modules[__name__], "all_reduces")


def free_port() -> int:
    """A free TCP port on localhost."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _launch(coordinator, num_processes, process_id):
    """(address, world size, rank): the explicit arguments, else torchrun's
    variables, else SLURM's, else a world of 1 on a free localhost port."""
    env = os.environ
    if coordinator is not None:
        return coordinator, int(num_processes), int(process_id)
    if "RANK" in env and "WORLD_SIZE" in env:
        return f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}", int(env["WORLD_SIZE"]), int(env["RANK"])
    if int(env.get("SLURM_NTASKS", 1)) > 1:
        if "MASTER_ADDR" not in env or "MASTER_PORT" not in env:
            raise RuntimeError("[mesh] a SLURM launch of several tasks needs MASTER_ADDR and "
                               "MASTER_PORT, or initialize_distributed(coordinator=...)")
        return (f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}", int(env["SLURM_NTASKS"]),
                int(env["SLURM_PROCID"]))
    return f"127.0.0.1:{free_port()}", 1, 0


def initialize_distributed(coordinator: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None) -> None:
    """Start the default process group (gloo, with a timeout, so that a dead
    rank fails the run) unless one exists.  ``coordinator`` ("host:port")
    with ``num_processes`` and ``process_id`` launch by hand; without them the
    launch is read from torchrun's variables (RANK, WORLD_SIZE, MASTER_ADDR,
    MASTER_PORT), then SLURM's (SLURM_PROCID, SLURM_NTASKS), and with none of
    these it is a world of 1, so the collective code is the same at every
    world size."""
    if dist.is_initialized():
        return
    address, world, rank = _launch(coordinator, num_processes, process_id)
    dist.init_process_group("gloo", init_method=f"tcp://{address}", world_size=world,
                            rank=rank, timeout=TIMEOUT)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The rank's place in the world: its device, and the groups its
    collectives run in."""

    world: int
    rank: int
    device: torch.device
    backend: str          # of ``group``: 'nccl' or 'gloo'
    group: Any            # the training path's all_reduces
    host_group: Any       # gloo on CPU tensors: barriers, host-side checks

    @property
    def captures(self) -> bool:
        """Whether the rank's updates, all_reduces included, replay as CUDA
        graphs on the card: on NCCL, whose collectives a capture records as
        kernels on the card.  Gloo stays eager (ranks sharing a card, and the
        CPU): it copies a CUDA tensor through the host for each all_reduce,
        which a capture refuses.  The backend is the same on every rank, so
        every rank decides alike."""
        return self.backend == "nccl"

    def _all_reduce(self, tensors, mean: bool):
        global all_reduces
        all_reduces += 1
        flat = torch.cat([t.reshape(-1) for t in tensors])
        dist.all_reduce(flat, group=self.group)
        if mean:
            flat /= self.world
        return [c.view_as(t) for c, t in zip(flat.split([t.numel() for t in tensors]), tensors)]

    def psum(self, tensors):
        """The sum over the ranks of each tensor (all of one dtype and
        device), as new tensors: one all_reduce of one flat buffer."""
        return self._all_reduce(tensors, mean=False)

    def pmean(self, tensors):
        """The mean over the ranks of each tensor: ``psum`` divided by W."""
        return self._all_reduce(tensors, mean=True)

    def barrier(self):
        dist.barrier(group=self.host_group)

    def all_gather_object(self, obj) -> list:
        """``obj`` of every rank, in rank order (pickled, through gloo)."""
        out = [None] * self.world
        dist.all_gather_object(out, obj, group=self.host_group)
        return out


def make_mesh(device=None) -> Mesh:
    """The rank's mesh, starting the process group if none exists.  The
    rank's device is ``cuda:(LOCAL_RANK % device_count)`` unless ``device``
    names one ("cpu" for the CPU; None means the card, raising without one).
    The backend follows the rule in the module docstring; rank 0 prints it."""
    dev = resolve_device(device)
    initialize_distributed()
    world, rank = dist.get_world_size(), dist.get_rank()
    if dev.type == "cuda":
        if dev.index is None:
            local = int(os.environ.get("LOCAL_RANK", os.environ.get("SLURM_LOCALID", rank)))
            dev = torch.device("cuda", local % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    host_group = (dist.group.WORLD if dist.get_backend() == "gloo"
                  else dist.new_group(backend="gloo", timeout=TIMEOUT))
    card = str(torch.cuda.get_device_properties(dev).uuid) if dev.type == "cuda" else None
    cards = [None] * world
    dist.all_gather_object(cards, card, group=host_group)
    own_cards = None not in cards and len(set(cards)) == world
    if own_cards:
        backend, group = "nccl", dist.new_group(backend="nccl", timeout=TIMEOUT)
    else:
        backend, group = "gloo", host_group
    if rank == 0:
        why = ("every rank owns its own card" if own_cards else
               "ranks share a card" if None not in cards else "ranks on the CPU")
        print(f"[mesh] {world} rank(s), backend {backend} ({why}); rank 0 on {dev}",
              flush=True)
    return Mesh(world=world, rank=rank, device=dev, backend=backend, group=group,
                host_group=host_group)


def sync_normalizers(mesh: Mesh, ts: vracer.TrainState) -> vracer.TrainState:
    """Average both normalizers over the ranks leaf by leaf (mean, m2 and
    count each averaged on its own, as JAX's tree-mapped pmean does;
    mesh.py:124-126, 158-160), in one all_reduce."""
    o, r = ts.obs_stats, ts.rew_stats
    om, o2, oc, rm, r2, rc = mesh.pmean([o.mean, o.m2, o.count, r.mean, r.m2, r.count])
    return dataclasses.replace(ts, obs_stats=running_stats.RunningStats(om, o2, oc),
                               rew_stats=running_stats.RunningStats(rm, r2, rc))


def make_sharded_generation(env: Env, rl_cfg: vracer.VracerConfig, mesh: Mesh,
                            envs_per_device: int, updates_per_gen: int):
    """The rank's one-generation function, in both minibatch modes with the
    JAX semantics (mesh.py:76-223).

    Returns (gen_fn, init_replay_shard):
      gen_fn(ts, rep, generator, episode_base) -> (ts, rep, stats)
    where ``rep`` is the rank's shard, ``generator`` the rank's device
    generator, ``episode_base`` the generation's first global episode (the
    rank's envs start at episode_base + rank * envs_per_device), and stats
    hold the mean return and episode length averaged over the ranks and the
    experiences summed over the shards.

      * experience mode: a flat shard of max(replay_max_experiences // W,
        envs_per_device * T) experiences and max(flat_episode_capacity // W,
        envs_per_device) episodes, each update sampling
        max(1, mini_batch_size // W) of them; the updates start once the
        shards together hold replay_start_experiences;
      * episode mode: max(replay_capacity_episodes // W, envs_per_device)
        episode slots, updates on episode minibatches with averaged gradients
        and far-policy fraction, started once the local fill times W reaches
        replay_start_experiences.
    """
    if env.device != mesh.device:
        raise ValueError(f"[mesh] the env lives on {env.device}, the rank on {mesh.device}")
    W = mesh.world
    exp_mode = rl_cfg.minibatch_mode == "experience"
    flat_cap = max(rl_cfg.replay_max_experiences // W, envs_per_device * rl_cfg.episode_length)
    flat_ep_cap = max(rl_cfg.flat_episode_capacity // W, envs_per_device)
    mb_local = max(1, rl_cfg.mini_batch_size // W)
    cap_per_dev = max(rl_cfg.replay_capacity_episodes // W, envs_per_device)

    def stats(traj, final, n_exp):
        ret, ep_len, n = mesh.psum([final.cum_reward.mean().double(),
                                    traj["mask"].sum(1).mean().double(),
                                    torch.tensor(float(n_exp), dtype=torch.float64,
                                                 device=mesh.device)])
        return dict(mean_return=ret.item() / W, mean_ep_len=ep_len.item() / W,
                    experiences=int(n.item()))

    def gen_fn(ts, rep, generator, episode_base):
        traj, final = collect_episodes(env, rl_cfg, ts, generator, envs_per_device,
                                       episode_base + mesh.rank * envs_per_device)
        if exp_mode:
            ts = sync_normalizers(mesh, vracer.observe_episodes(rl_cfg, ts, traj))
            rep = vracer.flat_insert(rl_cfg, ts, rep, traj, group=mesh)
            total = mesh.psum([torch.tensor(replay_flat.num_experiences(rep),
                                            device=mesh.device)])[0]
            if int(total) >= rl_cfg.replay_start_experiences:
                ts, rep, _ = trainer.run_updates(rl_cfg, ts, rep, generator, updates_per_gen,
                                                 group=mesh, mini_batch=mb_local)
            return ts, rep, stats(traj, final, replay_flat.num_experiences(rep))
        rep = replay_mod.add_episodes(rep, traj)
        ts = sync_normalizers(mesh, vracer.observe_episodes(rl_cfg, ts, traj))
        if replay_mod.num_experiences(rep) * W >= rl_cfg.replay_start_experiences:
            ts, rep, _ = trainer.run_updates(rl_cfg, ts, rep, generator, updates_per_gen,
                                             group=mesh)
        return ts, rep, stats(traj, final, replay_mod.num_experiences(rep))

    def init_replay_shard():
        kw = dict(dtype=trainer.REPLAY_DTYPE, device=mesh.device)
        if exp_mode:
            return replay_flat.init_flat(flat_cap, flat_ep_cap, env.num_agents, env.obs_dim,
                                         env.act_dim, **kw)
        return replay_mod.init(cap_per_dev, env.episode_length, env.num_agents, env.obs_dim,
                               env.act_dim, **kw)

    return gen_fn, init_replay_shard


def _seeds(host: torch.Generator, n: int) -> list:
    return torch.randint(0, _SEED_HIGH, (n,), generator=host).tolist()


def _device_generator(mesh: Mesh, seed: int) -> torch.Generator:
    return torch.Generator(device=mesh.device).manual_seed(seed)


def run_generations(env: Env, rl_cfg, mesh: Mesh, envs_per_device: int,
                    updates_per_gen: int, n_generations: int, seed: int = 0,
                    verbose: bool = False, init_ts=None, history: Optional[dict] = None,
                    testing_frequency: int = 0, testing_episodes: int = 8,
                    checkpoint_dir: Optional[str] = None, checkpoint_every: int = 25,
                    init_key=None, callback=None):
    """Run ``n_generations`` on every rank (mesh.py:226-295); returns (ts, the
    rank's replay shard, history).  history carries gen / experiences
    (gen * W * envs_per_device * T) / mean_return / mean_ep_len / wall_time /
    test_return, the JAX schema.  Every ``testing_frequency`` generations each
    rank runs the same deterministic ``testing_episodes`` from episode 0;
    every ``checkpoint_every`` and after the last, the train state, history
    and meta (the host generator's state and the counters) go to
    ``checkpoint_dir``: rank 0 writes the pickle backend, every rank takes
    part in the "orbax" one, then all meet at a barrier.  Resume through
    ``init_ts``, ``history`` and ``init_key`` (a saved host generator state):
    the history continues and the replay starts empty, as in JAX.
    ``callback(gen, ts, rep, history)`` runs after each generation.  On the
    card rank 0 builds the kernels while the other ranks wait."""
    W = mesh.world
    if mesh.device.type == "cuda":
        if mesh.rank == 0:
            build.build_all(("abcn", "mlp", "vracer_loss"))
        mesh.barrier()
    gen_fn, init_rep = make_sharded_generation(env, rl_cfg, mesh, envs_per_device,
                                               updates_per_gen)
    host = torch.Generator()
    if init_key is not None:
        host.set_state(init_key)
    else:
        host.manual_seed(seed)
    k0 = _seeds(host, 1)[0]
    ts = init_ts if init_ts is not None else vracer.init_train(
        rl_cfg, _device_generator(mesh, k0), dtype=env.dtype, device=mesh.device)
    rep = init_rep()
    history = history if history is not None else dict(
        gen=[], experiences=[], mean_return=[], mean_ep_len=[], wall_time=[], test_return=[])
    history.setdefault("test_return", [])
    gen0 = history["gen"][-1] if history["gen"] else 0

    def save(gen_now):
        if not checkpoint_dir:
            return
        if ckpt.resolve_backend() == "orbax" or mesh.rank == 0:
            ckpt.save_train_state(checkpoint_dir, ts, history)
        if mesh.rank == 0:
            exp_now = history["experiences"][-1] if history["experiences"] else 0
            ckpt.save_meta(checkpoint_dir, host, gen_now, exp_now,
                           gen_now * W * envs_per_device, rl_cfg=rl_cfg)
        mesh.barrier()

    # the rank's device generator, reseeded in place each generation: the
    # graphs that registered it follow the reseed and stay cached
    generator = torch.Generator(device=mesh.device)
    t0 = time.time()
    for g in range(n_generations):
        generator.manual_seed(_seeds(host, W)[mesh.rank])
        ts, rep, stats = gen_fn(ts, rep, generator, (gen0 + g) * W * envs_per_device)
        gen_now = gen0 + g + 1
        history["gen"].append(gen_now)
        history["experiences"].append(gen_now * W * envs_per_device * env.episode_length)
        history["mean_return"].append(stats["mean_return"])
        history["mean_ep_len"].append(stats["mean_ep_len"])
        history["wall_time"].append(time.time() - t0)
        if testing_frequency and gen_now % testing_frequency == 0:
            _, tfinal = collect_episodes(env, rl_cfg, ts, _device_generator(mesh, _seeds(host, 1)[0]),
                                         testing_episodes, 0, deterministic=True)
            history["test_return"].append(float(tfinal.cum_reward.mean()))
        if checkpoint_dir and gen_now % checkpoint_every == 0:
            save(gen_now)
        if verbose and mesh.rank == 0:
            print(f"[mesh-trainer] gen {gen_now} devices {W} "
                  f"return {history['mean_return'][-1]:.5f} "
                  f"eplen {history['mean_ep_len'][-1]:.1f}", flush=True)
        if callback is not None:
            callback(gen_now, ts, rep, history)
    save(gen0 + n_generations)
    # NCCL does not destroy a communicator while a CUDA graph that holds its
    # collectives lives: the run's update graphs end with the run
    graphs.forget(mesh)
    return ts, rep, history
