"""The port's CUDA-graph paths (utils/graphs.py) on the CPU, float64.

A CPU has no CUDA graphs, so the graphed paths of ``trainer.run_updates`` and
``rollout.collect_episodes`` run here through the stand-ins of
tests/graph_standins.py: every replay runs the step under rules that refuse
what a CUDA capture refuses and checks that it issues the same operations,
shapes and host values as the first replay, as a graph would.  Held against
the JAX package: the graphed updates of both minibatch modes across a
generation boundary (cursor, live count and update counter change), and the
graphed collection at the flagship's widths on injected actions.  Held
against the direct path, bit for bit: every env's collection, whole
training runs of both modes, and n updates of both modes replayed 50 to a
graph with the rest as its own graph; a collection under a second RL config on the
same objects (fault F1: the config was not in the graph's key).  And: the
W2 image after an optimizer step that bumps no version counter, the launch
accounting per replay, a capture that fails, and Adam's ``capturable``
through a checkpoint's state dict."""

import dataclasses
import gc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import graph_standins as standins
import marlpde_tpu.rl.replay_flat as jflat
import marlpde_tpu_torch.rl.replay_flat as tflat
from marlpde_tpu.envs import registry as jreg
from marlpde_tpu.envs import rollout as jroll
from marlpde_tpu.rl import replay as jreplay
from marlpde_tpu.rl import vracer as jv
from marlpde_tpu.train import trainer as jtr
from marlpde_tpu_torch.envs import registry as treg
from marlpde_tpu_torch.envs import rollout as troll
from marlpde_tpu_torch.kernels import abcn, mlp
from marlpde_tpu_torch.rl import replay as treplay
from marlpde_tpu_torch.rl import vracer as tv
from marlpde_tpu_torch.rl import vracer_loss
from marlpde_tpu_torch.train import trainer as ttr
from marlpde_tpu_torch.utils import checkpoint as ckpt
from marlpde_tpu_torch.utils import graphs
from test_torch_interop import (params64, replay_from_jax, replay_to_jax,
                                train_state_from_jax, train_state_to_jax)
from test_torch_vracer_experience import (ATOL, RTOL, _assert_replay, _batch,
                                          _states)

torch.set_num_threads(1)


@pytest.fixture
def replayed(monkeypatch):
    standins.use(monkeypatch, standins.Replayed)


def _device_table(rows):
    """A sampler that reads row k of ``rows`` at its k-th call from a device
    counter, as a captured graph can: (sampler, its table)."""
    table = torch.as_tensor(np.asarray(rows), dtype=torch.int64)
    k = torch.zeros((), dtype=torch.int64)

    def draw(*_args):
        out = torch.index_select(table, 0, k.view(1))[0]
        k.add_(1)
        return out

    return draw


def _jax_sequence(rows):
    it = iter(rows)
    return lambda *_args: jnp.asarray(next(it))


def _assert_train_state(ts, jts, cfg):
    back = train_state_to_jax(cfg, ts, jts)
    for a, b in zip(jax.tree.leaves(back.params), jax.tree.leaves(jts.params)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=RTOL, atol=ATOL)
    for a, b in zip(jax.tree.leaves(back.opt_state), jax.tree.leaves(jts.opt_state)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(ts.beta.numpy(), np.asarray(jts.beta), rtol=1e-14)
    assert int(ts.n_updates) == int(jts.n_updates)


def test_graphed_experience_updates_across_a_generation_boundary(replayed, monkeypatch):
    """Three updates after a first insert (ids 0..11 live), then a second
    insert (cursor 24, live 16: ids 8..23) and three more through the same
    captured update, which reads the new bounds and the new counter from the
    device; against jv.update_experience step for step."""
    cfg, jts, tcfg, ts = _states(lr=1e-2, minibatch_mode="experience")
    jrep = jflat.init_flat(16, 4, 2, cfg.obs_dim, cfg.act_dim, dtype=jnp.float64)
    trep = tflat.init_flat(16, 4, 2, cfg.obs_dim, cfg.act_dim, dtype=torch.float64)
    rows = [[0, 3, 3, 11, 7, 5, 1, 10], [2, 2, 9, 4, 11, 6, 0, 8], [11, 10, 9, 8, 3, 2, 1, 0],
            [9, 9, 11, 8, 18, 17, 12, 23], [23, 22, 8, 8, 15, 16, 13, 20],
            [10, 12, 14, 16, 18, 20, 22, 19]]
    monkeypatch.setattr(jflat, "sample_ids", _jax_sequence(rows))
    monkeypatch.setattr(tflat, "sample_ids", _device_table(rows))
    gen = torch.Generator().manual_seed(0)
    replays = graphs.replays
    for seed, live in ((0, (0, 12)), (1, (8, 24))):
        b = _batch(seed)
        jb = {k: jnp.asarray(v) for k, v in b.items()}
        tb = {k: torch.from_numpy(v) for k, v in b.items()}
        jts = jv.observe_episodes(cfg, jts, jb)
        ts = tv.observe_episodes(tcfg, ts, tb)
        jrep = jv.flat_insert(cfg, jts, jrep, jb)
        trep = tv.flat_insert(tcfg, ts, trep, tb)
        assert (trep.cursor - trep.live, trep.cursor) == live
        assert trep.counters.tolist() == [trep.cursor, trep.live]
        for _ in range(3):
            jts, jrep, jm = jv.update_experience(cfg, jts, jrep, jax.random.key(0))
        ts, trep, tm = ttr.run_updates(tcfg, ts, trep, gen, 3)
        _assert_train_state(ts, jts, tcfg)
        _assert_replay(trep, jrep)
        for k, v in tm.items():
            np.testing.assert_allclose(np.asarray(v), np.asarray(jm[k]), rtol=RTOL, atol=ATOL,
                                       err_msg=k)
    # three updates are one graph: its warm-up runs the first generation's
    # three for real, one replay runs the second's
    assert graphs.replays - replays == 1 and int(ts.n_updates) == 6


def test_graphed_episode_updates_across_a_generation_boundary(replayed, monkeypatch):
    """Episode mode: two inserts into a ring of 4 episodes (filled 3, then 4)
    with two updates after each, the sampled slots read from a device table;
    against jv.update."""
    cfg, jts, tcfg, ts = _states(lr=1e-2)
    jrep = jreplay.init(4, 5, 2, cfg.obs_dim, cfg.act_dim, dtype=jnp.float64)
    trep = replay_from_jax(jrep)
    rows = [[0, 2], [1, 1], [3, 0], [2, 3]]
    draw = _device_table(rows)

    def sample(rep, g, n):
        idx = draw()
        return {f: getattr(rep, f)[idx] for f in treplay._FIELDS}

    monkeypatch.setattr(treplay, "sample_episodes", sample)
    jrows = iter(rows)
    gen = torch.Generator().manual_seed(0)
    for seed, filled in ((0, 3), (1, 4)):
        b = _batch(seed)
        jb = {k: jnp.asarray(v) for k, v in b.items()}
        tb = {k: torch.from_numpy(v) for k, v in b.items()}
        jrep = jreplay.add_episodes(jrep, jb)
        trep = treplay.add_episodes(trep, tb)
        jts = jv.observe_episodes(cfg, jts, jb)
        ts = tv.observe_episodes(tcfg, ts, tb)
        assert trep.filled == filled and trep.counters.tolist() == [filled]
        for _ in range(2):
            idx = jnp.asarray(next(jrows))
            jbatch = {f: getattr(jrep, f)[idx] for f in treplay._FIELDS}
            jts, jm = jv.update(cfg, jts, jbatch)
        ts, trep, tm = ttr.run_updates(tcfg, ts, trep, gen, 2)
        _assert_train_state(ts, jts, tcfg)
        back = replay_to_jax(trep)
        for f in treplay._FIELDS:
            np.testing.assert_array_equal(np.asarray(getattr(back, f)), np.asarray(getattr(jrep, f)))
        for k, v in tm.items():
            np.testing.assert_allclose(np.asarray(v), np.asarray(jm[k]), rtol=RTOL, atol=ATOL,
                                       err_msg=k)
    assert int(ts.n_updates) == 4


def _small_learner(mode):
    """A float64 train state and a replay with two generations inserted, in
    either minibatch mode, the same at every call."""
    cfg, jts, tcfg, ts = _states(lr=1e-2, minibatch_mode=mode)
    rep = (tflat.init_flat(16, 4, 2, cfg.obs_dim, cfg.act_dim, dtype=torch.float64)
           if mode == "experience" else treplay.init(4, 5, 2, cfg.obs_dim, cfg.act_dim,
                                                     dtype=torch.float64))
    for seed in (0, 1):
        b = {k: torch.from_numpy(v) for k, v in _batch(seed).items()}
        ts, rep = ttr.insert_generation(tcfg, ts, rep, b)
    return tcfg, ts, rep


def _learner_tensors(ts, rep):
    return graphs.tensors((list(ts.net.parameters()), list(ts.opt.state.values()), ts.beta,
                           ts.n_updates, rep))


@pytest.mark.parametrize("mode", ["experience", "episode"])
@pytest.mark.parametrize("n", [0, 1, 49, 50, 51, 120])
def test_chunked_updates_give_the_bits_of_direct_updates(n, mode, monkeypatch):
    """``run_updates`` replays one graph of UPDATE_CHUNK updates n // 50
    times and one of the n % 50 left; the first call's warm-ups are real
    updates and count toward n.  Two generations of n updates, graphed and
    direct, from one state and one generator stream: the same bits after
    each, n updates a generation, no capture in the second, whose replays
    are one per graph."""
    assert ttr.UPDATE_CHUNK == 50
    runs = []
    for graphed in (False, True):
        with monkeypatch.context() as m:
            captures = []
            if graphed:
                standins.use(m, standins.Replayed)
                real = graphs.capture
                m.setattr(graphs, "capture", lambda name, *a, **k: (
                    captures.append(name), real(name, *a, **k))[1])
            tcfg, ts, rep = _small_learner(mode)
            gen = torch.Generator().manual_seed(5)
            states, metrics = [], []
            for g in (1, 2):
                replays, before = graphs.replays, len(captures)
                ts, rep, mets = ttr.run_updates(tcfg, ts, rep, gen, n)
                assert int(ts.n_updates) == g * n
                states.append([t.clone() for t in _learner_tensors(ts, rep)])
                metrics.append({k: v.clone() for k, v in mets.items()})
                if graphed and g == 2:
                    assert len(captures) == before
                    assert graphs.replays - replays == (n // 50) + (n % 50 > 0)
            if graphed:
                lengths = [50] * (n >= 50) + [n % 50] * (n % 50 > 0)
                assert captures == [f"{k} {mode}-mode updates" for k in lengths]
            runs.append((states, metrics))
    (sd, md), (sg, mg) = runs
    for a_gen, b_gen in zip(sd, sg):
        assert len(a_gen) == len(b_gen)
        for a, b in zip(a_gen, b_gen):
            torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)
    for a, b in zip(md, mg):
        assert set(a) == set(b) and all(torch.equal(a[k], b[k]) for k in a)


# the flagship's widths (32 points, 32 actions, 32 agents, 10 sub-steps a
# macro-step, an N_dns=512 pool) at 4 macro-steps
FLAGSHIP = dict(N_dns=512, grid_size=32, num_actions=32, num_agents=32, dt=1e-3, T=0.04,
                nu=0.02, episode_length=4, ic_case="turbulence", spectral_reward=True,
                noise=0.0)


def _injected(mod):
    """A policy of the observations alone, the same in both packages: the
    actions the test injects."""
    def act(cfg, ts, obs, key):
        mu = 0.3 * mod.tanh(obs.sum(-1, keepdims=True) * 0.1) * mod.ones_like(obs[..., :1])
        mu = mu * mod.ones(cfg.act_dim, dtype=obs.dtype)
        return mu, mu, 0.1 * mod.ones_like(mu)
    return act


@pytest.fixture(scope="module")
def flagship():
    jenv = jreg.make_env("burger", dtype=jnp.float64, **FLAGSHIP)
    tenv = treg.make_env("burger", dtype=torch.float64, device="cpu", **FLAGSHIP)
    return jenv, tenv


@pytest.mark.parametrize("graphed", [False, True], ids=["direct", "graphed"])
def test_collection_at_flagship_width_on_injected_actions(flagship, graphed, monkeypatch):
    """The rewritten collection (MacroStep buffers, the device index, the
    state copied in place) against JAX's scan, twice in a row, so that the
    graphed path also replays its cached graph from a new reset."""
    if graphed:
        standins.use(monkeypatch, standins.Replayed)
    jenv, tenv = flagship
    monkeypatch.setattr(jv, "act", _injected(jnp))
    monkeypatch.setattr(tv, "act", lambda cfg, ts, obs, g: _injected(torch)(cfg, ts, obs, g))
    cfg = jtr.default_rl_config(jenv, width=16)
    jts = params64(cfg, jv.init_train(cfg, jax.random.key(1), dtype=jnp.float64))
    tcfg = ttr.default_rl_config(tenv, width=16)
    ts = train_state_from_jax(tcfg, jts)
    gen = torch.Generator().manual_seed(0)
    for base in (0, 3):
        jtraj, jfinal = jroll.collect_episodes(jenv, cfg, jts, jax.random.key(2), 3,
                                               episode_base=base, record_fields=True)
        ttraj, tfinal = troll.collect_episodes(tenv, tcfg, ts, gen, 3, episode_base=base,
                                               record_fields=True)
        assert set(ttraj) == set(jtraj)
        for name in ttraj:
            assert ttraj[name].shape == jtraj[name].shape, name
            np.testing.assert_allclose(ttraj[name].numpy(), np.asarray(jtraj[name]),
                                       atol=1e-10, err_msg=name)
        np.testing.assert_allclose(tfinal.cum_reward.numpy(), np.asarray(jfinal.cum_reward),
                                   atol=1e-10)
        assert np.abs(ttraj["actions"].numpy()).max() > 0.01


SMALL = dict(N_dns=64, grid_size=16, num_actions=16, dt=0.01, T=0.1, episode_length=5,
             nu=0.05)
ENVS = {
    "burger-marl": ("burger", dict(SMALL, num_agents=4, spectral_reward=True,
                                   ic_case="turbulence")),
    "burger-mse": ("burger", dict(SMALL)),
    "burger-fd": ("burger-fd", dict(SMALL, dforce=True)),
    "burger-jax": ("burger-jax", dict(SMALL, dforce=True)),
    "coupled-burger": ("coupled-burger", dict(SMALL)),
    "forcing": ("burger", dict(SMALL, forcing=True)),
    "ssm": ("burger", dict(SMALL, ssm=True)),
    "dsm": ("burger", dict(SMALL, dsm=True, ic_case="forced")),
    "burger-lockstep": ("burger-lockstep", dict(SMALL)),
    "ks": ("ks", dict(N_dns=64, grid_size=16, num_actions=16, episode_length=5)),
    "diffusion-simple": ("diffusion-simple", dict(episode_length=5)),
    "diffusion-error": ("diffusion-error", dict(episode_length=5)),
    "diffusion-stencil3": ("diffusion-stencil3", dict(episode_length=5)),
    "advection-simple": ("advection-simple", dict(episode_length=5)),
    "laplace": ("laplace", dict(episode_length=5)),
}


def _collections(env, rl_cfg, ts, record):
    g = torch.Generator().manual_seed(5)
    return [troll.collect_episodes(env, rl_cfg, ts, g, 3, base, deterministic=det,
                                   record_fields=record)
            for det in (False, True) for base in (0, 3)]


@pytest.mark.parametrize("name", list(ENVS))
def test_every_env_collects_the_same_bits_graphed(name, monkeypatch):
    """Every env's macro-step obeys the capture rules, and the graphed
    collection (stochastic and deterministic, each twice) gives the direct
    one's bits."""
    preset, kw = ENVS[name]
    env = treg.make_env(preset, dtype=torch.float64, device="cpu", **kw)
    rl_cfg = ttr.default_rl_config(env, width=8)
    ts = tv.init_train(rl_cfg, torch.Generator().manual_seed(0), dtype=torch.float64,
                       device="cpu")
    record = preset != "burger-lockstep"
    direct = _collections(env, rl_cfg, ts, record)
    standins.use(monkeypatch, standins.Replayed)
    graphed = _collections(env, rl_cfg, ts, record)
    for (dt, df), (gt, gf) in zip(direct, graphed):
        assert set(dt) == set(gt)
        for k in dt:
            assert torch.equal(dt[k].nan_to_num(), gt[k].nan_to_num()), k
        for a, b in zip(graphs.tensors(df), graphs.tensors(gf)):
            assert torch.equal(a.nan_to_num(), b.nan_to_num())


@pytest.mark.parametrize("deterministic", [False, True], ids=["stochastic", "deterministic"])
def test_a_second_rl_config_gets_its_own_collection_graph(deterministic, monkeypatch):
    """The macro-step reads the RL config by value (the action bounds, the
    observation scaling), so a collection under a second config on the same
    net, env, consts and generator replays a graph of its own: its actions
    stay within the second config's bounds, bit for bit as the direct call's."""
    preset, kw = ENVS["burger-marl"]
    env = treg.make_env(preset, dtype=torch.float64, device="cpu", **kw)
    wide = ttr.default_rl_config(env, width=8)
    narrow = dataclasses.replace(wide, action_low=-0.01, action_high=0.01)
    ts = tv.init_train(wide, torch.Generator().manual_seed(0), dtype=torch.float64,
                       device="cpu")
    g = torch.Generator()

    def collect(cfg):
        g.manual_seed(5)
        return troll.collect_episodes(env, cfg, ts, g, 3, 0, deterministic=deterministic)

    direct = [collect(cfg) for cfg in (wide, narrow)]
    standins.use(monkeypatch, standins.Replayed)
    graphed = [collect(cfg) for cfg in (wide, narrow)]
    assert direct[0][0]["actions"].abs().max() > 0.5
    assert graphed[1][0]["actions"].abs().max() <= 0.01
    for (dt, df), (gt, gf) in zip(direct, graphed):
        for k in dt:
            assert torch.equal(dt[k].nan_to_num(), gt[k].nan_to_num()), k
        for a, b in zip(graphs.tensors(df), graphs.tensors(gf)):
            assert torch.equal(a.nan_to_num(), b.nan_to_num())


@pytest.mark.parametrize("mode", ["experience", "episode"])
def test_training_graphed_gives_the_direct_bits(mode, monkeypatch):
    """Four generations of ``trainer.train`` with testing, graphed and
    direct, with the sigma cap on: the same parameters, Adam state, beta,
    counter, replay and history, bit for bit."""
    env = treg.make_env("burger", dtype=torch.float32, device="cpu",
                        **ENVS["burger-marl"][1])
    rl_cfg = ttr.default_rl_config(env, width=8, minibatch_mode=mode, sigma_max=0.12,
                                   replay_start_experiences=20, replay_max_experiences=40,
                                   mini_batch_size=8, replay_episode_capacity=16)
    tc = ttr.TrainerConfig(num_envs=3, seed=0, max_updates_per_gen=4, max_experiences=60,
                           testing_frequency=2, testing_episodes=2)
    runs = []
    for graphed in (False, True):
        with monkeypatch.context() as m:
            if graphed:
                standins.use(m, standins.Replayed)
            runs.append(ttr.train(env, rl_cfg, tc, verbose=False))
    (ta, ra, ha), (tb, rb, hb) = runs
    for a, b in zip(graphs.tensors((list(ta.net.parameters()), list(ta.opt.state.values()),
                                    ta.beta, ta.n_updates, ra)),
                    graphs.tensors((list(tb.net.parameters()), list(tb.opt.state.values()),
                                    tb.beta, tb.n_updates, rb))):
        assert torch.equal(a, b)
    for key in ("mean_return", "metrics", "test_return", "updates"):
        assert ha[key] == hb[key], key
    assert ha["updates"] == [0, 4, 4, 4] and int(tb.n_updates) == 12


def test_w2_image_follows_a_step_that_bumps_no_version():
    """A replayed Adam step writes W2 without bumping its version counter, so
    the version check alone would keep the stale image: the update's own
    refresh rewrites the image in its fixed buffer."""
    net = tv.make_net(tv.VracerConfig(obs_dim=3, act_dim=1, width=64))
    image = mlp._cached_w2_image(net)
    w2 = net.hidden[1].weight
    version = w2._version
    w2.data.add_(0.5)                      # what a replay does: no version bump
    assert w2._version == version
    assert mlp._cached_w2_image(net) is image
    assert not torch.equal(image, mlp.w2_image(w2.detach()))      # stale
    mlp.refresh_w2_image(net)
    assert mlp._cached_w2_image(net) is image
    assert torch.equal(image, mlp.w2_image(w2.detach()))
    # a net that never built an image builds none
    fresh = tv.make_net(tv.VracerConfig(obs_dim=3, act_dim=1, width=64))
    mlp.refresh_w2_image(fresh)
    assert getattr(fresh, "_mlp_w2_image", None) is None


def test_update_rewrites_the_w2_image():
    """vracer's optimizer step refreshes the image whatever the version says."""
    cfg = tv.VracerConfig(obs_dim=3, act_dim=1, num_agents=2, episode_length=5, width=32)
    ts = tv.init_train(cfg, torch.Generator().manual_seed(0))
    image = mlp._cached_w2_image(ts.net).clone()
    batch = {k: torch.from_numpy(v).float() if v.dtype != bool else torch.from_numpy(v)
             for k, v in _batch(0).items()}
    ts = tv.observe_episodes(cfg, ts, batch)
    tv.update(cfg, ts, batch)
    w2 = ts.net.hidden[1].weight.detach()
    assert not torch.equal(ts.net._mlp_w2_image[1], image)
    assert torch.equal(ts.net._mlp_w2_image[1], mlp.w2_image(w2))


def test_replays_count_the_kernel_launches_the_capture_saw(monkeypatch):
    """The wrappers count in Python, which a replay skips: the capture's
    counts are taken back and added again at every replay."""
    standins.use(monkeypatch, standins.Counted)
    monkeypatch.setattr(mlp, "launches", 10)
    monkeypatch.setattr(abcn, "launches", 20)
    monkeypatch.setattr(vracer_loss, "launches", 30)

    def step():
        mlp.launches += 2          # two MLP launches, one ABCN launch and the loss
        abcn.launches += 1         # head's two launches a step
        vracer_loss.launches += 2

    first, graph = graphs.capture("stand-in step", step, "cpu")
    assert (mlp.launches, abcn.launches, vracer_loss.launches) == (12, 21, 32)  # the warm-up
    assert graph.launches == (1, 2, 2)         # in _COUNTED's order (abcn, mlp, vracer_loss)
    replays = graphs.replays
    for _ in range(5):
        graph.replay()
    assert (mlp.launches, abcn.launches, vracer_loss.launches) == (22, 26, 42)
    assert graphs.replays - replays == 5 and graph.graph.replays == 5


def test_replays_count_the_all_reduces_the_capture_saw(monkeypatch):
    """The mesh counts its all_reduces in Python as well: a replay adds the
    ones its capture saw, beside the kernels' launches."""
    from marlpde_tpu_torch.parallel import mesh as pmesh
    standins.use(monkeypatch, standins.Counted)
    monkeypatch.setattr(pmesh, "all_reduces", 5)
    monkeypatch.setattr(mlp, "launches", 0)

    def step():
        pmesh.all_reduces += 2     # the gradients' pmean and the off-policy psum
        mlp.launches += 1

    _, graph = graphs.capture("stand-in update", step, "cpu")
    assert (pmesh.all_reduces, graph.launches, graph.others) == (7, (0, 1, 0), (2,))
    for _ in range(3):
        graph.replay()
    assert (pmesh.all_reduces, mlp.launches) == (13, 4)


def test_a_failed_capture_raises_and_restores_the_counts(monkeypatch):
    """No quiet return to eager: a step that reads the device from the host
    fails its capture, the error names the step, and the counters are as
    the warm-up left them."""
    standins.use(monkeypatch, standins.Counted)
    x = torch.ones(3)

    def step():
        mlp.launches += 1
        return float(x.sum())

    before = mlp.launches
    with pytest.raises(RuntimeError, match="reads the device") as err:
        graphs.capture("readback step", step, "cpu")
    assert "while capturing readback step" in "".join(err.value.__notes__)
    assert mlp.launches == before + 1


def test_the_collector_frees_no_garbage_inside_a_capture(monkeypatch):
    """A step and its ``Step`` form a reference cycle, so an old graph is
    freed when the cyclic garbage collector runs, and on the card a graph
    destroyed during another's capture invalidates that capture.  Garbage
    made inside a capture is freed after it, even at a threshold of one
    allocation; the collector's state is as the caller left it."""
    standins.use(monkeypatch, standins.Counted)
    freed, calls, inside = [], [], [False]

    class OldGraph:
        def __del__(self):
            freed.append(("capture" if len(calls) == 2 and inside[0] else "elsewhere"))

    def step():
        calls.append(None)              # 1: the warm-up, 2: the capture
        inside[0] = True
        cycle = {"graph": OldGraph()}
        cycle["self"] = cycle
        del cycle
        _ = [[i] for i in range(1000)]  # allocations that would start a collection
        inside[0] = False

    thresholds = gc.get_threshold()
    gc.set_threshold(1, 1, 1)
    try:
        graphs.capture("step with garbage", step, "cpu")
        assert gc.isenabled()
        gc.collect()
        assert freed == ["elsewhere", "elsewhere"]
        gc.disable()
        graphs.capture("step with garbage", step, "cpu")
        assert not gc.isenabled()
    finally:
        gc.enable()
        gc.set_threshold(*thresholds)


def test_cuda_graphs_refuse_the_cpu():
    with pytest.raises(ValueError, match="CUDA tensors"):
        graphs.CudaGraph(torch.device("cpu"))
    assert not graphs.enabled("cpu")
    with graphs.eager():
        assert not graphs.enabled("cuda")


def test_adam_keeps_capturable_through_a_state_dict():
    """capturable -> plain -> capturable: each Adam keeps its own flag and
    its step count where it keeps it, whichever Adam wrote the state."""
    cfg = tv.VracerConfig(obs_dim=3, act_dim=1, width=8)
    nets = [tv.make_net(cfg) for _ in range(3)]
    opts = [torch.optim.Adam(nets[0].parameters(), lr=1e-3, capturable=True),
            torch.optim.Adam(nets[1].parameters(), lr=1e-3),
            torch.optim.Adam(nets[2].parameters(), lr=1e-3, capturable=True)]
    state = {i: {"step": torch.tensor(7.0), "exp_avg": torch.full_like(p, 0.5),
                 "exp_avg_sq": torch.full_like(p, 0.25)}
             for i, p in enumerate(nets[0].parameters())}
    opts[0].load_state_dict(dict(state=state, param_groups=opts[0].state_dict()["param_groups"]))
    for src, dst in zip(opts, opts[1:]):
        ckpt.load_optimizer(dst, src.state_dict())
    for opt, cap in zip(opts, (True, False, True)):
        assert all(g["capturable"] == cap for g in opt.param_groups)
        for p in opt.param_groups[0]["params"]:
            st = opt.state[p]
            assert st["step"].item() == 7.0 and st["step"].dtype == torch.float32
            assert torch.equal(st["exp_avg"], torch.full_like(p, 0.5))
    # the port's own optimizer is plain on the CPU
    assert not tv.make_optimizer(cfg, nets[1]).param_groups[0]["capturable"]


def test_the_train_state_counter_and_beta_change_in_place():
    """The update counter is a device tensor that the update advances in
    place, like beta, so a graph that read them reads the new values."""
    cfg = tv.VracerConfig(obs_dim=3, act_dim=1, num_agents=2, episode_length=5, width=8)
    ts = tv.init_train(cfg, torch.Generator().manual_seed(0), dtype=torch.float64)
    assert ts.n_updates.dtype == torch.int64 and int(ts.n_updates) == 0
    counter, beta = ts.n_updates, ts.beta
    batch = {k: torch.from_numpy(v) for k, v in _batch(0).items()}
    ts = tv.observe_episodes(cfg, ts, batch)
    ts1, m = tv.update(cfg, ts, batch)
    assert ts1 is ts and ts.n_updates is counter and ts.beta is beta
    assert int(counter) == 1 and torch.equal(m["beta"], beta)
    # an int given for the counter becomes the device tensor
    assert isinstance(dataclasses.replace(ts, n_updates=5).n_updates, torch.Tensor)
