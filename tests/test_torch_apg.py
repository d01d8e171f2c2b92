"""Port parity: ``rl/apg.py`` (the squash, the differentiable episode return
and its gradient, the training loop with its own clip + Adam and the
incumbent-best copy) against the JAX package on the burger-jax preset in
float64, from the same weights carried across by ``networks.params_from_flax``;
then the port of tests/test_apg.py's learning check.  The graphed path
(``Bptt``'s four steps as CUDA graphs on the card) runs here through
tests/graph_standins.py: bit for bit against direct calls, and against
JAX; the reverse scan's gradient against the checkpointed one; a second
ApgConfig on the same objects gets its own graphs (fault F1); every env's
reset, which ``Bptt.begin`` captures, under the capture rules.

The resets draw nothing at noise 0, so both packages run the same episodes.
Tolerances: 1e-8 relative to each tensor's max |value| against JAX (the same
float64 math; Adam's update is written in another order), 1e-12 between the
checkpointed and the plain backward pass of the port (one program), 1e-10
between the reverse scan and the checkpointed pass (the gradients summed in
another order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from marlpde_tpu.envs import registry as jreg
from marlpde_tpu.rl import apg as japg
from marlpde_tpu.rl import vracer as jv
from marlpde_tpu.train import trainer as jtrainer
from marlpde_tpu_torch.envs import registry as treg
from marlpde_tpu_torch.rl import apg as tapg
from marlpde_tpu_torch.rl import networks as tnet
from marlpde_tpu_torch.rl import vracer as tv
from marlpde_tpu_torch.train import trainer as ttrainer
from marlpde_tpu_torch.utils import graphs
from test_torch_interop import train_state_from_jax

import graph_standins as standins

torch.set_num_threads(1)
REL = 1e-8
KW = dict(N_dns=64, grid_size=16, num_actions=16, dt=0.01, T=0.2, episode_length=10)


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-300)


def _setup(width=32, scale=0.1, **rl):
    """The burger-jax env in both packages (float64) and one set of perturbed
    float64 weights: (jenv, jcfg, jts, tenv, tcfg, ts)."""
    jenv = jreg.make_env("burger-jax", dtype=jnp.float64, **KW)
    tenv = treg.make_env("burger-jax", dtype=torch.float64, device="cpu", **KW)
    jcfg = jtrainer.default_rl_config(jenv, width=width, **rl)
    tcfg = ttrainer.default_rl_config(tenv, width=width, **rl)
    jts = jv.init_train(jcfg, jax.random.key(1), dtype=jnp.float64)
    rng = np.random.default_rng(0)
    jts = jts.replace(params=jax.tree.map(
        lambda a: a.astype(jnp.float64) + scale * rng.standard_normal(a.shape), jts.params))
    return jenv, jcfg, jts, tenv, tcfg, train_state_from_jax(tcfg, jts)


def _grads(ts):
    return {n: (p.grad if p.grad is not None else torch.zeros_like(p)).numpy()
            for n, p in ts.net.named_parameters()}


def test_squash_matches_jax_and_keeps_a_gradient():
    mu = np.array([-1e3, -4.9, -1.0, 0.0, 0.3, 4.9, 100.0])
    want = np.asarray(japg.squash(jnp.asarray(mu), -5.0, 5.0))
    want_g = np.asarray(jax.grad(lambda m: jnp.sum(japg.squash(m, -5.0, 5.0)))(jnp.asarray(mu)))
    m = torch.tensor(mu, requires_grad=True)
    a = tapg.squash(m, -5.0, 5.0)
    a.sum().backward()
    np.testing.assert_allclose(a.detach().numpy(), want, rtol=1e-15, atol=1e-15)
    np.testing.assert_allclose(m.grad.numpy(), want_g, rtol=1e-15, atol=1e-300)
    assert (a >= -5.0).all() and (a <= 5.0).all() and m.grad[3] > 0.5


@pytest.mark.parametrize("mu_param", ["absolute", "sigma_relative"])
def test_episode_return_and_gradient_match_jax(mu_param):
    jenv, jcfg, jts, tenv, tcfg, ts = _setup(mu_param=mu_param)
    ret, g = jax.value_and_grad(lambda p: japg.episode_return(
        jenv, jcfg, p, jts, jenv.consts, jax.random.key(0), 3, 4))(jts.params)
    r = tapg.episode_return(tenv, tcfg, ts, tenv.consts, torch.Generator(), 3, 4)
    r.backward()
    assert abs(r.item() - float(ret)) <= REL * abs(float(ret))
    want = tnet.params_from_flax(jax.tree.map(np.asarray, g))
    got = _grads(ts)
    for name, w in want.items():
        assert _rel(got[name], w.numpy()) < REL, name
    assert np.abs(got["mu.weight"]).max() > 0


def test_checkpointed_gradient_equals_the_plain_one():
    *_, tenv, tcfg, ts = _setup(scale=0.3)
    out = []
    for ckpt in (True, False):
        ts.net.zero_grad(set_to_none=True)
        r = tapg.episode_return(tenv, tcfg, ts, tenv.consts, torch.Generator(), 0, 3,
                                checkpoint=ckpt)
        r.backward()
        out.append((r.item(), _grads(ts)))
    (r1, g1), (r2, g2) = out
    assert abs(r1 - r2) <= 1e-12 * abs(r2)
    for name in g1:
        assert np.abs(g1[name] - g2[name]).max() <= 1e-12 * max(np.abs(g2[name]).max(), 1e-300)


@pytest.mark.parametrize("lr,clip", [(5e-3, 0.05), (0.5, 1.0)], ids=["improving", "overshooting"])
def test_train_apg_matches_jax_over_three_iterations(lr, clip):
    """Improving, the incumbent is the last iterate before its update;
    overshooting (the return falls after the first step), the initial one."""
    jenv, jcfg, jts, tenv, tcfg, ts = _setup(scale=0.3)
    cfg = dict(iterations=3, batch_size=2, lr=lr, max_grad_norm=clip)
    jts2, jhist = japg.train_apg(jenv, jcfg, japg.ApgConfig(**cfg), key=jax.random.key(2),
                                 init_ts=jts, verbose=False)
    ts2, hist = tapg.train_apg(tenv, tcfg, tapg.ApgConfig(**cfg), generator=torch.Generator(),
                               init_ts=ts, verbose=False)
    assert hist["iter"] == jhist["iter"] == [0, 1, 2]
    for k in ("mean_return", "best_return"):
        assert _rel(hist[k], jhist[k]) < REL, k
    # the incumbent is the best of the iterates, not the last one
    best_it = int(np.argmax(jhist["mean_return"]))
    assert best_it == (2 if lr < 0.1 else 0)
    assert hist["best_return"][-1] == hist["mean_return"][best_it]
    want = tnet.params_from_flax(jax.tree.map(np.asarray, jts2.params))
    for name, p in ts2.net.named_parameters():
        assert _rel(p.detach().numpy(), want[name].numpy()) < REL, name
        assert p.grad is None
    # the VRACER optimizer is returned untouched
    assert ts2.opt is ts.opt and not ts2.opt.state


def test_the_best_copy_is_not_the_latest_iterate():
    """Adam steps the parameters in place: the incumbent must be a copy taken
    before the step, so a later, worse iterate does not overwrite it."""
    *_, tenv, tcfg, ts = _setup(scale=0.3)
    start = {n: p.detach().clone() for n, p in ts.net.named_parameters()}
    ts2, hist = tapg.train_apg(tenv, tcfg, tapg.ApgConfig(iterations=3, batch_size=2, lr=0.5),
                               generator=torch.Generator(), init_ts=ts, verbose=False)
    assert hist["mean_return"][1] < hist["mean_return"][0]
    assert hist["best_return"] == [hist["mean_return"][0]] * 3
    for n, p in ts2.net.named_parameters():
        assert torch.equal(p, start[n]), n
    r = tapg.episode_return(tenv, tcfg, ts2, tenv.consts, torch.Generator(), 0, 2)
    assert r.item() == hist["mean_return"][0]


def test_return_is_differentiable_and_improves():
    """tests/test_apg.py::test_return_is_differentiable_and_improves on the
    port (its env, width and training settings; the weights from a seeded
    generator)."""
    env = treg.make_env("burger-jax", device="cpu", **KW)
    rl_cfg = ttrainer.default_rl_config(env, width=32)
    ts, hist = tapg.train_apg(env, rl_cfg, tapg.ApgConfig(iterations=25, batch_size=4, lr=2e-3),
                              generator=torch.Generator().manual_seed(1), verbose=False)
    first = np.mean(hist["mean_return"][:3])
    last = np.mean(hist["mean_return"][-3:])
    assert np.isfinite(first) and np.isfinite(last)
    # gradient ascent must improve the (negative-MSE) return materially
    assert last > first
    assert (last - first) > 0.2 * abs(first)
    assert isinstance(ts, tv.TrainState)


# ------------------------------------------------------------- the graphed path
# On the card ``train_apg`` replays CUDA graphs of Bptt's four steps
# (utils/graphs.py); here tests/graph_standins.py's Replayed stands in for
# them: each replay runs the step under rules that refuse what a capture
# refuses and must repeat the first replay's operations.

OVERSHOOT = dict(iterations=3, batch_size=2, lr=0.5, max_grad_norm=1.0)


def _bptt_run(tenv, tcfg, ts, cfg, iterations):
    """A Bptt of ``cfg`` run ``iterations`` times from ``ts``: its state after
    (returns, parameters, incumbent, Adam's state, the generator's state)."""
    g = torch.Generator().manual_seed(4)
    bptt = tapg.Bptt(tenv, tcfg, ts, tapg.ApgConfig(**cfg), tenv.consts, g)
    outs = []
    for _ in range(iterations):
        bptt.iteration()
        outs.append(bptt.out.clone())
    state = [v.clone() for s in bptt.opt.state.values() for v in s.values()]
    return ([*outs, *[p.detach().clone() for p in bptt.params], *bptt.best, bptt.best_ret,
             *state], g.get_state())


@pytest.mark.parametrize("mu_param", ["absolute", "sigma_relative"])
def test_graphed_training_gives_the_direct_bits_and_matches_jax(mu_param, monkeypatch):
    """Three iterations whose return falls after the first update, so the
    incumbent stays behind: the graphed Bptt steps give the bits of direct
    calls (returns, parameters, incumbent, Adam's state, generator), and the
    graphed ``train_apg`` the JAX package's history and incumbent."""
    jenv, jcfg, jts, tenv, tcfg, ts = _setup(scale=0.3, mu_param=mu_param)
    start = [p.detach().clone() for p in ts.net.parameters()]
    direct, g_direct = _bptt_run(tenv, tcfg, ts, OVERSHOOT, 3)
    with torch.no_grad():
        for p, s in zip(ts.net.parameters(), start):
            p.copy_(s)
    standins.use(monkeypatch, standins.Replayed)
    graphed, g_graphed = _bptt_run(tenv, tcfg, ts, OVERSHOOT, 3)
    assert len(graphed) == len(direct)
    assert all(torch.equal(a, b) for a, b in zip(graphed, direct))
    assert torch.equal(g_graphed, g_direct)

    with torch.no_grad():
        for p, s in zip(ts.net.parameters(), start):
            p.copy_(s)
    jts2, jhist = japg.train_apg(jenv, jcfg, japg.ApgConfig(**OVERSHOOT), key=jax.random.key(2),
                                 init_ts=jts, verbose=False)
    ts2, hist = tapg.train_apg(tenv, tcfg, tapg.ApgConfig(**OVERSHOOT),
                               generator=torch.Generator(), init_ts=ts, verbose=False)
    assert hist["iter"] == [0, 1, 2]
    for k in ("mean_return", "best_return"):
        assert _rel(hist[k], jhist[k]) < REL, k
    assert hist["mean_return"][1] < hist["best_return"][1] == hist["mean_return"][0]
    want = tnet.params_from_flax(jax.tree.map(np.asarray, jts2.params))
    for name, p in ts2.net.named_parameters():
        assert _rel(p.detach().numpy(), want[name].numpy()) < REL, name
        assert torch.equal(p, start[[n for n, _ in ts.net.named_parameters()].index(name)])


@pytest.mark.parametrize("mu_param", ["absolute", "sigma_relative"])
def test_the_reverse_scan_gives_the_checkpointed_gradient(mu_param):
    """Bptt's forward tape and reverse VJPs against ``episode_return`` under
    ``torch.utils.checkpoint`` and autograd's backward pass (float64): the
    same return bit for bit, the gradients at 1e-10 (summed in another
    order), both of minus the return as ``train_apg`` descends it."""
    *_, tenv, tcfg, ts = _setup(scale=0.3, mu_param=mu_param)
    ts.net.zero_grad(set_to_none=True)
    r = tapg.episode_return(tenv, tcfg, ts, tenv.consts, torch.Generator(), 0, 3)
    (-r).backward()
    want = _grads(ts)
    bptt = tapg.Bptt(tenv, tcfg, ts, tapg.ApgConfig(batch_size=3), tenv.consts,
                     torch.Generator())
    bptt.steps["begin"]()
    for _ in range(bptt.T):
        bptt.steps["forward"]()
    for _ in range(bptt.T):
        bptt.steps["vjp"]()
    assert torch.mean(bptt.acc).item() == r.item()
    for (name, p), g in zip(ts.net.named_parameters(), bptt.grads):
        assert np.abs(g.numpy() - want[name]).max() <= 1e-10 * max(np.abs(want[name]).max(),
                                                                    1e-300), name
        assert p.grad is g
    assert np.abs(want["mu.weight"]).max() > 0


@pytest.mark.parametrize("change", [dict(lr=0.2), dict(max_grad_norm=0.3), dict(batch_size=3)],
                         ids=["lr", "clip", "batch"])
def test_a_second_apg_config_gets_its_own_graph(change, monkeypatch):
    """Fault F1's rule: a graph never serves a step whose by-value inputs
    differ from its capture's.  ``train_apg`` captures a ``Bptt`` of its own
    each call, so graphed runs of two ApgConfigs on the same net, env and
    generator each give the bits of their own direct run."""
    *_, tenv, tcfg, ts = _setup(scale=0.3)
    start = [p.detach().clone() for p in ts.net.parameters()]
    cfgs = [tapg.ApgConfig(**OVERSHOOT), tapg.ApgConfig(**dict(OVERSHOOT, **change))]

    def run(cfg, g):
        with torch.no_grad():
            for p, s in zip(ts.net.parameters(), start):
                p.copy_(s)
        _, hist = tapg.train_apg(tenv, tcfg, cfg, generator=g, init_ts=ts, verbose=False)
        return hist, [p.detach().clone() for p in ts.net.parameters()]

    direct = [run(cfg, torch.Generator()) for cfg in cfgs]
    standins.use(monkeypatch, standins.Replayed)
    g = torch.Generator()
    graphed = [run(cfg, g) for cfg in cfgs]
    assert direct[0][0] != direct[1][0]
    for (dh, dp), (gh, gp) in zip(direct, graphed):
        assert gh == dh and all(torch.equal(a, b) for a, b in zip(gp, dp))


@pytest.mark.parametrize("name", ["burger-jax", "burger", "burger-fd", "coupled-burger",
                                  "burger-lockstep", "ks", "diffusion-simple", "diffusion-error",
                                  "diffusion-stencil3", "advection-simple", "laplace"])
def test_every_env_resets_under_the_capture_rules(name):
    """Bptt's ``begin`` captures the resets on the card: after a first reset
    (the capture's warm-up, which fills the constants' caches) every env's
    reset makes no host copy or readback."""
    kw = dict(KW) if name.startswith(("burger", "coupled")) else dict(episode_length=5)
    if name == "ks":
        kw = dict(N_dns=64, grid_size=16, num_actions=16, episode_length=5)
    env = treg.make_env(name, dtype=torch.float64, device="cpu", **kw)
    counts = torch.arange(3)
    want = env.reset(env.consts, torch.Generator().manual_seed(1), counts)
    with standins.CaptureRules():
        got = env.reset(env.consts, torch.Generator().manual_seed(1), counts)
    assert all(torch.equal(a, b) for a, b in zip(graphs.tensors(got), graphs.tensors(want)))
