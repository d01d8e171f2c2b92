"""Port parity: ``ddp/pipeline.py`` (the stochastic DNS, the spectral filter
and SGS term, normalisation, shift augmentation, the ClosureNet and its
training with and without frozen layers, the a-priori score and the
a-posteriori rollout) against the JAX package in float64.  The draws (the
forcing blocks, the shifts, the epoch permutations) are made from the JAX
keys and injected into the port; the weights are carried across by
``pipeline.params_from_flax``.  Then the reference-scale pipeline of
tests/test_ddp.py::TestPipelineScale on the port, with its own limits.

Tolerances, relative to each tensor's max |value|: 1e-10 for the data path
(the same float64 math on torch.fft and jnp.fft), 1e-8 after training and
over the 50-step rollout (Adam's update in another order, amplified by the
steps); frozen layers bit for bit.  The graphed loops (a CUDA graph per DNS
forcing block, per training epoch, per LES step on the card) run here
through tests/graph_standins.py, bit for bit against direct calls."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from marlpde_tpu.ddp import pipeline as jp
from marlpde_tpu_torch.ddp import pipeline as tp
from marlpde_tpu_torch.solvers import closures as tclosures
from marlpde_tpu_torch.utils import graphs

import graph_standins as standins

torch.set_num_threads(1)
REL = 1e-10
REL_TRAIN = 1e-8
SMALL = dict(N=128, n_les=32)


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-300)


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float64))


def _block_draws(key, n_steps, s):
    """The (n_blocks, 2, 3) normals JAX's generate_dns draws from ``key``
    when u0 is given."""
    keys = jax.random.split(key, n_steps // s)
    return np.stack([np.asarray(jax.random.normal(kb, (2, 3))) for kb in keys])


@pytest.mark.parametrize("n_steps", [200, 130])
def test_generate_dns_matches_jax(n_steps):
    cfg_kw = SMALL
    jcfg, tcfg = jp.DdpConfig(**cfg_kw), tp.DdpConfig(**cfg_kw)
    x = np.linspace(0.0, jcfg.L, jcfg.N, endpoint=False)
    u0 = np.sin(2.0 * np.pi * 2.0 * x / jcfg.L + 0.7)
    key = jax.random.key(3)
    JU, JF = jp.generate_dns(jcfg, n_steps, key, u0=jnp.asarray(u0))
    U, F = tp.generate_dns(tcfg, n_steps, u0=_t(u0), draws=_block_draws(key, n_steps, jcfg.s),
                           dtype=torch.float64, device="cpu")
    assert U.shape == F.shape == ((n_steps // 20) * 20 + 1, 128)
    assert _rel(U.numpy(), JU) < REL and _rel(F.numpy(), JF) < REL


def test_generate_dns_draws_from_the_generator():
    """tests/test_ddp.py::TestDnsGeneration on the port: the sine IC of a
    random phase, forcing constant over s-step blocks."""
    cfg = tp.DdpConfig(**SMALL)
    U, F = tp.generate_dns(cfg, 200, torch.Generator().manual_seed(0), dtype=torch.float64,
                           device="cpu")
    assert U.shape == (201, 128) and torch.isfinite(U).all()
    f = F.numpy()
    assert np.allclose(f[1], f[20]) and not np.allclose(f[20], f[21])
    x = torch.arange(128, dtype=torch.float64) * (cfg.L / 128)
    phase = torch.asin(U[0, 0])
    assert torch.allclose(U[0], torch.sin(2 * np.pi * 2 * x / cfg.L + phase), atol=1e-12) or \
        torch.allclose(U[0], torch.sin(2 * np.pi * 2 * x / cfg.L + np.pi - phase), atol=1e-12)
    U2, _ = tp.generate_dns(cfg, 200, torch.Generator().manual_seed(0), dtype=torch.float64,
                            device="cpu")
    assert torch.equal(U, U2)


def test_filter_calc_bar_and_normalize_match_jax():
    rng = np.random.default_rng(0)
    U, F = rng.standard_normal((5, 64)), rng.standard_normal((5, 64))
    assert _rel(tp.filter_bar(_t(U), 16).numpy(), jp.filter_bar(jnp.asarray(U), 16)) < REL
    for got, want in zip(tp.calc_bar(_t(U), _t(F), 16, 100.0),
                         jp.calc_bar(jnp.asarray(U), jnp.asarray(F), 16, 100.0)):
        assert got.shape == (5, 16) and _rel(got.numpy(), want) < REL
    got = tp.normalize_data(_t(U))
    want = jp.normalize_data(jnp.asarray(U))
    assert _rel(got[0].numpy(), want[0]) < REL
    assert abs(got[1].item() - float(want[1])) < 1e-14 and abs(got[2].item() - np.std(U)) < 1e-14


def test_shift_augment_matches_jax():
    rng = np.random.default_rng(1)
    a, b = rng.standard_normal((6, 8)), rng.standard_normal((6, 8))
    key = jax.random.key(0)
    ja, jb = jp.shift_augment(key, jnp.asarray(a), jnp.asarray(b))
    shifts = np.asarray(jax.random.randint(key, (6,), 0, 8))
    ta, tb = tp.shift_augment(None, _t(a), _t(b), shifts=torch.tensor(shifts))
    assert np.array_equal(ta.numpy(), np.asarray(ja)) and np.array_equal(tb.numpy(), np.asarray(jb))
    ga, gb = tp.shift_augment(torch.Generator().manual_seed(0), _t(a), _t(b))
    for i in range(6):
        s = [s for s in range(8) if np.array_equal(ga[i].numpy(), np.roll(a[i], -s))]
        assert len(s) == 1 and np.array_equal(gb[i].numpy(), np.roll(b[i], -s[0]))


def _nets(n, width=250, n_hidden=6, seed=0):
    """One set of float64 weights as a flax ClosureNet's params and as the
    port's ClosureNet."""
    jnet = jp.ClosureNet(n_out=n, width=width, n_hidden=n_hidden)
    params = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64),
                          jnet.init(jax.random.key(seed), jnp.zeros((1, n))))
    tnet = tp.ClosureNet(n, n_out=n, width=width, n_hidden=n_hidden, dtype=torch.float64)
    tnet.load_state_dict(tp.params_from_flax(jax.tree.map(np.asarray, params)))
    return jnet, params, tnet


def test_closure_net_forward_and_converters():
    jnet, params, tnet = _nets(16)
    assert len(tnet.dense) == 8 and tnet.dense[0].out_features == 128
    assert [lin.out_features for lin in tnet.dense[1:]] == [250] * 6 + [16]
    x = np.random.default_rng(2).standard_normal((5, 16))
    assert _rel(tnet(_t(x)).detach().numpy(), jnet.apply(params, jnp.asarray(x))) < REL
    back = tp.params_to_flax(tnet)
    assert jax.tree.structure(back) == jax.tree.structure(jax.tree.map(np.asarray, params))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        assert np.array_equal(a, np.asarray(b))
    # flax's init statistics: lecun-normal kernels, zero biases
    fresh = tp.ClosureNet(16, n_out=16, generator=torch.Generator().manual_seed(0))
    w = fresh.dense[1].weight
    assert (fresh.dense[1].bias == 0).all() and abs(w.std().item() * np.sqrt(128) - 1) < 0.05
    assert w.abs().max().item() <= 2.0 / np.sqrt(128) / 0.8796 + 1e-6


def _perms(key, epochs, n):
    perms = []
    for _ in range(epochs):
        key, ks = jax.random.split(key)
        perms.append(np.array(jax.random.permutation(ks, n)))
    return perms


def _data(n_samples, n, seed=3):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n_samples, n))
    return x, 0.1 * x + 0.05 * np.roll(x, 1, axis=1) ** 2


@pytest.mark.parametrize("epochs,batch", [(1, 32), (2, 100)], ids=["1-epoch", "one-batch"])
def test_train_closure_matches_jax(epochs, batch):
    n = 16
    x, y = _data(64, n)
    jnet, params, tnet = _nets(n)
    key = jax.random.key(5)
    jm = jp.train_closure(jnp.asarray(x), jnp.asarray(y), key, epochs=epochs, batch_size=batch,
                          net=jnet, params=params)
    tm = tp.train_closure(_t(x), _t(y), epochs=epochs, batch_size=batch, net=tnet,
                          perms=_perms(key, epochs, 64))
    for f in ("mean_in", "std_in", "mean_out", "std_out"):
        assert abs(getattr(tm, f) - getattr(jm, f)) <= 1e-14 * max(abs(getattr(jm, f)), 1.0), f
    want = tp.params_from_flax(jax.tree.map(np.asarray, jm.params))
    for name, p in tm.net.state_dict().items():
        assert _rel(p.numpy(), want[name].numpy()) < REL_TRAIN, name
    # the caller's module is left as it was
    for name, p in tnet.state_dict().items():
        assert torch.equal(p, tp.params_from_flax(jax.tree.map(np.asarray, params))[name])
    u = _t(x[:7])
    assert _rel(tm.predict(u).numpy(), jm.predict(jnp.asarray(x[:7]))) < REL_TRAIN


@pytest.mark.parametrize("mask", ["transfer", "head_only"])
def test_frozen_layers_stay_bit_for_bit_and_the_rest_matches_jax(mask):
    n = 16
    x, y = _data(64, n)
    jnet, params, tnet = _nets(n)
    jmask = (jp.transfer_mask(params) if mask == "transfer" else jp.head_only_mask(params))
    tmask = tp.transfer_mask(tnet) if mask == "transfer" else tp.head_only_mask(tnet)
    want_flags = {lay: bool(jax.tree.leaves(jmask["params"][lay])[0]) for lay in jmask["params"]}
    assert tmask == want_flags
    key = jax.random.key(1)
    jm = jp.train_closure(jnp.asarray(x), jnp.asarray(-y), key, epochs=2, batch_size=32,
                          net=jnet, params=params, trainable_mask=jmask)
    tm = tp.train_closure(_t(x), _t(-y), epochs=2, batch_size=32, net=tnet,
                          trainable_mask=tmask, perms=_perms(key, 2, 64))
    want = tp.params_from_flax(jax.tree.map(np.asarray, jm.params))
    for i, (before, after) in enumerate(zip(tnet.dense, tm.net.dense)):
        trainable = tmask[f"Dense_{i}"]
        for k in ("weight", "bias"):
            a, b = getattr(before, k), getattr(after, k)
            if trainable:
                assert not torch.equal(a, b)
            else:
                assert torch.equal(a, b)
            assert _rel(b.detach().numpy(), want[f"dense.{i}.{k}"].numpy()) < REL_TRAIN


def _model_pair(n, seed=0):
    jnet, params, tnet = _nets(n, width=32, n_hidden=2, seed=seed)
    stats = dict(mean_in=0.1, std_in=0.8, mean_out=-0.01, std_out=0.05)
    return (jp.ClosureModel(params=params, net=jnet, **stats),
            tp.ClosureModel(net=tnet, **stats))


def test_apriori_eval_matches_jax():
    jm, tm = _model_pair(16)
    rng = np.random.default_rng(4)
    u, pi = rng.standard_normal((20, 16)), 0.05 * rng.standard_normal((20, 16))
    want = jp.apriori_eval(jm, jnp.asarray(u), jnp.asarray(pi))
    got = tp.apriori_eval(tm, _t(u), _t(pi))
    assert list(got) == list(want) == ["mse", "correlation"]
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-10 * abs(want[k]), k


def test_aposteriori_rollout_matches_jax():
    cfg = tp.DdpConfig(**SMALL)
    jm, tm = _model_pair(cfg.n_les, seed=2)
    x = np.linspace(0, cfg.L, cfg.n_les, endpoint=False)
    rng = np.random.default_rng(5)
    u0 = 0.5 * np.sin(2 * np.pi * 2 * x / cfg.L) + 0.05 * rng.standard_normal(cfg.n_les)
    u_prev = u0 + 0.01 * rng.standard_normal(cfg.n_les)
    fseq = 1e-3 * rng.standard_normal((60, cfg.n_les))
    want = jp.aposteriori_rollout(jm, jp.DdpConfig(**SMALL), jnp.asarray(u0), jnp.asarray(u_prev),
                                  jnp.asarray(fseq), 50)
    got = tp.aposteriori_rollout(tm, cfg, _t(u0), _t(u_prev), _t(fseq), 50)
    assert got.shape == (51, cfg.n_les) and torch.isfinite(got).all()
    assert _rel(got.numpy(), want) < REL_TRAIN


def test_pipeline_at_the_reference_scale():
    """tests/test_ddp.py::TestPipelineScale on the port, on that test's own
    draws: the IC phase and forcing blocks of its key 7, the epoch
    permutations and initial weights of its key 1 (cast to float64), its
    sizes, steps and limits.  N=1024 stochastic DNS -> filter to n_les=128 ->
    closure training -> a-priori correlation above 0.45 and above static
    Smagorinsky's -> a finite, bounded a-posteriori rollout."""
    cfg = tp.DdpConfig()
    key, kic = jax.random.split(jax.random.key(7))
    phase = float(jax.random.normal(kic)) * 2.0 * np.pi
    x = np.linspace(0.0, cfg.L, cfg.N, endpoint=False)
    U, F = tp.generate_dns(cfg, 4000, u0=_t(np.sin(2.0 * np.pi * 2.0 * x / cfg.L + phase)),
                           draws=_block_draws(key, 4000, cfg.s), dtype=torch.float64,
                           device="cpu")
    assert U.shape == (4001, 1024) and torch.isfinite(U).all()
    u_bar, pi, f_bar = tp.calc_bar(U[::cfg.s], F[::cfg.s], cfg.n_les, cfg.L)
    tr, te = slice(0, 150), slice(150, 200)
    key, kp = jax.random.split(jax.random.key(1))
    params = jp.ClosureNet(n_out=128).init(kp, jnp.zeros((1, 128)))
    net = tp.ClosureNet(128, dtype=torch.float64)
    net.load_state_dict(tp.params_from_flax(jax.tree.map(np.asarray, params)))
    model = tp.train_closure(u_bar[tr], pi[tr], epochs=80, batch_size=64, net=net,
                             perms=_perms(key, 80, 150))
    ev = tp.apriori_eval(model, u_bar[te], pi[te])
    smag = tclosures.ssm_forcing(u_bar[te], cfg.L / cfg.n_les, cfg.n_les).numpy()
    corr_smag = float(np.corrcoef(smag.ravel(), pi[te].numpy().ravel())[0, 1])
    assert ev["correlation"] > 0.45, (ev, corr_smag)
    assert ev["correlation"] > abs(corr_smag), (ev, corr_smag)
    start = 190
    n_roll = len(f_bar) - start - 1
    uu = tp.aposteriori_rollout(model, cfg, u_bar[start], u_bar[start - 1], f_bar[start:], n_roll)
    assert uu.shape == (n_roll + 1, 128) and torch.isfinite(uu).all()
    assert uu.abs().max().item() < 50.0


# ------------------------------------------------------------- the graphed path
# On the card generate_dns, train_closure and aposteriori_rollout each replay
# one CUDA graph of their loop's body (utils/graphs.py); here
# tests/graph_standins.py's Replayed stands in for it: each replay runs the
# body under rules that refuse what a capture refuses and must repeat the
# first replay's operations.


def _graphed(monkeypatch, fn):
    """``fn()`` directly, then with the graphs' stand-in."""
    direct = fn()
    with monkeypatch.context() as m:
        standins.use(m, standins.Replayed)
        before = graphs.replays
        graphed = fn()
        replays = graphs.replays - before
    return direct, graphed, replays


def test_graphed_dns_gives_the_direct_bits_and_matches_jax(monkeypatch):
    jcfg, tcfg = jp.DdpConfig(**SMALL), tp.DdpConfig(**SMALL)
    x = np.linspace(0.0, jcfg.L, jcfg.N, endpoint=False)
    u0 = np.sin(2.0 * np.pi * 2.0 * x / jcfg.L + 0.7)
    key = jax.random.key(3)
    JU, JF = jp.generate_dns(jcfg, 130, key, u0=jnp.asarray(u0))
    direct, graphed, replays = _graphed(monkeypatch, lambda: tp.generate_dns(
        tcfg, 130, u0=_t(u0), draws=_block_draws(key, 130, tcfg.s), dtype=torch.float64,
        device="cpu"))
    # six blocks: the first is the capture's warm-up
    assert replays == 5
    for d, g, j in zip(direct, graphed, (JU, JF)):
        assert g.shape == (121, 128) and torch.equal(g, d) and _rel(g.numpy(), j) < REL


def test_graphed_transfer_epoch_gives_the_direct_bits_and_matches_jax(monkeypatch):
    """One frozen-layer transfer epoch (Dense_0-5 frozen) of two steps: the
    frozen layers bit for bit, the graphed epoch the direct bits, the
    trained layers JAX's at the training tolerance; then two more epochs
    replay the one capture."""
    n = 16
    x, y = _data(64, n)
    jnet, params, tnet = _nets(n)
    jmask = jp.transfer_mask(params)
    key = jax.random.key(1)
    for epochs in (1, 3):
        jm = jp.train_closure(jnp.asarray(x), jnp.asarray(y), key, epochs=epochs,
                              batch_size=32, net=jnet, params=params, trainable_mask=jmask)
        direct, graphed, replays = _graphed(monkeypatch, lambda: tp.train_closure(
            _t(x), _t(y), epochs=epochs, batch_size=32, net=tnet,
            trainable_mask=tp.transfer_mask(tnet), perms=_perms(key, epochs, 64)))
        assert replays == epochs - 1
        want = tp.params_from_flax(jax.tree.map(np.asarray, jm.params))
        for i, (before, d, g) in enumerate(zip(tnet.dense, direct.net.dense, graphed.net.dense)):
            for k in ("weight", "bias"):
                a, b = getattr(d, k), getattr(g, k)
                assert torch.equal(a, b)
                assert torch.equal(b, getattr(before, k)) == (i < 6)
                assert _rel(b.detach().numpy(), want[f"dense.{i}.{k}"].numpy()) < REL_TRAIN


def test_graphed_rollout_gives_the_direct_bits_and_matches_jax(monkeypatch):
    cfg = tp.DdpConfig(**SMALL)
    jm, tm = _model_pair(cfg.n_les, seed=2)
    xg = np.linspace(0, cfg.L, cfg.n_les, endpoint=False)
    rng = np.random.default_rng(5)
    u0 = 0.5 * np.sin(2 * np.pi * 2 * xg / cfg.L) + 0.05 * rng.standard_normal(cfg.n_les)
    u_prev = u0 + 0.01 * rng.standard_normal(cfg.n_les)
    fseq = 1e-3 * rng.standard_normal((60, cfg.n_les))
    want = jp.aposteriori_rollout(jm, jp.DdpConfig(**SMALL), jnp.asarray(u0),
                                  jnp.asarray(u_prev), jnp.asarray(fseq), 50)
    direct, graphed, replays = _graphed(monkeypatch, lambda: tp.aposteriori_rollout(
        tm, cfg, _t(u0), _t(u_prev), _t(fseq), 50))
    assert replays == 49
    assert graphed.shape == (51, cfg.n_les) and torch.equal(graphed, direct)
    assert _rel(graphed.numpy(), want) < REL_TRAIN
