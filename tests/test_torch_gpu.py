"""The port's CUDA kernels on the card, against their plain versions.

These tests need an NVIDIA card with sm_90a and nvcc; elsewhere they skip.
The file imports no JAX, so it runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py -q
"""

import contextlib
import dataclasses

import numpy as np
import pytest
import torch

from marlpde_tpu_torch.envs import burger_env, burger_fast, ks_env
from marlpde_tpu_torch.kernels import abcn, mlp
from marlpde_tpu_torch.rl import networks
from marlpde_tpu_torch.solvers import ks

pytestmark = pytest.mark.gpu
torch.set_num_threads(1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _abcn_inputs(B, N, seed):
    g = torch.Generator().manual_seed(seed)
    u = torch.randn(B, N, generator=g) * 0.5 + 1.0
    v = torch.fft.fft(u)
    k = torch.fft.fftfreq(N, 1.0 / N)
    D = torch.fft.fft(0.5 * u * u)
    return [u, v.real.contiguous(), v.imag.contiguous(), (-k * D.imag).contiguous(),
            (k * D.real).contiguous(), torch.full((B, 1), 0.02),
            torch.randn(B, N, generator=g) * 0.1, torch.randn(B, N, generator=g) * 0.1]


@pytest.mark.parametrize("N", [2, 16, 32, 64, 1024])
@pytest.mark.parametrize("B", [1, 10, 33, 1000, 1024])
def test_abcn_kernel_matches_plain_version(cuda, B, N):
    """Batches that fill no warp, one warp, and end in a ragged warp; N with
    several envs a warp, one env a warp, and one env across warps."""
    args = [a.to(cuda) for a in _abcn_inputs(B, N, N)]
    kw = dict(n_intermediate=10, dt=1e-3, dx=float(2 * np.pi / N))
    before = abcn.launches
    out = abcn.abcn_macro_step(*args, **kw)
    torch.cuda.synchronize()
    assert abcn.launches == before + 1
    ref = abcn.abcn_macro_step_reference(*args, **kw)
    # float32 FFTs in another order than torch.fft: relative to each field's scale
    tol = 2e-6 if N <= 64 else 1e-4
    for o, r in zip(out, ref):
        assert o.shape == r.shape and o.dtype == torch.float32
        assert (o - r).abs().max().item() <= tol * max(1.0, r.abs().max().item())


@pytest.mark.parametrize("B,N", [(1024, 32), (10, 32), (33, 64), (3, 1024)])
def test_abcn_kernel_gives_the_same_bits_twice(cuda, B, N):
    args = [a.to(cuda) for a in _abcn_inputs(B, N, 5)]
    kw = dict(n_intermediate=10, dt=1e-3, dx=float(2 * np.pi / N))
    first = abcn.abcn_macro_step(*args, **kw)
    second = abcn.abcn_macro_step(*args, **kw)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.parametrize("N", [2, 4, 16, 32, 64])
@pytest.mark.parametrize("B", [1, 33, 1024])
def test_abcn_kernel_follows_its_radix2_schedule(cuda, B, N):
    """The kernel against abcn_macro_step_radix2 on the card: the same stage
    order, lane pairs, twiddles and bit-reversed order, so they differ only by
    the kernel's fused multiply-adds.  A wrong permutation or twiddle shows
    here as an O(1) error."""
    args = [a.to(cuda) for a in _abcn_inputs(B, N, 2 * N + B)]
    kw = dict(n_intermediate=10, dt=1e-3, dx=float(2 * np.pi / N))
    out = abcn.abcn_macro_step(*args, **kw)
    emu = abcn.abcn_macro_step_radix2(*args, **kw)
    torch.cuda.synchronize()
    for o, e in zip(out, emu):
        assert (o - e).abs().max().item() <= 1e-6 * e.abs().max().item()


def test_abcn_kernel_refuses_what_it_does_not_take(cuda):
    args = [a.to(cuda) for a in _abcn_inputs(4, 32, 0)]
    kw = dict(n_intermediate=2, dt=1e-3, dx=0.2)
    with pytest.raises(TypeError):
        abcn.abcn_macro_step(*[a.double() for a in args], **kw)
    args24 = [a.to(cuda) for a in _abcn_inputs(4, 24, 0)]
    with pytest.raises(ValueError, match="power of two"):
        abcn.abcn_macro_step(*args24, **kw)


@pytest.mark.parametrize("mu_param,sigma_max", [("absolute", np.inf), ("absolute", 0.5),
                                                ("sigma_relative", np.inf),
                                                ("sigma_relative", 0.5)])
@pytest.mark.parametrize("R", [1, 63, 64, 65, 127, 1001, 32768])
def test_mlp_kernel_matches_module(cuda, mu_param, sigma_max, R):
    """Row counts on both sides of the 64-row warpgroup and 128-row block
    tiles: the last tile is masked."""
    g = torch.Generator().manual_seed(R)
    net = networks.VracerNet(3, 1, width=128, mu_param=mu_param, sigma_max=sigma_max,
                             device=cuda)
    with torch.no_grad():
        for p in net.parameters():
            p.copy_(torch.randn(p.shape, generator=g).to(cuda) * 0.3)
        x = torch.randn(R, 3, generator=g).to(cuda)
        before = mlp.launches
        out = mlp.mlp_forward(x, net)
        torch.cuda.synchronize()
        assert mlp.launches == before + 1
        for o, r in zip(out, net(x)):
            assert o.shape == r.shape
            assert (o - r).abs().max().item() <= 2e-5     # tests/test_pallas.py MLP tolerance


@pytest.mark.parametrize("mu_param", ["absolute", "sigma_relative"])
@pytest.mark.parametrize("obs_dim,act_dim", [(3, 1), (32, 32), (33, 8), (80, 16), (128, 2),
                                             (128, 128), (256, 256)])
@pytest.mark.parametrize("width", range(32, 257, 32))
def test_mlp_kernel_widths(cuda, width, obs_dim, act_dim, mu_param):
    """Every width the kernel takes (one wgmma width each), at the
    burger-marl shape (the narrow route: W2 resident up to 160, streamed
    above), and on the wide route at the single-agent burger shape (32 obs,
    32 actions), at obs 33 (a layer-1 chunk with one live k-step, inputs
    read one at a time), and at obs 80, 128 and 256 (diffusion-stencil3 and
    diffusion-simple at obs 128, burger-fd at width 256): with W1 and the x
    tile staged whole in shared memory, obs 80 at width 256 left one stage
    to a streaming ring, which hung, and obs 128 from width 160 and obs 256
    from width 64 left none, which raised."""
    g = torch.Generator().manual_seed(width)
    net = networks.VracerNet(obs_dim, act_dim, width=width, mu_param=mu_param, device=cuda)
    with torch.no_grad():
        for p in net.parameters():
            p.copy_(torch.randn(p.shape, generator=g).to(cuda) * (0.5 / np.sqrt(p.shape[-1])))
        x = torch.randn(3000, obs_dim, generator=g).to(cuda)
        out = mlp.mlp_forward(x, net)
        torch.cuda.synchronize()
        for o, r in zip(out, net(x)):
            assert o.shape == r.shape
            # float32 sums of up to 256 terms in another order than cuBLAS
            assert (o - r).abs().max().item() <= 2e-5


@pytest.mark.parametrize("obs_dim,act_dim", [(32, 16), (128, 128)])
@pytest.mark.parametrize("width", [32, 128, 256])
def test_mlp_kernel_unaligned_inputs_give_the_aligned_bits(cuda, width, obs_dim, act_dim):
    """obs whose rows are not 16-byte aligned give the bits of aligned ones
    (the wide route stages x in its fragment order either way), within 2e-5
    of the module."""
    g = torch.Generator().manual_seed(width + obs_dim)
    net = networks.VracerNet(obs_dim, act_dim, width=width, device=cuda)
    with torch.no_grad():
        for p in net.parameters():
            p.copy_(torch.randn(p.shape, generator=g).to(cuda) * (0.5 / np.sqrt(p.shape[-1])))
        flat = torch.randn(1000 * obs_dim + 1, generator=g).to(cuda)
        unaligned = flat[1:].view(1000, obs_dim)
        aligned = unaligned.clone()
        assert unaligned.is_contiguous() and unaligned.data_ptr() % 16 == 4
        first = mlp.mlp_forward(unaligned, net)
        second = mlp.mlp_forward(aligned, net)
        ref = net(aligned)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, second))
    for o, r in zip(first, ref):
        assert (o - r).abs().max().item() <= 2e-5


def _mlp_net(cuda, width, seed):
    g = torch.Generator().manual_seed(seed)
    net = networks.VracerNet(3, 1, width=width, device=cuda)
    with torch.no_grad():
        for p in net.parameters():
            p.copy_(torch.randn(p.shape, generator=g).to(cuda) * (0.5 / np.sqrt(p.shape[-1])))
    return net, torch.randn(5000, 3, generator=g).to(cuda)


@pytest.mark.parametrize("width", [128, 256])
def test_mlp_kernel_gives_the_same_bits_twice(cuda, width):
    net, x = _mlp_net(cuda, width, 11)
    with torch.no_grad():
        first = mlp.mlp_forward(x, net)
        second = mlp.mlp_forward(x, net)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.parametrize("width", [128, 256])
def test_mlp_kernel_follows_w2_updated_in_place(cuda, width):
    """The split of W2 is cached per parameter version: an in-place update of
    W2 (by hand, then by an Adam step) between two calls must reach the kernel
    as it reaches the module."""
    net, x = _mlp_net(cuda, width, 12)
    with torch.no_grad():
        before = mlp.mlp_forward(x, net)
        net.hidden[1].weight.add_(0.05)
        after = mlp.mlp_forward(x, net)
        ref = net(x)
    assert (before[0] - ref[0]).abs().max().item() > 1e-3
    for o, r in zip(after, ref):
        assert (o - r).abs().max().item() <= 2e-5
    opt = torch.optim.Adam(net.parameters(), lr=0.05)
    net(x)[0].square().mean().backward()
    opt.step()
    with torch.no_grad():
        for o, r in zip(mlp.mlp_forward(x, net), net(x)):
            assert (o - r).abs().max().item() <= 2e-5


@pytest.mark.parametrize("width", [96 + 1, 288])
def test_mlp_kernel_refuses_widths_it_does_not_take(cuda, width):
    net = networks.VracerNet(3, 1, width=width, device=cuda)
    with pytest.raises(ValueError, match="multiple of 32 up to 256"):
        mlp.mlp_forward(torch.zeros(4, 3, device=cuda), net)


# the wide route's shapes: burger-fd, diffusion-simple, KS, obs 256 at width 256
# (obs, actions, width, mu_param, sigma_max, iex)
WIDE_SHAPES = [(256, 256, 32, "absolute", 0.05, 0.005), (128, 128, 128, "sigma_relative", 5.0, 3.0),
               (32, 16, 256, "sigma_relative", 5.0, 0.01), (256, 256, 256, "absolute", 0.5, 0.005)]


def _wide_net(cuda, obs_dim, act_dim, width, mu_param, sigma_max, iex, seed):
    """A net whose sigma heads reach the cap on some outputs and not on others."""
    g = torch.Generator().manual_seed(seed)
    net = networks.VracerNet(obs_dim, act_dim, width=width, mu_param=mu_param,
                             sigma_max=sigma_max, init_noise=iex, device=cuda)
    with torch.no_grad():
        for p in net.parameters():
            p.copy_(torch.randn(p.shape, generator=g).to(cuda) * (0.5 / np.sqrt(p.shape[-1])))
        net.sigma.bias.copy_(torch.linspace(-3.0, 3.0, act_dim) * sigma_max / iex)
    return net, g


def _held(out, net, x):
    ref = net(x)
    for o, r in zip(out, ref):
        assert o.shape == r.shape and torch.isfinite(o).all()
        assert (o - r).abs().max().item() <= 2e-5     # tests/test_pallas.py MLP tolerance
    return ref


@pytest.mark.parametrize("R", [1, 10, 16, 63, 64, 65, 127, 129, 5000, 8000])
@pytest.mark.parametrize("shape", WIDE_SHAPES, ids=lambda s: f"d{s[0]}a{s[1]}w{s[2]}")
def test_mlp_wide_route_rows(cuda, shape, R):
    """Row counts on both sides of the 64-row tile, at the acting and insert
    counts of the paths, with the cap and sigma_relative in the epilogue."""
    net, g = _wide_net(cuda, *shape, seed=R)
    with torch.no_grad():
        x = torch.randn(R, shape[0], generator=g).to(cuda)
        before = mlp.launches
        out = mlp.mlp_forward(x, net)
        torch.cuda.synchronize()
        assert mlp.launches == before + 1
        ref = _held(out, net, x)
    if shape[4] < 1.0:      # the cap is reached by some outputs, not all
        assert (ref[2] == shape[4]).any() and (ref[2] < shape[4]).any()


@pytest.mark.parametrize("mu_param", ["absolute", "sigma_relative"])
@pytest.mark.parametrize("act_dim", [1, 2, 3, 16, 33, 64, 128, 256])
@pytest.mark.parametrize("width", [32, 128, 256])
def test_mlp_wide_route_actions(cuda, width, act_dim, mu_param):
    """Action counts that leave the last 32-slot head tile part full (the
    value head takes slot A), at R=65 (two row tiles, the second with one
    row) and R=10 (one tile, a block per head tile)."""
    net, g = _wide_net(cuda, 128, act_dim, width, mu_param, 0.5, 0.1, seed=act_dim)
    with torch.no_grad():
        for R in (65, 10):
            x = torch.randn(R, 128, generator=g).to(cuda)
            _held(mlp.mlp_forward(x, net), net, x)


@pytest.mark.parametrize("R", [10, 5000])
@pytest.mark.parametrize("shape", WIDE_SHAPES, ids=lambda s: f"d{s[0]}a{s[1]}w{s[2]}")
def test_mlp_wide_route_gives_the_same_bits_twice(cuda, shape, R):
    net, g = _wide_net(cuda, *shape, seed=3)
    with torch.no_grad():
        x = torch.randn(R, shape[0], generator=g).to(cuda)
        first = mlp.mlp_forward(x, net)
        second = mlp.mlp_forward(x, net)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, second))


def test_mlp_wide_route_reads_weights_changed_in_place(cuda):
    """The wide route reads the parameters themselves: W1 and a head row
    edited in place, then every weight changed by a replayed graph of an Adam
    step (which bumps no version counter), reach the next call."""
    from marlpde_tpu_torch.utils import graphs
    net, g = _wide_net(cuda, 32, 16, 256, "sigma_relative", 5.0, 0.01, seed=9)
    x = torch.randn(16, 32, generator=g).to(cuda)
    with torch.no_grad():
        before = mlp.mlp_forward(x, net)
        net.hidden[0].weight.mul_(1.25)
        net.mu.weight[3].add_(0.02)
        after = mlp.mlp_forward(x, net)
        ref = _held(after, net, x)
    assert (before[1] - ref[1]).abs().max().item() > 1e-3
    opt = torch.optim.Adam(net.parameters(), lr=1e-3, capturable=True)

    def step():
        opt.zero_grad(set_to_none=False)
        v, mu, sigma = net(x)
        (v.square().mean() + mu.square().mean() + sigma.mean()).backward()
        opt.step()

    _, graph = graphs.capture("adam step", step, cuda)
    versions = [p._version for p in net.parameters()]
    with torch.no_grad():
        stale = [t.clone() for t in mlp.mlp_forward(x, net)]
        graph.replay()
        assert [p._version for p in net.parameters()] == versions
        out = mlp.mlp_forward(x, net)
        _held(out, net, x)
    assert (out[1] - stale[1]).abs().max().item() > 1e-4


@pytest.mark.parametrize("width", [32, 256])
@pytest.mark.parametrize("R", [10, 5000])
def test_mlp_route_boundary(cuda, R, width):
    """obs 4 takes the narrow route and obs 5 the wide one; at obs 4 the wide
    route, forced, agrees too, and the narrow route refuses obs 5."""
    for obs_dim in (4, 5):
        net, g = _wide_net(cuda, obs_dim, 3, width, "absolute", 0.5, 0.1, seed=obs_dim)
        x = torch.randn(R, obs_dim, generator=g).to(cuda)
        with torch.no_grad():
            _held(mlp.mlp_forward(x, net), net, x)
            _held(mlp.mlp_forward(x, net, route="wide"), net, x)
            if obs_dim == 4:
                narrow = mlp.mlp_forward(x, net, route="narrow")
                assert all(torch.equal(a, b) for a, b in zip(narrow, mlp.mlp_forward(x, net)))
            else:
                with pytest.raises(ValueError, match="route"):
                    mlp.mlp_forward(x, net, route="narrow")


def test_fast_env_step_on_card_matches_cpu(cuda):
    cfg = burger_env.BurgerEnvConfig(N_dns=64, grid_size=32, num_actions=32, num_agents=4,
                                     dt=0.01, T=0.5, nu=0.05, episode_length=5,
                                     ic_case="turbulence", spectral_reward=True)
    pools = {d: burger_env.make_dns_pool(cfg, 2, device=d) for d in ("cpu", cuda)}
    states = {d: burger_fast.reset(cfg, pools[d], None, torch.arange(6, device=d))[0]
              for d in pools}
    g = torch.Generator().manual_seed(0)
    for _ in range(3):
        a = torch.randn(6, 4, 8, generator=g)
        outs = {d: burger_fast.step(cfg, pools[d], states[d], a.to(d)) for d in pools}
        states = {d: outs[d][0] for d in pools}
        for x, y in zip(outs[cuda][1:3], outs["cpu"][1:3]):
            assert (x.cpu() - y).abs().max().item() <= 1e-5 * max(1.0, y.abs().max().item())


def test_experience_update_on_card_matches_cpu(cuda, monkeypatch):
    """flat_insert then one update_experience with the same minibatch ids, on
    the card (MLP kernel, cuBLAS) and on the CPU (plain versions), float32."""
    from marlpde_tpu_torch.rl import replay_flat, vracer

    cfg = vracer.VracerConfig(obs_dim=3, act_dim=1, num_agents=4, episode_length=20,
                              width=128, mini_batch_size=6, replay_max_experiences=64,
                              replay_episode_capacity=8, lr=1e-3)
    rng = np.random.default_rng(0)
    B, T, na = 4, 20, 4
    mask = np.ones((B, T), np.float32)
    mask[1, 12:] = 0.0
    batch = dict(obs=rng.standard_normal((B, T, na, 3)), actions=rng.standard_normal((B, T, na, 1)),
                 mu=rng.standard_normal((B, T, na, 1)) * 0.3,
                 sigma=rng.uniform(0.05, 0.3, (B, T, na, 1)),
                 rewards=rng.standard_normal((B, T, na)) * 0.05, mask=mask,
                 final_obs=rng.standard_normal((B, na, 3)),
                 truncated=np.array([False, True, False, False]))
    ids = np.array([20, 20, 31, 50, 61, 35])            # live ids 8..71 after the insert
    states = []
    weights = None
    for dev in ("cpu", cuda):
        ts = vracer.init_train(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
        if weights is None:
            with torch.no_grad():
                for p in ts.net.parameters():
                    p.add_(torch.randn(p.shape, generator=torch.Generator().manual_seed(1)) * 0.2)
            weights = {k: v.clone() for k, v in ts.net.state_dict().items()}
        ts.net.load_state_dict(weights)
        tb = {k: torch.from_numpy(np.asarray(v)).to(dev) for k, v in batch.items()}
        tb = {k: (v.float() if v.is_floating_point() else v) for k, v in tb.items()}
        ts = vracer.observe_episodes(cfg, ts, tb)
        rep = replay_flat.init_flat(64, 8, na, 3, 1, device=dev)
        rep = vracer.flat_insert(cfg, ts, rep, tb)
        monkeypatch.setattr(replay_flat, "sample_ids",
                            lambda r, g, n: torch.as_tensor(ids, device=r.obs.device))
        ts, rep, m = vracer.update_experience(cfg, ts, rep, None)
        torch.cuda.synchronize()
        states.append((ts, rep, m))
    (tc, rc, mc), (tg, rg, mg) = states
    assert tg.n_updates == tc.n_updates == 1 and rg.cursor == rc.cursor == 72
    # float32 sums in other orders (kernel, cuBLAS) through one Adam step
    for a, b in zip(tg.net.parameters(), tc.net.parameters()):
        assert (a.cpu() - b).abs().max().item() <= 1e-5
    for name in ("sv", "vtg", "rho", "boot"):
        a, b = getattr(rg, name).cpu(), getattr(rc, name)
        assert (a - b).abs().max().item() <= 1e-4 * max(1.0, b.abs().max().item()), name
    assert torch.equal(rg.off.cpu(), rc.off) and torch.equal(rg.ep_last.cpu(), rc.ep_last)
    for k in ("loss", "beta", "frac_off_replay"):
        assert abs(float(mg[k]) - float(mc[k])) <= 1e-4 * max(1.0, abs(float(mc[k]))), k


@pytest.mark.parametrize("R", [16, 8000])
def test_mlp_kernel_at_the_ks_shape(cuda, R):
    """The run-926 policy: obs 32, 16 actions, width 256, sigma_relative,
    sigma_max 5; R=16 acting rows, R=8000 insert rows."""
    g = torch.Generator().manual_seed(R)
    net = networks.VracerNet(32, 16, width=256, mu_param="sigma_relative", sigma_max=5.0,
                             init_noise=0.01, device=cuda)
    with torch.no_grad():
        for p in net.parameters():
            p.copy_(torch.randn(p.shape, generator=g).to(cuda) * (0.5 / np.sqrt(p.shape[-1])))
        x = torch.randn(R, 32, generator=g).to(cuda)
        before = mlp.launches
        out = mlp.mlp_forward(x, net)
        torch.cuda.synchronize()
        assert mlp.launches == before + 1
        for o, r in zip(out, net(x)):
            assert o.shape == r.shape
            assert (o - r).abs().max().item() <= 2e-5


@pytest.mark.parametrize("N", [16, 1024])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.float64, 1e-12)])
def test_ks_irfft_on_the_card_matches_the_cpu(cuda, N, dtype, tol):
    """A half-spectrum with non-zero imaginary parts in bins 0 and N/2 (the KS
    state carries them): cuFFT's C2R on the card must read them as zero, as
    pocketfft does on the CPU."""
    g = torch.Generator().manual_seed(N)
    rv = torch.complex(torch.randn(5, N // 2 + 1, generator=g, dtype=dtype),
                       torch.randn(5, N // 2 + 1, generator=g, dtype=dtype))
    cpu = ks.irfft(rv, N)
    card = ks.irfft(rv.to(cuda), N).cpu()
    np.testing.assert_allclose(cpu.numpy(), np.fft.irfft(rv.numpy(), N), atol=tol)
    assert (card - cpu).abs().max().item() <= tol * cpu.abs().max().item()


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.float64, 1e-10)])
def test_ks_step_on_card_matches_cpu(cuda, dtype, tol):
    """Six KS envs through five macro-steps of 40 ETDRK4 sub-steps, on the
    card and on the CPU from the same pool and actions."""
    cfg = ks_env.KSEnvConfig(N_dns=64, grid_size=16, num_actions=16, t_transient=5.0,
                             t_end=15.0, episode_length=5)
    pool = ks_env.make_dns_pool(cfg, 2, dtype=dtype, device="cpu")
    pools = {"cpu": pool, cuda: ks_env.KSDnsPool(**{
        k: getattr(pool, k).to(cuda) for k in ("uu", "spline_m", "v0", "ek_ktt", "nu")})}
    states = {d: ks_env.reset(cfg, pools[d], None, torch.arange(6, device=d))[0] for d in pools}
    g = torch.Generator().manual_seed(0)
    for _ in range(cfg.episode_length):
        a = (torch.randn(6, 1, 16, generator=g) * 0.5).to(dtype)
        outs = {d: ks_env.step(cfg, pools[d], states[d], a.to(d)) for d in pools}
        states = {d: outs[d][0] for d in pools}
        for x, y in [(outs[cuda][k].cpu(), outs["cpu"][k]) for k in (1, 2)] + [
                (states[cuda].solver.u.cpu(), states["cpu"].solver.u)]:
            assert torch.isfinite(y).all()
            assert (x - y).abs().max().item() <= tol * max(1.0, y.abs().max().item())


@pytest.mark.parametrize("R", [10, 5000])
def test_mlp_kernel_at_the_burger_fd_shape(cuda, R):
    """run-vracer-burger-fd.py's policy: obs 256, 256 actions, width 32, iex
    0.005 (sigma_max 0.05, the CLI's default); R=10 acting rows, R=5000
    insert rows.  When W1 and the x tile were staged whole in shared memory
    (1024 + 4 (W D + W + 128 D) bytes, ~165 KB), they left room for one 8 KB
    W2 stage within the 227 KB opt-in limit; the wide route streams them."""
    g = torch.Generator().manual_seed(R)
    net = networks.VracerNet(256, 256, width=32, init_noise=0.005, sigma_max=0.05,
                             device=cuda)
    with torch.no_grad():
        for p in net.parameters():
            p.copy_(torch.randn(p.shape, generator=g).to(cuda) * (0.5 / np.sqrt(p.shape[-1])))
        x = torch.randn(R, 256, generator=g).to(cuda)
        before = mlp.launches
        out = mlp.mlp_forward(x, net)
        torch.cuda.synchronize()
        assert mlp.launches == before + 1
        for o, r in zip(out, net(x)):
            assert o.shape == r.shape and torch.isfinite(o).all()
            assert (o - r).abs().max().item() <= 2e-5


@pytest.mark.parametrize("noise", [0.0, 0.1], ids=["truth-channel", "spline"])
def test_burger_fd_env_on_card_matches_cpu(cuda, noise):
    """Six burger-fd envs (explicit-Euler FD, MSE reward; N_dns 256, grid 64)
    through five macro-steps on the card and on the CPU, from the same float32
    pool, offsets and actions: the truth channel's gather (noise 0) and the
    uniform spline (noise 0.1).  Tolerance 1e-4 relative to each tensor's max
    |value|, as chip_smoke.py's [fd-agree]: the version-0 observation
    d2u/dx2 differences the float32 field twice, over 50 explicit steps."""
    cfg = burger_env.BurgerEnvConfig(N_dns=256, grid_size=64, num_actions=64, dt=1e-3, T=0.05,
                                     nu=0.02, episode_length=5, ic_case="turbulence",
                                     scheme="fd", state_bound=1e6, noise=noise)
    pool = burger_env.make_dns_pool(cfg, 2, device="cpu")
    assert pool.truth_les is not None
    pools = {"cpu": pool, cuda: burger_env.DnsPool(**{
        k: getattr(pool, k).to(cuda) for k in ("uu", "spline_m", "v0_re", "v0_im", "ek_ktt",
                                               "nu", "randfac1", "randfac2", "truth_les")})}
    offsets = torch.linspace(-0.5, 0.5, 6) * noise
    states = {d: burger_env.reset_at(cfg, pools[d], offsets.to(d), torch.arange(6, device=d))[0]
              for d in pools}
    g = torch.Generator().manual_seed(0)
    for _ in range(cfg.episode_length):
        a = torch.randn(6, 1, 64, generator=g) * 0.5
        outs = {d: burger_env.step(cfg, pools[d], states[d], a.to(d)) for d in pools}
        states = {d: outs[d][0] for d in pools}
        for x, y in [(outs[cuda][k].cpu(), outs["cpu"][k]) for k in (1, 2)] + [
                (states[cuda].solver.u.cpu(), states["cpu"].solver.u)]:
            assert torch.isfinite(y).all()
            assert (x - y).abs().max().item() <= 1e-4 * max(1.0, y.abs().max().item())


# ------------------------------------------------------------------ CUDA graphs

def _same_bits(a, b):
    """Equal values, NaN where NaN (a blown env's frozen state holds NaN)."""
    a, b = a.detach(), b.detach()
    if a.is_complex():
        a, b = torch.view_as_real(a), torch.view_as_real(b)
    if not a.is_floating_point():
        return torch.equal(a, b)
    return torch.equal(torch.nan_to_num(a), torch.nan_to_num(b)) and torch.equal(
        torch.isnan(a), torch.isnan(b))


def _copies(ts, rep, generator):
    """A second train state, replay and generator with the same contents."""
    import copy
    from marlpde_tpu_torch.utils import graphs
    g = torch.Generator(device=generator.device)
    g.set_state(generator.get_state())
    return copy.deepcopy(ts), graphs.clone(rep), g


def _learner(cuda, mode):
    """A width-128 learner on the card with one inserted generation of
    random episodes (4 episodes of 20 steps, 4 agents, obs 3)."""
    from marlpde_tpu_torch.rl import replay, replay_flat, vracer
    cfg = vracer.VracerConfig(obs_dim=3, act_dim=1, num_agents=4, episode_length=20,
                              width=128, mini_batch_size=8, mini_batch_episodes=2,
                              minibatch_mode=mode, replay_max_experiences=64,
                              replay_episode_capacity=8, lr=1e-3)
    g = torch.Generator(device=cuda).manual_seed(0)
    ts = vracer.init_train(cfg, g, device=cuda)
    rng = np.random.default_rng(0)
    B, T, na = 4, 20, 4
    mask = np.ones((B, T), np.float32)
    mask[1, 12:] = 0.0
    batch = dict(obs=rng.standard_normal((B, T, na, 3)), actions=rng.standard_normal((B, T, na, 1)),
                 mu=rng.standard_normal((B, T, na, 1)) * 0.3,
                 sigma=rng.uniform(0.05, 0.3, (B, T, na, 1)),
                 rewards=rng.standard_normal((B, T, na)) * 0.05, mask=mask,
                 final_obs=rng.standard_normal((B, na, 3)),
                 truncated=np.array([False, True, False, False]))
    tb = {k: torch.from_numpy(np.asarray(v)).to(cuda) for k, v in batch.items()}
    tb = {k: (v.float() if v.is_floating_point() else v) for k, v in tb.items()}
    ts = vracer.observe_episodes(cfg, ts, tb)
    if mode == "experience":
        rep = vracer.flat_insert(cfg, ts, replay_flat.init_flat(64, 8, na, 3, 1, device=cuda), tb)
    else:
        rep = replay.add_episodes(replay.init(8, T, na, 3, 1, device=cuda), tb)
    return cfg, ts, rep, g


@pytest.mark.parametrize("mode", ["experience", "episode"])
def test_graph_replays_of_the_update_match_eager_calls(cuda, mode):
    """Two calls of UPDATE_CHUNK + 3 updates through run_updates (the first
    call's are the warm-ups of the 50-update graph and of the 3-update
    remainder, run for real; the second replays each once) against as many
    eager calls from the same state: the same bits in the parameters, Adam's
    state, beta, the counter, the replay and the generator; the MLP kernel's
    launches counted per replay."""
    from marlpde_tpu_torch.train import trainer
    from marlpde_tpu_torch.utils import graphs
    n = trainer.UPDATE_CHUNK + 3
    cfg, ts, rep, g = _learner(cuda, mode)
    ts_e, rep_e, g_e = _copies(ts, rep, g)
    with graphs.eager():
        before = mlp.launches
        for _ in range(2):
            _, _, m_e = trainer.run_updates(cfg, ts_e, rep_e, g_e, n)
        per_update = (mlp.launches - before) / (2 * n)
    before, replays = mlp.launches, graphs.replays
    for _ in range(2):
        _, _, m_g = trainer.run_updates(cfg, ts, rep, g, n)
    torch.cuda.synchronize()
    assert graphs.replays - replays == 2
    assert mlp.launches - before == 2 * n * per_update == (2 * n if mode == "experience" else 0)
    left = list(ts.net.parameters()) + [s for st in ts.opt.state.values() for s in st.values()]
    right = list(ts_e.net.parameters()) + [s for st in ts_e.opt.state.values()
                                           for s in st.values()]
    left += [ts.beta, ts.n_updates, *graphs.tensors(rep), g.get_state()]
    right += [ts_e.beta, ts_e.n_updates, *graphs.tensors(rep_e), g_e.get_state()]
    assert int(ts.n_updates) == 2 * n and len(left) == len(right)
    assert all(_same_bits(a, b) for a, b in zip(left, right))
    assert all(_same_bits(m_g[k], m_e[k]) for k in m_e)


@pytest.mark.parametrize("preset", ["burger", "ks"])
def test_graph_replays_of_the_macro_step_match_eager_calls(cuda, preset):
    """Two collections through the captured macro-step (the flagship's
    whole-batch env with both kernels; KS with the MLP kernel) against the
    eager loop: the same trajectories and final states, and the kernels'
    launches counted per replay."""
    from marlpde_tpu_torch.envs import registry, rollout
    from marlpde_tpu_torch.rl import vracer
    from marlpde_tpu_torch.train import trainer
    from marlpde_tpu_torch.utils import graphs
    kw = (dict(N_dns=64, grid_size=32, num_actions=32, num_agents=4, dt=0.01, T=0.5, nu=0.05,
               episode_length=5, ic_case="turbulence", spectral_reward=True)
          if preset == "burger" else
          dict(N_dns=64, grid_size=16, num_actions=16, episode_length=5))
    env = registry.make_env(preset, device=cuda, **kw)
    assert env.whole_batch == (preset == "burger")
    rl_cfg = trainer.default_rl_config(env, width=128)
    ts = vracer.init_train(rl_cfg, torch.Generator(device=cuda).manual_seed(1), device=cuda)
    outs = {}
    for path in ("eager", "graphs"):
        g = torch.Generator(device=cuda).manual_seed(2)
        counts = (abcn.launches, mlp.launches)
        with graphs.eager() if path == "eager" else contextlib.nullcontext():
            outs[path] = [rollout.collect_episodes(env, rl_cfg, ts, g, 6, base)
                          for base in (0, 6)] + [g.get_state()]
        torch.cuda.synchronize()
        outs[path + " launches"] = (abcn.launches - counts[0], mlp.launches - counts[1])
    T = env.episode_length
    assert outs["graphs launches"] == outs["eager launches"] == (
        (2 * T if preset == "burger" else 0), 2 * T)
    for (te, fe), (tg, fg) in zip(outs["eager"][:2], outs["graphs"][:2]):
        assert set(te) == set(tg) and all(_same_bits(te[k], tg[k]) for k in te)
        names = [f.name for f in dataclasses.fields(fe)]
        differ = [(i, a.dtype, tuple(a.shape)) for i, (a, b) in enumerate(
            zip(graphs.tensors(fe), graphs.tensors(fg))) if not _same_bits(a, b)]
        assert not differ, (names, differ)
    assert torch.equal(outs["eager"][2], outs["graphs"][2])


def test_registered_generator_advances_as_eager_draws(cuda):
    """A generator registered with a graph: n replays draw what n eager calls
    draw, leave the same state (what a checkpoint saves), and follow a
    set_state (what a resume does) on the next replay."""
    from marlpde_tpu_torch.utils import checkpoint, graphs
    g = torch.Generator(device=cuda).manual_seed(5)
    start = g.get_state()
    out = torch.empty(3, 7, device=cuda)

    def draw():
        out.copy_(torch.randn(3, 7, generator=g, device=cuda))

    first, graph = graphs.capture("draw", draw, cuda, generators=[g])
    drawn = [out.clone()]                          # the warm-up's draw
    for _ in range(4):
        graph.replay()
        drawn.append(out.clone())
    after = g.get_state()
    e = torch.Generator(device=cuda)
    e.set_state(start)
    eager = [torch.randn(3, 7, generator=e, device=cuda) for _ in range(5)]
    assert all(torch.equal(a, b) for a, b in zip(drawn, eager))
    assert torch.equal(after, e.get_state())
    assert np.array_equal(checkpoint.generator_state(g), e.get_state().numpy())
    g.set_state(start)
    graph.replay()
    assert torch.equal(out, eager[0])


def test_registered_generator_follows_a_manual_seed(cuda):
    """The mesh reseeds its rank's generator in place every generation: a
    replay after ``manual_seed`` draws what an eager call draws after the
    same reseed, and so does the next replay."""
    from marlpde_tpu_torch.utils import graphs
    g = torch.Generator(device=cuda).manual_seed(5)
    out = torch.empty(3, 7, device=cuda)

    def draw():
        out.copy_(torch.randn(3, 7, generator=g, device=cuda))

    _, graph = graphs.capture("draw", draw, cuda, generators=[g])
    graph.replay()
    e = torch.Generator(device=cuda)
    for seed in (9, 2**61 + 3):
        g.manual_seed(seed)
        e.manual_seed(seed)
        for _ in range(2):
            graph.replay()
            assert torch.equal(out, torch.randn(3, 7, generator=e, device=cuda))
        assert torch.equal(g.get_state(), e.get_state())


def test_a_capture_outlives_an_old_graph_dropped_inside_it(cuda):
    """A graph destroyed during another's capture invalidates that capture
    ("operation failed due to a previous error during capture").  An old
    graph dropped into a reference cycle inside a step, with the garbage
    collector at a threshold of one allocation, is freed after the capture:
    ``graphs.capture`` holds the collector off."""
    import gc

    from marlpde_tpu_torch.utils import graphs
    x = torch.zeros(1024, device=cuda)

    def step():
        x.add_(1.0)

    old = [graphs.capture("old step", step, cuda)[1] for _ in range(2)]

    def dropping():
        step()
        cycle = {"graph": old.pop()}
        cycle["self"] = cycle
        del cycle
        _ = [[i] for i in range(1000)]

    thresholds = gc.get_threshold()
    gc.set_threshold(1, 1, 1)
    try:
        graph = graphs.capture("step dropping an old graph", dropping, cuda)[1]
    finally:
        gc.set_threshold(*thresholds)
    graph.replay()
    assert x[0].item() == 4.0


@pytest.mark.parametrize("mode", ["experience", "episode"])
def test_mesh_update_replays_with_nccl_all_reduces_match_eager_calls(cuda, mode):
    """A world of 1 on NCCL: two calls of UPDATE_CHUNK + 3 updates through
    run_updates with the mesh (the first call's are the warm-ups of the
    50-update graph, which holds 50 updates' all_reduces, and of the 3-update
    remainder; the second replays each once) against as many eager calls
    from the same state: the same bits, and each replay counts its updates'
    all_reduces (experience mode: the reward-scale and off-policy sums and
    the gradients' mean; episode mode: one mean)."""
    import torch.distributed as dist
    from marlpde_tpu_torch.parallel import mesh as pmesh
    from marlpde_tpu_torch.train import trainer
    from marlpde_tpu_torch.utils import graphs
    started = not dist.is_initialized()
    mesh = pmesh.make_mesh(cuda)
    try:
        assert mesh.world == 1 and mesh.backend == "nccl" and mesh.captures
        n = trainer.UPDATE_CHUNK + 3
        cfg, ts, rep, g = _learner(cuda, mode)
        ts_e, rep_e, g_e = _copies(ts, rep, g)
        with graphs.eager():
            before = pmesh.all_reduces
            for _ in range(2):
                _, _, m_e = trainer.run_updates(cfg, ts_e, rep_e, g_e, n, group=mesh,
                                                mini_batch=8)
            per_update = (pmesh.all_reduces - before) / (2 * n)
        before, replays = pmesh.all_reduces, graphs.replays
        for _ in range(2):
            _, _, m_g = trainer.run_updates(cfg, ts, rep, g, n, group=mesh, mini_batch=8)
        torch.cuda.synchronize()
        assert graphs.replays - replays == 2
        assert per_update == (3 if mode == "experience" else 1)
        assert pmesh.all_reduces - before == 2 * n * per_update
    finally:
        graphs.forget(mesh)
        if started:
            dist.destroy_process_group()
    left = list(ts.net.parameters()) + [s for st in ts.opt.state.values() for s in st.values()]
    right = list(ts_e.net.parameters()) + [s for st in ts_e.opt.state.values()
                                           for s in st.values()]
    left += [ts.beta, ts.n_updates, *graphs.tensors(rep), g.get_state()]
    right += [ts_e.beta, ts_e.n_updates, *graphs.tensors(rep_e), g_e.get_state()]
    assert int(ts.n_updates) == 2 * n and len(left) == len(right)
    assert all(_same_bits(a, b) for a, b in zip(left, right))
    assert all(_same_bits(m_g[k], m_e[k]) for k in m_e)


def _device_kernels(prof) -> list:
    """Names of the kernels a torch.profiler run saw on the card (no copies,
    fills, or device-side copies of host ranges)."""
    events = list(prof.profiler.kineto_results.events())
    host = {e.name() for e in events if e.device_type() != torch.autograd.DeviceType.CUDA}
    return [e.name() for e in events
            if e.device_type() == torch.autograd.DeviceType.CUDA and e.name() not in host
            and not e.name().startswith(("Memcpy", "Memset"))]


@pytest.mark.parametrize("mode", ["experience", "episode"])
def test_update_graph_kernel_nodes_are_the_eager_kernels(cuda, mode):
    """The kernel nodes counted from a captured one-update graph are the
    kernels torch.profiler sees in one eager update from the same state; the
    tracer's counters hold the capture and add the nodes at each replay."""
    from marlpde_tpu_torch.train import trainer
    from marlpde_tpu_torch.utils import graphs, profiling
    cfg, ts, rep, g = _learner(cuda, mode)
    ts_e, rep_e, g_e = _copies(ts, rep, g)
    name = f"1 {mode}-mode updates"
    counters = profiling.TRACER.counters
    before = {k: counters.get(f"{k}/{name}", 0) for k in ("captures", "replays", "kernels")}
    graph, _ = trainer._update_graph(cfg, ts, rep, g, None, None, 1)
    graph.replay()
    with graphs.eager():
        trainer._update(cfg, ts_e, rep_e, g_e)          # the eager path's own first call
        torch.cuda.synchronize()
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            trainer._update(cfg, ts_e, rep_e, g_e)
            torch.cuda.synchronize()
    eager = _device_kernels(prof)
    nodes = profiling.TRACER.graphs[name]
    print(f"[tracer] {name}: graph nodes {nodes}, eager kernels {len(eager)}")
    assert graph.kernels == nodes["kernel"] == len(eager) > 100
    assert counters[f"captures/{name}"] - before["captures"] == 1
    assert counters[f"replays/{name}"] - before["replays"] == 1
    assert counters[f"kernels/{name}"] - before["kernels"] == graph.kernels


# the benchmark cells' paths at tiny sizes, updates from the first generation:
# run 918's (the ABCN env, experience mode at mbsize 8, the cumulative reward
# scale, the forward trust region, --diag) and run 926's (KS, --fused)
SYNC_RUNS = {
    "918": "burger-marl --nagents 4 --specreward --dforce --ic turbulence --NDNS 64 --dt 0.01 "
           "--T 0.1 --episodelength 5 --numenvs 2 --minibatch experience --mbsize 8 --rstart 5 "
           "--maxupd 3 --NE 40 --diag --rscale cumulative --trust forward --width 32 "
           "--testfreq 0 --run 999",
    "926": "ks --NDNS 64 --N 16 --NA 16 --ndns 2 --episodelength 5 --numenvs 2 --width 32 "
           "--rstart 10 --fused --maxupd 3 --NE 40 --run 999",
}


@pytest.mark.parametrize("run_flags", sorted(SYNC_RUNS))
def test_a_steady_graphed_generation_synchronises_only_inside_wait_spans(cuda, monkeypatch,
                                                                        tmp_path, run_flags):
    """Under torch.cuda.set_sync_debug_mode("error") outside the tracer's
    ``wait`` spans, a generation of the graphed CLI run that captures nothing
    runs to its end: every readback of the loop is a ``wait`` span (as far
    as the sync debug mode sees synchronisations)."""
    from marlpde_tpu_torch import run
    from marlpde_tpu_torch.utils import profiling
    real = profiling.span

    @contextlib.contextmanager
    def span(name, *args, **kw):
        allowed = name == "wait"
        if allowed:
            torch.cuda.set_sync_debug_mode(0)
        try:
            with real(name, *args, **kw) as s:
                yield s
        finally:
            if allowed:
                torch.cuda.set_sync_debug_mode("error")

    seen = []

    def callback(gen, ts, rep, history):
        torch.cuda.set_sync_debug_mode(0)
        seen.append((gen, sum(n for k, n in profiling.TRACER.counters.items()
                              if k.startswith("captures/"))))
        if gen == 2:            # generation 1 captured every graph: 3 runs under the rule
            torch.cuda.synchronize()
            monkeypatch.setattr(profiling, "span", span)
            torch.cuda.set_sync_debug_mode("error")

    monkeypatch.chdir(tmp_path)
    try:
        run.main(SYNC_RUNS[run_flags].split(), callback=callback, device=cuda)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert [g for g, _ in seen] == [1, 2, 3, 4]
    assert seen[0][1] > 0 and seen[1][1] == seen[2][1] == seen[0][1]


def test_span_encloses_its_kernels_on_the_profilers_clock(cuda):
    """A span's host start comes before the card starts the kernels launched
    inside it, and, closed after a synchronisation, its end after they end:
    the tracer's clock is the profiler's on the card too."""
    from marlpde_tpu_torch.utils import profiling
    tracer = profiling.Tracer()
    x = torch.randn(512, 512, device=cuda)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        with tracer.span("probe") as s:
            for _ in range(20):
                x = torch.tanh(x @ x)
            torch.cuda.synchronize()
    events = [e for e in prof.profiler.kineto_results.events()
              if e.device_type() == torch.autograd.DeviceType.CUDA]
    assert len(events) >= 40
    assert all(s.start_ns <= e.start_ns() and e.start_ns() + e.duration_ns() <= s.end_ns
               for e in events)


# ------------------------------------------------------- the experience-mode loss head

HEAD_CASES = ("forward", "jeffreys", "jeffreys-dimnorm", "forward-dimnorm", "correlation",
              "cooperation")


def _head_on_card(cuda, shape, case, seed=7):
    """tests/test_torch_vracer_loss.py's minibatch (near and far rows, actions
    at both bounds, F2's element) at a path's shape, on the card."""
    from test_torch_vracer_loss import CASES, SHAPES, head_inputs
    cfg, *tensors = head_inputs(SHAPES[shape], seed, **CASES[case])
    to = lambda t: ({k: v.to(cuda) for k, v in t.items()} if isinstance(t, dict)
                    else tuple(x.to(cuda) for x in t) if isinstance(t, tuple) else t.to(cuda))
    return (cfg, *(to(t) for t in tensors))


def _loss_head(cfg, beta, out, rows, vtg_next, scale, cutoff, inv_cutoff, plain=False):
    """The loss head as an update runs it, through the op (the kernels) or its
    plain version on the same tensors: (rho, off, metrics, dV, dmu, dsigma),
    the gradients for a loss cotangent of 1, taken by
    ``torch.autograd.backward`` as update_experience takes them."""
    from marlpde_tpu_torch.rl import vracer_loss as VL
    leaves = [t.clone().requires_grad_(True) for t in out]
    mu, sigma = leaves[1].detach(), leaves[2].detach()
    if plain:
        rho, _ = VL.joint_rho(cfg, rows["actions"], mu, sigma, rows["mu"], rows["sigma"])
        off = ~((rho > inv_cutoff) & (rho < cutoff))
        loss, metrics = VL.loss_experience(cfg, beta, leaves, rows, vtg_next, scale, cutoff)
        backward = ((loss,), None)
    else:
        rho, off, terms = VL.rho_terms(cfg, rows, mu, sigma, scale, cutoff, inv_cutoff)
        metrics, backward = VL.experience_loss(cfg, beta, leaves, rows, vtg_next, terms)
    torch.autograd.backward(*backward)
    return rho, off, metrics, *(t.grad for t in leaves)


def _head_shapes():
    from test_torch_vracer_loss import SHAPE_ID, SHAPES
    return [pytest.param(k, id=SHAPE_ID(k)) for k in SHAPES]


@pytest.mark.parametrize("case", HEAD_CASES)
@pytest.mark.parametrize("shape", _head_shapes())
def test_loss_head_kernels_match_the_plain_version(cuda, shape, case):
    """rho, the flags, the loss's metrics and dL/dV, dL/dmu, dL/dsigma of the
    two kernels against the plain version on the card, at the minibatch
    shape of every experience-mode path and at shapes where torch sums a row
    in its other orders (float4 units from 128 entries on, rows 64 to 128
    lanes wide, rows off a 16-byte unit, 130 agents): each tensor within
    1e-6 of its max |plain|, the flags identical, the loss and metrics within
    1e-6 of max(|plain|, 1) (their float32 sums over rows take another
    order); two launches.  The elements equal bit for bit are printed, and
    the F2 element's gradient is finite."""
    from test_torch_vracer_loss import loss_grads_by_hand
    from marlpde_tpu_torch.rl import vracer_loss as VL
    args = _head_on_card(cuda, shape, case)
    before = VL.launches
    rho, off, metrics, *grads = _loss_head(*args)
    torch.cuda.synchronize()
    assert VL.launches == before + 2
    p_rho, p_off, p_metrics, *p_grads = _loss_head(*args, plain=True)
    hand = loss_grads_by_hand(*args[:7])
    assert torch.equal(off, p_off)
    for name, got, want, oracle in zip(("rho", "dV", "dmu", "dsigma"), [rho, *grads],
                                       [p_rho, *p_grads], [p_rho, *hand]):
        assert got.shape == want.shape and torch.isfinite(got).all(), name
        err, top = (got - want).abs().max().item(), want.abs().max().item()
        print(f"[vracer_loss] {shape} {case} {name}: max |kernel - plain| {err:.3e}, max "
              f"|plain| {top:.3e}; bitwise equal to plain {int((got == want).sum())}, to the "
              f"by-hand oracle {int((got == oracle).sum())} of {got.numel()}")
        assert err <= 1e-6 * top, name
    for k in VL.METRICS:
        want = float(p_metrics[k])
        assert abs(float(metrics[k]) - want) <= 1e-6 * max(abs(want), 1.0), k


@pytest.mark.parametrize("shape", _head_shapes())
def test_loss_head_kernels_give_the_same_bits_twice(cuda, shape):
    args = _head_on_card(cuda, shape, "jeffreys-dimnorm", seed=11)
    first, second = _loss_head(*args), _loss_head(*args)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        if isinstance(a, dict):
            assert all(torch.equal(a[k], b[k]) for k in a)
        else:
            assert _same_bits(a, b)


def test_loss_head_kernels_refuse_what_they_do_not_take(cuda):
    from marlpde_tpu_torch.rl import vracer_loss as VL
    cfg, beta, out, rows, vtg_next, scale, cutoff, inv_cutoff = _head_on_card(cuda, "918",
                                                                              "forward")
    rows64 = {k: v.double() for k, v in rows.items()}
    with pytest.raises(TypeError, match="float32"):
        VL.rho_terms(cfg, rows64, out[1].double(), out[2].double(), scale, cutoff, inv_cutoff)
    with pytest.raises(ValueError, match="not contiguous"):
        VL.rho_terms(cfg, rows, out[1].transpose(0, 1).contiguous().transpose(0, 1),
                     out[2], scale, cutoff, inv_cutoff)
    _, _, terms = VL.rho_terms(cfg, rows, out[1], out[2], scale, cutoff, inv_cutoff)
    with pytest.raises(ValueError, match="expected"):
        VL.experience_loss(cfg, beta, out, rows, vtg_next[:, :4], terms)


# the cells' learners at their minibatch shapes: run 918's (32 agents x 1
# action, mbsize 8, the forward trust region, the cumulative scale) and run
# 926's (1 agent x 32 actions, obs 64, mbsize 256, jeffreys, cutoff_dim_norm,
# sigma_relative with sigma_max 5, the live-buffer scale)
HEAD_CELLS = {
    "918": dict(obs_dim=3, act_dim=1, num_agents=32, mini_batch_size=8, trust_region="forward",
                reward_scale_source="cumulative", init_noise=0.1, sigma_max=1.0),
    "926": dict(obs_dim=64, act_dim=32, num_agents=1, mini_batch_size=256,
                trust_region="jeffreys", cutoff_dim_norm=True, mu_param="sigma_relative",
                sigma_max=5.0, init_noise=1e-3),
}


def _cell_learner(cuda, cell):
    """A width-256 learner of a cell's shapes on the card, with 8 inserted
    episodes of 50 random steps (one truncated)."""
    from marlpde_tpu_torch.rl import replay_flat, vracer
    T, B = 50, 8
    cfg = vracer.VracerConfig(episode_length=T, width=256, minibatch_mode="experience",
                              replay_max_experiences=1024, replay_episode_capacity=16, lr=1e-3,
                              **HEAD_CELLS[cell])
    g = torch.Generator(device=cuda).manual_seed(0)
    ts = vracer.init_train(cfg, g, device=cuda)
    rng = np.random.default_rng(0)
    na, D, A = cfg.num_agents, cfg.obs_dim, cfg.act_dim
    batch = dict(obs=rng.standard_normal((B, T, na, D)),
                 actions=rng.standard_normal((B, T, na, A)) * 0.3,
                 mu=rng.standard_normal((B, T, na, A)) * 0.3,
                 sigma=rng.uniform(0.05, 0.3, (B, T, na, A)),
                 rewards=rng.standard_normal((B, T, na)) * 0.05, mask=np.ones((B, T), np.float32),
                 final_obs=rng.standard_normal((B, na, D)),
                 truncated=np.arange(B) == 1)
    tb = {k: torch.from_numpy(np.asarray(v)).to(cuda) for k, v in batch.items()}
    tb = {k: (v.float() if v.is_floating_point() else v) for k, v in tb.items()}
    ts = vracer.observe_episodes(cfg, ts, tb)
    rep = vracer.flat_insert(cfg, ts, replay_flat.init_flat(1024, 16, na, D, A, device=cuda), tb)
    return cfg, ts, rep, g


@pytest.mark.parametrize("cell", sorted(HEAD_CELLS))
def test_cell_updates_through_the_loss_head_graphed_match_eager_and_repeat(cuda, cell):
    """At a cell's shapes, two calls of UPDATE_CHUNK updates through
    run_updates (the warm-up of the 50-update graph, then one replay) against
    100 eager updates from the same state: the same bits in the parameters,
    Adam's state, beta, the counter, the replay, the generator and the
    metrics; the loss head's two launches an update counted per replay.
    Then the whole of it again from a fresh learner: the same bits."""
    from marlpde_tpu_torch.rl import vracer_loss as VL
    from marlpde_tpu_torch.train import trainer
    from marlpde_tpu_torch.utils import graphs
    n = trainer.UPDATE_CHUNK
    runs = []
    for _ in range(2):
        cfg, ts, rep, g = _cell_learner(cuda, cell)
        ts_e, rep_e, g_e = _copies(ts, rep, g)
        with graphs.eager():
            for _ in range(2):
                _, _, m_e = trainer.run_updates(cfg, ts_e, rep_e, g_e, n)
        trainer.run_updates(cfg, ts, rep, g, n)
        before, replays = VL.launches, graphs.replays
        _, _, m_g = trainer.run_updates(cfg, ts, rep, g, n)
        torch.cuda.synchronize()
        assert graphs.replays - replays == 1 and VL.launches - before == 2 * n
        left = list(ts.net.parameters()) + [s for st in ts.opt.state.values()
                                            for s in st.values()]
        right = list(ts_e.net.parameters()) + [s for st in ts_e.opt.state.values()
                                               for s in st.values()]
        left += [ts.beta, ts.n_updates, *graphs.tensors(rep), g.get_state()]
        right += [ts_e.beta, ts_e.n_updates, *graphs.tensors(rep_e), g_e.get_state()]
        assert int(ts.n_updates) == 2 * n and len(left) == len(right)
        assert all(_same_bits(a, b) for a, b in zip(left, right))
        assert all(_same_bits(m_g[k], m_e[k]) for k in m_e)
        assert torch.isfinite(m_g["loss"])
        runs.append([t.detach().clone() for t in left[:-1]] + [left[-1]])
    assert all(_same_bits(a, b) for a, b in zip(*runs))
