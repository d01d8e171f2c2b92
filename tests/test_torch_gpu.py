"""The port's CUDA kernels on the card, against their plain versions.

These tests need an NVIDIA card with sm_90a and nvcc; elsewhere they skip.
The file imports no JAX, so it runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py -q
"""

import numpy as np
import pytest
import torch

from marlpde_tpu_torch.envs import burger_env, burger_fast
from marlpde_tpu_torch.kernels import abcn, mlp
from marlpde_tpu_torch.rl import networks

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


@pytest.mark.parametrize("B,N", [(1024, 32), (1000, 32), (7, 16), (5, 64), (2, 1024)])
def test_abcn_kernel_matches_plain_version(cuda, B, N):
    args = [a.to(cuda) for a in _abcn_inputs(B, N, N)]
    kw = dict(n_intermediate=10, dt=1e-3, dx=float(2 * np.pi / N))
    before = abcn.launches
    out = abcn.abcn_macro_step(*args, **kw)
    torch.cuda.synchronize()
    assert abcn.launches == before + 1
    ref = abcn.abcn_macro_step_reference(*args, **kw)
    # direct O(N^2) float32 sums against torch.fft: relative to each field's scale
    tol = 2e-6 if N <= 64 else 1e-4
    for o, r in zip(out, ref):
        assert o.shape == r.shape and o.dtype == torch.float32
        assert (o - r).abs().max().item() <= tol * max(1.0, r.abs().max().item())


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
@pytest.mark.parametrize("R", [32768, 1001])
def test_mlp_kernel_matches_module(cuda, mu_param, sigma_max, R):
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
