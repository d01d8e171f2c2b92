"""The MLP kernel's 3xTF32 arithmetic on the CPU: the TF32 split, the W2 image
the narrow route reads, the head matrix the wide route's product reads, and a
plain emulation of the forward on both routes against the JAX package's
float64 VracerNet, which also shows why one TF32 product is not enough for
the kernel's 2e-5 tolerance, in layer 2 or in layer 1 and the heads."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from marlpde_tpu.rl import networks as jnet
from marlpde_tpu_torch.kernels import mlp
from marlpde_tpu_torch.rl import networks as tnet
from test_torch_interop import np_tree

torch.set_num_threads(1)
MLP_TOL = 2e-5      # tests/test_pallas.py's MLP tolerance, as the card holds the kernel


def _float_patterns():
    """Every sign and exponent (zeros, subnormals, infinities and NaNs
    included), each with all 8192 values of the 13 low mantissa bits that the
    split rounds away, under four values of the 10 bits it keeps (0, 1, the
    middle and all ones, where rounding carries into the exponent)."""
    low = np.arange(1 << 13, dtype=np.uint32)
    keep = np.array([0, 1, 0x200, 0x3FF], np.uint32) << 13
    expo = np.arange(256, dtype=np.uint32) << 23
    sign = np.array([0, 1], np.uint32) << 31
    bits = (sign[:, None, None, None] | expo[None, :, None, None] | keep[None, None, :, None]
            | low[None, None, None, :]).ravel()
    return torch.from_numpy(bits.view(np.float32))


def test_split_tf32_is_exact_and_keeps_10_mantissa_bits():
    w = _float_patterns()
    hi, lo = mlp.split_tf32(w)
    finite = torch.isfinite(w)
    assert int(finite.sum()) == 2 * 255 * 4 * 8192
    hb = hi.view(torch.int32)
    assert torch.equal(hb[finite] & 0x1FFF, torch.zeros_like(hb[finite]))
    assert torch.equal(hi[finite] + lo[finite], w[finite])
    assert torch.isfinite(hi[finite]).all() and torch.isfinite(lo[finite]).all()
    # round to nearest, ties away from zero: |lo| is at most half of hi's last place
    wb = w.view(torch.int32)
    half = (wb & 0x7F800000) == 0           # zero and subnormal: lo within 0x1000 units
    ulp_half = torch.where(half, torch.full_like(w, 2.0**-149 * 0x1000),
                           torch.ldexp(torch.ones_like(w), ((wb >> 23) & 0xFF) - 127 - 11))
    rounds = finite & ((wb & 0x7FFFFFFF) < 0x7F7FF000)  # above, rounding would overflow
    assert (lo[rounds].abs() <= ulp_half[rounds]).all()
    assert (lo[finite & ~rounds].abs() < 2 * ulp_half[finite & ~rounds]).all()   # truncated
    # NaN and infinity pass through as hi, with lo = 0
    assert torch.equal(lo[~finite], torch.zeros_like(lo[~finite]))
    assert torch.equal(torch.isnan(hi), torch.isnan(w))


def test_split_tf32_rounds_ties_away_from_zero():
    one = np.float32(1.0).view(np.uint32)
    tie = np.array([one | 0x1000, one | 0x0FFF, one | 0x3000], np.uint32).view(np.float32)
    hi, lo = mlp.split_tf32(torch.from_numpy(np.concatenate([tie, -tie])))
    step = 2.0**-10
    assert hi.tolist() == [1 + step, 1.0, 1 + 2 * step, -(1 + step), -1.0, -(1 + 2 * step)]


@pytest.mark.parametrize("width", [32, 128, 256])
def test_w2_image_is_the_swizzled_split(width):
    w2 = torch.from_numpy(np.random.default_rng(width).standard_normal((width, width))
                          .astype(np.float32))
    img = mlp.w2_image(w2)
    assert img.shape == (width // 32, 2, width, 32) and img.is_contiguous()
    hi, lo = mlp.split_tf32(w2)
    n = np.arange(width)
    for kc in range(width // 32):
        for part, ref in ((0, hi), (1, lo)):
            for j in range(8):
                slot = j ^ (n % 8)          # 16-byte group j of row n sits at j ^ (n % 8)
                got = img[kc, part][n[:, None], slot[:, None] * 4 + np.arange(4)]
                assert torch.equal(got, ref[:, kc * 32 + 4 * j: kc * 32 + 4 * j + 4])


def _nets(width, obs_dim, act_dim, mu_param, seed, sigma_max=np.inf):
    """A flax VracerNet with seeded lecun-scale weights (non-zero heads and
    biases) and the port's float32 VracerNet loaded with the same weights."""
    jn = jnet.VracerNet(act_dim=act_dim, width=width, init_noise=0.3, mu_param=mu_param,
                        sigma_max=sigma_max)
    params = jn.init(jax.random.key(0), jnp.zeros((1, obs_dim)))
    rng = np.random.default_rng(seed)
    params = jax.tree.map(lambda a: jnp.asarray(
        rng.standard_normal(a.shape) / np.sqrt(a.shape[0] if a.ndim == 2 else 10.0),
        jnp.float64), params)
    tn = tnet.VracerNet(obs_dim, act_dim, width=width, init_noise=0.3, mu_param=mu_param,
                        sigma_max=sigma_max)
    state = {k: v.float() for k, v in tnet.params_from_flax(np_tree(params)).items()}
    tn.load_state_dict(state)
    return jn, params, tn


@pytest.mark.parametrize("mu_param", ["absolute", "sigma_relative"])
@pytest.mark.parametrize("width,obs_dim,act_dim", [(128, 3, 1), (256, 3, 1), (128, 32, 32),
                                                   (256, 32, 32)])
def test_3xtf32_forward_matches_flax_float64_and_tf32_does_not(width, obs_dim, act_dim,
                                                               mu_param):
    jn, params, tn = _nets(width, obs_dim, act_dim, mu_param, seed=width + obs_dim)
    obs = np.random.default_rng(1).standard_normal((300, obs_dim))
    ref = [np.asarray(o) for o in jn.apply(params, jnp.asarray(obs))]
    x = torch.from_numpy(obs.astype(np.float32))
    with torch.no_grad():
        three = [o.double().numpy() for o in mlp.mlp_forward_tf32(x, tn, products=3)]
        one = [o.double().numpy() for o in mlp.mlp_forward_tf32(x, tn, products=1)]
    err3 = max(np.abs(o - r).max() for o, r in zip(three, ref))
    err1 = max(np.abs(o - r).max() for o, r in zip(one, ref))
    assert err3 <= MLP_TOL, err3
    assert err1 > 5 * MLP_TOL, err1     # plain TF32: 10 mantissa bits are not enough


def _errors(jn, params, tn, obs, **products):
    ref = [np.asarray(o) for o in jn.apply(params, jnp.asarray(obs))]
    with torch.no_grad():
        got = mlp.mlp_forward_tf32(torch.from_numpy(obs.astype(np.float32)), tn, **products)
    return max(np.abs(o.double().numpy() - r).max() for o, r in zip(got, ref))


@pytest.mark.parametrize("mu_param", ["absolute", "sigma_relative"])
@pytest.mark.parametrize("width,obs_dim,act_dim", [(32, 256, 256), (128, 128, 128),
                                                   (256, 32, 16), (256, 256, 256)])
def test_wide_route_matches_flax_float64_and_tf32_layer1_and_heads_do_not(
        width, obs_dim, act_dim, mu_param):
    """The wide route's shapes (burger-fd, diffusion-simple, KS, obs 256 at
    width 256) under a sigma cap that some outputs reach: every product in
    3xTF32 is within the tolerance; plain TF32 in layer 1 and the heads alone
    (layer 2 still 3xTF32) is not."""
    assert mlp.wide_route(obs_dim)
    jn, params, tn = _nets(width, obs_dim, act_dim, mu_param, seed=width + obs_dim,
                           sigma_max=0.5)
    obs = np.random.default_rng(2).standard_normal((100, obs_dim))
    with torch.no_grad():
        sigma = mlp.mlp_forward_tf32(torch.from_numpy(obs.astype(np.float32)), tn)[2]
    assert (sigma == 0.5).any() and (sigma < 0.5).any()       # the cap acts on some
    err3 = _errors(jn, params, tn, obs)
    err1 = _errors(jn, params, tn, obs, wide_products=1)
    assert err3 <= MLP_TOL, err3
    assert err1 > 5 * MLP_TOL, err1


@pytest.mark.parametrize("act_dim", [1, 31, 32, 33, 256])
def test_head_matrix_is_the_heads_permuted(act_dim):
    """The wide route's head matrix holds every row of the three heads once,
    at the place the kernel's epilogue reads it (mu of slot s in tile s // 32,
    column s % 32; its sigma 32 columns on; the value head at slot A), and
    zeros elsewhere."""
    _, _, tn = _nets(64, 8, act_dim, "absolute", act_dim)
    weight, bias = mlp.head_matrix(tn)
    tiles = -(-(act_dim + 1) // 32)
    assert weight.shape == (tiles * mlp.HEAD_N, 64) and bias.shape == (tiles * mlp.HEAD_N,)
    mu_rows = [(s // 32) * 64 + s % 32 for s in range(act_dim)]
    sigma_rows = [r + 32 for r in mu_rows]
    v_row = (act_dim // 32) * 64 + act_dim % 32
    assert torch.equal(weight[mu_rows], tn.mu.weight) and torch.equal(bias[mu_rows], tn.mu.bias)
    assert torch.equal(weight[sigma_rows], tn.sigma.weight)
    assert torch.equal(bias[sigma_rows], tn.sigma.bias)
    assert torch.equal(weight[v_row], tn.value.weight[0]) and bias[v_row] == tn.value.bias[0]
    rest = sorted(set(range(len(weight))) - set(mu_rows) - set(sigma_rows) - {v_row})
    assert not weight[rest].any() and not bias[rest].any()


def test_route_boundary():
    """obs widths up to 4 take the narrow route, wider ones the wide route;
    the emulation follows: at obs 4 plain TF32 in layer 1 and the heads
    changes nothing (they are float32 there), at obs 5 it does."""
    assert [mlp.wide_route(d) for d in (1, 3, 4, 5, 6, 256)] == [False] * 3 + [True] * 3
    obs = {d: torch.from_numpy(np.random.default_rng(d).standard_normal((50, d))
                               .astype(np.float32)) for d in (4, 5)}
    with torch.no_grad():
        for d, changes in ((4, False), (5, True)):
            _, _, tn = _nets(64, d, 3, "absolute", d)
            three = mlp.mlp_forward_tf32(obs[d], tn)
            one = mlp.mlp_forward_tf32(obs[d], tn, wide_products=1)
            assert any(not torch.equal(a, b) for a, b in zip(three, one)) == changes


def test_forward_tf32_rejects_other_product_counts():
    _, _, tn = _nets(32, 3, 1, "absolute", 0)
    with pytest.raises(ValueError, match="1 or 3"):
        mlp.mlp_forward_tf32(torch.zeros(2, 3), tn, products=2)


def test_w2_image_is_rebuilt_when_w2_changes_in_place():
    """The wrapper's cache of the image follows W2's version counter, so an
    optimizer step or a load_state_dict between two calls is never missed."""
    _, _, tn = _nets(64, 3, 1, "absolute", 3)
    before = mlp.w2_splits
    first = mlp._cached_w2_image(tn)
    assert mlp._cached_w2_image(tn) is first and mlp.w2_splits == before + 1
    with torch.no_grad():
        tn.hidden[1].weight.add_(1.0)
    second = mlp._cached_w2_image(tn).clone()
    assert mlp.w2_splits == before + 2
    assert torch.equal(second, mlp.w2_image(tn.hidden[1].weight.detach()))
    opt = torch.optim.Adam(tn.parameters(), lr=0.1)
    tn(torch.ones(2, 3))[0].sum().backward()
    opt.step()
    assert not torch.equal(mlp._cached_w2_image(tn), second) and mlp.w2_splits == before + 3
    tn.load_state_dict({k: v.clone() for k, v in tn.state_dict().items()})
    mlp._cached_w2_image(tn)
    assert mlp.w2_splits == before + 4
