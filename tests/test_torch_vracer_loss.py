"""The experience-mode loss head (rl/vracer_loss.py) on the CPU.

The entry points run the plain version on CPU tensors, and refuse a device
they have no kernel for rather than fall back to it.  ``loss_grads_by_hand``,
the CUDA kernel's arithmetic in torch, gives autograd's gradients of the plain
loss bit for bit: the same backward formulas, summed into mu and sigma in the
order of autograd's engine.  Shapes: the minibatch (rows x agents x actions)
of every experience-mode path of the port.  No JAX is imported; the card's
tests are in tests/test_torch_gpu.py.
"""

import numpy as np
import pytest
import torch

from marlpde_tpu_torch.rl import distributions as D
from marlpde_tpu_torch.rl import vracer
from marlpde_tpu_torch.rl import vracer_loss as VL

torch.set_num_threads(1)

# the experience-mode minibatches, (rows, agents, actions): run 918's and run
# 926's (the benchmark's cells), and those of the CLI's presets at mbsize
# 256: ks at --NA 16, burger-fd (256 actions), diffusion-simple and -error
# (128), advection-simple (64), diffusion-stencil3 (2), laplace (32 agents x
# 3) and coupled-burger (1); then the other ways torch sums a row
# (reduce_order): few rows, so that a row's sum is 64 and 128 lanes wide,
# rows that do not start on a 16-byte unit, and 130 agents
SHAPES = {"918": (8, 32, 1), "926": (256, 1, 32), "ks-na16": (256, 1, 16),
          "fd-a256": (256, 1, 256), "diffusion-a128": (256, 1, 128),
          "advection-a64": (256, 1, 64), "stencil3-a2": (256, 1, 2),
          "laplace": (256, 32, 3), "coupled-a1": (256, 1, 1),
          "few-rows-a256": (4, 2, 256), "few-rows-a1024": (3, 2, 1024),
          "unaligned-a130": (16, 1, 130), "agents-130": (6, 130, 1)}
SHAPE_ID = lambda s: f"run{s}" if s.isdigit() else s
CASES = {
    "forward": dict(trust_region="forward"),
    "jeffreys": dict(trust_region="jeffreys"),
    "jeffreys-dimnorm": dict(trust_region="jeffreys", cutoff_dim_norm=True),
    "forward-dimnorm": dict(trust_region="forward", cutoff_dim_norm=True),
    "correlation": dict(multi_agent_correlation=True, cutoff_dim_norm=True),
    "cooperation": dict(multi_agent_relationship="cooperation", value_coef=0.5),
}


def head_inputs(shape, seed, **cfg_kw):
    """(cfg, beta, out, rows, vtg_next, scale, cutoff, inv_cutoff): a
    minibatch with near- and far-policy rows (a third of the rows' behavior
    policies far from the current one), actions at both bounds, and one
    element whose (lb - mu) / sigma lies below -10 (fault F2's case: sigma
    1e-4 at the lower bound)."""
    n, na, A = shape
    cfg = vracer.VracerConfig(obs_dim=3, act_dim=A, num_agents=na, **cfg_kw)
    rng = np.random.default_rng(seed)
    mu = rng.standard_normal(shape) * 0.4
    sigma = rng.uniform(0.05, 0.6, shape)
    far = rng.random((n, 1, 1)) < 0.3
    near = 0.01 * min(1.0, np.sqrt(32 / A))   # a near row's joint ratio stays near 1
    mu_b = mu + rng.standard_normal(shape) * np.where(far, 0.5, near)
    sigma_b = sigma * np.where(far, rng.uniform(0.7, 1.4, shape),
                               rng.uniform(1 - near, 1 + near, shape))
    actions = np.clip(mu_b + sigma_b * rng.standard_normal(shape), -5.0, 5.0)
    flat = actions.reshape(-1)
    flat[rng.choice(flat.size, max(2, flat.size // 50), replace=False)] = -5.0
    flat[rng.choice(flat.size, max(2, flat.size // 50), replace=False)] = 5.0
    flat[0], mu.reshape(-1)[0], sigma.reshape(-1)[0] = -5.0, 0.3, 1e-4
    f = lambda x: torch.tensor(x, dtype=torch.float32)
    rows = dict(actions=f(actions), mu=f(mu_b), sigma=f(sigma_b),
                rewards=f(rng.standard_normal((n, na)) * 0.3))
    out = (f(rng.standard_normal((n, na))), f(mu), f(sigma))
    cutoff = f(4.0)
    return (cfg, f(0.3), out, rows, f(rng.standard_normal((n, na))), f(0.7), cutoff,
            torch.reciprocal(cutoff))


def _ndtr_ratio(x):
    """d log_ndtr(x) / dx as ``distributions._LogNdtr.backward`` forms it."""
    lower = D._LOG_NDTR_LOWER[x.dtype]
    ans = torch.where(x > lower, torch.special.log_ndtr(x),
                      D._log_ndtr_lower(torch.clamp(x, max=lower)))
    return torch.exp((-0.5 * (x * x) - D.LOG_SQRT_2PI) - ans)


def loss_grads_by_hand(cfg, beta, out, rows, vtg_next, scale, cutoff):
    """(dL/dV, dL/dmu, dL/dsigma) of ``loss_experience`` for a loss cotangent
    of 1, in the operations the CUDA kernel takes: autograd's backward
    formula of each forward operation, and the contributions to mu and sigma
    summed in the order autograd's engine delivers them (the node of the
    highest sequence number first: the reverse KL, the forward KL, then
    log_prob's upper tail, lower tail and density).  The oracle of the
    kernel's arithmetic: on one device it gives autograd's bits."""
    V, mu, sigma = (t.detach() for t in out)
    a, mu_b, sigma_b = rows["actions"], rows["mu"], rows["sigma"]
    lb, ub = cfg.action_low, cfg.action_high
    rho, _ = VL.joint_rho(cfg, a, mu, sigma, mu_b, sigma_b)
    near = (rho > torch.reciprocal(cutoff)) & (rho < cutoff)
    n_tot = float(rho.numel())
    one = torch.ones_like(beta)
    td = VL.rescale_rewards(cfg, rows["rewards"], scale) + cfg.gamma * vtg_next - V
    d = V - (V + torch.clamp(rho, max=1.0) * td)
    dV = one * cfg.value_coef / n_tot * 0.5 * (2.0 * d)
    pg_w = torch.minimum(rho, cutoff) * td * near
    gp = (-(one * beta / n_tot) * pg_w)[..., None].expand(a.shape)
    gk = one * (1.0 - beta) / n_tot * (~near).to(V.dtype)
    if cfg.trust_region == "jeffreys":
        gk = gk * 0.5
    gk = gk[..., None].expand(a.shape)
    zero = torch.zeros_like(a)
    lo, hi = a <= lb, a >= ub
    g_cdf, g_in = torch.where(lo, gp, zero), torch.where(lo, zero, gp)
    g_sf, g_pdf = torch.where(hi, g_in, zero), torch.where(hi, zero, g_in)
    z = (a - mu) / sigma
    sig_log = -g_pdf / sigma
    gz = g_pdf * (-0.5 * z) + g_pdf * z * -0.5
    sig_pdf = -gz * (z / sigma)
    mu_pdf = -(gz / sigma)
    xl = (lb - mu) / sigma
    gxl = g_cdf * _ndtr_ratio(xl)
    sig_lo = -gxl * (xl / sigma)
    mu_lo = -(gxl / sigma)
    vh = (ub - mu) / sigma
    gvh = -(g_sf * _ndtr_ratio(-vh))
    sig_hi = -gvh * (vh / sigma)
    mu_hi = -(gvh / sigma)
    ratio = sigma / sigma_b
    dm = mu - mu_b
    den = 2.0 * (sigma * sigma)
    fr = (sigma_b * sigma_b + dm ** 2) / den
    sig_kl = gk / ratio / sigma_b
    mu_kl = gk / den * (2.0 * dm)
    sig_var = -gk * (fr / den) * 2.0 * sigma
    if cfg.trust_region == "jeffreys":
        ratio_r = sigma_b / sigma
        g_num_r = gk / (2.0 * (sigma_b * sigma_b))
        sig_klr = -(gk / ratio_r) * (ratio_r / sigma)
        mu_klr = -(g_num_r * (2.0 * (mu_b - mu)))
        sig_var_r = g_num_r * sigma
        dmu = mu_klr + mu_kl + mu_hi + mu_lo + mu_pdf
        dsigma = (sig_klr + sig_var_r + sig_var_r + sig_kl + sig_var + sig_var + sig_hi + sig_lo
                  + sig_log + sig_pdf)
    else:
        dmu = mu_kl + mu_hi + mu_lo + mu_pdf
        dsigma = sig_kl + sig_var + sig_var + sig_hi + sig_lo + sig_log + sig_pdf
    return dV, dmu, dsigma


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("shape", sorted(SHAPES), ids=SHAPE_ID)
def test_by_hand_gradients_are_autograds_bits(shape, case):
    cfg, beta, out, rows, vtg_next, scale, cutoff, _ = head_inputs(SHAPES[shape], 7,
                                                                    **CASES[case])
    leaves = [t.clone().requires_grad_(True) for t in out]
    loss, metrics = VL.loss_experience(cfg, beta, leaves, rows, vtg_next, scale, cutoff)
    loss.backward()
    hand = loss_grads_by_hand(cfg, beta, out, rows, vtg_next, scale, cutoff)
    for name, leaf, h in zip(("V", "mu", "sigma"), leaves, hand):
        assert torch.isfinite(leaf.grad).all(), name
        assert torch.equal(leaf.grad, h), (name, (leaf.grad - h).abs().max().item())
    # the inputs reach every branch: near and far rows, both bounds, the F2 element
    assert 0.0 < float(metrics["frac_far"]) < 1.0
    a = rows["actions"]
    assert (a <= -5.0).any() and (a >= 5.0).any()
    assert float((-5.0 - out[1].reshape(-1)[0]) / out[2].reshape(-1)[0]) < -10.0


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("shape", sorted(SHAPES), ids=SHAPE_ID)
def test_the_entry_points_run_the_plain_version_on_the_cpu(shape, case):
    cfg, beta, out, rows, vtg_next, scale, cutoff, inv_cutoff = head_inputs(
        SHAPES[shape], 3, **CASES[case])
    before = VL.launches
    rho, off, terms = VL.rho_terms(cfg, rows, out[1], out[2], scale, cutoff, inv_cutoff)
    want, _ = VL.joint_rho(cfg, rows["actions"], out[1], out[2], rows["mu"], rows["sigma"])
    assert torch.equal(rho, want) and rho.shape == SHAPES[shape][:2]
    assert torch.equal(off, ~((want > inv_cutoff) & (want < cutoff)))
    assert terms.rho is None and terms.scale is scale and terms.cutoff is cutoff
    metrics, ((loss,), cotangents) = VL.experience_loss(cfg, beta, out, rows, vtg_next, terms)
    want_loss, want_metrics = VL.loss_experience(cfg, beta, out, rows, vtg_next, scale, cutoff)
    assert torch.equal(loss, want_loss) and cotangents is None
    assert list(metrics) == list(VL.METRICS)
    assert all(torch.equal(metrics[k], want_metrics[k]) for k in VL.METRICS)
    assert VL.launches == before


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_the_card_path_raises_rather_than_falling_back(no_card):
    """Tensors on a device with no kernel (here ``meta``) take the card's
    path, which raises: neither entry point computes the plain version."""
    cfg, beta, out, rows, vtg_next, scale, cutoff, inv_cutoff = head_inputs(SHAPES["918"], 1)
    meta = lambda t: t.to("meta")
    rows_m = {k: meta(v) for k, v in rows.items()}
    out_m = tuple(meta(t) for t in out)
    before = VL.launches
    with pytest.raises(ValueError, match="no kernel for device meta"):
        VL.rho_terms(cfg, rows_m, out_m[1], out_m[2], meta(scale), meta(cutoff),
                     meta(inv_cutoff))
    terms = VL.Terms(meta(scale), meta(cutoff))
    with pytest.raises(ValueError, match="no kernel for device meta"):
        VL.experience_loss(cfg, meta(beta), out_m, rows_m, meta(vtg_next), terms)
    assert VL.launches == before


@pytest.mark.parametrize("A,G", [(1, 1), (2, 2), (3, 2), (8, 8), (24, 16), (32, 32),
                                 (33, 32), (256, 32)])
def test_lanes_follow_the_action_count(A, G):
    """A group of G lanes an agent, G the largest power of two <= min(A, 32),
    so that each lane's strided sum and the butterfly take torch's order."""
    assert VL.lanes(A) == G


@pytest.mark.parametrize("rows,m,vec,width", [
    (256, 1, 0, 1), (256, 16, 0, 16), (8, 32, 0, 32), (1, 33, 0, 32), (1, 64, 0, 64),
    (8, 96, 0, 64), (256, 127, 0, 32), (256, 128, 1, 32), (1, 128, 1, 32), (8, 256, 1, 64),
    (8192, 256, 1, 32), (2, 512, 1, 128), (1, 1024, 1, 256), (16, 130, 1, 32),
])
def test_reduce_order_is_torchs(rows, m, vec, width):
    """torch's CUDA sum over a contiguous last axis (the orders measured on an
    H100 with torch 2.11, 1 to 8192 rows of 33 to 1024 entries): float4 loads
    from 128 entries on, and its lanes a row; the kernels' group is a warp's
    share of them."""
    assert VL.reduce_order(rows, m) == (vec, width)
    assert VL.lanes(m) == min(width, 32)


@pytest.mark.parametrize("shape,rho_plan,loss_blocks", [
    ((8, 32, 1), (8, 1, 1), 1),          # run 918: one block of 256 agents
    ((256, 1, 32), (8, 1, 32), 32),      # run 926: a warp a row, 8 rows a block
    ((256, 32, 1), (8, 1, 32), 32),      # mbsize 256 at 32 agents
    ((3, 512, 1), (1, 2, 3), 6),         # more agents than threads: two passes a row
    ((5, 4, 128), (2, 1, 3), 3),         # 128 actions: a warp an agent, 4 actions a lane
])
def test_launch_plan(shape, rho_plan, loss_blocks):
    n, na, A = shape
    assert VL.rho_plan(n, na, A) == rho_plan
    assert VL.loss_blocks(n * na, A) == loss_blocks


def test_update_experience_calls_the_loss_head(monkeypatch):
    """Every experience-mode update takes its rho through ``rho_terms`` and
    its loss through ``experience_loss``, in that order, on the same rows."""
    from marlpde_tpu_torch.rl import replay_flat
    cfg = vracer.VracerConfig(obs_dim=3, act_dim=1, num_agents=4, episode_length=20, width=8,
                              mini_batch_size=6, replay_max_experiences=64,
                              replay_episode_capacity=8, minibatch_mode="experience")
    rng = np.random.default_rng(0)
    B, T, na = 4, 20, 4
    batch = dict(obs=rng.standard_normal((B, T, na, 3)), actions=rng.standard_normal((B, T, na, 1)),
                 mu=rng.standard_normal((B, T, na, 1)) * 0.3,
                 sigma=rng.uniform(0.05, 0.3, (B, T, na, 1)),
                 rewards=rng.standard_normal((B, T, na)) * 0.05,
                 mask=np.ones((B, T), np.float32), final_obs=rng.standard_normal((B, na, 3)),
                 truncated=np.zeros(B, bool))
    tb = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
    tb = {k: (v.float() if v.is_floating_point() else v) for k, v in tb.items()}
    ts = vracer.init_train(cfg, torch.Generator().manual_seed(0))
    ts = vracer.observe_episodes(cfg, ts, tb)
    rep = vracer.flat_insert(cfg, ts, replay_flat.init_flat(64, 8, na, 3, 1), tb)
    calls = []
    for name in ("rho_terms", "experience_loss"):
        def spy(*a, _fn=getattr(VL, name), _name=name, **kw):
            calls.append((_name, a[1] if _name == "rho_terms" else a[3]))
            return _fn(*a, **kw)
        monkeypatch.setattr(VL, name, spy)
    _, _, metrics = vracer.update_experience(cfg, ts, rep, torch.Generator().manual_seed(1))
    assert [c[0] for c in calls] == ["rho_terms", "experience_loss"]
    assert calls[0][1] is calls[1][1]
    assert set(VL.METRICS) <= set(metrics) and torch.isfinite(metrics["loss"])
