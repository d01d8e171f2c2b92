"""The experience-mode VRACER loss head: everything between the network's
``(V, mu, sigma)`` on a minibatch of experiences and dL/dV, dL/dmu, dL/dsigma
(rl/vracer.py:update_experience), as the CUDA kernels
``csrc/vracer_loss.cu`` and their plain version.  Two entry points, called in
turn by every experience-mode update:

  ``rho_terms``        ahead of the metadata refresh, on the detached
                       outputs: the importance weights rho and their
                       off-policy flags;
  ``experience_loss``  after the retrace refresh, on the attached outputs:
                       the loss's metrics, and what
                       ``torch.autograd.backward`` takes to carry its
                       gradient into the module.

On CPU tensors they run the plain version (``joint_rho``,
``loss_experience``: autograd differentiates it).  On CUDA tensors they
launch the kernels or raise, one launch each: ``rho_terms`` both policies'
joint log densities, rho, the flags, and the rescaled rewards the loss
reads; ``experience_loss`` the loss, its metrics and its gradients in
(V, mu, sigma).  The tensors' device alone picks between them.  The kernels
follow the plain version's float32 operations element by element.
"""

from __future__ import annotations

import ctypes
import dataclasses
from functools import lru_cache

import numpy as np
import torch

from marlpde_tpu_torch.kernels import build
from marlpde_tpu_torch.rl import distributions as D
from marlpde_tpu_torch.rl import running_stats
from marlpde_tpu_torch.utils import profiling

# kernel launches since the last reset; incremented only where a CUDA kernel
# is launched (the tracer also counts them by shape: launches/vracer_loss
# <rows>x<agents>x<actions>), two an update
launches = 0

THREADS = 256       # csrc/vracer_loss.cu THREADS
ROW_TERMS = 6       # csrc/vracer_loss.cu ROW_TERMS: the loss's terms an agent-row
NSUM = 2            # csrc/vracer_loss.cu NSUM: the block partial sums
SMEM_LIMIT = 48 * 1024
METRICS = ("loss", "v_loss", "pg_loss", "kl_loss", "frac_far", "mean_rho", "mean_sigma",
           "mean_mu", "mean_V")


# ---------------------------------------------------------------- plain version

def joint_dims(cfg) -> int:
    return cfg.act_dim * (cfg.num_agents if (cfg.multi_agent_correlation
                                             and cfg.num_agents > 1) else 1)


def rho_temper(cfg) -> float:
    """Exponent applied to the joint importance weight under cutoff_dim_norm
    (vracer.py:217-223); 1.0 otherwise."""
    if not cfg.cutoff_dim_norm:
        return 1.0
    return 1.0 / float(np.sqrt(joint_dims(cfg)))


def trust_kl(cfg, mu_b, sigma_b, mu, sigma):
    if cfg.trust_region == "jeffreys":
        return D.kl_jeffreys(mu_b, sigma_b, mu, sigma)
    return D.kl_normal(mu_b, sigma_b, mu, sigma)


def rescale_rewards(cfg, rewards, scale):
    """Floor, divide by the reward-rescaling sigma, bound in scaled units, and
    pool to the team mean under Cooperation (vracer.py:479-487).  Rewards read
    from the float32 replay divide by a float64 scale in float64, as in JAX
    (``running_stats.promoted``)."""
    rewards = torch.clamp(running_stats.promoted(rewards, scale), min=cfg.reward_floor) / scale
    rewards = torch.clamp(rewards, min=cfg.scaled_reward_floor)
    if cfg.multi_agent_relationship == "cooperation":
        rewards = rewards.mean(-1, keepdim=True).expand(rewards.shape)
    return rewards


def joint_rho(cfg, actions, mu, sigma, mu_b, sigma_b):
    """Importance weight pi_cur/pi_behavior per (.., na) and log pi_cur; with
    Multi Agent Correlation the product over agents is shared."""
    logp = D.joint_log_prob(actions, mu, sigma, cfg.action_low, cfg.action_high)
    logp_b = D.joint_log_prob(actions, mu_b, sigma_b, cfg.action_low, cfg.action_high)
    log_ratio = logp - logp_b
    if cfg.multi_agent_correlation and cfg.num_agents > 1:
        log_ratio = log_ratio.sum(-1, keepdim=True).expand(log_ratio.shape)
    log_ratio = torch.clamp(log_ratio * rho_temper(cfg), -20.0, 20.0)
    return torch.exp(log_ratio), logp


def loss_experience(cfg, beta, out, rows, vtg_next, scale, cutoff):
    """korali VRACER loss over n iid sampled experiences (vracer.py:550-580).
    ``out`` = (V, mu, sigma), the module's forward on the rows' prepared
    observations, still attached to the graph: the one-step value target runs
    through the just-refreshed retrace value of the successor, and the REFER
    near/far split weighs the policy terms.  ``cutoff`` is a 0-d float32
    tensor, and 1/cutoff is taken in float32 too, as JAX does."""
    V, mu, sigma = out                                                # (n, na[, A])
    rewards = rescale_rewards(cfg, rows["rewards"], scale)
    rho, logp = joint_rho(cfg, rows["actions"], mu, sigma, rows["mu"], rows["sigma"])
    near = (rho > torch.reciprocal(cutoff)) & (rho < cutoff)

    rho_bar = torch.clamp(rho, max=1.0).detach()
    Vsg = V.detach()
    td = rewards + cfg.gamma * vtg_next - Vsg
    vtarget = Vsg + rho_bar * td
    adv = td

    n_tot = float(rho.numel())
    v_loss = 0.5 * torch.sum((V - vtarget) ** 2) / n_tot
    pg_w = (torch.minimum(rho, cutoff.to(rho.dtype)) * adv * near).detach()
    pg_loss = -torch.sum(pg_w * logp) / n_tot
    kl = trust_kl(cfg, rows["mu"], rows["sigma"], mu, sigma)
    far = (~near).to(kl.dtype)
    kl_loss = torch.sum(far * kl) / n_tot

    loss = cfg.value_coef * v_loss + beta * pg_loss + (1.0 - beta) * kl_loss
    metrics = dict(loss=loss, v_loss=v_loss, pg_loss=pg_loss, kl_loss=kl_loss,
                   frac_far=far.mean(), mean_rho=rho.mean(), mean_sigma=sigma.mean(),
                   mean_mu=mu.mean(), mean_V=V.mean())
    return loss, {k: v.detach() for k, v in metrics.items()}


# ---------------------------------------------------------------- the kernels

@dataclasses.dataclass
class Terms:
    """What ``experience_loss`` reads of its update's ``rho_terms``: the
    reward scale and the cutoff, and on the card the rho kernel's outputs
    (rho, the current policy's joint log density, the rescaled rewards) and
    the ticket it zeroes for the loss kernel's last block."""

    scale: torch.Tensor
    cutoff: torch.Tensor
    rho: torch.Tensor | None = None
    logp: torch.Tensor | None = None
    rewards: torch.Tensor | None = None
    ticket: torch.Tensor | None = None


def lanes(A: int) -> int:
    """Lanes that share one agent's actions (csrc/vracer_loss.cu's G): the
    largest power of two <= min(A, 32), a warp's share of torch's own CUDA
    reduction over A entries (``reduce_order``); 32 // lanes agents share a
    warp."""
    return 1 << (min(A, 32).bit_length() - 1)


def reduce_order(rows: int, m: int) -> tuple[int, int]:
    """(vec, width) of torch's CUDA sum over the contiguous last axis of a
    (rows, m) float32 tensor, which csrc/vracer_loss.cu's Order follows:
    float4 loads from 128 entries on, and the lanes a row, as ATen's
    Reduce.cuh sets its block (at most 512 threads, a warp wide, as many rows
    as fit, then as wide as the rest allow).  Measured on the card, torch
    2.11: 1 to 8192 rows of 33 to 1024 entries."""
    pow2 = lambda x: 1 << (x.bit_length() - 1)
    vec = int(m >= 128)
    dim0 = m // 4 if vec else m
    d0 = pow2(dim0) if dim0 < 512 else 512
    d1 = pow2(rows) if rows < 512 else 512
    height = min(d1, 512 // min(d0, 32))
    return vec, min(d0, 512 // height)


def rho_plan(n: int, na: int, A: int) -> tuple[int, int, int]:
    """(rows a block, passes, blocks) of the rho kernel: a block takes whole
    rows, as many as fill its THREADS // lanes(A) agent groups (at least
    one), in as many passes as its agents need."""
    per_pass = THREADS // lanes(A)
    rows = max(1, per_pass // na)
    return rows, -(-rows * na // per_pass), -(-n // rows)


def loss_blocks(nr: int, A: int) -> int:
    """Blocks of the loss kernel: THREADS // lanes(A) agent-rows a block."""
    return -(-nr // (THREADS // lanes(A)))


@lru_cache(maxsize=None)
def _library():
    lib = build.load("vracer_loss")
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.vracer_rho.argtypes = [ptr] * 14 + [i32] * 12 + [f32] * 6 + [ptr]
    lib.vracer_rho.restype = ctypes.c_int
    lib.vracer_loss.argtypes = [ptr] * 19 + [i32] * 9 + [f32] * 7 + [ptr]
    lib.vracer_loss.restype = ctypes.c_int
    lib.error_string.argtypes = [ctypes.c_int]
    lib.error_string.restype = ctypes.c_char_p
    return lib


def _check(op: str, like: torch.Tensor, **tensors):
    """Raise unless every tensor lies on ``like``'s CUDA device as contiguous
    float32 of the shape given beside it: name=(tensor, shape)."""
    if like.device.type != "cuda":
        raise ValueError(f"{op}: no kernel for device {like.device}")
    for name, (t, shape) in tensors.items():
        if t.dtype != torch.float32:
            raise TypeError(f"{op}: the CUDA kernel takes float32; {name} is {t.dtype}")
        if t.device != like.device or tuple(t.shape) != tuple(shape):
            raise ValueError(f"{op}: {name} is {tuple(t.shape)} on {t.device}; expected "
                             f"{tuple(shape)} on {like.device}")
        if not t.is_contiguous():
            raise ValueError(f"{op}: {name} is not contiguous")


def _raise_on(op: str, status: int):
    if status != 0:
        raise RuntimeError(f"{op}: launch failed: "
                           f"{_library().error_string(status).decode()} ({status})")


def _launched(shape):
    global launches
    launches += 1
    profiling.count("launches/vracer_loss " + "x".join(map(str, shape)))


def rho_terms(cfg, rows, mu, sigma, scale, cutoff, inv_cutoff):
    """(rho, off, terms) of the current policy ``(mu, sigma)`` (detached,
    (n, na, A)) on the gathered ``rows``: the importance weights (n, na), the
    off-policy flags ~(1/cutoff < rho < cutoff), and the ``Terms`` that this
    update's ``experience_loss`` reads."""
    if mu.device.type == "cpu":
        rho, _ = joint_rho(cfg, rows["actions"], mu, sigma, rows["mu"], rows["sigma"])
        return rho, ~((rho > inv_cutoff) & (rho < cutoff)), Terms(scale, cutoff)
    n, na, A = mu.shape
    _check("rho_terms", mu, mu=(mu, (n, na, A)), sigma=(sigma, (n, na, A)),
           actions=(rows["actions"], (n, na, A)), mu_b=(rows["mu"], (n, na, A)),
           sigma_b=(rows["sigma"], (n, na, A)), rewards=(rows["rewards"], (n, na)),
           scale=(scale, ()), cutoff=(cutoff, ()), inv_cutoff=(inv_cutoff, ()))
    rows_per_block, passes, blocks = rho_plan(n, na, A)
    if 2 * 4 * rows_per_block * na > SMEM_LIMIT:
        raise ValueError(f"rho_terms: the CUDA kernel takes up to "
                         f"{SMEM_LIMIT // 8} agents, got {na}")
    rho = torch.empty((n, na), dtype=torch.float32, device=mu.device)
    off = torch.empty((n, na), dtype=torch.bool, device=mu.device)
    logp, rewards = torch.empty_like(rho), torch.empty_like(rho)
    ticket = torch.empty(1, dtype=torch.int32, device=mu.device)
    mac = cfg.multi_agent_correlation and na > 1
    coop = cfg.multi_agent_relationship == "cooperation"
    f32 = np.float32
    with torch.cuda.device(mu.device):
        status = _library().vracer_rho(
            *(t.data_ptr() for t in (rows["actions"], mu, sigma, rows["mu"], rows["sigma"],
                                     rows["rewards"], scale, cutoff, inv_cutoff, rho, off,
                                     logp, rewards, ticket)),
            n, na, A, lanes(A), rows_per_block, passes, int(mac), int(coop),
            *reduce_order(n * na, A), *reduce_order(n, na),
            float(f32(cfg.action_low)), float(f32(cfg.action_high)),
            float(f32(rho_temper(cfg))), float(f32(cfg.reward_floor)),
            float(f32(cfg.scaled_reward_floor)), float(f32(n) / f32(n * na)),
            torch.cuda.current_stream().cuda_stream)
    _raise_on("rho_terms", status)
    _launched((n, na, A))
    return rho, off, Terms(scale, cutoff, rho, logp, rewards, ticket)


def experience_loss(cfg, beta, out, rows, vtg_next, terms: Terms):
    """(metrics, backward) of ``loss_experience`` on ``out`` = (V, mu, sigma),
    still attached; ``terms`` from this update's ``rho_terms``; ``beta`` the
    0-d REFER beta.  ``torch.autograd.backward(*backward)`` carries the
    loss's gradient into whatever ``out`` was computed from: on the CPU
    ``backward`` is ((loss,), None), autograd differentiating the plain
    version; on the card ((V, mu, sigma), (dL/dV, dL/dmu, dL/dsigma)), which
    the kernel computes with the loss."""
    V, mu, sigma = out
    if V.device.type == "cpu":
        loss, metrics = loss_experience(cfg, beta, out, rows, vtg_next, terms.scale, terms.cutoff)
        return metrics, ((loss,), None)
    n, na, A = mu.shape
    _check("experience_loss", V, V=(V, (n, na)), mu=(mu, (n, na, A)), sigma=(sigma, (n, na, A)),
           actions=(rows["actions"], (n, na, A)), mu_b=(rows["mu"], (n, na, A)),
           sigma_b=(rows["sigma"], (n, na, A)), vtg_next=(vtg_next, (n, na)),
           beta=(beta, ()), cutoff=(terms.cutoff, ()))
    if terms.rho is None or terms.rho.shape != (n, na) or terms.rho.device != V.device:
        raise ValueError("experience_loss: terms from rho_terms on the card, of these rows")
    nr = n * na
    blocks = loss_blocks(nr, A)
    grads = tuple(torch.empty_like(t) for t in out)
    row_terms = torch.empty((ROW_TERMS, nr), dtype=torch.float32, device=V.device)
    partials = torch.empty((blocks, NSUM), dtype=torch.float32, device=V.device)
    metrics = torch.empty(len(METRICS), dtype=torch.float32, device=V.device)
    f32 = np.float32
    with torch.cuda.device(V.device):
        status = _library().vracer_loss(
            *(t.data_ptr() for t in (V, mu, sigma, rows["actions"], rows["mu"], rows["sigma"],
                                     terms.rho, terms.logp, terms.rewards, vtg_next,
                                     terms.cutoff, beta, *grads, row_terms, partials, metrics,
                                     terms.ticket)),
            nr, A, lanes(A), blocks, int(cfg.trust_region == "jeffreys"), *reduce_order(nr, A),
            *reduce_order(1, nr),
            float(f32(cfg.action_low)), float(f32(cfg.action_high)), float(f32(cfg.gamma)),
            float(f32(cfg.value_coef)), float(f32(1) / f32(nr)), float(f32(1) / f32(nr)),
            float(f32(1) / f32(nr * A)), torch.cuda.current_stream().cuda_stream)
    _raise_on("experience_loss", status)
    _launched((n, na, A))
    return dict(zip(METRICS, metrics.unbind())), (tuple(out), grads)
