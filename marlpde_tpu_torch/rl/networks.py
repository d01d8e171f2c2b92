"""VRACER network: one MLP trunk emitting V(s), policy mean, and policy stddev
(port of marlpde_tpu/rl/networks.py).

Parity target: the korali function approximator configured by the reference
run scripts — 2 hidden Linear(width) + Tanh layers, Adam
(run-vracer-burger.py:175-190), with a single network for value + policy.
sigma is softplus(raw) scaled so that raw=0 gives the run script's "Initial
Exploration Noise" (run-vracer-burger.py:158).

Initialisation follows flax's defaults, not nn.Linear's: lecun-normal kernels
(a normal truncated at two standard deviations, rescaled to unit variance per
fan-in), zero biases, a zero sigma head, and a zero mu head under
``mu_param='sigma_relative'``.  ``params_from_flax`` loads a flax
``VracerNet`` parameter tree (as numpy) into this module.
"""

from __future__ import annotations

from collections import OrderedDict

import numpy as np
import torch
from torch import nn

# Gradient leak of the sigma ceiling: above the cap the backward pass sees
# this slope instead of zero, so sigma can come back below the cap; the
# forward value stays exactly min(sigma, cap) (networks.py:18-29).
SIGMA_CAP_LEAK = 0.05

# flax truncated-normal correction: stddev of a standard normal truncated to
# [-2, 2] (jax.nn.initializers.variance_scaling)
_TRUNC_STD = 0.87962566103423978


def leaky_sigma_cap(sigma, sigma_max, leak: float = SIGMA_CAP_LEAK):
    """Straight-through sigma ceiling: value = min(sigma, cap); gradient =
    identity below the cap, `leak` above it."""
    cap = sigma.new_tensor(sigma_max)
    over = torch.maximum(sigma - cap, torch.zeros_like(sigma))
    hard = torch.minimum(sigma, cap)
    leaky = hard + leak * over
    # forward evaluates to `hard`; gradient flows through `leaky`
    return leaky + (hard - leaky).detach()


class VracerNet(nn.Module):
    """Layers in flax's creation order: ``hidden.0..n_hidden-1`` are
    Dense_0..Dense_{n-1}, then ``value`` (Dense_n), ``mu`` (Dense_{n+1}) and
    ``sigma`` (Dense_{n+2}), as networks.py:79-81 fixes."""

    def __init__(self, obs_dim: int, act_dim: int, width: int = 128,
                 n_hidden: int = 2, init_noise: float = 0.1,
                 sigma_floor: float = 1e-5, mu_param: str = "absolute",
                 sigma_max: float = np.inf, dtype=torch.float32, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        if mu_param not in ("absolute", "sigma_relative"):
            raise ValueError(f"[networks] unknown mu_param {mu_param}")
        self.obs_dim, self.act_dim, self.width = obs_dim, act_dim, width
        self.n_hidden = n_hidden
        self.init_noise, self.sigma_floor = init_noise, sigma_floor
        self.mu_param, self.sigma_max = mu_param, sigma_max

        device = torch.device("cpu") if device is None else device

        def linear(n_in, n_out):
            return nn.utils.skip_init(nn.Linear, n_in, n_out, dtype=dtype, device=device)

        dims = [obs_dim] + [width] * n_hidden
        self.hidden = nn.ModuleList(linear(a, b) for a, b in zip(dims[:-1], dims[1:]))
        self.value = linear(width, 1)
        self.mu = linear(width, act_dim)
        self.sigma = linear(width, act_dim)
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None):
        zero_kernel = {self.sigma}
        if self.mu_param == "sigma_relative":
            zero_kernel.add(self.mu)
        for lin in (*self.hidden, self.value, self.mu, self.sigma):
            lin.bias.zero_()
            if lin in zero_kernel:
                lin.weight.zero_()
            else:
                # flax lecun_normal: truncated_normal(-2, 2) * sqrt(1/fan_in)/0.8796
                nn.init.trunc_normal_(lin.weight, 0.0, 1.0, -2.0, 2.0, generator=generator)
                lin.weight.mul_(float(np.sqrt(1.0 / lin.in_features)) / _TRUNC_STD)

    @property
    def sigma_scale(self) -> float:
        # softplus(0) = log 2, so raw=0 yields sigma = init_noise exactly
        return self.init_noise / float(np.log(2.0))

    def forward(self, obs):
        h = obs
        for lin in self.hidden:
            h = torch.tanh(lin(h))
        v = self.value(h)[..., 0]
        mu = self.mu(h)
        raw = self.sigma(h)
        # jax.nn.softplus is logaddexp(x, 0), also in its gradient at 0
        sigma = torch.logaddexp(raw, torch.zeros_like(raw)) * self.sigma_scale + self.sigma_floor
        if np.isfinite(self.sigma_max):
            sigma = leaky_sigma_cap(sigma, self.sigma_max)
        if self.mu_param == "sigma_relative":
            # mu (the Dense output above) is mu-in-sigma-units; rescale
            mu = mu * sigma.detach()
        return v, mu, sigma

    def layers(self):
        """The Linear layers in flax order (Dense_0, Dense_1, ...)."""
        return [*self.hidden, self.value, self.mu, self.sigma]


def _layer_names(n_hidden: int):
    return [f"hidden.{i}" for i in range(n_hidden)] + ["value", "mu", "sigma"]


def params_from_flax(tree) -> "OrderedDict[str, torch.Tensor]":
    """flax VracerNet params (``{'params': {'Dense_i': {'kernel', 'bias'}}}``,
    or the inner dict, leaves as numpy arrays) -> a ``VracerNet`` state_dict.
    Kernels ``(in, out)`` become weights ``(out, in)``."""
    p = tree["params"] if "params" in tree else tree
    dense = sorted(p, key=lambda s: int(s.split("_")[-1]))
    out = OrderedDict()
    for name, layer in zip(_layer_names(len(dense) - 3), dense):
        out[f"{name}.weight"] = torch.from_numpy(np.array(np.asarray(p[layer]["kernel"]).T))
        out[f"{name}.bias"] = torch.from_numpy(np.array(p[layer]["bias"]))
    return out


def params_to_flax(net: VracerNet) -> dict:
    """Inverse of ``params_from_flax``: a flax-layout tree of numpy arrays."""
    return {"params": {
        f"Dense_{i}": {"kernel": lin.weight.detach().cpu().numpy().T.copy(),
                       "bias": lin.bias.detach().cpu().numpy().copy()}
        for i, lin in enumerate(net.layers())}}
