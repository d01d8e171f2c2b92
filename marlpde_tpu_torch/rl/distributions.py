"""Clipped-Normal policy distribution (korali's "Clipped Normal",
run-vracer-burger.py:169); port of marlpde_tpu/rl/distributions.py.

A normal N(mu, sigma) whose samples are clipped to [lb, ub]; the density has
point masses Phi((lb-mu)/sigma) and 1-Phi((ub-mu)/sigma) at the bounds.
Log-probabilities, sampling, and the normal KL (used for the REFER
far-policy penalization) are all elementwise over action dims.
"""

from __future__ import annotations

import numpy as np
import torch

LOG_SQRT_2PI = float(0.5 * np.log(2.0 * np.pi))


def sample_from_noise(noise, mu, sigma, lb, ub):
    """The clipped-normal sample for given standard-normal ``noise``."""
    return torch.clamp(mu + sigma * noise, lb, ub)


def sample(generator, mu, sigma, lb, ub):
    noise = torch.randn(mu.shape, generator=generator, dtype=mu.dtype, device=mu.device)
    return sample_from_noise(noise, mu, sigma, lb, ub)


def log_prob(a, mu, sigma, lb, ub):
    """Per-dimension log density/mass of the clipped normal."""
    z = (a - mu) / sigma
    log_pdf = -0.5 * z * z - torch.log(sigma) - LOG_SQRT_2PI
    log_cdf_lo = torch.special.log_ndtr((lb - mu) / sigma)
    log_sf_hi = torch.special.log_ndtr(-((ub - mu) / sigma))
    return torch.where(a <= lb, log_cdf_lo, torch.where(a >= ub, log_sf_hi, log_pdf))


def joint_log_prob(a, mu, sigma, lb, ub):
    """Summed over the trailing action-dim axis."""
    return log_prob(a, mu, sigma, lb, ub).sum(-1)


def kl_normal(mu_b, sigma_b, mu, sigma):
    """KL(N(mu_b, sigma_b) || N(mu, sigma)), summed over trailing axis."""
    var_b = sigma_b * sigma_b
    var = sigma * sigma
    kl = torch.log(sigma / sigma_b) + (var_b + (mu - mu_b) ** 2) / (2.0 * var) - 0.5
    return kl.sum(-1)


def kl_jeffreys(mu_b, sigma_b, mu, sigma):
    """Symmetrized (Jeffreys) KL between behavior and current policy; see
    marlpde_tpu/rl/distributions.py:51-65 for why it replaces the paper's
    forward KL by default."""
    return 0.5 * (kl_normal(mu_b, sigma_b, mu, sigma)
                  + kl_normal(mu, sigma, mu_b, sigma_b))
