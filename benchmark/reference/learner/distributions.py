"""Frozen copy of marlpde_tpu_torch/rl/distributions.py at the commit that added the
benchmark, the plain version the reference follows: it imports nothing of
the port.  The original docstring follows.

Clipped-Normal policy distribution (korali's "Clipped Normal",
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


# below this argument jax.scipy.special.log_ndtr takes its asymptotic series,
# per dtype
_LOG_NDTR_LOWER = {torch.float32: -10.0, torch.float64: -20.0}


def _log_ndtr_lower(x):
    """log ndtr(x) for x << -1 by the asymptotic series of order 3, in the
    operations of jax.scipy.special's ``_log_ndtr_lower``."""
    x_2 = x * x
    x_4 = x_2 * x_2
    log_scale = -0.5 * x_2 - torch.log(-x) - LOG_SQRT_2PI
    odd_sum = 1.0 / x_2 + 15.0 / (x_4 * x_2)
    even_sum = 3.0 / x_4
    return log_scale + torch.log(1.0 + even_sum - odd_sum)


class _LogNdtr(torch.autograd.Function):
    """log Phi(x) with the derivative jax.scipy.special.log_ndtr defines,
    exp(norm.logpdf(x) - log_ndtr(x)), where its log_ndtr below the lower
    segment is the asymptotic series (``_log_ndtr_lower``), whose leading
    -x^2/2 rounds as norm.logpdf's does, so the difference stays small and
    the derivative finite.  ``torch.special.log_ndtr``'s own backward,
    exp(-(log_ndtr(x) + x^2/2)), takes the difference of two numbers of size
    x^2/2 rounded apart: beyond |x| ~ 3e4 in float32 it returns 0 or inf, and
    ``log_prob``'s unselected tail then multiplies its zero cotangent by inf,
    which is NaN in the gradient (fault F2).  The value is
    torch.special.log_ndtr's."""

    @staticmethod
    def forward(ctx, x):
        ans = torch.special.log_ndtr(x)
        ctx.save_for_backward(x, ans)
        return ans

    @staticmethod
    def backward(ctx, grad):
        x, ans = ctx.saved_tensors
        lower = _LOG_NDTR_LOWER[x.dtype]
        ans = torch.where(x > lower, ans, _log_ndtr_lower(torch.clamp(x, max=lower)))
        return grad * torch.exp((-0.5 * (x * x) - LOG_SQRT_2PI) - ans)


def log_ndtr(x):
    return _LogNdtr.apply(x)


def log_prob(a, mu, sigma, lb, ub):
    """Per-dimension log density/mass of the clipped normal."""
    z = (a - mu) / sigma
    log_pdf = -0.5 * z * z - torch.log(sigma) - LOG_SQRT_2PI
    log_cdf_lo = log_ndtr((lb - mu) / sigma)
    log_sf_hi = log_ndtr(-((ub - mu) / sigma))
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
