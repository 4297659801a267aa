"""Log-density kernels used by the parametric log-posterior, in torch.

Counterparts of the densities of ``stan4bart_tpu/models/dists.py``, with
normalizing constants, so ``lp__`` is comparable to Stan's; the default
model's gamma / beta / exponential prior terms are written out in
``ParametricModel._prior_lp`` with their constants summed once, and the
other prior families call the functions below.  Every function sums
over the LAST dimension only: ``x`` of shape (C, k) gives one
log-density per chain (C,).  Parameters are Python
floats or tensors that broadcast against ``x``; a Python float stays on
the host (no device tensor is made for it).
"""

from __future__ import annotations

import math

import torch

_LOG_SQRT_2PI = 0.9189385332046727417803297364056176


def _log(v):
    return math.log(v) if isinstance(v, (int, float)) else torch.log(v)


def _lgamma(v):
    return math.lgamma(v) if isinstance(v, (int, float)) else torch.lgamma(v)


def normal_lpdf(x, mu=0.0, sigma=1.0):
    z = (x - mu) / sigma
    return torch.sum(-0.5 * z * z - _log(sigma) - _LOG_SQRT_2PI, -1)


def student_t_lpdf(x, nu, mu=0.0, sigma=1.0):
    z = (x - mu) / sigma
    half_nup1 = 0.5 * (nu + 1.0)
    return torch.sum(
        _lgamma(half_nup1) - _lgamma(0.5 * nu)
        - 0.5 * _log(nu * math.pi) - _log(sigma)
        - half_nup1 * torch.log1p(z * z / nu), -1)


def exponential_lpdf(x, rate=1.0):
    return torch.sum(_log(rate) - rate * x, -1)


def gamma_lpdf(x, alpha, beta=1.0):
    return torch.sum(
        alpha * _log(beta) - _lgamma(alpha)
        + (alpha - 1.0) * torch.log(x) - beta * x, -1)


def inv_gamma_lpdf(x, alpha, beta):
    return torch.sum(
        alpha * _log(beta) - _lgamma(alpha)
        - (alpha + 1.0) * torch.log(x) - beta / x, -1)


def beta_lpdf(x, a, b):
    return torch.sum(
        _lgamma(a + b) - _lgamma(a) - _lgamma(b)
        + (a - 1.0) * torch.log(x) + (b - 1.0) * torch.log1p(-x), -1)


def chi_square_lpdf(x, nu):
    half_nu = 0.5 * nu
    return torch.sum(
        -half_nu * math.log(2.0) - _lgamma(half_nu)
        + (half_nu - 1.0) * torch.log(x) - 0.5 * x, -1)
