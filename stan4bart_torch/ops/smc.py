"""Tempered SMC sampler over any unconstrained log-density.

Counterpart of ``stan4bart_tpu/ops/smc.py`` (adaptive tempering in the
style of Del Moral et al. 2006):

* geometric bridge  log pi_t(u) = (1 - t) log N(u; 0, I) + t logp(u);
* next temperature by bisection, so that the incremental-weight ESS stays
  near ``target_ess_frac * n_particles``;
* systematic resampling;
* rejuvenation by a few HMC steps targeting pi_t, with a stepsize scaled
  from the particle cloud's spread.

The particles are the batch axis of one log-density call: ``logdensity_fn``
maps (n, P) points to (n,) values, and HMC gradients are autograd of their
sum (the particles are independent).  The tempering loop runs on the host
with one synchronization per stage (the ``t < 1`` test); the bisection is
a fixed number of steps on the device, on the stage's one log-density
evaluation.  The generator is drawn in a fixed order: the initial
particles, then per stage the resampling uniform and, per HMC step, the
momenta and the acceptance uniforms.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

from stan4bart_torch.ops.nuts import value_and_grad
from stan4bart_torch.utils.device import check_generator, resolve_device


class SmcResult(NamedTuple):
    particles: torch.Tensor     # (n_particles, P)
    log_evidence: torch.Tensor  # estimate of the log normalizing-constant ratio
    n_stages: int
    final_temp: torch.Tensor


def _log_base(u):
    return -0.5 * (u * u).sum(-1)


def _ess_from_logw(logw):
    logw = logw - torch.logsumexp(logw, 0)
    return torch.exp(-torch.logsumexp(2.0 * logw, 0))


def _systematic_resample(gen, logw, n, u=None):
    """Indices of ``n`` systematic draws from the weights exp(logw); ``u``
    an optional uniform replacing the draw.  An index past the last
    particle (the cumulative sum rounding below 1) takes the last one, as
    the JAX package's clamped gather does."""
    logw = logw - torch.logsumexp(logw, 0)
    if u is None:
        u = torch.rand((), generator=gen, dtype=logw.dtype,
                       device=logw.device)
    positions = (u + torch.arange(n, dtype=logw.dtype,
                                  device=logw.device)) / n
    cum = torch.cumsum(torch.exp(logw), 0)
    return torch.searchsorted(cum, positions).clamp(max=n - 1)


def _next_temp(ll, t, target, bisect_iters):
    """The largest t' in (t, 1] whose incremental weights (t' - t) ll keep
    an ESS >= target, by ``bisect_iters`` bisection steps; ll is
    logp(u) - log_base(u) of every particle."""
    one = torch.ones_like(t)

    def ess_at(t_new):
        return _ess_from_logw((t_new - t) * ll)

    full = ess_at(one) >= target
    lo, hi = t, one
    for _ in range(bisect_iters):
        mid = 0.5 * (lo + hi)
        ok = ess_at(mid) >= target
        lo, hi = torch.where(ok, mid, lo), torch.where(ok, hi, mid)
    return torch.where(full, one, lo)


def smc_sample(
    logdensity_fn: Callable,
    num_params: int,
    n_particles: int,
    gen: torch.Generator,
    max_stages: int = 100,
    target_ess_frac: float = 0.5,
    n_mcmc: int = 5,
    n_leapfrog: int = 10,
    bisect_iters: int = 26,
    dtype=torch.float64,
    device="cuda",
) -> SmcResult:
    """Runs on the card unless ``device="cpu"``; ``gen`` must be on that
    device."""
    device = resolve_device(device)
    check_generator(gen, device)
    P, n = num_params, int(n_particles)
    u = torch.randn((n, P), generator=gen, dtype=dtype, device=device)
    target = target_ess_frac * n

    def bridge(u, t):
        """log pi_t and its gradient, (n,) and (n, P)."""
        lp, g = value_and_grad(logdensity_fn, u)
        return (1.0 - t) * _log_base(u) + t * lp, (1.0 - t) * (-u) + t * g

    def rejuvenate(u, t):
        """``n_mcmc`` HMC steps of ``n_leapfrog`` leapfrogs targeting
        pi_t; each leapfrog's closing gradient opens the next."""
        scale = u.std(0, unbiased=False) + 1e-6
        eps = 0.3 * scale / n_leapfrog ** 0.5
        lp_u, g_u = bridge(u, t)
        for _ in range(n_mcmc):
            p0 = torch.randn(u.shape, generator=gen, dtype=dtype,
                             device=device)
            h0 = -lp_u + 0.5 * (p0 * p0).sum(-1)
            q, p, g = u, p0, g_u
            for _ in range(n_leapfrog):
                p = p + 0.5 * eps * g
                q = q + eps * p
                lp_q, g = bridge(q, t)
                p = p + 0.5 * eps * g
            h_new = -lp_q + 0.5 * (p * p).sum(-1)
            log_acc = h0 - h_new
            accept = torch.log(torch.rand(n, generator=gen, dtype=dtype,
                                          device=device)) < log_acc
            u = torch.where(accept[:, None], q, u)
            lp_u = torch.where(accept, lp_q, lp_u)
            g_u = torch.where(accept[:, None], g, g_u)
        return u

    t = torch.zeros((), dtype=dtype, device=device)
    log_z = torch.zeros((), dtype=dtype, device=device)
    stage = 0
    while stage < max_stages:
        with torch.no_grad():
            ll = logdensity_fn(u) - _log_base(u)
        t_new = _next_temp(ll, t, target, bisect_iters)
        lw = (t_new - t) * ll
        log_z = log_z + (torch.logsumexp(lw, 0) - math.log(n))
        u = u[_systematic_resample(gen, lw, n)]
        u = rejuvenate(u, t_new)
        t = t_new
        stage += 1
        if not bool(t < 1.0):
            break
    return SmcResult(particles=u, log_evidence=log_z, n_stages=stage,
                     final_temp=t)
