"""ADVI: automatic differentiation variational inference over any
unconstrained log-density.

Counterpart of ``stan4bart_tpu/ops/advi.py`` (Kucukelbir et al. 2017): a
Gaussian variational family in the unconstrained space NUTS samples,
reparameterized ELBO gradients, adagrad-style steps with Stan's eta grid
search, and a relative-ELBO-change stopping rule checked on the host
every ``eval_every`` iterations.

Families: "meanfield" N(mu, diag(exp(2 omega))) and "fullrank"
N(mu, L L'), L kept lower-triangular with its diagonal floored at 1e-8
(entropy sum(log|diag L|)).  VI-within-Gibbs (``GibbsProgram._vi_update``)
uses another fullrank form, L = diag(exp(omega)) + strict_tril(L_off).

``logdensity_fn`` maps (n, P) points to (n,) values; the ELBO's
``n_mc`` draws are one call.  The generator is drawn in a fixed order:
each iteration's (n_mc, P) normals, the eta grid's runs first, then the
main run's; ``advi(normals=)`` takes them from an iterator instead.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from stan4bart_torch.utils.device import check_generator, resolve_device


def _sample_q(mu, omega, z, fullrank):
    if fullrank:
        return mu + z @ omega.T
    return mu + z * torch.exp(omega)


def _entropy(omega, fullrank):
    if fullrank:
        return torch.log(torch.abs(torch.diagonal(omega))).sum()
    return omega.sum()


def _normals(gen, n, P, dtype, device):
    return torch.randn((n, P), generator=gen, dtype=dtype, device=device)


def elbo(logdensity_fn, mu, omega, gen, n_mc, fullrank, z=None):
    """The ELBO's Monte Carlo estimate from ``n_mc`` draws of q; z an
    optional (n_mc, P) normals replacing the draw."""
    if z is None:
        z = _normals(gen, n_mc, mu.shape[0], mu.dtype, mu.device)
    lp = logdensity_fn(_sample_q(mu, omega, z, fullrank))
    return lp.mean() + _entropy(omega, fullrank)


def _floor_fullrank(v, P):
    """[mu | L] with L lower-triangular and its diagonal at least 1e-8."""
    L = torch.tril(v[P:].reshape(P, P))
    diag = torch.diagonal(L)
    L = L + torch.diag(torch.clamp(diag, min=1e-8) - diag)
    return torch.cat([v[:P], L.reshape(-1)])


def _unflat(v, P, fullrank):
    return v[:P], (v[P:].reshape(P, P) if fullrank else v[P:])


def _elbo_grad_fn(logdensity_fn, P, n_mc, fullrank, gen, normals=None):
    """grad_fn(v, z): the negative ELBO and its gradient at the flat
    v = [mu | omega], on normals z (n_mc, P); when z is None, the next of
    ``normals`` or, without them, a draw from gen."""
    def grad_fn(v, z):
        if z is None:
            z = (next(normals) if normals is not None
                 else _normals(gen, n_mc, P, v.dtype, v.device))
        with torch.enable_grad():
            vg = v.detach().requires_grad_(True)
            mu, omega = _unflat(vg, P, fullrank)
            loss = -elbo(logdensity_fn, mu, omega, gen, n_mc, fullrank, z=z)
            (g,) = torch.autograd.grad(loss, vg)
        return loss.detach(), g

    return grad_fn


def _adagrad_steps(grad_fn, v, acc, eta, tau, n_iters, fullrank, P,
                   it_offset, z=None):
    """``n_iters`` adagrad iterations from iteration ``it_offset``:
    acc = g * g at the first iteration, then 0.9 acc + 0.1 g * g; the step
    eta k^-1/2 / (tau + sqrt(acc)) g at iteration k.  grad_fn(v, z) gives
    the negative ELBO and its gradient at v on normals z (None: drawn);
    z an optional (n_iters, n_mc, P).  Returns (v, acc, the losses)."""
    losses = []
    for i in range(n_iters):
        loss, g = grad_fn(v, None if z is None else z[i])
        losses.append(loss)
        g = torch.where(torch.isfinite(g), g, 0.0)
        k = it_offset + i + 1.0
        acc = g * g if k == 1.0 else 0.9 * acc + 0.1 * g * g
        step = eta * k ** -0.5 / (tau + torch.sqrt(acc))
        v = v - step * g
        if fullrank:
            v = _floor_fullrank(v, P)
    return v, acc, torch.stack(losses)


def _advi_block(grad_fn, v, acc, eta, tau, n_iters, fullrank, P,
                it_offset, z=None):
    """One block of the main run (``_adagrad_steps``); returns (v, acc,
    the mean loss of the block's second half)."""
    v, acc, losses = _adagrad_steps(grad_fn, v, acc, eta, tau, n_iters,
                                    fullrank, P, it_offset, z)
    return v, acc, losses[-max(n_iters // 2, 1):].mean()


def advi(
    logdensity_fn: Callable,
    num_params: int,
    gen: torch.Generator,
    family: str = "meanfield",
    n_mc: int = 10,
    max_iters: int = 2000,
    eta_grid=(100.0, 10.0, 1.0, 0.1, 0.01),
    eta_adapt_iters: int = 40,
    tol_rel_obj: float = 0.01,
    eval_every: int = 50,
    dtype=torch.float64,
    device="cuda",
    normals=None,
):
    """Optimize the ELBO; returns (mu, omega, info dict).

    stan::variational::advi semantics: the eta grid search on short runs
    (the eta with the best mean loss over their last 10 iterations), then
    adagrad updates ``eta / (tau + sqrt(acc))`` with a k^-1/2 decay until
    the relative change of the block-mean ELBO falls below
    ``tol_rel_obj``.  omega is the log-sds (meanfield) or L (fullrank).
    ``normals``: an optional iterator of (n_mc, P) normals, one per
    iteration in the order the iterations run, replacing the draws from
    ``gen``.  Runs on the card unless ``device="cpu"``; ``gen`` must be
    on that device."""
    device = resolve_device(device)
    check_generator(gen, device)
    if family not in ("meanfield", "fullrank"):
        raise ValueError("family must be 'meanfield' or 'fullrank'")
    fullrank = family == "fullrank"
    P = num_params
    mu0 = torch.zeros(P, dtype=dtype, device=device)
    omega0 = (torch.eye(P, dtype=dtype, device=device) if fullrank
              else torch.zeros(P, dtype=dtype, device=device))
    v0 = torch.cat([mu0, omega0.reshape(-1)])

    grad_fn = _elbo_grad_fn(logdensity_fn, P, n_mc, fullrank, gen, normals)
    tau = 1.0
    # Stan's eta grid search: short runs, the eta with the best final ELBO
    best_eta, best_obj = None, np.inf
    for eta in eta_grid:
        _, _, losses = _adagrad_steps(grad_fn, v0, torch.zeros_like(v0), eta,
                                      tau, eta_adapt_iters, fullrank, P, 0.0)
        final = float(losses[-10:].mean())
        if np.isfinite(final) and final < best_obj:
            best_eta, best_obj = eta, final
    if best_eta is None:
        raise RuntimeError("ADVI eta search failed: all etas diverged")

    # the main run with a convergence check every eval_every iterations
    v, acc = v0, torch.zeros_like(v0)
    history = []
    converged = False
    it = 0
    prev = None
    while it < max_iters:
        v, acc, mean_loss = _advi_block(grad_fn, v, acc, best_eta, tau,
                                        eval_every, fullrank, P, float(it))
        cur = float(mean_loss)
        history.append(cur)
        it += eval_every
        if prev is not None and np.isfinite(cur) and np.isfinite(prev):
            if abs(cur - prev) / max(abs(prev), 1e-12) < tol_rel_obj:
                converged = True
                break
        prev = cur

    mu, omega = _unflat(v, P, fullrank)
    return mu, omega, dict(
        eta=best_eta, converged=converged, iters=it,
        elbo=-history[-1] if history else np.nan, history=history,
        family=family,
    )


def advi_draws(mu, omega, gen, n_draws, family="meanfield", z=None):
    """``n_draws`` draws from the fitted variational family; z optional
    (n_draws, P) normals replacing the draw."""
    if z is None:
        z = _normals(gen, n_draws, mu.shape[0], mu.dtype, mu.device)
    return _sample_q(mu, omega, z, family == "fullrank")
