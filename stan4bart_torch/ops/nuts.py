"""Iterative multinomial NUTS with Stan-style windowed diagonal-metric
adaptation, batched over chains.

Counterpart of ``stan4bart_tpu/ops/nuts.py``: the checkpoint-stack
iterative tree build, multinomial (biased-progressive) sampling, the
generalized U-turn criterion with the cross-subtree interface checks,
the divergence threshold ``H - H0 > 1000``, dual-averaging stepsize
adaptation and Stan's windowed Welford metric adaptation.

Chains sit on the leading dimension of every tensor.  Where the JAX
package ran ``vmap`` over ``lax.while_loop``, the port runs Python loops
over tree depth and leaves with per-chain masks: every chain that is
still building its trajectory takes the same depth and leaf step, so the
loops advance all running chains in lockstep and a finished chain is
frozen by its mask.  Per-chain gradients are ``torch.autograd.grad`` of
the sum of the chains' log-densities (the chains are independent).

``nuts_transition`` takes its momentum normals and both uniform tables
as optional inputs, so a test can replay the JAX package's draws.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import numpy as np
import torch


class NutsConfig(NamedTuple):
    max_treedepth: int = 10
    delta: float = 0.8       # adapt_delta (target accept stat)
    gamma: float = 0.05      # adapt_gamma
    kappa: float = 0.75      # adapt_kappa
    t0: float = 10.0         # adapt_t0
    max_delta_h: float = 1000.0
    stepsize_jitter: float = 0.0
    # re-run the stepsize search at metric-window boundaries (Stan)
    window_end_research: bool = True
    # stepsize frozen when adaptation disengages: "bar" (Stan), "last",
    # or "mid" (geometric midpoint)
    freeze_rule: str = "bar"
    # cross-chain pooled adaptation over the chain dimension (the JAX
    # package's pooled_axis="chains"): which signals pool, "metric"
    # (window-end variance), "stepsize" (dual-averaging accept signal and
    # the window-end restart stepsize) or "both"; pooled_between adds the
    # between-chain variance of the window means to the pooled metric
    pooled: bool = False
    pooled_parts: str = "metric"
    pooled_between: bool = False


class DualAveragingState(NamedTuple):
    log_eps: torch.Tensor       # (C,) current log stepsize
    log_eps_bar: torch.Tensor   # (C,) averaged log stepsize
    h_bar: torch.Tensor
    mu: torch.Tensor
    count: torch.Tensor         # (C,) adaptation iteration in the window


class WelfordState(NamedTuple):
    count: torch.Tensor   # (C,)
    mean: torch.Tensor    # (C, D)
    m2: torch.Tensor      # (C, D)


class NutsState(NamedTuple):
    q: torch.Tensor             # (C, D) unconstrained positions
    inv_mass: torch.Tensor      # (C, D) diagonal inverse metric
    da: DualAveragingState
    welford: WelfordState


class NutsInfo(NamedTuple):
    lp: torch.Tensor
    accept_stat: torch.Tensor
    stepsize: torch.Tensor
    treedepth: torch.Tensor
    n_leapfrog: torch.Tensor
    divergent: torch.Tensor
    energy: torch.Tensor


def value_and_grad(fn: Callable, q):
    """Per-chain log-density (C,) and its gradient (C, D)."""
    with torch.enable_grad():
        x = q.detach().requires_grad_(True)
        lp = fn(x)
        (g,) = torch.autograd.grad(lp.sum(), x)
    return lp.detach(), g


def _kinetic(p, inv_mass):
    return 0.5 * (p * p * inv_mass).sum(-1)


def welford_init(n_chains, dim, dtype, device):
    z = torch.zeros((n_chains, dim), dtype=dtype, device=device)
    return WelfordState(torch.zeros(n_chains, dtype=dtype, device=device),
                        z, z.clone())


def welford_update(w: WelfordState, x) -> WelfordState:
    count = w.count + 1.0
    delta = x - w.mean
    mean = w.mean + delta / count[:, None]
    m2 = w.m2 + delta * (x - mean)
    return WelfordState(count, mean, m2)


def welford_variance(w: WelfordState):
    """Stan's regularized variance estimate."""
    n = w.count[:, None]
    var = w.m2 / (n - 1.0)
    return (n / (n + 5.0)) * var + 1e-3 * (5.0 / (n + 5.0))


def chain_mean(x, pool=None):
    """The mean of x (C, ...) over the chains, (1, ...): over this
    program's chains, or with ``pool`` (parallel/multihost.ChainPool) over
    every chain of every rank, by one all-reduce."""
    return x.mean(0, keepdim=True) if pool is None else pool.mean(x)


def pooled_welford_variance(w: WelfordState, include_between: bool = False,
                            pool=None):
    """The pooled metric estimate over the chain dimension, the same row
    for every chain: the geometric mean of the per-chain variances (robust
    to chains whose window mean still drifts), regularized as Stan does
    but with the pooled count n C; optionally plus the between-chain
    variance of the window means, scaled by C / (C - 1).  ``pool`` pools
    over every chain of every rank (one all-reduce, two more with the
    between-chain term)."""
    n = w.count[:, None]
    C = w.count.shape[0] if pool is None else pool.n_chains
    var = torch.exp(chain_mean(
        torch.log(torch.clamp(w.m2 / (n - 1.0), min=1e-30)), pool))
    if include_between:
        gm = chain_mean(w.mean, pool)
        var = var + chain_mean((w.mean - gm) ** 2, pool) * (
            C / max(C - 1.0, 1.0))
    pooled_n = n * C
    return ((pooled_n / (pooled_n + 5.0)) * var
            + 1e-3 * (5.0 / (pooled_n + 5.0)))


def da_init(stepsize, n_chains, dtype, device):
    log_eps = torch.log(torch.as_tensor(stepsize, dtype=dtype,
                                        device=device)).expand(n_chains)
    z = torch.zeros(n_chains, dtype=dtype, device=device)
    return DualAveragingState(log_eps=log_eps.clone(), log_eps_bar=z,
                              h_bar=z.clone(), mu=math.log(10.0) + log_eps,
                              count=z.clone())


def da_update(da: DualAveragingState, accept_stat, cfg: NutsConfig):
    """Nesterov dual averaging, Stan parameterization."""
    count = da.count + 1.0
    eta = 1.0 / (count + cfg.t0)
    h_bar = (1.0 - eta) * da.h_bar + eta * (cfg.delta - accept_stat)
    log_eps = da.mu - torch.sqrt(count) / cfg.gamma * h_bar
    x_eta = count ** (-cfg.kappa)
    log_eps_bar = x_eta * log_eps + (1.0 - x_eta) * da.log_eps_bar
    return DualAveragingState(log_eps, log_eps_bar, h_bar, da.mu, count)


def init_stepsize(logdensity_fn: Callable, q, inv_mass, stepsize0, gen,
                  max_iter: int = 100, momentum=None):
    """Stan's init_stepsize heuristic per chain: double/halve until the
    one-step Metropolis log-ratio crosses log(0.5).  momentum: optional
    (C, D) standard normals replacing the draw."""
    C = q.shape[0]
    logp0, grad0 = value_and_grad(logdensity_fn, q)
    if momentum is None:
        momentum = torch.randn(q.shape, generator=gen, dtype=q.dtype,
                               device=q.device)
    p0 = momentum / torch.sqrt(inv_mass)
    h0 = -logp0 + _kinetic(p0, inv_mass)

    def delta_h(eps):
        p_half = p0 + 0.5 * eps[:, None] * grad0
        q_new = q + eps[:, None] * p_half * inv_mass
        logp_new, grad_new = value_and_grad(logdensity_fn, q_new)
        p_new = p_half + 0.5 * eps[:, None] * grad_new
        return h0 - (-logp_new + _kinetic(p_new, inv_mass))

    log_half = math.log(0.5)
    eps = torch.as_tensor(stepsize0, dtype=q.dtype,
                          device=q.device).expand(C).clone()
    dh = delta_h(eps)
    up = dh > log_half
    active = torch.ones(C, dtype=torch.bool, device=q.device)
    for it in range(max_iter + 1):
        if it > 0:
            dh = delta_h(eps)
        keep = torch.where(up, dh > log_half, dh <= log_half)
        ok = torch.isfinite(dh) | ~up
        active = (active & keep & ok & (eps > 1e-10) & (eps < 1e7)
                  & (it < max_iter))
        if not bool(active.any()):
            break
        eps = torch.where(active, torch.where(up, eps * 2.0, eps * 0.5),
                          eps)
    return eps


def nuts_init(q0, stepsize: float = 1.0) -> NutsState:
    C, D = q0.shape
    return NutsState(
        q=q0,
        inv_mass=torch.ones_like(q0),
        da=da_init(stepsize, C, q0.dtype, q0.device),
        welford=welford_init(C, D, q0.dtype, q0.device),
    )


def make_adapt_schedule(num_warmup: int, init_buffer: int = 75,
                        term_buffer: int = 50, base_window: int = 25):
    """Stan's windowed_adaptation schedule as boolean arrays."""
    if num_warmup < 20:
        return dict(
            adapt_stepsize=np.ones(max(num_warmup, 1), dtype=bool),
            collect=np.zeros(max(num_warmup, 1), dtype=bool),
            window_end=np.zeros(max(num_warmup, 1), dtype=bool),
        )
    if num_warmup < init_buffer + term_buffer + base_window:
        init_buffer = int(0.15 * num_warmup)
        term_buffer = int(0.10 * num_warmup)
        base_window = num_warmup - (init_buffer + term_buffer)

    collect = np.zeros(num_warmup, dtype=bool)
    window_end = np.zeros(num_warmup, dtype=bool)
    adapt_stepsize = np.ones(num_warmup, dtype=bool)

    window_start = init_buffer
    window_size = base_window
    while window_start < num_warmup - term_buffer:
        next_boundary = window_start + window_size
        if next_boundary + 2 * window_size > num_warmup - term_buffer:
            next_boundary = num_warmup - term_buffer
        next_boundary = min(next_boundary, num_warmup - term_buffer)
        collect[window_start:next_boundary] = True
        window_end[next_boundary - 1] = True
        window_start = next_boundary
        window_size *= 2
    return dict(adapt_stepsize=adapt_stepsize, collect=collect,
                window_end=window_end)


def _criterion(p_sharp_m, p_sharp_p, rho):
    return (((p_sharp_m * rho).sum(-1) > 0)
            & ((p_sharp_p * rho).sum(-1) > 0))


def _pick(mask, new, old):
    """Per-chain select: ``new`` where mask (C,) holds, else ``old``."""
    m = mask.reshape(mask.shape + (1,) * (new.dim() - 1))
    return torch.where(m, new, old)


def nuts_transition(logdensity_fn: Callable, state: NutsState, gen,
                    cfg: NutsConfig, adapt_stepsize: bool, collect: bool,
                    window_end: bool, momentum=None, u_leaf=None,
                    u_depth=None, pool=None):
    """One NUTS transition + adaptation bookkeeping for every chain.

    adapt_stepsize / collect / window_end: this iteration's schedule
    flags (shared by all chains); all False after warmup.  momentum
    (C, D) standard normals, u_leaf (C, 2^max_treedepth + 1) and
    u_depth (C, max_treedepth, 2) uniforms optionally replace the draws.
    pool: pooled adaptation over every chain of every rank
    (parallel/multihost.ChainPool) instead of this program's chains.
    """
    q0 = state.q
    C, D = q0.shape
    dtype, dev = q0.dtype, q0.device
    inv_mass = state.inv_mass
    max_depth = cfg.max_treedepth
    max_leaps = 2 ** max_depth
    rows = torch.arange(C, device=dev)

    if momentum is None:
        momentum = torch.randn((C, D), generator=gen, dtype=dtype,
                               device=dev)
    if u_leaf is None:
        u_leaf = torch.rand((C, max_leaps + 1), generator=gen, dtype=dtype,
                            device=dev)
    if u_depth is None:
        u_depth = torch.rand((C, max_depth, 2), generator=gen, dtype=dtype,
                             device=dev)

    da = state.da
    if adapt_stepsize:
        stepsize = torch.exp(da.log_eps)
    else:
        stepsize = torch.where(da.count > 0, torch.exp(da.log_eps_bar),
                               torch.exp(da.log_eps))
    if cfg.stepsize_jitter:
        u_jit = torch.rand(C, generator=gen, dtype=dtype, device=dev)
        stepsize = stepsize * (1.0 + cfg.stepsize_jitter
                               * (2.0 * u_jit - 1.0))
    eps = stepsize[:, None]

    logp0, grad0 = value_and_grad(logdensity_fn, q0)
    p0 = momentum / torch.sqrt(inv_mass)
    h0 = -logp0 + _kinetic(p0, inv_mass)

    def leapfrog(q, p, grad):
        p_half = p + 0.5 * eps * grad
        q_new = q + eps * p_half * inv_mass
        logp_new, grad_new = value_and_grad(logdensity_fn, q_new)
        return q_new, p_half + 0.5 * eps * grad_new, logp_new, grad_new

    false = torch.zeros(C, dtype=torch.bool, device=dev)
    edge_q = torch.stack([q0, q0], 1)            # 0 = backward, 1 = forward
    edge_p = torch.stack([p0, p0], 1)
    edge_grad = torch.stack([grad0, grad0], 1)
    depth = torch.zeros(C, dtype=torch.long, device=dev)
    rho = p0
    sample_q, sample_logp, sample_energy = q0, logp0, h0
    log_sum_weight = torch.zeros(C, dtype=dtype, device=dev)
    sum_metro = torch.zeros(C, dtype=dtype, device=dev)
    n_leapfrog = torch.zeros(C, dtype=torch.long, device=dev)
    divergent = false
    turning = false

    for k in range(max_depth):
        active = (depth < max_depth) & ~turning & ~divergent
        if not bool(active.any()):
            break
        # every active chain has completed k doublings: depth == k
        u_pair = u_depth[:, k]
        go_fwd = u_pair[:, 0] < 0.5
        edge_idx = go_fwd.long()
        sign = torch.where(go_fwd, 1.0, -1.0).to(dtype)[:, None]

        # ---- subtree of 2^k leaves from the chosen edge ------------------
        q = edge_q[rows, edge_idx]
        p = edge_p[rows, edge_idx] * sign
        grad = edge_grad[rows, edge_idx]
        leaf = torch.zeros(C, dtype=torch.long, device=dev)
        rho_cum = torch.zeros_like(q0)
        cand_q = q
        cand_logp = torch.full((C,), -math.inf, dtype=dtype, device=dev)
        cand_energy = torch.full((C,), math.inf, dtype=dtype, device=dev)
        lsw = torch.full((C,), -math.inf, dtype=dtype, device=dev)
        sub_metro = torch.zeros(C, dtype=dtype, device=dev)
        begin_p = p
        ckpt_p = torch.zeros((C, max_depth + 1, D), dtype=dtype, device=dev)
        ckpt_rho = torch.zeros_like(ckpt_p)
        sub_turning = false
        sub_div = false
        run = active
        for n in range(2 ** k):
            if n > 0:
                run = run & ~sub_turning & ~sub_div
                if not bool(run.any()):
                    break
            u_mult = u_leaf[rows, (n_leapfrog + n).clamp(max=max_leaps)]
            q_n, p_n, logp_n, grad_n = leapfrog(q, p, grad)
            h = -logp_n + _kinetic(p_n, inv_mass)
            h = torch.where(torch.isnan(h), math.inf, h)
            div_n = (h - h0) > cfg.max_delta_h
            log_w = h0 - h
            metro_n = sub_metro + torch.clamp(torch.exp(h0 - h), max=1.0)
            lsw_n = torch.logaddexp(lsw, log_w)
            take = u_mult < torch.exp(log_w - lsw_n)
            cand_q = _pick(run & take, q_n, cand_q)
            cand_logp = _pick(run & take, logp_n, cand_logp)
            cand_energy = _pick(run & take, h, cand_energy)
            if n == 0:
                begin_p = _pick(run, p_n, begin_p)
            if n % 2 == 0:
                slot = bin(n).count("1")
                ckpt_p[:, slot] = _pick(run, p_n, ckpt_p[:, slot])
                ckpt_rho[:, slot] = _pick(run, rho_cum, ckpt_rho[:, slot])
            rho_n = rho_cum + p_n
            if n % 2 == 1:
                idx_max = bin(max(n - 1, 0)).count("1")
                idx_min = bin(n + 1).count("1") - 1
                turn_n = sub_turning
                for i in range(idx_min, idx_max + 1):
                    turn_n = turn_n | ~_criterion(
                        ckpt_p[:, i] * inv_mass, p_n * inv_mass,
                        rho_n - ckpt_rho[:, i])
                sub_turning = _pick(run, turn_n, sub_turning)
            q, p, grad = (_pick(run, q_n, q), _pick(run, p_n, p),
                          _pick(run, grad_n, grad))
            rho_cum = _pick(run, rho_n, rho_cum)
            lsw = _pick(run, lsw_n, lsw)
            sub_metro = _pick(run, metro_n, sub_metro)
            sub_div = sub_div | (run & div_n)
            leaf = _pick(run, torch.full_like(leaf, n + 1), leaf)

        # ---- merge the subtree into the trajectory -----------------------
        sub_invalid = sub_turning | sub_div
        end_p = p * sign
        begin_p = begin_p * sign
        rho_sub = rho_cum * sign
        new_edge_q = edge_q.clone()
        new_edge_q[rows, edge_idx] = q
        new_edge_p = edge_p.clone()
        new_edge_p[rows, edge_idx] = end_p
        new_edge_grad = edge_grad.clone()
        new_edge_grad[rows, edge_idx] = grad

        take_sub = torch.where(lsw > log_sum_weight, True,
                               u_pair[:, 1] < torch.exp(lsw - log_sum_weight))
        take_sub = active & take_sub & ~sub_invalid
        sample_q = _pick(take_sub, cand_q, sample_q)
        sample_logp = _pick(take_sub, cand_logp, sample_logp)
        sample_energy = _pick(take_sub, cand_energy, sample_energy)

        rho_total = rho + rho_sub
        p_sharp_minus = new_edge_p[:, 0] * inv_mass
        p_sharp_plus = new_edge_p[:, 1] * inv_mass
        persist = _criterion(p_sharp_minus, p_sharp_plus, rho_total)
        old_edge_p = edge_p[rows, edge_idx]
        p_sharp_begin = begin_p * inv_mass
        p_sharp_end = end_p * inv_mass
        p_sharp_old = old_edge_p * inv_mass
        rho_iface1 = rho_sub + old_edge_p
        rho_iface2 = rho + begin_p
        persist = persist & torch.where(
            go_fwd,
            _criterion(p_sharp_old, p_sharp_end, rho_iface1)
            & _criterion(p_sharp_minus, p_sharp_begin, rho_iface2),
            _criterion(p_sharp_begin, p_sharp_plus, rho_iface2)
            & _criterion(p_sharp_end, p_sharp_old, rho_iface1))

        n_leapfrog = _pick(active, n_leapfrog + leaf, n_leapfrog)
        sum_metro = _pick(active, sum_metro + sub_metro, sum_metro)
        divergent = divergent | (active & sub_div)
        edge_q = _pick(active, new_edge_q, edge_q)
        edge_p = _pick(active, new_edge_p, edge_p)
        edge_grad = _pick(active, new_edge_grad, edge_grad)
        rho = _pick(active, rho_total, rho)
        log_sum_weight = _pick(active, torch.logaddexp(log_sum_weight, lsw),
                               log_sum_weight)
        turning = turning | (active & (~persist | sub_invalid))
        # Stan counts only completed (valid) doublings in treedepth__
        depth = depth + (active & ~sub_invalid).long()

    accept_stat = torch.where(n_leapfrog > 0,
                              sum_metro / n_leapfrog.clamp(min=1).to(dtype),
                              torch.ones_like(sum_metro))

    # ---- adaptation -------------------------------------------------------
    welford = state.welford
    pool_eps = cfg.pooled and cfg.pooled_parts != "metric"
    if adapt_stepsize:
        # pooled: every chain's dual averaging takes the chains' mean
        # accept signal
        if pool_eps:
            mean_acc = (accept_stat.mean() if pool is None
                        else pool.mean(accept_stat[:, None])[0, 0])
        da = da_update(da, mean_acc.expand(C) if pool_eps
                       else accept_stat, cfg)
    if collect:
        welford = welford_update(welford, sample_q)
    if window_end:
        if cfg.pooled and cfg.pooled_parts != "stepsize":
            inv_mass = pooled_welford_variance(welford, cfg.pooled_between,
                                               pool)
        else:
            inv_mass = welford_variance(welford)
        if cfg.window_end_research:
            new_eps = init_stepsize(logdensity_fn, sample_q, inv_mass,
                                    torch.exp(da.log_eps), gen)
        else:
            new_eps = torch.exp(da.log_eps)
        if pool_eps:
            # the chains restart from their geometric-mean stepsize
            log_eps = torch.log(new_eps)
            new_eps = torch.exp(
                log_eps.mean() if pool is None
                else pool.mean(log_eps[:, None])[0, 0]).expand(C)
        zero = torch.zeros_like(new_eps)
        da = DualAveragingState(
            log_eps=torch.log(new_eps), log_eps_bar=da.log_eps_bar,
            h_bar=zero, mu=math.log(10.0) + torch.log(new_eps), count=zero)
        welford = welford_init(C, D, dtype, dev)

    new_state = NutsState(q=sample_q, inv_mass=inv_mass, da=da,
                          welford=welford)
    info = NutsInfo(
        lp=sample_logp,
        accept_stat=accept_stat,
        stepsize=stepsize,
        treedepth=depth.to(dtype),
        n_leapfrog=n_leapfrog.to(dtype),
        divergent=divergent.to(dtype),
        energy=sample_energy,
    )
    return new_state, info
