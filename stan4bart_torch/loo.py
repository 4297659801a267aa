"""PSIS-LOO and WAIC model-comparison criteria.

A copy of ``stan4bart_tpu/loo.py`` (numpy and scipy only), kept here so
the port imports nothing of the JAX package.  The fit object exposes
``fit.log_lik()``, ``fit.loo()`` and ``fit.waic()`` built on this
module.

Algorithms are the published standards:

- Pareto-smoothed importance sampling: Vehtari, Simpson, Gelman, Yao,
  Gabry, "Pareto smoothed importance sampling" (arXiv:1507.02646) —
  fit a generalized Pareto distribution to the largest importance
  ratios, replace them with expected order statistics of the fit,
  truncate at the raw maximum.
- Generalized-Pareto fit: Zhang & Stephens (2009) empirical-Bayes
  profile posterior, with the loo package's small-sample shrinkage of
  k-hat toward 0.5.
- WAIC: Watanabe (2010) / Gelman, Hwang, Vehtari (2014), the pWAIC2
  (posterior-variance) penalty.

Everything is plain numpy on the host: the inputs are posterior draws
already on the host, and the per-observation GPD fits are O(n * tail)
scalar work.
"""

from __future__ import annotations

import numpy as np
from scipy.special import logsumexp

__all__ = ["gpdfit", "psis_smooth", "psis_loo", "waic", "loo_compare"]


def gpdfit(x: np.ndarray) -> tuple[float, float]:
    """Empirical-Bayes generalized-Pareto fit to exceedances ``x`` > 0.

    Zhang & Stephens (2009): profile the likelihood over a grid of
    ``b = k/sigma`` values placed by quartile spacing, weight by the
    profile posterior, and report the posterior-mean ``k`` (shrunk
    toward 0.5 with the loo package's (n*k + 5)/(n+10) prior) and the
    implied ``sigma``.  Returns (k_hat, sigma_hat).
    """
    x = np.sort(np.asarray(x, dtype=np.float64))
    n = x.size
    if n < 5 or not np.all(np.isfinite(x)) or x[-1] <= 0:
        return np.inf, np.nan
    # grid over theta = -k/sigma (the GPD here is survival
    # (1 + k x / sigma)^(-1/k), the usual Vehtari khat orientation:
    # theta < 0 <=> heavy tail, theta bounded above by 1/max(x))
    prior = 3.0
    m = 30 + int(np.sqrt(n))
    jj = np.arange(1, m + 1)
    xstar = x[int(n / 4 + 0.5) - 1]
    if xstar <= 0:
        xstar = x[-1]
    theta = 1.0 / x[-1] + (1.0 - np.sqrt(m / (jj - 0.5))) / (prior * xstar)
    # per-candidate MLE of k and the profile log-likelihood
    ks = np.mean(np.log1p(-theta[:, None] * x[None, :]), axis=1)
    with np.errstate(divide="ignore", invalid="ignore"):
        ls = n * (np.log(-theta / ks) - ks - 1.0)
    ls = np.where(np.isfinite(ls), ls, -np.inf)
    ws = np.exp(ls - logsumexp(ls))
    theta_hat = float(np.sum(theta * ws))
    k_hat = float(np.mean(np.log1p(-theta_hat * x)))
    sigma = -k_hat / theta_hat if theta_hat != 0 else np.nan
    k_hat = (n * k_hat + 5.0) / (n + 10.0)  # shrink toward 0.5 (wip)
    return k_hat, sigma


def psis_smooth(log_ratios: np.ndarray,
                r_eff: float = 1.0) -> tuple[np.ndarray, float]:
    """Pareto-smooth ONE observation's log importance ratios.

    Returns (log weights normalized to max 0, k_hat).  Follows
    arXiv:1507.02646: tail size M = min(0.2 S, 3 sqrt(S / r_eff)); the
    M largest ratios are replaced by GPD quantiles at the expected
    order statistics and truncated at the raw maximum.

    r_eff: relative efficiency ESS/S of the (autocorrelated MCMC)
    draws — the loo package's correction making the effective tail
    longer for poorly-mixing chains so pareto_k does not understate
    tail risk; 1.0 = independent draws.
    """
    lr = np.asarray(log_ratios, dtype=np.float64)
    S = lr.size
    lw = lr - lr.max()
    r_eff = min(max(float(r_eff), 1e-3), 1.0)
    M = int(min(np.ceil(0.2 * S), np.ceil(3.0 * np.sqrt(S / r_eff))))
    if M < 5 or S < 25:
        return lw, -np.inf  # too few draws to fit a tail
    order = np.argsort(lw)
    tail_ids = order[-M:]
    cutoff_lw = lw[order[-M - 1]]
    cutoff = np.exp(cutoff_lw)
    exceed = np.exp(lw[tail_ids]) - cutoff
    if np.ptp(exceed) <= 0:
        return lw, -np.inf
    k_hat, sigma = gpdfit(exceed)
    if np.isfinite(k_hat) and sigma > 0:
        p = (np.arange(1, M + 1) - 0.5) / M
        if abs(k_hat) < 1e-12:
            q = sigma * (-np.log1p(-p))          # exponential limit
        else:
            q = sigma * (np.power(1.0 - p, -k_hat) - 1.0) / k_hat
        smoothed = np.log(cutoff + q)
        # assign in ascending order, truncate at the raw max (= 0)
        lw[tail_ids[np.argsort(lw[tail_ids])]] = np.minimum(smoothed, 0.0)
    return lw, k_hat


def psis_loo(log_lik: np.ndarray, r_eff=None) -> dict:
    """PSIS-LOO from a pointwise log-likelihood matrix (n, S).

    r_eff: per-observation relative efficiency ESS/S of the draws
    (scalar or (n,) array; ``Stan4bartFit.loo`` computes it from the
    chain-structured draws).  None assumes independent draws (r_eff=1)
    — with autocorrelated MCMC input that can understate tail risk, so
    pass the real value when chains mix slowly.

    Returns the loo-package summary: elpd_loo / p_loo with standard
    errors, the looic, per-observation pareto_k diagnostics, and
    counts of observations whose k exceeds the 0.7 reliability
    threshold.
    """
    ll = np.asarray(log_lik, dtype=np.float64)
    if ll.ndim != 2:
        raise ValueError("log_lik must be (n_obs, draws)")
    n, S = ll.shape
    r = np.broadcast_to(
        np.asarray(1.0 if r_eff is None else r_eff, np.float64), (n,))
    elpd_i = np.empty(n)
    k_hat = np.empty(n)
    lppd_i = logsumexp(ll, axis=1) - np.log(S)
    for i in range(n):
        lw, k_hat[i] = psis_smooth(-ll[i], r_eff=r[i])
        lw = lw - logsumexp(lw)
        elpd_i[i] = logsumexp(ll[i] + lw)
    p_loo_i = lppd_i - elpd_i
    return dict(
        elpd_loo=float(elpd_i.sum()),
        se_elpd_loo=float(np.sqrt(n * np.var(elpd_i, ddof=1))),
        p_loo=float(p_loo_i.sum()),
        se_p_loo=float(np.sqrt(n * np.var(p_loo_i, ddof=1))),
        looic=float(-2.0 * elpd_i.sum()),
        elpd_i=elpd_i,
        pareto_k=k_hat,
        n_high_k=int(np.sum(k_hat > 0.7)),
        n_draws=S,
        n_obs=n,
    )


def waic(log_lik: np.ndarray) -> dict:
    """WAIC with the pWAIC2 penalty from a (n, S) log-likelihood."""
    ll = np.asarray(log_lik, dtype=np.float64)
    if ll.ndim != 2:
        raise ValueError("log_lik must be (n_obs, draws)")
    n, S = ll.shape
    lppd_i = logsumexp(ll, axis=1) - np.log(S)
    p_i = np.var(ll, axis=1, ddof=1)
    elpd_i = lppd_i - p_i
    return dict(
        elpd_waic=float(elpd_i.sum()),
        se_elpd_waic=float(np.sqrt(n * np.var(elpd_i, ddof=1))),
        p_waic=float(p_i.sum()),
        waic=float(-2.0 * elpd_i.sum()),
        elpd_i=elpd_i,
        n_draws=S,
        n_obs=n,
    )


def loo_compare(results: dict) -> list:
    """Rank models by elpd_loo with pairwise-difference standard errors.

    ``results`` maps model name -> the dict returned by ``psis_loo``
    (or ``fit.loo()``); every entry must cover the same observations.
    Returns rows of (name, elpd_loo, elpd_diff, se_diff) sorted best
    first — the loo package's ``loo_compare`` table, where se_diff is
    the standard error of the PAIRED pointwise difference against the
    best model (never the difference of the marginal SEs).
    """
    items = list(results.items())
    if len(items) < 2:
        raise ValueError("loo_compare needs at least two models")
    n = {name: r["n_obs"] for name, r in items}
    if len(set(n.values())) != 1:
        raise ValueError(f"models cover different observation sets: {n}")
    items.sort(key=lambda kv: -kv[1]["elpd_loo"])
    best = items[0][1]
    rows = []
    for name, r in items:
        d_i = np.asarray(r["elpd_i"]) - np.asarray(best["elpd_i"])
        se = float(np.sqrt(r["n_obs"] * np.var(d_i, ddof=1)))
        rows.append(dict(name=name, elpd_loo=r["elpd_loo"],
                         elpd_diff=float(d_i.sum()), se_diff=se))
    return rows
