"""Cross-chain convergence diagnostics: split-R-hat and effective sample
size, in numpy (Stan's definitions, as in the JAX package's
parallel/diagnostics.py): split each chain in half for R-hat; ESS from
the combined-chain FFT autocorrelation with Geyer's initial-positive and
initial-monotone truncation.
"""

from __future__ import annotations

import numpy as np


def split_rhat(draws):
    """draws: (chains, iterations[, params]) -> split-R-hat."""
    x = np.asarray(draws, dtype=np.float64)
    squeeze = x.ndim == 2
    if squeeze:
        x = x[..., None]
    half = x.shape[1] // 2
    x = np.concatenate([x[:, :half], x[:, half : 2 * half]], axis=0)
    n = half
    chain_mean = x.mean(axis=1)
    chain_var = x.var(axis=1, ddof=1)
    B = n * chain_mean.var(axis=0, ddof=1)
    W = chain_var.mean(axis=0)
    var_plus = (n - 1) / n * W + B / n
    rhat = np.sqrt(var_plus / W)
    return rhat[0] if squeeze else rhat


def _autocovariance(x):
    """Per-chain biased autocovariance via FFT along the last axis;
    x: (..., chains, n)."""
    n = x.shape[-1]
    x = x - x.mean(axis=-1, keepdims=True)
    size = int(2 ** np.ceil(np.log2(2 * n)))
    f = np.fft.rfft(x, size, axis=-1)
    acov = np.fft.irfft(f * np.conj(f), size, axis=-1)[..., :n]
    return acov / n


def ess(draws):
    """draws: (..., chains, iterations) -> effective sample size, one per
    leading index (a float for a (chains, iterations) input)."""
    x = np.asarray(draws, dtype=np.float64)
    C, n = x.shape[-2:]
    acov = _autocovariance(x)
    chain_mean = x.mean(axis=-1)
    mean_var = acov[..., 0].mean(axis=-1) * n / (n - 1.0)
    var_plus = mean_var * (n - 1.0) / n
    if C > 1:
        var_plus = var_plus + chain_mean.var(axis=-1, ddof=1)
    rho = 1.0 - (mean_var[..., None] - acov.mean(axis=-2)) \
        / var_plus[..., None]
    rho[..., 0] = 1.0
    n_pairs = n // 2
    pair = rho[..., 0 : 2 * n_pairs : 2] + rho[..., 1 : 2 * n_pairs : 2]
    keep = np.cumprod((pair > 0).astype(np.float64), axis=-1)
    pair_mono = np.minimum.accumulate(pair, axis=-1)
    tau = -1.0 + 2.0 * np.sum(pair_mono * keep, axis=-1)
    tau = np.maximum(tau, 1.0 / np.log10(float(n * C)))
    out = C * n / tau
    return float(out) if out.ndim == 0 else out
