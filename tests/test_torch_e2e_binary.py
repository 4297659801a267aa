"""The JAX package's probit end-to-end test (tests/test_e2e_binary.py) on the
port, on the CPU.

Two fits of the port:

* ``fit_and_data``, the reference's fixture as the reference runs it:
  N = 300, 2 chains, 300 warmup / 700 iterations, seed 11, 40 trees,
  float64 (the reference's tests run with x64 on).  Every gate of the
  reference file is asserted with the reference's numbers, the deviance
  ladder against its three fitted comparators included (probit IRLS, a
  BART-only probit fit, whose parametric vector is empty, and the VI
  fit).  The fixture costs minutes on the CPU, so these tests are
  ``slow``.
* ``small``, a short fit of the same model (N = 120, 2 chains, 10 / 30
  iterations, 10 trees, treedepth 4, float64) for the identities the
  reference asserts on its fixture: the family, ppd in {0, 1}, the latent
  flow ev = Phi(bart + fixef + ranef) at 1e-10, and the missing sigma.
"""

import numpy as np
import pytest
import torch
from scipy.stats import norm

import stan4bart_torch as s4b
from stan4bart_tpu.utils.friedman import (
    friedman_dataframe,
    generate_friedman_data,
)

torch.set_num_threads(2)

FORMULA = "y ~ bart(X1 + X2 + X3 + X5) + X4 + (1 | g.2)"
N = 300
KW = dict(chains=2, warmup=300, iter=700, verbose=-1,
          bart_args={"n.trees": 40}, dtype=torch.float64, device="cpu")


@pytest.fixture(scope="module")
def fit_and_data():
    d = generate_friedman_data(N, ranef=True, binary=True)
    df = friedman_dataframe(d)
    return s4b.stan4bart(FORMULA, df, seed=11, **KW), d, df


@pytest.fixture(scope="module")
def small():
    d = generate_friedman_data(120, ranef=True, binary=True)
    fit = s4b.stan4bart(
        FORMULA, friedman_dataframe(d), chains=2, warmup=10, iter=30,
        seed=11, verbose=-1, bart_args={"n.trees": 10},
        stan_args={"max_treedepth": 4}, dtype=torch.float64, device="cpu")
    return fit, d


def _deviance(p, y):
    p = np.clip(p, 1e-9, 1 - 1e-9)
    return -2 * np.sum(y * np.log(p) + (1 - y) * np.log1p(-p))


# -- identities (tests/test_e2e_binary.py:26-30, 92-115) -------------------


def test_family_detected(small):
    fit, _ = small
    assert fit.family == "binomial"
    assert "aux.1" not in fit.stan_names  # no sigma for probit
    assert fit.mf.X_names == ["X4"]


def test_sigma_raises(small):
    fit, _ = small
    with pytest.raises(ValueError, match="binary"):
        fit.extract("sigma")


def test_ppd_is_binary(small):
    fit, _ = small
    ppd = fit.extract("ppd")
    assert set(np.unique(ppd)) <= {0.0, 1.0}
    assert ppd.shape == fit.extract("ev").shape


def test_latent_flow_components(small):
    """indiv components combine on the LATENT scale then map through Phi."""
    fit, _ = small
    bart = fit.extract("indiv.bart")
    fx = fit.extract("indiv.fixef")
    rf = fit.extract("indiv.ranef")
    ev = fit.extract("ev")
    np.testing.assert_allclose(ev, norm.cdf(bart + fx + rf), atol=1e-10)


# -- the reference's gates at its fixture (slow) ---------------------------


@pytest.mark.slow
def test_probabilities_calibrated(fit_and_data):
    fit, d, df = fit_and_data
    assert fit.family == "binomial"
    assert "aux.1" not in fit.stan_names
    ev = fit.fitted("ev")
    assert np.all((ev > 0) & (ev < 1))
    p_true = norm.cdf(d["mu"])
    cor = np.corrcoef(ev, p_true)[0, 1]
    assert cor > 0.75, f"cor(ev, true p) = {cor}"
    y = d["y"]
    dev = -2 * np.sum(y * np.log(ev) + (1 - y) * np.log1p(-ev))
    p0 = y.mean()
    dev0 = -2 * np.sum(y * np.log(p0) + (1 - y) * np.log1p(-p0))
    assert dev < 0.8 * dev0, f"deviance {dev} vs null {dev0}"


@pytest.mark.slow
def test_deviance_ladder_vs_fitted_comparators(fit_and_data):
    """tests/test_e2e_binary.py:54-89: deviance <= probit IRLS with group
    dummies, <= 1.35x a BART-only fit, <= 1.35x the VI fit."""
    from stan4bart_torch.fit import _init_parametric_fit

    fit, d, df = fit_and_data
    y = d["y"]
    dev_s4b = _deviance(fit.fitted("ev"), y)

    eta_glm, _ = _init_parametric_fit(fit.mf, "binomial")
    dev_glm = _deviance(norm.cdf(eta_glm), y)

    # the fixed-effect column moves into bart() and the ranef go
    bart_only = s4b.stan4bart("y ~ bart(X1 + X2 + X3 + X4 + X5)", df,
                              seed=12, **KW)
    assert bart_only.pm.num_upars == 0
    dev_bart = _deviance(bart_only.fitted("ev"), y)

    vi = s4b.stan4bart(FORMULA, df, seed=13, algorithm="vi", **KW)
    dev_vi = _deviance(vi.fitted("ev"), y)

    assert dev_s4b <= dev_glm, (dev_s4b, dev_glm)
    assert dev_s4b <= 1.35 * dev_bart, (dev_s4b, dev_bart)
    assert dev_s4b <= 1.35 * dev_vi, (dev_s4b, dev_vi)


@pytest.mark.slow
def test_sigma_raises_at_fixture(fit_and_data):
    fit, _, _ = fit_and_data
    with pytest.raises(ValueError, match="binary"):
        fit.extract("sigma")


@pytest.mark.slow
def test_ppd_binary(fit_and_data):
    """ppd draws are 0/1 with mean matching ev (test-02:125-145)."""
    fit, d, df = fit_and_data
    ppd = fit.extract("ppd")
    assert set(np.unique(ppd)) <= {0.0, 1.0}
    ev = fit.fitted("ev")
    resid = np.abs(ppd.mean(axis=-1) - ev).mean()
    assert resid < 0.05, f"mean |ppd - ev| = {resid}"


@pytest.mark.slow
def test_latent_flow_at_fixture(fit_and_data):
    fit, d, df = fit_and_data
    ev = fit.extract("ev")
    latent = (fit.extract("indiv.bart") + fit.extract("indiv.fixef")
              + fit.extract("indiv.ranef"))
    np.testing.assert_allclose(ev, norm.cdf(latent), atol=1e-10)
