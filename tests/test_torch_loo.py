"""The port's information criteria against the JAX package's.

``stan4bart_torch/loo.py`` is a copy of ``stan4bart_tpu/loo.py``: on the
same seeded numpy inputs every function agrees to 1e-12 (the same numpy
arithmetic).  The fit surface (``log_lik``, ``loo``, ``waic``) is held
against the reference on the SAME draws: a small JAX fit's stored draws
are carried into the port's fit object with
``stan4bart_torch.convert.draws_from_numpy``, and both packages evaluate
the gaussian, weighted-gaussian and probit log-likelihood of those draws
over the same design (log_lik is a function of the draws, the design and
the family) to 1e-9 relative in float64.  Then the tests of
tests/test_loo.py:90-170 on the port's own fits.

One fit per package per module: n = 120, 2 chains, 30 iterations (15
warmup), 10 trees, treedepth capped at 4, on the CPU."""

from concurrent.futures import ThreadPoolExecutor
from dataclasses import replace

import numpy as np
import pytest
import torch
from scipy.special import logsumexp
from scipy.stats import genpareto, norm

import stan4bart_torch
import stan4bart_tpu
from stan4bart_torch import loo as port_loo
from stan4bart_torch.convert import draws_from_numpy
from stan4bart_torch.formula.design import build_model_frame as port_mf
from stan4bart_torch.parallel.diagnostics import ess as port_ess
from stan4bart_tpu import loo as ref_loo
from stan4bart_tpu.formula import build_model_frame as ref_mf
from stan4bart_tpu.parallel.diagnostics import ess as ref_ess
from stan4bart_tpu.utils.friedman import (
    friedman_dataframe,
    generate_friedman_data,
)

torch.set_num_threads(2)

FORMULA = "y ~ bart(X1 + X2 + X3 + X5) + X4 + (1 | g.2)"
N = 120
KW = dict(chains=2, iter=30, warmup=15, seed=11, verbose=-1,
          bart_args={"n.trees": 10}, stan_args={"max_treedepth": 4})
EXACT = dict(rtol=1e-12, atol=1e-12)
F64 = dict(rtol=1e-9, atol=1e-12)


@pytest.fixture(scope="module")
def data():
    d = generate_friedman_data(N, ranef=True)
    df = friedman_dataframe(d)
    w = np.linspace(0.5, 2.0, N)
    yb = (np.asarray(df["y"]) > np.median(df["y"])).astype(float)
    return d, df, w, yb


@pytest.fixture(scope="module")
def pool():
    """One thread in which the JAX package's fit compiles and runs beside
    the port's work."""
    with ThreadPoolExecutor(1) as ex:
        yield ex


@pytest.fixture(scope="module")
def ref_started(pool, data):
    d, df, w, yb = data
    return pool.submit(stan4bart_tpu.stan4bart, FORMULA, df, **KW)


@pytest.fixture(scope="module")
def ref_fit(ref_started):
    return ref_started.result()


@pytest.fixture(scope="module")
def port_fit(data, ref_started):
    """The port's fit; the reference's, started first, runs meanwhile."""
    d, df, w, yb = data
    return stan4bart_torch.stan4bart(FORMULA, df, device="cpu",
                                     dtype=torch.float64, **KW)


def _inputs(name):
    rng = np.random.default_rng(0)
    ll = norm.logpdf(rng.normal(size=(30, 1)),
                     loc=rng.normal(size=(1, 400)), scale=1.3)
    return {
        "gpdfit": (genpareto.rvs(0.4, size=800, random_state=rng),),
        "psis_smooth": (rng.standard_t(3, size=2000), 0.7),
        "psis_loo": (ll,),
        "psis_loo_r_eff": (ll, rng.uniform(0.3, 1.0, size=30)),
        "waic": (ll,),
    }[name]


@pytest.mark.parametrize("name", ["gpdfit", "psis_smooth", "psis_loo",
                                  "psis_loo_r_eff", "waic"])
def test_loo_module_matches_reference(name):
    """Equal to 1e-12 on the same seeded inputs."""
    fn = name.replace("_r_eff", "")
    args = _inputs(name)
    got = getattr(port_loo, fn)(*args)
    want = getattr(ref_loo, fn)(*args)
    if isinstance(want, dict):
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_allclose(got[k], want[k], **EXACT, err_msg=k)
    else:
        for a, b in zip(got, want):
            np.testing.assert_allclose(a, b, **EXACT)


def test_loo_compare_matches_reference():
    """Equal to 1e-12: the ranking, elpd differences and paired SEs."""
    rng = np.random.default_rng(1)
    ll = {m: norm.logpdf(rng.normal(size=(40, 1)),
                         loc=rng.normal(s, 1.0, size=(1, 300)))
          for m, s in (("a", 0.0), ("b", 0.4), ("c", -0.8))}
    got = port_loo.loo_compare({m: port_loo.psis_loo(x)
                                for m, x in ll.items()})
    want = ref_loo.loo_compare({m: ref_loo.psis_loo(x)
                                for m, x in ll.items()})
    assert [r["name"] for r in got] == [r["name"] for r in want]
    for a, b in zip(got, want):
        for k in ("elpd_loo", "elpd_diff", "se_diff"):
            np.testing.assert_allclose(a[k], b[k], **EXACT)


def _same_draws(ref_fit, port_fit, data, case):
    """The reference fit and a port fit over the same draws, design and
    family for one log_lik branch."""
    d, df, w, yb = data
    port = replace(port_fit, draws=draws_from_numpy(ref_fit.draws),
                   warmup=ref_fit.warmup)
    if case == "weighted":
        ref_fit = replace(ref_fit, mf=ref_mf(FORMULA, df, weights=w))
        port = replace(port, mf=port_mf(FORMULA, df, weights=w))
    elif case == "probit":
        dfb = dict(df, y=yb)
        ref_fit = replace(ref_fit, mf=ref_mf(FORMULA, dfb),
                          family="binomial")
        port = replace(port, mf=port_mf(FORMULA, dfb), family="binomial")
    return ref_fit, port


@pytest.mark.parametrize("case", ["gaussian", "weighted", "probit"])
def test_log_lik_matches_reference_on_same_draws(ref_fit, port_fit, data,
                                                 case):
    """log_lik, and the loo / waic built on it, equal the reference's on
    the reference's own draws to 1e-9 relative in float64 (the r_eff of
    loo comes from each package's FFT)."""
    ref, port = _same_draws(ref_fit, port_fit, data, case)
    want = ref.log_lik(combine_chains=False, include_warmup=True)
    got = port.log_lik(combine_chains=False, include_warmup=True)
    assert got.shape == want.shape == (N, ref_fit.iterations, 2)
    np.testing.assert_allclose(got, want, **F64)
    w_ref, w_port = ref.waic(), port.waic()
    for k in ("elpd_waic", "p_waic", "waic"):
        np.testing.assert_allclose(w_port[k], w_ref[k], **F64, err_msg=k)
    l_ref, l_port = ref.loo(), port.loo()
    for k in ("elpd_loo", "p_loo", "looic", "pareto_k"):
        np.testing.assert_allclose(l_port[k], l_ref[k], **F64, err_msg=k)


def test_ess_and_r_eff_vectorization(ref_fit, port_fit, data):
    """The port's ess equals the reference's on the same draws (1e-9
    relative); loo's r_eff, ess batched over the observation axis,
    equals a per-observation loop of ess to 1e-12 relative."""
    ref, port = _same_draws(ref_fit, port_fit, data, "gaussian")
    raw = port._log_lik_raw(False)                 # (chains, iter, n)
    loop = np.array([port_ess(raw[..., i]) for i in range(N)])
    batched = port_ess(np.moveaxis(raw, -1, 0))
    np.testing.assert_allclose(batched, loop, rtol=1e-12)
    for i in (0, 57, N - 1):
        np.testing.assert_allclose(loop[i], float(ref_ess(raw[..., i])),
                                   rtol=1e-9)


def test_log_lik_matches_extracted_density(port_fit):
    """fit.log_lik reconstructs exactly from extract('ev') and sigma
    (1e-10 relative, tests/test_loo.py:90)."""
    ll = port_fit.log_lik()
    ev = port_fit.extract("ev")
    sigma = port_fit.extract("sigma")
    y = np.asarray(port_fit.mf.y)
    expect = norm.logpdf(y[:, None], loc=ev, scale=sigma[None, :])
    np.testing.assert_allclose(ll, expect, rtol=1e-10)
    assert ll.shape == (N, sigma.size)


def test_loo_waic_on_fit(port_fit):
    """elpd_loo below the lppd (a positive penalty), p_loo and p_waic
    positive, every value finite (tests/test_loo.py:102)."""
    res = port_fit.loo()
    w = port_fit.waic()
    ll = port_fit.log_lik()
    lppd = float(np.sum(logsumexp(ll, axis=1) - np.log(ll.shape[1])))
    assert res["elpd_loo"] < lppd
    assert res["p_loo"] > 0 and w["p_waic"] > 0
    for k in ("elpd_loo", "p_loo", "looic"):
        assert np.isfinite(res[k]), k
    assert np.isfinite(w["waic"])
    assert res["n_obs"] == N and res["n_draws"] == 2 * (
        KW["iter"] - KW["warmup"])


def test_log_lik_weighted_and_probit_fits(data):
    """The port's own weighted-gaussian and probit fits: var_i = sigma^2
    / w_i, and Bernoulli(ev), each within 1e-10 relative of the density
    rebuilt from extract (tests/test_loo.py:142)."""
    d, df, w, yb = data
    small = dict(KW, iter=12, warmup=6, bart_args={"n.trees": 5})
    fit = stan4bart_torch.stan4bart(FORMULA, df, weights=w, device="cpu",
                                    dtype=torch.float64, **small)
    ll = fit.log_lik()
    sigma = fit.extract("sigma")[None, :] / np.sqrt(w)[:, None]
    expect = norm.logpdf(np.asarray(fit.mf.y)[:, None],
                         loc=fit.extract("ev"), scale=sigma)
    np.testing.assert_allclose(ll, expect, rtol=1e-10)

    fitb = stan4bart_torch.stan4bart(FORMULA, dict(df, y=yb), device="cpu",
                                     dtype=torch.float64, **small)
    assert fitb.family == "binomial"
    p = np.clip(fitb.extract("ev"), 1e-12, 1 - 1e-12)
    expectb = np.where(yb[:, None] > 0, np.log(p), np.log1p(-p))
    np.testing.assert_allclose(fitb.log_lik(), expectb, rtol=1e-10)
    assert np.all(np.isfinite(fitb.loo()["elpd_i"]))


def test_log_lik_needs_raw_draws(data):
    d, df, w, yb = data
    fit = stan4bart_torch.stan4bart(
        FORMULA, df, device="cpu", keep_fits=False,
        **dict(KW, iter=6, warmup=3, bart_args={"n.trees": 3}))
    with pytest.raises(ValueError, match="keep_fits"):
        fit.log_lik()
