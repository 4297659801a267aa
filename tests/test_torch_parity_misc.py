"""The JAX package's small-fit parity tests on the port, on the CPU:
tests/test_misc_parity.py:18-60 and 115-268 (seed reproducibility, the
no-ranef model, split probabilities, factor levels, weights, ``subset``,
``offset`` and ``test`` with their accessors, the Gram likelihood against
the direct one, a logical treatment).

Each property is asserted of the port's own fit, at the reference's
sizes, tolerances and seeds; an identity the reference holds at 1e-10
runs in float64, as the reference's tests do.  The model frames that
``weights``, ``offset`` and ``subset`` build are held to the JAX
package's ``build_model_frame`` on the same input.  Fits that check
wiring, not a posterior, cap the NUTS treedepth at 4."""

import numpy as np
import pytest
import torch

import stan4bart_torch as s4b
from stan4bart_torch.formula import build_model_frame as port_mf
from stan4bart_tpu.formula import build_model_frame as ref_mf
from stan4bart_tpu.utils.friedman import (
    friedman_dataframe,
    generate_friedman_data,
)

torch.set_num_threads(2)

SHALLOW = {"max_treedepth": 4}


def _small_df(n=100, **kw):
    return friedman_dataframe(generate_friedman_data(n, **kw))


def _fit(formula, df, **kw):
    return s4b.stan4bart(formula, df, verbose=-1, device="cpu", **kw)


def test_rng_reproducibility():
    df = _small_df()
    kw = dict(chains=2, warmup=20, iter=50, bart_args={"n.trees": 5},
              stan_args=SHALLOW)
    f1 = _fit("y ~ bart(X1 + X2) + X4", df, seed=123, **kw)
    f2 = _fit("y ~ bart(X1 + X2) + X4", df, seed=123, **kw)
    f3 = _fit("y ~ bart(X1 + X2) + X4", df, seed=124, **kw)
    np.testing.assert_array_equal(f1.extract("stan"), f2.extract("stan"))
    assert not np.array_equal(f1.extract("stan"), f3.extract("stan"))


def test_no_ranef_model():
    df = _small_df()
    fit = _fit("y ~ bart(X1 + X2 + X3 + X5) + X4", df, chains=2, warmup=50,
               iter=150, seed=5, bart_args={"n.trees": 20},
               dtype=torch.float64)
    assert fit.mf.q == 0
    assert fit.extract("ranef") == {}
    assert fit.extract("Sigma") == {}
    ev = fit.fitted("ev")
    parts = fit.fitted("indiv.bart") + fit.fitted("indiv.fixef")
    np.testing.assert_allclose(ev, parts + fit.fitted("indiv.ranef"),
                               atol=1e-10)
    r2 = np.corrcoef(ev, df["y"])[0, 1] ** 2
    assert r2 > 0.7


def test_bart_args_reach_sampler():
    df = _small_df()
    sp = np.zeros(2)
    sp[0] = 1.0  # every split on X1
    fit = _fit("y ~ bart(X1 + X2) + X4", df, chains=1, warmup=30, iter=80,
               seed=2, stan_args=SHALLOW,
               bart_args={"n.trees": 7, "power": 3.0, "base": 0.8,
                          "split.probs": sp})
    assert fit.prog.bart_cfg.num_trees == 7
    assert fit.prog.bart_cfg.power == 3.0
    assert fit.prog.bart_cfg.base == 0.8
    vc = fit.fitted("varcount")
    assert vc[1] == 0.0 and vc[0] > 0.0


def test_factor_levels():
    """Unused and new factor levels do not break a fit (test-04)."""
    rng = np.random.default_rng(0)
    n = 80
    df = {
        "y": rng.normal(size=n),
        "x1": rng.normal(size=n),
        "f": np.array(["a", "b", "c", "d"])[rng.integers(0, 3, n)],
        "g": np.array(["u", "v", "w"])[rng.integers(0, 3, n)],
    }
    kw = dict(chains=1, warmup=15, iter=40, seed=1,
              bart_args={"n.trees": 4}, stan_args=SHALLOW)
    fit = _fit("y ~ bart(x1 + f) + (1 | g)", df, **kw)
    assert np.all(np.isfinite(fit.extract("ev")))
    new = dict(df)
    new["g"] = np.array(["u", "zz", "w"])[rng.integers(0, 3, n)]
    fit2 = _fit("y ~ bart(x1 + f) + (1 | g)", df, test=new, **kw)
    assert np.all(np.isfinite(fit2.extract("ev", sample="test")))


def test_weights():
    df = _small_df()
    w = np.ones(100)
    w[:50] = 4.0
    fit = _fit("y ~ bart(X1 + X2) + X4", df, weights=w, chains=1,
               warmup=30, iter=80, seed=6, bart_args={"n.trees": 8})
    noise = fit.extract("ppd") - fit.extract("ev")
    assert noise[50:].std() / noise[:50].std() > 1.5  # ~2 expected


def test_weights_offset_subset_frames_match_reference():
    """The frames ``weights``, ``offset`` and a ``subset`` of rows build
    (a fit's ``mf``) equal the JAX package's on the same input."""
    df = _small_df(120, ranef=True)
    rng = np.random.default_rng(4)
    w, off = rng.uniform(0.5, 2.0, 120), rng.normal(size=120)
    formula = "y ~ bart(X1 + X2) + X4 + (1 | g.2)"
    got = port_mf(formula, df, weights=w, offset=off)
    want = ref_mf(formula, df, weights=w, offset=off)
    for name in ("y", "X", "bart_X", "weights", "offset",
                 "complete_rows"):
        np.testing.assert_array_equal(np.asarray(getattr(got, name)),
                                      np.asarray(getattr(want, name)), name)
    sub = np.arange(100)
    fit = _fit(formula, df, subset=sub, weights=w, offset=off, chains=1,
               warmup=2, iter=4, seed=0, bart_args={"n.trees": 2})
    want = ref_mf(formula, {k: np.asarray(v)[sub] for k, v in df.items()},
                  weights=w[sub], offset=off[sub])
    assert fit.mf.N == want.N == 100
    for name in ("y", "X", "bart_X", "weights", "offset",
                 "complete_rows"):
        np.testing.assert_array_equal(np.asarray(getattr(fit.mf, name)),
                                      np.asarray(getattr(want, name)), name)


def test_subset_offset_test_accessors():
    df = _small_df(120)
    kw = dict(chains=1, warmup=15, iter=40, seed=2,
              bart_args={"n.trees": 4}, stan_args=SHALLOW)
    fit = _fit("y ~ bart(X1 + X2) + X4", df, subset=np.arange(100), **kw)
    assert fit.mf.N == 100
    mask = np.zeros(120, dtype=bool)
    mask[:90] = True
    fit_b = _fit("y ~ bart(X1 + X2) + X4", df, subset=mask, **kw)
    assert fit_b.mf.N == 90
    # offset_test replaces the test offset (stan4bart.R:108)
    test = {k: np.asarray(v)[:20] for k, v in df.items()}
    f1 = _fit("y ~ bart(X1 + X2) + X4", df, test=test,
              offset_test=np.full(20, 7.0), dtype=torch.float64, **kw)
    f0 = _fit("y ~ bart(X1 + X2) + X4", df, test=test,
              dtype=torch.float64, **kw)
    np.testing.assert_allclose(
        f1.fitted("ev", sample="test"), f0.fitted("ev", sample="test") + 7.0,
        atol=1e-8)
    assert "bart(" in f1.formula
    assert f1.terms("fixed") == ["X4"]
    assert f1.terms("bart") == ["X1", "X2"]
    X, names = f1.model_frame("fixed")
    assert X.shape[1] == len(names) == 1


def test_gram_fit_matches_direct_fit():
    """The Gram-compressed likelihood reproduces the direct one (an exact
    reformulation; float64 round-off over the first 10 draws)."""
    df = friedman_dataframe(generate_friedman_data(90, ranef=True))
    kw = dict(chains=2, warmup=15, iter=40, seed=5,
              bart_args={"n.trees": 4}, dtype=torch.float64)
    f_on = _fit("y ~ bart(X1+X2) + X4 + (1 | g.2)", df,
                stan_args={"gram_lik": True, **SHALLOW}, **kw)
    f_off = _fit("y ~ bart(X1+X2) + X4 + (1 | g.2)", df,
                 stan_args={"gram_lik": False, **SHALLOW}, **kw)
    assert f_on.prog.use_gram and not f_off.prog.use_gram
    np.testing.assert_allclose(f_on.draws.stan[:, :10],
                               f_off.draws.stan[:, :10], rtol=1e-6,
                               atol=1e-6)
    assert np.all(np.isfinite(f_on.extract("ev")))


def test_logical_treatment():
    df = dict(_small_df(100, ranef=True, causal=True))
    df["z"] = np.asarray(df["z"]) > 0
    fit = _fit(
        "y ~ bart(. - g.1 - g.2 - X4 - z) + X4 + z + (1 + X4 | g.1) "
        "+ (1 | g.2)", df,
        chains=3, warmup=7, iter=13, seed=0, bart_args={"n.trees": 11},
        stan_args=SHALLOW, treatment="z")
    ft = fit.fitted(sample="test")
    assert ft.shape == (100,) and np.all(np.isfinite(ft))
    assert not np.array_equal(np.asarray(fit.test_frame.X),
                              np.asarray(fit.mf.X))
