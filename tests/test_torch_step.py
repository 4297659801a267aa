"""The per-chain driver of the port and the fit surfaces it serves.

``GibbsProgram.step`` (the per-chain iteration, whose sweep is the
per-chain kernel wrapper) against ``step_batched`` from the same
generator: on the CPU both run the same plain sweep, so states and draws
must agree to the bit.  Then the JAX package's callback / keep_fits tests
(tests/test_misc_parity.py:61-113, the reference's test-11-callback.R) on
the port's ``stan4bart``, and the chi(df, scale) k hyperprior through the
fit surface; one small fit per module-scoped fixture (100 rows, 2 chains,
60 iterations, 5 trees, on the CPU)."""

import numpy as np
import pytest
import torch

import stan4bart_torch as s4b
from stan4bart_torch.fit import _resolve_bart_args
from stan4bart_torch.formula.design import build_model_frame
from stan4bart_torch.gibbs import GibbsProgram
from stan4bart_torch.models.assemble import build_parametric_model
from stan4bart_torch.ops.bart import BartConfig
from stan4bart_torch.utils.friedman import (
    friedman_dataframe,
    generate_friedman_data,
)

torch.set_num_threads(2)

FORMULA = "y ~ bart(X1 + X2) + X4"
KW = dict(chains=2, warmup=20, iter=60, seed=9, verbose=-1, device="cpu",
          bart_args={"n.trees": 5})


@pytest.fixture(scope="module")
def df():
    return friedman_dataframe(generate_friedman_data(100))


def _tree_equal(a, b, path=""):
    if isinstance(a, tuple):
        for name, x, y in zip(a._fields, a, b):
            _tree_equal(x, y, f"{path}.{name}")
    elif a is None:            # a stored forest of a fit without keep_trees
        assert b is None, path
    else:
        assert torch.equal(a, b), path


def test_step_equals_step_batched_to_the_bit():
    d = generate_friedman_data(120, ranef=True, causal=True)
    mf = build_model_frame(
        "y ~ bart(. - g.1 - g.2 - X4 - z) + X4 + z + (1 | g.1)",
        friedman_dataframe(d))
    pm, _, _ = build_parametric_model(mf, "gaussian", {"max_treedepth": 5},
                                      dtype=torch.float32, device="cpu")
    prog = GibbsProgram(pm, BartConfig(num_trees=6, k_df=3.0), mf.y,
                        mf.bart_X, warmup=10, iterations=2,
                        dtype=torch.float32, device="cpu")
    runs = []
    for per_chain in (False, True):
        gen = torch.Generator()
        gen.manual_seed(12)
        states = prog.init_state(gen, 3, per_chain=per_chain)
        step = prog.step if per_chain else prog.step_batched
        draws = []
        for it in range(3):
            states, draw = step(states, it, True, gen)
            draws.append(draw)
        runs.append((states, draws))
    (s0, d0), (s1, d1) = runs
    _tree_equal(s0, s1, "state")
    for a, b in zip(d0, d1):
        _tree_equal(a, b, "draw")
    assert not torch.equal(d1[0].k, d1[2].k)   # k is sampled


@pytest.fixture(scope="module")
def fit_no_keep(df):
    def cb(draw):
        # named access parity with the reference's callback environment
        # (yhat.train + named stan_pars; init.cpp:849-911)
        return {"yhat_mean": draw.yhat_train.mean(), "sigma": draw["aux.1"]}

    return s4b.stan4bart(FORMULA, df, keep_fits=False, callback=cb, **KW)


def test_callback_keep_fits_false(fit_no_keep):
    """keep_fits=False stores only callback results (test-11:43-100)."""
    out = fit_no_keep.extract("callback")
    assert out["yhat_mean"].shape == (80,)
    assert np.all(out["sigma"] > 0)
    assert fit_no_keep.extract("callback", include_warmup=True)[
        "sigma"].shape == (120,)
    with pytest.raises(ValueError, match="keep_fits"):
        fit_no_keep.extract("ev")
    fit_no_keep.check_sampler_diagnostics()   # nothing to check: no raise


@pytest.fixture(scope="module")
def fit_keep(df):
    def cb(draw):
        return {"sigma": draw["aux.1"], "yhat": draw.yhat_train}

    return s4b.stan4bart(FORMULA, df, keep_fits=True, callback=cb, **KW)


def test_callback_named_matches_extract(fit_keep):
    """Callback sigma by NAME reproduces extract('sigma') componentwise
    (test-11-callback.R:43-100); with keep_fits=True both are stored."""
    out = fit_keep.extract("callback")
    np.testing.assert_allclose(out["sigma"], fit_keep.extract("sigma"))
    np.testing.assert_allclose(out["yhat"], fit_keep.extract("indiv.bart"))


def test_keep_fits_false_no_callback_stores_nothing(df):
    """Nothing raw is materialized (reference allocates no storage,
    init.cpp:691-720); only final states survive."""
    fit = s4b.stan4bart(FORMULA, df, keep_fits=False, **KW)
    assert fit.draws is None
    assert fit.final_states is not None
    assert fit.iterations == 60
    with pytest.raises(ValueError, match="keep_fits"):
        fit.extract("ev")
    with pytest.raises(ValueError, match="stored no raw draws"):
        fit.extract("callback")


def test_chi_k_hyperprior_through_the_fit(df):
    """bart_args k = chi(df, scale) samples k; the tuple spec resolves as
    the dict one; a fixed numeric k stays fixed."""
    cfg, _, _ = _resolve_bart_args({"k": s4b.chi(3.0, 2.0)}, False)
    assert (cfg.k_init, cfg.k_df, cfg.k_scale) == (2.0, 3.0, 2.0)
    assert _resolve_bart_args({"k": ("chi", 3.0, 2.0)}, False)[0] == cfg
    assert _resolve_bart_args({"k": 3}, False)[0].k_df == 0.0
    with pytest.raises(ValueError, match="k spec"):
        _resolve_bart_args({"k": "chi"}, False)
    kw = dict(KW, bart_args={"n.trees": 5, "k": s4b.chi()})
    fit = s4b.stan4bart(FORMULA, df, **kw)
    k = fit.extract("k", include_warmup=True)
    assert np.all(np.isfinite(k)) and np.all(k > 0) and np.ptp(k) > 0
