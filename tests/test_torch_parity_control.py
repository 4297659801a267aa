"""The JAX package's Stan control tests (tests/test_stan_control.py; its
``sigma_gibbs`` posterior comparison marked ``slow``) and its front-end checks
(tests/test_init_and_validation.py:16-94) on the port, on the CPU, with
``split_rhat`` held to the JAX package's.

Deterministic functions are held to their JAX counterparts on the same
input: the adaptation schedule, checkNlevels' messages, ``split_rhat``
and ``ess``.  Wiring is asserted of the port's own fits: the adaptation
windows land on ``GibbsProgram.sched`` (the port's name for the
reference's ``sched_collect`` / ``sched_window_end``: ``(adapt_stepsize,
collect, window_end)``), the stepsize and its jitter on the program and
in ``stepsize__`` (float64, the reference's 1e-12), the derived ``skip``,
``stan_args["seed"]``, and the bounds' messages.  The prior forests of
the port (``sample_trees_from_prior`` takes a chain count) must hold the
reference's heap invariants."""

import warnings

import numpy as np
import pytest
import torch

import stan4bart_torch as s4b
import stan4bart_tpu.parallel.diagnostics as ref_diag
from stan4bart_torch.formula.design import build_model_frame as port_mf
from stan4bart_torch.models.assemble import build_parametric_model
from stan4bart_torch.ops import bart as bart_ops
from stan4bart_torch.ops.nuts import make_adapt_schedule
from stan4bart_torch.parallel import diagnostics
from stan4bart_tpu.formula import build_model_frame as ref_mf
from stan4bart_tpu.ops.nuts import make_adapt_schedule as ref_schedule
from stan4bart_tpu.utils.friedman import (
    friedman_dataframe,
    generate_friedman_data,
)

torch.set_num_threads(2)

FORMULA = "y ~ bart(X1+X2) + X4"


def _fit(df, **kw):
    return s4b.stan4bart(FORMULA, df, verbose=-1, device="cpu", **kw)


@pytest.fixture(scope="module")
def df60():
    return friedman_dataframe(generate_friedman_data(60))


def test_custom_windows_change_schedule():
    default = make_adapt_schedule(300)
    custom = make_adapt_schedule(300, init_buffer=20, term_buffer=20,
                                 base_window=40)
    for got, want in ((default, ref_schedule(300)),
                      (custom, ref_schedule(300, init_buffer=20,
                                            term_buffer=20,
                                            base_window=40))):
        for key in ("adapt_stepsize", "collect", "window_end"):
            np.testing.assert_array_equal(got[key], np.asarray(want[key]))
    assert not np.array_equal(default["collect"], custom["collect"])
    assert not np.array_equal(default["window_end"], custom["window_end"])
    assert custom["collect"][:20].sum() == 0 and custom["collect"][20]
    assert default["collect"][:75].sum() == 0 and default["collect"][75]
    assert np.flatnonzero(custom["window_end"])[-1] == 300 - 20 - 1
    assert np.flatnonzero(default["window_end"])[-1] == 300 - 50 - 1


def test_unknown_stan_args_warn(df60):
    mf = port_mf(FORMULA, df60)
    with pytest.warns(UserWarning, match="unsupported stan_args"):
        build_parametric_model(mf, "gaussian", {"not_a_real_arg": 1},
                               device="cpu")
    with pytest.warns(UserWarning, match="BART component"):
        build_parametric_model(mf, "gaussian",
                               {"prior_intercept": {"dist": "normal"}},
                               device="cpu")


def test_adapt_buffers_reach_gibbs_program(df60):
    fit = _fit(df60, chains=1, warmup=120, iter=140, seed=0,
               bart_args={"n.trees": 3},
               stan_args={"adapt_init_buffer": 10, "adapt_term_buffer": 10,
                          "adapt_base_window": 30, "max_treedepth": 4})
    _, collect, window_end = fit.prog.sched
    collect, window_end = np.asarray(collect), np.asarray(window_end)
    assert collect[:10].sum() == 0 and collect[10]
    assert np.flatnonzero(window_end)[-1] == 109


def test_stepsize_and_jitter_wired(df60):
    kw = dict(chains=1, warmup=20, iter=50, seed=0, dtype=torch.float64,
              bart_args={"n.trees": 3})
    fit = _fit(df60, stan_args={"stepsize": 0.25, "stepsize_jitter": 0.3},
               **kw)
    assert fit.prog.stepsize_init == 0.25
    assert fit.prog.nuts_cfg.stepsize_jitter == 0.3
    ss = fit.extract("stan")[fit.stan_names.index("stepsize__")]
    assert np.std(ss) > 1e-3
    base = _fit(df60, **kw)
    ss0 = base.extract("stan")[base.stan_names.index("stepsize__")]
    assert np.std(ss0) < 1e-12  # frozen stepsize without jitter


def test_derived_skip_default(df60):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        fit = _fit(df60, chains=1, warmup=0, iter=12, seed=0,
                   bart_args={"n.trees": 3})
    # skip unset, warmup 0 -> stan skip = (2000 - 0) // 1000 = 2
    assert fit.prog.skip_stan == 2 and fit.prog.skip_bart == 1


def test_stan_args_seed_used(df60):
    kw = dict(chains=1, warmup=15, iter=35, bart_args={"n.trees": 3})
    f1 = _fit(df60, stan_args={"seed": 123, "max_treedepth": 4}, **kw)
    f2 = _fit(df60, seed=123, stan_args={"max_treedepth": 4}, **kw)
    np.testing.assert_array_equal(f1.extract("ev"), f2.extract("ev"))


@pytest.mark.slow
def test_sigma_gibbs_posterior_parity():
    """tests/test_stan_control.py:95-112 on the port: the exact sigma
    slice draw (``sigma_gibbs``) is its own Metropolis-within-Gibbs
    kernel, so the sigma posterior matches the NUTS-only chain's within
    Monte Carlo error at the reference's run length."""
    df = friedman_dataframe(generate_friedman_data(150, ranef=True))
    kw = dict(chains=2, warmup=500, iter=1500, seed=77, verbose=-1,
              bart_args={"n.trees": 15}, dtype=torch.float64, device="cpu")
    formula = "y ~ bart(X1+X2+X3) + X4 + (1 | g.2)"
    base = s4b.stan4bart(formula, df, **kw)
    sg = s4b.stan4bart(formula, df, stan_args={"sigma_gibbs": True}, **kw)
    assert sg.prog.sigma_gibbs and not base.prog.sigma_gibbs
    s0, s1 = base.extract("sigma"), sg.extract("sigma")
    assert abs(s0.mean() - s1.mean()) < 0.5 * s0.std() + 0.05
    assert 0.5 < s1.std() / s0.std() < 2.0
    assert np.all(np.isfinite(sg.extract("ev")))


@pytest.mark.parametrize("kw,msg", [
    (dict(iter=0), "iter"),
    (dict(chains=0), "chains"),
    (dict(skip=0), "skip"),
    (dict(cores=0), "cores"),
    (dict(stan_args={"adapt_delta": 1.5}), "adapt_delta"),
    (dict(stan_args={"stepsize": -1.0}), "stepsize"),
    (dict(stan_args={"max_treedepth": 0}), "max_treedepth"),
    (dict(stan_args={"freeze_rule": "nope"}), "freeze_rule"),
])
def test_bounds_validation(kw, msg):
    df = friedman_dataframe(generate_friedman_data(40))
    with pytest.raises(ValueError, match=msg):
        _fit(df, **kw)


def test_split_rhat_and_ess_match_reference():
    rng = np.random.default_rng(0)
    draws = rng.normal(size=(4, 101, 3)).cumsum(axis=1)  # odd n, drifting
    np.testing.assert_allclose(diagnostics.split_rhat(draws),
                               np.asarray(ref_diag.split_rhat(draws)),
                               rtol=1e-12)
    np.testing.assert_allclose(diagnostics.split_rhat(draws[..., 0]),
                               float(ref_diag.split_rhat(draws[..., 0])),
                               rtol=1e-12)
    x = np.moveaxis(draws, -1, 0)
    np.testing.assert_allclose(
        diagnostics.ess(x), [float(ref_diag.ess(xi)) for xi in x],
        rtol=1e-10)


def test_prior_tree_structures_valid():
    d = generate_friedman_data(200)
    cfg = bart_ops.BartConfig(num_trees=40)
    cuts = bart_ops.make_cut_grid(d["x"], cfg.n_cuts)
    ranks = torch.as_tensor(bart_ops.compute_ranks(d["x"], cuts))
    gen = torch.Generator()
    gen.manual_seed(0)
    st = bart_ops.sample_trees_from_prior(cfg, gen, ranks,
                                          np.full(10, 0.1), 1)
    f = st.feature[0].numpy()
    M = cfg.max_nodes
    assert np.all(f[:, 0] != -2)
    for t in range(cfg.num_trees):
        for i in range((M - 1) // 2):
            if f[t, i] >= 0:
                assert f[t, 2 * i + 1] != -2 and f[t, 2 * i + 2] != -2
            else:
                assert f[t, 2 * i + 1] == -2 and f[t, 2 * i + 2] == -2
    frac_split = (f[:, 0] >= 0).mean()
    assert 0.6 < frac_split <= 1.0
    fresh = bart_ops.walk_tree(st.feature[0], st.cut[0], ranks,
                               cfg.max_depth)
    assert torch.equal(fresh, st.leaf_idx[0].long())


@pytest.mark.parametrize("levels,msg", [
    (lambda n: ["a"] * n, "> 1 sampled level"),
    (lambda n: [str(i) for i in range(n)],
     "must be < number of observations")])
def test_checkNlevels_matches_reference(levels, msg):
    n = 30
    rng = np.random.default_rng(0)
    data = {"y": rng.normal(size=n), "x": rng.normal(size=n),
            "g": np.array(levels(n))}
    with pytest.raises(ValueError, match=msg) as want:
        ref_mf("y ~ bart(x) + (1 | g)", data)
    with pytest.raises(ValueError, match=msg) as got:
        port_mf("y ~ bart(x) + (1 | g)", data)
    assert str(got.value) == str(want.value)


def test_print_trees_and_prior_summary(capsys):
    df = friedman_dataframe(generate_friedman_data(60, ranef=True))
    fit = s4b.stan4bart(
        "y ~ bart(X1+X2) + X4 + (1 | g.2)", df, chains=1, warmup=10,
        iter=25, seed=0, verbose=-1, device="cpu",
        bart_args={"n.trees": 3, "keep_trees": True},
        stan_args={"max_treedepth": 4})
    fit.print_trees(samples=[0], max_print=3)
    out = capsys.readouterr().out
    assert "tree 1:" in out and "leaf" in out
    fit.prior_summary()
    out = capsys.readouterr().out
    assert "coefficients: normal" in out
    assert "covariance: decov" in out
    assert fit.timings["total"] > 0
