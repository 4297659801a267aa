"""The port's formula front end against the JAX package's.

``stan4bart_torch.formula`` is a copy of ``stan4bart_tpu.formula`` (it
imports only numpy); every model frame and test frame built from the
same formula and data must hold identical arrays and names."""

import numpy as np
import pytest
import torch

from stan4bart_torch.formula import build_model_frame as port_mf
from stan4bart_torch.formula import parse_formula as port_parse
from stan4bart_tpu.formula import build_model_frame as ref_mf
from stan4bart_tpu.formula import parse_formula as ref_parse
from stan4bart_tpu.utils.friedman import (
    friedman_dataframe,
    generate_friedman_data,
)

torch.set_num_threads(2)

FLAGSHIP = ("y ~ bart(. - g.1 - g.2 - X4 - z) + X4 + z + (1 + X4 | g.1) "
            "+ (1 | g.2)")


def _friedman():
    return friedman_dataframe(
        generate_friedman_data(100, ranef=True, causal=True))


def _factor_data():
    rng = np.random.default_rng(0)
    n = 30
    return {"y": rng.normal(size=n), "x1": rng.normal(size=n),
            "f": np.array(["a", "b", "c"])[rng.integers(0, 3, n)]}


def _na_data():
    rng = np.random.default_rng(1)
    n = 20
    x1, x2 = rng.normal(size=n), rng.normal(size=n)
    x1[3] = np.nan
    x2[7] = np.nan
    return {"y": rng.normal(size=n), "x1": x1, "x2": x2}


CASES = {
    "flagship": (FLAGSHIP, _friedman, {}),
    "slash_nesting": ("y ~ bart(X1 + X2) + X4 + (1 | g.1/g.2)", _friedman,
                      {}),
    "double_bar": ("y ~ bart(X1 + X2) + (1 + X4 || g.1)", _friedman, {}),
    "interactions": ("y ~ bart(X1 + X2) + X4*X5 + X3:X6", _friedman, {}),
    "factor_onehot": ("y ~ bart(x1 + f) + f", _factor_data, {}),
    "na_omit": ("y ~ bart(x1) + x2", _na_data, {}),
    "na_exclude": ("y ~ bart(x1) + x2", _na_data, {"na_action": "exclude"}),
}


def _assert_terms_equal(a, b):
    assert len(a) == len(b)
    for ta, tb in zip(a, b):
        assert ta.group_name == tb.group_name
        assert ta.coef_names == tb.coef_names
        assert list(ta.levels) == list(tb.levels)
        assert (ta.p, ta.l) == (tb.p, tb.l)
        np.testing.assert_array_equal(ta.lhs, tb.lhs)
        np.testing.assert_array_equal(ta.group_idx, tb.group_idx)


def _assert_frames_equal(m1, m2):
    for name in ("y", "X", "bart_X", "complete_rows"):
        np.testing.assert_array_equal(np.asarray(getattr(m1, name)),
                                      np.asarray(getattr(m2, name)), name)
    assert list(m1.X_names) == list(m2.X_names)
    assert list(m1.bart_names) == list(m2.bart_names)
    assert (m1.N, m1.K, m1.q, m1.p, m1.l, m1.len_theta_L) == \
        (m2.N, m2.K, m2.q, m2.p, m2.l, m2.len_theta_L)
    assert m1.b_names() == m2.b_names()
    _assert_terms_equal(m1.re_terms, m2.re_terms)


@pytest.mark.parametrize("case", sorted(CASES))
def test_model_frame_matches_reference(case):
    formula, make_data, kw = CASES[case]
    data = make_data()
    ref, port = ref_mf(formula, data, **kw), port_mf(formula, data, **kw)
    _assert_frames_equal(ref, port)
    # the same column encodings re-applied to new data
    tr, tp = ref.build_test_frame(data), port.build_test_frame(data)
    np.testing.assert_array_equal(tr.X, tp.X)
    np.testing.assert_array_equal(tr.bart_X, tp.bart_X)
    _assert_terms_equal(tr.re_terms, tp.re_terms)


def test_parse_matches_reference():
    cols = list(_friedman().keys())
    for f in (FLAGSHIP, "y ~ bart(x1) + a*b + c:d",
              "y ~ bart(x1) + x2 + offset(o)",
              "y ~ bart(x1) + (1 + x2 | a/b/c)"):
        r = ref_parse(f, columns=cols if "X4" in f else None)
        p = port_parse(f, columns=cols if "X4" in f else None)
        assert r.response == p.response
        assert r.bart_terms == p.bart_terms
        assert r.fixed_terms == p.fixed_terms
        assert r.offset_terms == p.offset_terms
        assert ([(t.group, t.lhs_terms, t.lhs_intercept)
                 for t in r.random_terms]
                == [(t.group, t.lhs_terms, t.lhs_intercept)
                    for t in p.random_terms])


def test_test_frame_new_levels_match():
    rng = np.random.default_rng(2)
    n = 10
    data = {"y": rng.normal(size=n), "x": rng.normal(size=n),
            "g": np.array(["a", "b"])[rng.integers(0, 2, n)]}
    new = dict(data, g=np.array(["a", "c"] * 5))
    tr = ref_mf("y ~ bart(x) + (1 | g)", data).build_test_frame(new)
    tp = port_mf("y ~ bart(x) + (1 | g)", data).build_test_frame(new)
    _assert_terms_equal(tr.re_terms, tp.re_terms)
    assert (tp.re_terms[0].group_idx == -1).sum() == 5


def test_verbose_initial_summary(capsys):
    """verbose=1 prints the reference's initial summary (the JAX
    package's tests/test_init_and_validation.py:61-69 on the port)."""
    import stan4bart_torch

    df = friedman_dataframe(generate_friedman_data(60, ranef=True))
    stan4bart_torch.stan4bart("y ~ bart(X1+X2) + X4 + (1 | g.2)", df,
                              chains=1, warmup=5, iter=15, seed=0,
                              verbose=1, bart_args={"n.trees": 3},
                              device="cpu")
    out = capsys.readouterr().out
    assert "stan4bart: gaussian model" in out
    assert "trees = 3" in out
    assert "adapt_delta = 0.8" in out


def test_double_bar_fit_diagonal_covariance():
    """The JAX package's tests/test_formula.py:224-246 on the port: a ``||``
    fit's covariance comes back as two independent 1x1 blocks, ``g.1`` and
    ``g.1.2``, in both extract dicts, and ev equals its parts (float64, as
    the JAX package's tests run; NUTS's treedepth capped at 4, as this
    checks a layout and an identity, not a posterior)."""
    import stan4bart_torch

    fit = stan4bart_torch.stan4bart(
        "y ~ bart(X1 + X2 + X3) + X4 + (1 + X4 || g.1)", _friedman(),
        seed=3, chains=2, iter=60, warmup=30, verbose=-1,
        bart_args={"n.trees": 10}, stan_args={"max_treedepth": 4},
        dtype=torch.float64, device="cpu")
    sig = fit.extract("Sigma")
    assert set(sig.keys()) == {"g.1", "g.1.2"}
    assert sig["g.1"].shape[:2] == (1, 1)
    assert sig["g.1.2"].shape[:2] == (1, 1)
    ran = fit.extract("ranef")
    assert set(ran.keys()) == {"g.1", "g.1.2"}
    assert np.all(np.isfinite(sig["g.1"]))
    ev = fit.extract("ev")
    comp = (fit.extract("indiv.bart") + fit.extract("indiv.fixef")
            + fit.extract("indiv.ranef"))
    np.testing.assert_allclose(ev, comp, atol=1e-5)
