"""The JAX package's continuous end-to-end test (tests/test_e2e_continuous.py)
on the port, on the CPU.

Two fits of the port:

* ``fit``, the reference's fixture as the reference runs it: the flagship
  causal model, N = 250, 3 chains, 300 warmup / 700 iterations, seed 7,
  50 trees, float64 (the reference's tests run with x64 on).  Every gate of
  the reference file is asserted with the reference's numbers.  It costs
  minutes on the CPU (the NUTS host loop at the default treedepth), so
  these tests are ``slow``, as is the reference's held-out RMSE gate, which
  fits its own model, and the check of the port's post-warmup leapfrog
  count against the JAX package's fit of the same fixture.
* ``small``, a short fit of the same model (N = 120, 2 chains, 10 / 30
  iterations, 10 trees, treedepth 4, float64) for the identities the
  reference asserts on its fixture (shapes, extract against fitted, ev as
  the sum of its components, names), at the reference's tolerances.
"""

import numpy as np
import pytest
import torch

import stan4bart_torch as s4b
from stan4bart_tpu.utils.friedman import (
    friedman_dataframe,
    generate_friedman_data,
)

torch.set_num_threads(2)

FORMULA = ("y ~ bart(. - g.1 - g.2 - X4 - z) + X4 + z + (1 + X4 | g.1) "
           "+ (1 | g.2)")
N = 250
CHAINS = 3
WARMUP, ITER = 300, 700  # 400 kept
SMALL_N, SMALL_CHAINS, SMALL_WARMUP, SMALL_ITER = 120, 2, 10, 30


@pytest.fixture(scope="module")
def data():
    d = generate_friedman_data(N, ranef=True, causal=True)
    return d, friedman_dataframe(d)


@pytest.fixture(scope="module")
def fit(data):
    d, df = data
    return s4b.stan4bart(
        FORMULA, df, treatment="z",
        chains=CHAINS, warmup=WARMUP, iter=ITER, seed=7, verbose=-1,
        bart_args={"n.trees": 50}, dtype=torch.float64, device="cpu")


@pytest.fixture(scope="module")
def small():
    df = friedman_dataframe(
        generate_friedman_data(SMALL_N, ranef=True, causal=True))
    return s4b.stan4bart(
        FORMULA, df, treatment="z", chains=SMALL_CHAINS,
        warmup=SMALL_WARMUP, iter=SMALL_ITER, seed=7, verbose=-1,
        bart_args={"n.trees": 10}, stan_args={"max_treedepth": 4},
        dtype=torch.float64, device="cpu")


# -- identities (tests/test_e2e_continuous.py:35-69, 161-189) -------------


def test_no_intercept(small):
    assert "(Intercept)" not in small.mf.X_names
    assert not any(n.startswith("gamma") for n in small.stan_names)


def test_shapes(small):
    kept = SMALL_ITER - SMALL_WARMUP
    ev = small.extract("ev")
    assert ev.shape == (SMALL_N, kept * SMALL_CHAINS)
    ev_nc = small.extract("ev", combine_chains=False)
    assert ev_nc.shape == (SMALL_N, kept, SMALL_CHAINS)
    ev_w = small.extract("ev", include_warmup=True)
    assert ev_w.shape == (SMALL_N, SMALL_ITER * SMALL_CHAINS)
    vc = small.extract("varcount")
    assert vc.shape == (9, kept * SMALL_CHAINS)
    k = small.extract("sigma")
    assert k.shape == (kept * SMALL_CHAINS,)


def test_extract_matches_fitted(small):
    for typ in ("ev", "indiv.bart", "indiv.fixef", "indiv.ranef"):
        draws = small.extract(typ)
        m = small.fitted(typ)
        assert np.allclose(draws.mean(axis=-1), m), typ
    draws = small.extract("ev", sample="test")
    assert np.allclose(draws.mean(axis=-1), small.fitted("ev", sample="test"))


def test_ev_is_sum_of_components(small):
    ev = small.fitted("ev")
    parts = (small.fitted("indiv.bart") + small.fitted("indiv.fixef")
             + small.fitted("indiv.ranef"))
    assert np.allclose(ev, parts, atol=1e-8)


def test_sigma_Sigma_ranef_shapes(small):
    Sig = small.extract("Sigma")
    assert set(Sig.keys()) == {"g.1", "g.2"}
    assert Sig["g.1"].shape[:2] == (2, 2)
    assert Sig["g.2"].shape[:2] == (1, 1)
    ranef = small.extract("ranef")
    assert ranef["g.1"].shape[:2] == (5, 2)
    assert ranef["g.2"].shape[:2] == (8, 1)


def test_fixef_names(small):
    assert small.extract("fixef").shape[0] == 2
    assert small.mf.X_names == ["X4", "z"]


# -- the reference's gates at its fixture (slow) ---------------------------


@pytest.mark.slow
def test_statistical_quality(fit, data):
    """tests/test_e2e_continuous.py:72-96."""
    d, df = data
    bart = fit.fitted("indiv.bart")
    bc = bart - bart.mean()
    tc = d["mu_bart"] - d["mu_bart"].mean()
    cor_bart = np.corrcoef(bc, tc)[0, 1]
    assert cor_bart >= 0.95, f"cor(indiv.bart, truth) = {cor_bart}"

    fx = fit.fitted("indiv.fixef")
    mu_fx = np.where(d["z"] == 1, d["mu_fixef_1"], d["mu_fixef_0"])
    cor_fx = np.corrcoef(fx - fx.mean(), mu_fx - mu_fx.mean())[0, 1]
    assert cor_fx >= 0.99, f"cor(indiv.fixef, truth) = {cor_fx}"

    rf = fit.fitted("indiv.ranef")
    cor_rf = np.corrcoef(rf, d["mu_ranef"])[0, 1]
    assert cor_rf >= 0.68, f"cor(indiv.ranef, truth) = {cor_rf}"

    sigma = fit.fitted("sigma")
    assert 0.8 < sigma < 1.4, f"sigma = {sigma}"


@pytest.mark.slow
def test_treatment_effect(fit, data):
    d, df = data
    ev_train = fit.extract("ev")
    ev_test = fit.extract("ev", sample="test")
    z = d["z"][:, None]
    icate = (ev_train - ev_test) * (2 * z - 1)
    sate = icate.mean(axis=0)
    assert abs(sate.mean() - d["tau"]) < 1.0, f"SATE = {sate.mean()}"


@pytest.mark.slow
def test_ppd_noise_calibration(fit):
    ev = fit.extract("ev")
    ppd = fit.extract("ppd")
    sigma = fit.fitted("sigma")
    ratio = (ppd - ev).std() / sigma
    assert 1 / 1.15 < ratio < 1.15, f"ppd noise ratio = {ratio}"


@pytest.mark.slow
def test_sigma_Sigma_ranef(fit):
    Sig = fit.extract("Sigma")
    assert set(Sig.keys()) == {"g.1", "g.2"}
    assert Sig["g.1"].shape[:2] == (2, 2)
    assert Sig["g.2"].shape[:2] == (1, 1)
    S1 = Sig["g.1"].mean(axis=-1)
    assert np.all(np.linalg.eigvalsh(S1) > 0)
    ranef = fit.extract("ranef")
    assert ranef["g.1"].shape[:2] == (5, 2)
    assert ranef["g.2"].shape[:2] == (8, 1)


@pytest.mark.slow
def test_fixef_names_and_vals(fit):
    fx = fit.extract("fixef")
    assert fx.shape[0] == 2
    assert fit.mf.X_names == ["X4", "z"]
    est = fx.mean(axis=-1)
    assert abs(est[0] - 10.0) < 3.0   # X4 slope
    assert abs(est[1] - 5.0) < 1.5    # treatment effect


@pytest.mark.slow
def test_diagnostics_present(fit):
    stan = fit.extract("stan")
    assert stan.shape[0] == len(fit.stan_names)
    div_idx = fit.stan_names.index("divergent__")
    assert stan[div_idx].sum() < 0.2 * stan.shape[1]


@pytest.mark.slow
def test_leapfrogs_match_reference(fit, data):
    """The port's mean post-warmup leapfrogs per transition against the
    JAX package's fit of the same fixture: the two draw from different
    random streams, so they agree within a quarter (the adaptation's
    stepsize and metric set the count; a fault there moves it by
    factors of 2, one tree depth)."""
    import stan4bart_tpu

    d, df = data
    ref = stan4bart_tpu.stan4bart(
        FORMULA, df, treatment="z",
        chains=CHAINS, warmup=WARMUP, iter=ITER, seed=7, verbose=-1,
        bart_args={"n.trees": 50})
    i_p = fit.stan_names.index("n_leapfrog__")
    i_r = ref.stan_names.index("n_leapfrog__")
    port = fit.extract("stan", combine_chains=False)[i_p]
    want = ref.extract("stan", combine_chains=False)[i_r]
    print(f"post-warmup n_leapfrog__: port {port.mean():.2f} "
          f"(chains {np.round(port.mean(0), 2)}), JAX package "
          f"{want.mean():.2f} (chains {np.round(want.mean(0), 2)})")
    assert abs(port.mean() / want.mean() - 1.0) < 0.25, (
        port.mean(), want.mean())


@pytest.mark.slow
def test_rmse_beats_linear_mixed_model():
    """tests/test_e2e_continuous.py:141-189: the held-out RMSE beats least
    squares on [1, X, Z-dummies]."""
    rng = np.random.default_rng(3)
    d = generate_friedman_data(300, ranef=True, causal=False)
    df = friedman_dataframe(d)
    idx = rng.permutation(300)
    tr, te = idx[:220], idx[220:]
    df_tr = {k: np.asarray(v)[tr] for k, v in df.items()}
    df_te = {k: np.asarray(v)[te] for k, v in df.items()}

    fit = s4b.stan4bart(
        "y ~ bart(. - g.1 - g.2 - X4) + X4 + (1 + X4 | g.1) + (1 | g.2)",
        df_tr, test=df_te,
        chains=2, warmup=250, iter=600, seed=9, verbose=-1,
        bart_args={"n.trees": 50}, dtype=torch.float64, device="cpu")
    yhat_test = fit.fitted(sample="test")
    rmse_bart = float(np.sqrt(np.mean((yhat_test - df_te["y"]) ** 2)))

    def design(dd):
        cols = [np.ones(len(dd["y"]))]
        for j in range(1, 11):
            cols.append(np.asarray(dd[f"X{j}"], float))
        for g, inter in (("g.1", False), ("g.1", True), ("g.2", False)):
            levels = np.unique(np.asarray(df[g]))
            onehot = (np.asarray(dd[g])[:, None] == levels[None, :]
                      ).astype(float)
            cols.append(onehot * np.asarray(dd["X4"], float)[:, None]
                        if inter else onehot)
        return np.column_stack(cols)

    A_tr, A_te = design(df_tr), design(df_te)
    coef, *_ = np.linalg.lstsq(A_tr, np.asarray(df_tr["y"], float),
                               rcond=None)
    rmse_lin = float(np.sqrt(np.mean((A_te @ coef - df_te["y"]) ** 2)))
    assert rmse_bart <= rmse_lin, (rmse_bart, rmse_lin)
