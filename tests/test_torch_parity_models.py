"""Models with no parametric coefficients, and the ``dtype`` argument, on
the port against the JAX package.

A pure-BART model (``y ~ bart(...)``) has no fixed and no random effect.
For probit it has no aux either, so its unconstrained vector is empty
(D = 0): NUTS has nothing to move, every transition is one leapfrog of an
empty momentum (accept 1, treedepth 1, no divergence, energy -lp__), and
dual averaging drives the stepsize up from Stan's stepsize search, which
doubles to its cap of 1e7.  Both packages' fits of the same data must
have the same draw layout and, the stepsize path being deterministic, the
same ``stan`` rows but lp__ (float64; lp__ depends on the latents).  The
gaussian pure-BART model keeps aux (D = 1) and mirrors
tests/test_misc_parity.py:52-60.  One JAX fit per family, n = 100, 2
chains, 20 / 40 iterations, 10 trees, each in a thread of its own beside
the port's fits.

``stan4bart(dtype=)`` takes float32 and float64 as torch dtypes, names or
numpy dtypes, as the JAX package does, and names what it takes when given
anything else."""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import stan4bart_torch
import stan4bart_tpu
from stan4bart_tpu.utils.friedman import (
    friedman_dataframe,
    generate_friedman_data,
)

torch.set_num_threads(2)

FORMULA = "y ~ bart(X1 + X2 + X3 + X4 + X5)"
KW = dict(chains=2, warmup=20, iter=40, seed=12, verbose=-1,
          bart_args={"n.trees": 10})
FAMILIES = ("binomial", "gaussian")
LAYOUT = ("stan", "ev", "indiv.bart", "indiv.fixef", "indiv.ranef", "ppd",
          "fixef", "varcount", "k")


@pytest.fixture(scope="module")
def fits():
    """Each family's data and both packages' fits; the reference's fits
    compile and run in threads of their own beside the port's."""
    dfs = {family: friedman_dataframe(generate_friedman_data(
        100, ranef=True, binary=family == "binomial"))
        for family in FAMILIES}
    with ThreadPoolExecutor(len(FAMILIES)) as pool:
        refs = {family: pool.submit(stan4bart_tpu.stan4bart, FORMULA,
                                    dfs[family], **KW)
                for family in FAMILIES}
        ports = {family: stan4bart_torch.stan4bart(
            FORMULA, dfs[family], device="cpu", dtype=torch.float64, **KW)
            for family in FAMILIES}
        return {family: (dfs[family], refs[family].result(), ports[family])
                for family in FAMILIES}


@pytest.mark.parametrize("family", FAMILIES)
def test_pure_bart_draw_layout_matches(fits, family):
    df, ref, port = fits[family]
    assert port.family == ref.family == family
    assert port.mf.K == 0 and port.mf.q == 0
    assert port.pm.num_upars == ref.pm.num_upars
    assert port.stan_names == ref.stan_names
    for typ in LAYOUT:
        assert port.extract(typ).shape == ref.extract(typ).shape, typ
    assert port.extract("fixef").shape[0] == 0
    assert port.extract("ranef") == {} and port.extract("Sigma") == {}
    for name in ("stan", "bart_train", "varcount", "k"):
        assert np.all(np.isfinite(getattr(port.draws, name))), name


def test_probit_pure_bart_stan_rows_match(fits):
    df, ref, port = fits["binomial"]
    assert port.pm.num_upars == 0
    assert port.stan_names == ["lp__", "accept_stat__", "stepsize__",
                               "treedepth__", "n_leapfrog__", "divergent__",
                               "energy__"]
    got = port.extract("stan", include_warmup=True, combine_chains=False)
    want = ref.extract("stan", include_warmup=True, combine_chains=False)
    np.testing.assert_allclose(got[1:6], want[1:6], rtol=1e-12)
    np.testing.assert_array_equal(got[4], 1.0)      # one leapfrog each
    np.testing.assert_allclose(got[6], -got[0], rtol=1e-12)  # energy
    assert np.all(np.isfinite(got[0]))


@pytest.mark.parametrize("family", FAMILIES)
def test_pure_bart_fits_the_data(fits, family):
    """tests/test_misc_parity.py:52-60 (r^2 > 0.7 for the gaussian model);
    probit: calibration against the observed outcome."""
    df, ref, port = fits[family]
    ev = port.fitted("ev")
    if family == "gaussian":
        assert np.corrcoef(ev, df["y"])[0, 1] ** 2 > 0.7
        assert np.all(port.extract("sigma") > 0)
    else:
        assert np.all((ev > 0) & (ev < 1))
        y = np.asarray(df["y"])
        assert ev[y == 1].mean() > ev[y == 0].mean()
        assert set(np.unique(port.extract("ppd"))) <= {0.0, 1.0}


@pytest.mark.parametrize("algorithm,stan_args", [
    ("vi", {}), ("advi", {}), ("advi", {"vi_family": "fullrank"})])
def test_probit_pure_bart_under_vi(fits, algorithm, stan_args):
    """The VI samplers on the empty vector: the NUTS fit's layout, and
    the rows the JAX package's VI fits of this model give (accept 1,
    stepsize 0.5, treedepth 0, vi_steps x vi_mc = 20 log-density calls,
    no divergence)."""
    df, ref, port = fits["binomial"]
    fit = stan4bart_torch.stan4bart(
        FORMULA, df, device="cpu", dtype=torch.float64,
        algorithm=algorithm, stan_args=stan_args, **KW)
    assert fit.stan_names == port.stan_names
    assert fit.extract("ev").shape == port.extract("ev").shape
    stan = fit.extract("stan", include_warmup=True)
    np.testing.assert_array_equal(
        stan[1:6], np.broadcast_to([[1.0], [0.5], [0.0], [20.0], [0.0]],
                                   stan[1:6].shape))
    assert np.all(np.isfinite(stan[0]))


@pytest.mark.parametrize("dtype,want", [
    ("float32", torch.float32), ("float64", torch.float64),
    (np.float32, torch.float32), (np.dtype("float64"), torch.float64),
    (torch.float64, torch.float64), (None, torch.float32)])
def test_dtype_names_and_numpy_dtypes(dtype, want):
    df = friedman_dataframe(generate_friedman_data(40))
    fit = stan4bart_torch.stan4bart(
        "y ~ bart(X1 + X2) + X4", df, chains=1, warmup=2, iter=4, seed=0,
        verbose=-1, bart_args={"n.trees": 2}, device="cpu", dtype=dtype)
    assert fit.prog.dtype == want
    assert fit.final_states.nuts.q.dtype == want


@pytest.mark.parametrize("dtype", ["float16", torch.bfloat16, "bogus", 3])
def test_unknown_dtype_names_the_accepted_ones(dtype):
    df = friedman_dataframe(generate_friedman_data(40))
    with pytest.raises(ValueError, match="float32 or float64.*'float32'"):
        stan4bart_torch.stan4bart("y ~ bart(X1 + X2) + X4", df, iter=4,
                                  device="cpu", dtype=dtype)
