"""The JAX package's ``na_action``, new-level, resume, ``skip`` and ``cores``
tests on the port, on the CPU: tests/test_checkpoint_na.py:57-129 and
tests/test_cores_skip.py:30-90.

``na_action="exclude"`` reinserts the dropped rows as NaN at the fit
object and ``"omit"`` drops them; the frames both build are held to the
JAX package's ``build_model_frame``.  Rows of one new group level share
one random-effect draw per iteration.  A resume is equal to the bit
whole and chunked, and ``dtype="float32"`` (a name, as the reference
passes it) runs the chain-blocked driver.  ``skip`` as a dict, a tuple
and an int lands on the program; ``cores > 1`` on the CPU runs the
single-device path, so it equals the ``cores = 1`` fit to the bit (the
reference compares its sharded fit loosely, its batch rounding
differing)."""

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

RANEF = "y ~ bart(X1+X2) + X4 + (1 | g.2)"
SHALLOW = {"max_treedepth": 4}


def _fit(formula, df, **kw):
    return s4b.stan4bart(formula, df, verbose=-1, device="cpu", **kw)


def _df(n=100):
    return friedman_dataframe(generate_friedman_data(n, ranef=True))


def _na_df():
    df = friedman_dataframe(generate_friedman_data(90))
    df["X1"] = df["X1"].copy()
    df["X1"][[3, 17]] = np.nan        # bart-component NAs
    df["X4"] = df["X4"].copy()
    df["X4"][7] = np.nan              # fixed-component NA
    return df


@pytest.mark.parametrize("na_action", ["omit", "exclude"])
def test_na_frames_match_reference(na_action):
    got = port_mf("y ~ bart(X1+X2) + X4", _na_df(), na_action=na_action)
    want = ref_mf("y ~ bart(X1+X2) + X4", _na_df(), na_action=na_action)
    assert got.na_action == want.na_action == na_action
    for name in ("y", "X", "bart_X", "complete_rows"):
        np.testing.assert_array_equal(np.asarray(getattr(got, name)),
                                      np.asarray(getattr(want, name)), name)


def test_na_exclude_reinserts():
    fit = _fit("y ~ bart(X1+X2) + X4", _na_df(), chains=1, warmup=5,
               iter=10, seed=0, na_action="exclude",
               bart_args={"n.trees": 4}, stan_args=SHALLOW)
    assert fit.mf.N == 87
    ev = fit.extract("ev")
    assert ev.shape[0] == 90
    assert np.isnan(ev[[3, 7, 17]]).all()
    assert np.isfinite(ev[np.setdiff1d(np.arange(90), [3, 7, 17])]).all()
    assert np.isnan(fit.fitted("ev")[[3, 7, 17]]).all()


def test_na_omit_drops():
    df = friedman_dataframe(generate_friedman_data(90))
    df["X1"] = df["X1"].copy()
    df["X1"][[3, 17]] = np.nan
    fit = _fit("y ~ bart(X1+X2) + X4", df, chains=1, warmup=5, iter=10,
               seed=0, na_action="omit", bart_args={"n.trees": 4},
               stan_args=SHALLOW)
    assert fit.mf.N == 88
    assert fit.extract("ev").shape[0] == 88


def test_new_level_draws_shared_within_level():
    df = friedman_dataframe(generate_friedman_data(80, ranef=True))
    fit = _fit(RANEF, df, chains=1, warmup=5, iter=10, seed=0,
               bart_args={"n.trees": 4}, stan_args=SHALLOW)
    new = {c: np.asarray(df[c])[:6].copy() for c in df}
    new["g.2"] = np.array(["newA", "newA", "newA", "newB", "newB", "newB"],
                          dtype=object)
    tf = fit.mf.build_test_frame(new)
    ran = fit._indiv_ranef(False, sample_new_levels=True, frame=tf)
    np.testing.assert_allclose(ran[..., 0], ran[..., 1])
    np.testing.assert_allclose(ran[..., 3], ran[..., 4])
    assert np.max(np.abs(ran[..., 0] - ran[..., 3])) > 1e-8


def test_continue_sampling_chunked_equals_single_execution():
    df = friedman_dataframe(generate_friedman_data(80, ranef=True))
    fit = _fit(RANEF, df, chains=2, warmup=5, iter=10, seed=4,
               bart_args={"n.trees": 5}, stan_args=SHALLOW)
    whole = fit.continue_sampling(12)
    chunked = fit.continue_sampling(12, chunk_size=5)
    np.testing.assert_array_equal(whole.draws.stan, chunked.draws.stan)
    np.testing.assert_array_equal(whole.draws.bart_train,
                                  chunked.draws.bart_train)
    # a float32 fit named as a string resumes on the chain-blocked driver
    fit32 = _fit(RANEF, df, chains=2, warmup=4, iter=8, seed=4,
                 dtype="float32", stan_args=SHALLOW,
                 bart_args={"n.trees": 5, "sweep_kernel": True})
    assert fit32.prog.dtype == torch.float32
    more = fit32.continue_sampling(8, chunk_size=3)
    assert more.iterations == fit32.iterations + 8
    assert np.all(np.isfinite(more.extract("sigma")))


@pytest.mark.parametrize("skip,want", [
    ({"bart": 2, "stan": 3}, (2, 3)), ((2, 2), (2, 2)), (3, (3, 3))])
def test_skip_thinning(skip, want):
    fit = _fit(RANEF, _df(), chains=1, warmup=6, iter=12, seed=3,
               skip=skip, bart_args={"n.trees": 4}, stan_args=SHALLOW)
    assert (fit.prog.skip_bart, fit.prog.skip_stan) == want
    # one stored draw per iteration whatever the thinning
    assert fit.draws.stan.shape[1] == 12
    assert np.all(np.isfinite(fit.extract("ev")))


def test_cores_fused_sweep_dispatch():
    df = _df()
    kw = dict(chains=4, warmup=6, iter=12, seed=11, stan_args=SHALLOW,
              bart_args={"n.trees": 4, "sweep_kernel": True},
              dtype="float32")
    f_cores = _fit(RANEF, df, cores=4, **kw)
    f_single = _fit(RANEF, df, **kw)
    assert f_cores.prog.sweep_consts is not None
    assert f_cores.prog.dtype == torch.float32
    np.testing.assert_array_equal(f_cores.draws.stan, f_single.draws.stan)
    assert np.all(np.isfinite(f_cores.extract("ev")))
    f_again = _fit(RANEF, df, cores=4, **kw)
    np.testing.assert_array_equal(f_cores.draws.stan, f_again.draws.stan)


def test_cores_keep_fits_false_dispatch():
    fit = _fit(RANEF, _df(), chains=4, cores=4, warmup=4, iter=8, seed=3,
               keep_fits=False, dtype="float32", stan_args=SHALLOW,
               bart_args={"n.trees": 4, "sweep_kernel": True})
    assert fit.draws is None  # the reference stores nothing
    assert fit.final_states.nuts.q.dtype == torch.float32
