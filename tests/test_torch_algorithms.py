"""The port's ``algorithm`` surface and SMC adjudication through
``stan4bart``, mirroring tests/test_algorithms.py and
tests/test_vi_gibbs.py on tiny fits (120 rows, 2 chains, 20 iterations,
10 trees, on the CPU).

``algorithm="vi"`` warns that its sigma is biased high and runs
streaming RMSProp; ``"advi"`` runs adagrad on the ``vi_family`` q.  A VI
fit's draws have a NUTS fit's layout, with the reference's sampler
columns for VI.  On the CPU every path is deterministic, so chunked,
resumed (after ``save`` / ``load``) and per-chain (callback) VI fits are
held to an uninterrupted batched one to the bit: the variational state,
its step count included, carries over.  SMC adjudication bridges to the
target for a gaussian fit and refuses a probit one."""

import warnings

import numpy as np
import pytest
import torch

import stan4bart_torch as s4b
from stan4bart_torch.utils.friedman import (
    friedman_dataframe,
    generate_friedman_data,
)

torch.set_num_threads(2)

FORMULA = ("y ~ bart(. - g.1 - g.2 - X4 - z) + X4 + z + (1 + X4 | g.1) "
           "+ (1 | g.2)")
ITER = 20
KW = dict(treatment="z", chains=2, warmup=10, iter=ITER, seed=11,
          verbose=-1, bart_args={"n.trees": 10}, device="cpu")
FIELDS = ("stan", "bart_train", "bart_test", "varcount", "k")


@pytest.fixture(scope="module")
def df():
    return friedman_dataframe(generate_friedman_data(120, ranef=True,
                                                     causal=True))


def _fit(df, record=None, **kw):
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        fit = s4b.stan4bart(FORMULA, df, **{**KW, **kw})
    if record is not None:
        record.extend(str(w.message) for w in caught)
    return fit


@pytest.fixture(scope="module")
def vi_fit(df):
    caught = []
    fit = _fit(df, caught, algorithm="vi")
    fit.caught = caught
    return fit


def _assert_draws_equal(a, b, iters=None):
    for name in FIELDS:
        x = getattr(a.draws, name)
        y = getattr(b.draws, name)[:, :iters]
        assert np.array_equal(x, y), name


def test_vi_warns_and_runs_rmsprop(vi_fit):
    assert any("biased high" in m for m in vi_fit.caught)
    prog = vi_fit.prog
    assert (prog.parametric_method, prog.vi_method, prog.vi_family) == (
        "vi", "rmsprop", "meanfield")
    for name in FIELDS:
        assert np.all(np.isfinite(getattr(vi_fit.draws, name))), name
    vi = vi_fit.final_states.vi
    assert torch.equal(vi.count,
                       torch.full((2,), float(ITER * prog.vi_steps)))
    assert vi.L_off.shape == (2, 0, 0)


def test_advi_fullrank_runs_adagrad(df):
    caught = []
    fit = _fit(df, caught, algorithm="advi", iter=20, warmup=10,
               stan_args={"vi_family": "fullrank"})
    assert not any("biased high" in m for m in caught)
    prog = fit.prog
    assert (prog.vi_method, prog.vi_family) == ("adagrad", "fullrank")
    P = fit.pm.num_upars
    assert fit.final_states.vi.L_off.shape == (2, P, P)
    assert fit.final_states.vi.acc.shape == (2, 2 * P + P * P)
    for name in FIELDS:
        assert np.all(np.isfinite(getattr(fit.draws, name))), name


def test_vi_draw_layout_equals_nuts(df, vi_fit):
    """The same names and shapes as a NUTS fit; the sampler columns hold
    accept_stat__ 1, stepsize__ vi_eta, treedepth__ 0, n_leapfrog__
    vi_steps * vi_mc and divergent__ 0.  Then SMC adjudication of the
    NUTS fit at 128 particles."""
    nuts = _fit(df, stan_args={"max_treedepth": 2})
    assert vi_fit.stan_names == nuts.stan_names
    for name in FIELDS:
        assert (getattr(vi_fit.draws, name).shape
                == getattr(nuts.draws, name).shape), name
    stan = vi_fit.draws.stan
    col = {n: stan[..., i] for i, n in enumerate(vi_fit.stan_names[:7])}
    prog = vi_fit.prog
    assert np.all(col["accept_stat__"] == 1.0)
    assert np.all(col["stepsize__"] == np.float32(prog.vi_eta))
    assert np.all(col["treedepth__"] == 0.0)
    assert np.all(col["n_leapfrog__"] == prog.vi_steps * prog.vi_mc)
    assert np.all(col["divergent__"] == 0.0)
    # energy__ is -logp at the draw from q; lp__ is taken again after the
    # linear refresh and the level interweave, as in the JAX package
    assert vi_fit.prog.linear_gibbs and vi_fit.prog.level_gibbs
    assert np.all(np.isfinite(col["energy__"]))

    adj = nuts.adjudicate_parametric_smc(n_particles=128, n_mcmc=2)
    names = nuts.pm.constrained_names()
    assert adj["final_temp"] == 1.0
    assert np.isfinite(adj["log_evidence"])
    assert adj["names"] == names
    assert adj["draws"].shape == (128, len(names))
    assert adj["smc_mean"].shape == adj["mcmc_mean"].shape == (len(names),)
    assert np.all(np.isfinite(adj["draws"]))


def test_vi_chunked_and_resumed_equal_uninterrupted(df, vi_fit, tmp_path):
    """A fit 10 iterations longer, in chunks of 7, against the fit run
    whole (its first ITER iterations) and against that fit saved, loaded
    and resumed for 10 iterations."""
    longer = _fit(df, algorithm="vi", iter=ITER + 10, chunk_size=7)
    _assert_draws_equal(vi_fit, longer, iters=ITER)
    path = tmp_path / "vi.pkl"
    vi_fit.save(str(path))
    back = s4b.Stan4bartFit.load(str(path), device="cpu")
    assert back.prog.vi_method == "rmsprop"
    assert torch.equal(back.final_states.vi.count,
                       vi_fit.final_states.vi.count)
    resumed = back.continue_sampling(10)
    _assert_draws_equal(resumed, longer)
    _assert_draws_equal(longer, resumed)
    for a, b in zip(resumed.final_states.vi, longer.final_states.vi):
        assert torch.equal(a, b)


def test_vi_callback_step_equals_batched(df, vi_fit):
    """The per-chain driver (``GibbsProgram.step``) draws what the batched
    one draws."""
    fit = _fit(df, algorithm="vi",
               callback=lambda d: {"sigma": d["aux.1"]})
    assert fit.per_chain
    _assert_draws_equal(fit, vi_fit)
    assert np.array_equal(fit.extract("callback")["sigma"],
                          vi_fit.extract("sigma"))


def test_probit_vi_runs_and_smc_refuses():
    d = generate_friedman_data(120, ranef=True, causal=True, binary=True)
    fit = _fit(friedman_dataframe(d), algorithm="vi")
    assert fit.family == "binomial"
    for name in FIELDS:
        assert np.all(np.isfinite(getattr(fit.draws, name))), name
    ev = fit.extract("ev")
    assert np.all((ev >= 0) & (ev <= 1))
    with pytest.raises(NotImplementedError):
        fit.adjudicate_parametric_smc(n_particles=64)


def test_bad_algorithm_message(df):
    with pytest.raises(ValueError, match="'nuts', 'vi', or 'advi'"):
        s4b.stan4bart("y ~ bart(X1 + X2) + X4 + (1 | g.2)", df,
                      algorithm="laplace", device="cpu")
