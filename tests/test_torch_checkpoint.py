"""Checkpoint and resume of the port: ``save``, ``load`` and
``continue_sampling``, mirroring tests/test_checkpoint_na.py:11-38 and
:107-131.

The port draws from an external ``torch.Generator`` whose state the fit
keeps; every resume starts a fresh generator from a copy of it.  On the
CPU the whole path is deterministic, so the resumed draws are held to
the bit: whole against chunked, two resumes of one fit, and a resume
after ``save``/``load`` against one before.  The JAX package's resume of
the same model gives the layout the port's must have (iteration counts,
every stored field, forests included, appended along the iteration
axis); the two samplers share no random stream, so that comparison is of
shapes and of the untouched old draws.  One fit per package: n = 80, 2
chains, 30 iterations (15 warmup), 5 trees, treedepth capped at 4, on
the CPU."""

import pickle
from concurrent.futures import ThreadPoolExecutor
from dataclasses import replace

import numpy as np
import pytest
import torch

import stan4bart_torch
import stan4bart_tpu
from stan4bart_torch.gibbs import tree_map
from stan4bart_tpu.utils.friedman import (
    friedman_dataframe,
    generate_friedman_data,
)

torch.set_num_threads(2)

FORMULA = "y ~ bart(X1 + X2) + X4 + (1 | g.2)"
KW = dict(chains=2, warmup=15, iter=30, seed=4, verbose=-1,
          bart_args={"n.trees": 5, "keep_trees": True},
          stan_args={"max_treedepth": 4})
FIELDS = ("stan", "bart_train", "bart_test", "varcount", "k",
          "tree_feature", "tree_cut", "tree_leaf_value")


@pytest.fixture(scope="module")
def df():
    return friedman_dataframe(generate_friedman_data(80, ranef=True))


@pytest.fixture(scope="module")
def pool():
    """One thread in which the JAX package's fit compiles and runs beside
    the port's work."""
    with ThreadPoolExecutor(1) as ex:
        yield ex


@pytest.fixture(scope="module")
def ref_started(pool, df):
    return pool.submit(stan4bart_tpu.stan4bart, FORMULA, df, **KW)


@pytest.fixture(scope="module")
def fit(df, ref_started):
    """The port's fit; the reference's, started first, runs meanwhile."""
    return stan4bart_torch.stan4bart(FORMULA, df, device="cpu", **KW)


@pytest.fixture(scope="module")
def ref_fit(ref_started):
    return ref_started.result()


def _assert_draws_equal(a, b):
    for name in FIELDS:
        x, y = getattr(a.draws, name), getattr(b.draws, name)
        if x is None:
            assert y is None, name
        else:
            np.testing.assert_array_equal(x, y, err_msg=name)


def _state_leaves(states):
    out = []
    tree_map(lambda t: out.append(t.clone()), states)
    return out


def test_save_load_roundtrip(fit, df, tmp_path):
    path = str(tmp_path / "fit.pkl")
    fit.save(path)
    back = stan4bart_torch.Stan4bartFit.load(path, device="cpu")
    assert back.prog is not fit.prog and back.prog.device.type == "cpu"
    _assert_draws_equal(back, fit)
    np.testing.assert_array_equal(back.extract("ev"), fit.extract("ev"))
    np.testing.assert_array_equal(back.extract("sigma"),
                                  fit.extract("sigma"))
    np.testing.assert_array_equal(back.predict(df, type="indiv.bart"),
                                  fit.predict(df, type="indiv.bart"))
    for a, b in zip(_state_leaves(back.final_states),
                    _state_leaves(fit.final_states)):
        assert torch.equal(a, b)
    assert torch.equal(back.rng_state, fit.rng_state)
    assert back.stan_names == fit.stan_names
    assert back.prog.keep_trees and back.prog.warmup == fit.prog.warmup


def test_continue_sampling(fit):
    """Iterations grow by n, the old draws stay as they were, the new
    ones are finite, and the forests are appended."""
    more = fit.continue_sampling(6)
    assert more.iterations == fit.iterations + 6
    assert more.warmup == fit.warmup
    for name in FIELDS:
        old = getattr(fit.draws, name)
        new = getattr(more.draws, name)
        assert new.shape[1] == old.shape[1] + 6, name
        np.testing.assert_array_equal(new[:, : fit.iterations], old)
        assert np.all(np.isfinite(new)), name
    ev = more.extract("ev")
    assert ev.shape[-1] == (more.iterations - more.warmup) * 2


def test_continue_whole_equals_chunked(fit):
    """Chunk boundaries do not change the resumed draws: equal to the
    bit, forests included."""
    whole = fit.continue_sampling(6)
    chunked = fit.continue_sampling(6, chunk_size=4)
    _assert_draws_equal(whole, chunked)
    assert torch.equal(whole.rng_state, chunked.rng_state)


def test_resume_leaves_the_fit_as_it_was(fit):
    """Two resumes of one fit draw the same, and neither advances the
    fit: its generator state, final states and draws are unchanged."""
    rng = fit.rng_state.clone()
    states = _state_leaves(fit.final_states)
    stan = fit.draws.stan.copy()
    a = fit.continue_sampling(4)
    b = fit.continue_sampling(4)
    _assert_draws_equal(a, b)
    assert torch.equal(fit.rng_state, rng)
    for x, y in zip(_state_leaves(fit.final_states), states):
        assert torch.equal(x, y)
    np.testing.assert_array_equal(fit.draws.stan, stan)
    assert not torch.equal(a.rng_state, rng)
    # a resume of the resumed fit continues its stream
    c = a.continue_sampling(2)
    assert c.iterations == fit.iterations + 6


def test_resume_after_load_equals_resume_before_save(fit, tmp_path):
    before = fit.continue_sampling(5, chunk_size=2)
    path = str(tmp_path / "fit.pkl")
    fit.save(path)
    after = stan4bart_torch.Stan4bartFit.load(path, device="cpu") \
        .continue_sampling(5)
    _assert_draws_equal(before, after)


def test_resume_per_chain_fit(df, monkeypatch):
    """A fit with a callback resumes on the per-chain driver, whole equal
    to chunked; the callback's stored outputs are not extended."""
    fit = stan4bart_torch.stan4bart(
        FORMULA, df, device="cpu",
        callback=lambda d: {"sigma": d["aux.1"]},
        **dict(KW, iter=8, warmup=4))
    assert fit.per_chain
    calls = {"step": 0, "step_batched": 0}
    for name in calls:
        orig = getattr(fit.prog, name)

        def spy(*a, _name=name, _orig=orig):
            calls[_name] += 1
            return _orig(*a)

        monkeypatch.setattr(fit.prog, name, spy)
    whole = fit.continue_sampling(4)
    chunked = fit.continue_sampling(4, chunk_size=3)
    assert calls == {"step": 8, "step_batched": 0}
    _assert_draws_equal(whole, chunked)
    assert whole.extract("callback")["sigma"].shape == \
        fit.extract("callback")["sigma"].shape


def test_resume_matches_reference_layout(fit, ref_fit):
    """The port's resume has the JAX package's layout: the same
    iteration count and, for every stored field, the same shape."""
    ref_more = ref_fit.continue_sampling(4)
    more = fit.continue_sampling(4)
    assert more.iterations == ref_more.iterations == 34
    for name in FIELDS:
        assert getattr(more.draws, name).shape == \
            np.asarray(getattr(ref_more.draws, name)).shape, name
    np.testing.assert_array_equal(
        np.asarray(ref_more.draws.stan)[:, :30], ref_fit.draws.stan)


def test_loaded_on_another_device_type_does_not_resume(fit, tmp_path):
    """A generator state is tied to its device type: loaded on another
    type, the fit serves its accessors but refuses to resume."""
    path = str(tmp_path / "fit.pkl")
    fit.save(path)
    with open(path, "rb") as fh:
        payload = pickle.load(fh)
    payload["rng_device"] = "cuda"          # as written on the card
    with open(path, "wb") as fh:
        pickle.dump(payload, fh)
    back = stan4bart_torch.Stan4bartFit.load(path, device="cpu")
    assert back.rng_state is None
    np.testing.assert_array_equal(back.extract("ev"), fit.extract("ev"))
    with pytest.raises(ValueError, match="device type"):
        back.continue_sampling(2)


def test_load_needs_cuda_or_explicit_cpu(fit, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    path = str(tmp_path / "fit.pkl")
    fit.save(path)
    for kw in ({}, {"device": "cuda"}):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            stan4bart_torch.Stan4bartFit.load(path, **kw)


def test_continue_needs_raw_draws_and_a_count(fit, df):
    no_keep = stan4bart_torch.stan4bart(
        FORMULA, df, device="cpu", keep_fits=False,
        **dict(KW, iter=4, warmup=2))
    with pytest.raises(ValueError, match="keep_fits"):
        no_keep.continue_sampling(2)
    with pytest.raises(ValueError, match="iterations"):
        fit.continue_sampling(0)
    with pytest.raises(ValueError, match="final sampler state"):
        replace(fit, final_states=None).continue_sampling(2)
