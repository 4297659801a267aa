"""Stored forests of the port: ``keep_trees``, ``predict``, ``trees``,
``print_trees`` and ``prior_summary`` against the JAX package.

On the port's own fit, the identities of tests/test_predict_trees.py:
walking the stored forests over the training rows gives the stored BART
fit, and over the counterfactual rows the stored test fit (exactly: the
sampler's BART fit is the sum of its trees' fits, and both walks are the
same ``predict_trees``; asserted to the reference's 1e-10). On the
reference's own stored forests, carried into the port's fit object with
``stan4bart_torch.convert.draws_from_numpy``: ``predict`` equal to the
reference's to 1e-12 (float64 sums in another order), ``trees()`` and
the ``print_trees`` / ``prior_summary`` text identical. Then the per-
chain and chain-batched drivers store the same forests to the bit, every
spelling of the option is accepted, a fit without it refuses to predict,
and Z b (which ev and predict add) is the same from the dense design and
from the per-row gather, new levels included. One fit per package: n =
120, 2 chains, 20 iterations (10 warmup), 10 trees, treedepth capped at
4, on the CPU; a
``cuda``-marked test holds ``predict`` on the card against the CPU."""

from concurrent.futures import ThreadPoolExecutor
from dataclasses import replace

import numpy as np
import pytest
import torch

import stan4bart_torch
import stan4bart_tpu
from stan4bart_torch.convert import draws_from_numpy
from stan4bart_torch.formula.design import build_model_frame
from stan4bart_torch.gibbs import GibbsProgram
from stan4bart_torch.models.assemble import build_parametric_model
from stan4bart_torch.ops.bart import BartConfig
from stan4bart_tpu.utils.friedman import (
    friedman_dataframe,
    generate_friedman_data,
)

torch.set_num_threads(2)

FORMULA = "y ~ bart(X1 + X2 + X3 + X5) + X4 + z + (1 | g.2)"
N = 120
ITER, WARMUP = 20, 10
KEPT = ITER - WARMUP
KW = dict(treatment="z", chains=2, iter=ITER, warmup=WARMUP, seed=3,
          verbose=-1,
          bart_args={"n.trees": 10, "keep_trees": True},
          stan_args={"max_treedepth": 4})


@pytest.fixture(scope="module")
def df():
    return friedman_dataframe(generate_friedman_data(N, ranef=True,
                                                     causal=True))


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
def ref_fit(ref_started):
    return ref_started.result()


@pytest.fixture(scope="module")
def port_fit(df, ref_started):
    """The port's fit; the reference's, started first, runs meanwhile."""
    return stan4bart_torch.stan4bart(FORMULA, df, device="cpu",
                                     dtype=torch.float64, **KW)


@pytest.fixture(scope="module")
def carried(ref_fit, port_fit):
    """The port's fit object over the reference's stored draws."""
    np.testing.assert_array_equal(port_fit.prog.cuts, ref_fit.prog.cuts)
    return replace(port_fit, draws=draws_from_numpy(ref_fit.draws),
                   warmup=ref_fit.warmup)


def _counterfactual(df):
    flipped = dict(df)
    flipped["z"] = 1.0 - np.asarray(df["z"], dtype=float)
    return flipped


def test_stored_forest_shapes(port_fit):
    """(chains, iterations, trees, max_nodes) int32 structure and float
    leaves, one per stored iteration, warmup included."""
    d = port_fit.draws
    assert d.tree_feature.shape == (2, ITER, 10, 127)
    assert d.tree_feature.dtype == d.tree_cut.dtype == np.int32
    assert d.tree_leaf_value.shape == (2, ITER, 10, 127)
    assert np.all(np.isfinite(d.tree_leaf_value))


def test_predict_train_equals_extract(port_fit, df):
    pred = port_fit.predict(df, type="indiv.bart")
    np.testing.assert_allclose(pred, port_fit.extract("indiv.bart"),
                               atol=1e-10)


def test_predict_counterfactual_equals_extract_test(port_fit, df):
    pred = port_fit.predict(_counterfactual(df), type="indiv.bart")
    np.testing.assert_allclose(
        pred, port_fit.extract("indiv.bart", sample="test"), atol=1e-10)


def test_predict_ev_equals_extract(port_fit, df):
    pred = port_fit.predict(df, type="ev", sample_new_levels=False)
    stored = port_fit.extract("ev", sample_new_levels=False)
    np.testing.assert_allclose(pred, stored, atol=1e-10)


def test_predict_components(port_fit, df):
    fx = port_fit.predict(df, type="indiv.fixef")
    rf = port_fit.predict(df, type="indiv.ranef")
    bt = port_fit.predict(df, type="indiv.bart")
    ev = port_fit.predict(df, type="ev")
    np.testing.assert_allclose(ev, fx + rf + bt, atol=1e-10)


def test_predict_new_rows_offset_and_ppd(port_fit, df):
    new = {k: np.asarray(v)[:30] for k, v in df.items()}
    ev = port_fit.predict(new, type="ev")
    assert ev.shape == (30, 2 * KEPT) and np.all(np.isfinite(ev))
    np.testing.assert_allclose(
        port_fit.predict(new, type="ev", offset=np.full(30, 2.0)), ev + 2.0,
        atol=1e-10)
    ppd = port_fit.predict(new, type="ppd", combine_chains=False)
    assert ppd.shape == (30, KEPT, 2) and np.all(np.isfinite(ppd))


@pytest.mark.parametrize("type_", ["indiv.bart", "ev"])
def test_predict_matches_reference_on_same_trees(ref_fit, carried, df,
                                                 type_):
    """The reference's forests walked by the port equal the reference's
    own prediction to 1e-12 (float64 sums over the trees in another
    order); new rows included."""
    for data in (df, _counterfactual(df)):
        want = ref_fit.predict(data, type=type_, sample_new_levels=False)
        got = carried.predict(data, type=type_, sample_new_levels=False)
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


def test_trees_match_reference(ref_fit, carried):
    """trees(): identical columns (preorder rows, 0-based var, -1
    leaves, training counts per node)."""
    want = ref_fit.trees()
    got = carried.trees()
    assert list(got) == list(want) == ["chain", "sample", "tree", "n",
                                       "var", "value"]
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_print_trees_and_prior_summary_match_reference(ref_fit, carried,
                                                       capsys):
    """Identical text."""
    for fit in (ref_fit, carried):
        fit.print_trees(chains=1, samples=[0, 5], max_print=3)
        fit.print_trees(trees=2, max_print=2)
        fit.prior_summary()
    out = capsys.readouterr().out
    half = len(out) // 2
    assert out[:half] == out[half:]
    assert "leaf" in out and "<=" in out and "Priors:" in out


def test_trees_export(port_fit):
    """tests/test_predict_trees.py:59: columns, tree ids, every kept
    sample, leaves present, and every root counts all n rows."""
    tr = port_fit.trees()
    assert set(tr) == {"chain", "sample", "tree", "n", "var", "value"}
    assert tr["tree"].max() == 9
    assert len(np.unique(tr["sample"])) == port_fit.iterations - WARMUP
    assert (tr["var"] == -1).sum() > 0
    first_rows = np.flatnonzero(
        np.r_[True, (np.diff(tr["tree"]) != 0)
              | (np.diff(tr["sample"]) != 0) | (np.diff(tr["chain"]) != 0)])
    assert np.all(tr["n"][first_rows] == N)
    leaves = tr["var"] == -1
    assert tr["n"][leaves].sum() == N * 10 * KEPT * 2


@pytest.mark.parametrize("dense", [True, False])
def test_new_levels_and_both_ranef_routes(port_fit, df, monkeypatch, dense):
    """Z b from the dense design and from the per-row gather (many
    levels) agree to 1e-12, new levels included; rows of one new level
    share one draw per iteration (tests/test_checkpoint_na.py:56)."""
    import stan4bart_torch.results as results

    new = {c: np.asarray(df[c])[:6].copy() for c in df}
    new["g.2"] = np.array(["newA"] * 3 + ["newB"] * 3, dtype=object)
    tf = port_fit.mf.build_test_frame(new)
    if not dense:
        monkeypatch.setattr(results, "DENSE_Z_MAX", 0)
    port_fit._rng_calls = 0
    ran = port_fit._indiv_ranef(False, sample_new_levels=True, frame=tf)
    train = port_fit._indiv_ranef(False)
    monkeypatch.setattr(results, "DENSE_Z_MAX", 0 if dense else 2 ** 24)
    port_fit._rng_calls = 0
    np.testing.assert_allclose(
        ran, port_fit._indiv_ranef(False, sample_new_levels=True, frame=tf),
        rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(train, port_fit._indiv_ranef(False),
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(ran[..., 0], ran[..., 1])
    np.testing.assert_allclose(ran[..., 3], ran[..., 4])
    assert np.max(np.abs(ran[..., 0] - ran[..., 3])) > 1e-8


def test_predict_without_keep_trees_raises(df):
    fit = stan4bart_torch.stan4bart(
        "y ~ bart(X1 + X2) + X4", df, chains=1, warmup=3, iter=6, seed=0,
        verbose=-1, device="cpu", bart_args={"n.trees": 3})
    assert fit.draws.tree_feature is None
    with pytest.raises(ValueError, match="keep_trees"):
        fit.predict(df)
    with pytest.raises(ValueError, match="keep_trees"):
        fit.trees()


@pytest.mark.parametrize("spelling", [
    {"bart_args": {"n.trees": 3, "keep_trees": True}},
    {"bart_args": {"n.trees": 3, "keepTrees": True}},
    {"bart_args": {"n.trees": 3}, "stan_args": {"keep_trees": True}},
])
def test_keep_trees_spellings(df, spelling):
    """Each way the JAX package takes the option stores the forests."""
    fit = stan4bart_torch.stan4bart(
        "y ~ bart(X1 + X2) + X4", df, chains=2, warmup=3, iter=6, seed=0,
        verbose=-1, device="cpu", **spelling)
    assert fit.draws.tree_feature.shape == (2, 6, 3, 127)
    np.testing.assert_array_equal(
        fit.predict(df, type="indiv.bart"), fit.extract("indiv.bart"))


def test_step_and_step_batched_store_the_same_trees():
    """From one generator the per-chain and chain-batched drivers store
    the same forests, equal to the bit, and each stored forest is the
    state's forest after that iteration."""
    d = generate_friedman_data(100, ranef=True, causal=True)
    mf = build_model_frame(
        "y ~ bart(. - g.1 - g.2 - X4 - z) + X4 + z + (1 | g.1)",
        friedman_dataframe(d))
    pm, _, _ = build_parametric_model(mf, "gaussian", {"max_treedepth": 5},
                                      dtype=torch.float32, device="cpu")
    prog = GibbsProgram(pm, BartConfig(num_trees=6), mf.y, mf.bart_X,
                        warmup=4, iterations=2, keep_trees=True,
                        dtype=torch.float32, device="cpu")
    runs = []
    for per_chain in (False, True):
        gen = torch.Generator()
        gen.manual_seed(5)
        states = prog.init_state(gen, 3, per_chain=per_chain)
        step = prog.step if per_chain else prog.step_batched
        stored = []
        for it in range(3):
            states, draw = step(states, it, True, gen)
            assert torch.equal(draw.tree_feature, states.bart.feature)
            assert torch.equal(draw.tree_cut, states.bart.cut)
            assert torch.equal(draw.tree_leaf_value,
                               states.bart.leaf_value)
            stored.append((draw.tree_feature, draw.tree_cut,
                           draw.tree_leaf_value))
        runs.append(stored)
    for a, b in zip(*runs):
        for x, y in zip(a, b):
            assert torch.equal(x, y)


@pytest.mark.cuda
def test_cuda_predict_matches_cpu(df, tmp_path):
    """predict over the stored forests of a small fit on the card equals
    the same call on the CPU over the same arrays (the fit saved and
    loaded with device='cpu'), within 1e-5 (float32 sums over the trees
    on two devices)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    fit = stan4bart_torch.stan4bart(
        FORMULA, df, device="cuda", **dict(KW, iter=20, warmup=10))
    path = str(tmp_path / "fit.pkl")
    fit.save(path)
    cpu = stan4bart_torch.Stan4bartFit.load(path, device="cpu")
    for data in (df, _counterfactual(df)):
        np.testing.assert_allclose(fit.predict(data, type="indiv.bart"),
                                   cpu.predict(data, type="indiv.bart"),
                                   rtol=0, atol=1e-5)
    np.testing.assert_allclose(fit.predict(df, type="indiv.bart"),
                               fit.extract("indiv.bart"), rtol=0, atol=1e-5)
