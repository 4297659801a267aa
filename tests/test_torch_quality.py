"""The port's quality harness (``stan4bart_torch/utils/quality.py``)
against ``benchmarks/quality_chip.py``, ``benchmarks/probit_quality_chip.py``
and the held-out RMSE gate of tests/test_e2e_continuous.py:147-189, on
the CPU.

- Configuration: each JAX harness's ``main`` runs with
  ``stan4bart_tpu.stan4bart`` replaced by a recorder; the formula, frame,
  weights, treatment, chains, warmup, iterations, seed, trees and
  ``stan_args`` that the port's harness passes equal the recorded ones
  (weights and y to the bit), for the three gaussian variants and the
  probit harness.
- Gate arithmetic: the recorder runs one tiny fit of the port with the
  weighted variant's arguments (the harness's own data, 2 chains, 20
  iterations, 10 trees, NUTS treedepth capped at 4), and the port's
  gates on that fit, its ppd noise replayed, are the ones
  quality_chip.py prints, to its digits.
  The probit harness, at n = 300, gets fixed draws of P(y = 1) and the
  ppd; the port's probit gates on them equal the record it writes.
- Held-out RMSE: the port's split and least-squares comparator give
  tests/test_e2e_continuous.py's rows and RMSE to 1e-12, read from its
  assertion on a stand-in fit.
- ``slow``: quality_chip.py's full-budget gates through the port."""

import contextlib
import importlib.util
import io
import json
import os
import sys

import numpy as np
import pandas as pd
import pytest
import torch

import stan4bart_torch
import stan4bart_tpu
from stan4bart_torch.utils import quality
from stan4bart_tpu.utils import friedman

torch.set_num_threads(2)

FRAME = friedman.friedman_dataframe
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class Recorded(Exception):
    """Raised by the recorder that stops a harness at its fit."""


class DrawsFit:
    """A fit object of fixed draws (what the harnesses read of one)."""

    def __init__(self, draws):
        self.draws = draws
        self.timings = {"total": 3.0, "warmup": 1.0, "sample": 2.0}

    def extract(self, type="ev", sample="train"):
        return self.draws[type, sample]

    def fitted(self, type="ev", sample="train"):
        return self.extract(type, sample).mean(axis=-1)


def load(path, name):
    """A script of the repo loaded by file, ``sys.path`` left as it was."""
    before = list(sys.path)
    spec = importlib.util.spec_from_file_location(name,
                                                  os.path.join(REPO, path))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    sys.path[:] = before
    return mod


def patch_harness(mp, calls, fit=None):
    """Replace ``stan4bart_tpu.stan4bart`` by a recorder of its calls
    that returns ``fit(formula, data, kw)`` (or stops the harness when
    ``fit`` is None), and the harnesses' compile-cache settings by
    no-ops."""
    import jax

    real_makedirs = os.makedirs

    def recorder(formula, data, **kw):
        calls.append((formula, data, kw))
        if fit is None:
            raise Recorded
        return fit(formula, data, kw)

    mp.setattr(stan4bart_tpu, "stan4bart", recorder)
    mp.setattr(jax.config, "update", lambda *a, **k: None)
    mp.setattr(os, "makedirs", lambda p, *a, **k: None
               if str(p).endswith(".jax_cache") else real_makedirs(p, *a, **k))
    mp.setattr(sys, "path", list(sys.path))


def run_quality_chip(variant, fit=None):
    """quality_chip.py's ``main`` for ``variant``: (recorded calls,
    printed text).  Its weighted variant draws ``len(df)`` weights, one
    a row of a data frame, but ``friedman_dataframe`` returns a dict of
    its 14 columns, so as written it fails to broadcast 14 weights over
    250 rows; it runs here on a pandas frame of the same columns, whose
    length is its rows."""
    mod = load("benchmarks/quality_chip.py", "quality_chip_harness")
    calls, out = [], io.StringIO()
    with pytest.MonkeyPatch.context() as mp:
        patch_harness(mp, calls, fit)
        if variant == "weighted":
            mp.setattr(friedman, "friedman_dataframe",
                       lambda d: pd.DataFrame(FRAME(d)))
        mp.setenv("QUALITY_WEIGHTED", str(int(variant == "weighted")))
        mp.setenv("QUALITY_IW", str(int(variant == "interweave")))
        with contextlib.redirect_stdout(out), \
                contextlib.suppress(Recorded, SystemExit):
            mod.main()
    return calls, out.getvalue()


def run_probit_quality_chip(tmp, n, fit=None):
    """probit_quality_chip.py's ``main`` at ``n``: (recorded calls, the
    record it wrote, or None)."""
    mod = load("benchmarks/probit_quality_chip.py", "probit_quality_harness")
    calls, path = [], os.path.join(tmp, "probit.json")
    with pytest.MonkeyPatch.context() as mp:
        patch_harness(mp, calls, fit)
        mp.setattr(sys, "argv", ["probit_quality_chip.py", "--n", str(n),
                                 "--out", path])
        with contextlib.redirect_stdout(io.StringIO()), \
                contextlib.suppress(Recorded):
            mod.main()
    if not os.path.exists(path):
        return calls, None
    with open(path) as fh:
        return calls, json.load(fh)


def assert_same_columns(a, b):
    assert list(a) == list(b)
    for k in b:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]),
                                      err_msg=k)


def assert_same_call(recorded, case, jax_only):
    """The port's (formula, data, kwargs) equal the recorded call's,
    arrays to the bit; ``jax_only`` are the recorded keyword arguments
    the port's harness does not pass (the JAX package's knobs); both
    dtypes are float32."""
    formula, data, kw = recorded
    p_formula, p_data, p_kw = case
    assert p_formula == formula
    assert_same_columns(p_data, data)
    kw = {k: v for k, v in kw.items() if k not in jax_only}
    p_kw = dict(p_kw)
    bart = dict(kw.pop("bart_args") or {})
    bart.pop("sweep_kernel", None)   # the port always runs its kernel
    assert (p_kw.pop("bart_args", None) or {}) == bart
    np.testing.assert_array_equal(p_kw.pop("weights", None),
                                  kw.pop("weights", None))
    assert np.dtype(kw.pop("dtype")) == np.dtype(p_kw.pop("dtype")) \
        == np.float32
    assert p_kw == kw


@pytest.mark.parametrize("variant", ["plain", "weighted", "interweave"])
def test_gaussian_fit_arguments_match_quality_chip(variant):
    (call,), _ = run_quality_chip(variant)
    d, *case = quality.gaussian_case(variant)
    assert_same_call(call, case, ("chunk_size",))
    if variant == "weighted":
        w = np.random.default_rng(11).uniform(0.5, 2.0, quality.N)
        np.testing.assert_array_equal(case[2]["weights"], w)
        assert not np.array_equal(case[1]["y"], d["y"])


def test_probit_fit_arguments_match_probit_quality_chip(tmp_path):
    (call,), rec = run_probit_quality_chip(str(tmp_path), quality.PROBIT_N)
    assert rec is None
    _, *case = quality.probit_case()
    assert_same_call(call, case, ())


@pytest.fixture(scope="module")
def weighted_run():
    """quality_chip.py's weighted gates on one tiny fit of the port, made
    from the arguments the harness passes: (fit, its ppd stream's count
    before the harness's gates, printed text)."""
    fits = []

    def tiny(formula, data, kw):
        kw = dict(kw, chains=2, iter=20, warmup=10, dtype="float32",
                  bart_args={"n.trees": 10},
                  stan_args={"max_treedepth": 4})
        kw.pop("chunk_size")
        fit = stan4bart_torch.stan4bart(formula, data, device="cpu", **kw)
        fits.append((fit, fit._rng_calls))
        return fit

    _, out = run_quality_chip("weighted", tiny)
    return fits[0] + (out,)


def test_gaussian_gate_arithmetic_matches_quality_chip(weighted_run):
    fit, rng_calls, out = weighted_run
    printed = {}
    for line in out.splitlines():
        if line.startswith(("# PASS ", "# FAIL ")):
            name, value = line[7:].rsplit(" = ", 1)
            printed[name] = (line[2:6] == "PASS", value)
    d, *_ = quality.gaussian_case("weighted")
    fit._rng_calls = rng_calls     # the same ppd noise as the harness's
    gates = quality.gaussian_gates(fit, d)
    assert list(gates) == list(printed)
    for name, g in gates.items():
        assert (g["pass"], f"{g['value']:.4f}") == printed[name], name
    n_pass = sum(g["pass"] for g in gates.values())
    assert f"# {n_pass}/{len(gates)} gates passed" in out
    assert fit.prog.weights is not None


def test_probit_gate_arithmetic_matches_probit_quality_chip(tmp_path):
    n = 300
    rng = np.random.default_rng(5)
    ev = rng.beta(2.0, 3.0, size=(n, 40))
    fit = DrawsFit({("ev", "train"): ev,
                    ("ppd", "train"): rng.binomial(1, ev).astype(float)})
    _, rec = run_probit_quality_chip(str(tmp_path), n,
                                     lambda f, d, kw: fit)
    d, _, df, _ = quality.probit_case(n)
    got = quality.probit_gates(fit, d, df["y"])
    for key in ("cor_ev_ptrue", "deviance", "null_deviance",
                "deviance_ratio", "ppd_gap", "gates", "all_pass"):
        assert got[key] == rec[key], key


def test_heldout_split_and_comparator_match_the_e2e_test():
    """tests/test_e2e_continuous.py's held-out gate on a stand-in fit
    whose test-frame mean is y + 10: its assertion reports (rmse_bart,
    rmse_lin), which the port's functions give on the same rows."""
    mod = load("tests/test_e2e_continuous.py", "e2e_continuous_ref")
    calls = []

    def stand_in(formula, data, **kw):
        calls.append((formula, data, kw))
        y = np.asarray(kw["test"]["y"], float)
        return DrawsFit({("ev", "test"): (y + 10.0)[:, None]})

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(mod.s4b, "stan4bart", stand_in)
        with pytest.raises(AssertionError) as err:
            mod.test_rmse_beats_linear_mixed_model()
    rmse_bart, rmse_lin = err.value.args[0]
    formula, df_tr, df_te, kw, df = quality.rmse_case()
    (r_formula, r_tr, r_kw), = calls
    assert formula == r_formula
    assert_same_columns(df_tr, r_tr)
    assert_same_columns(df_te, r_kw.pop("test"))
    kw.pop("test")
    assert kw == r_kw
    fit = DrawsFit({("ev", "test"): (df_te["y"] + 10.0)[:, None]})
    assert quality.bart_rmse(fit, df_te) == pytest.approx(rmse_bart,
                                                          rel=1e-12)
    assert quality.linear_rmse(df, df_tr, df_te) == pytest.approx(
        rmse_lin, rel=1e-12, abs=1e-12)
    assert rmse_bart == pytest.approx(10.0, rel=1e-12)


@pytest.mark.slow
@pytest.mark.parametrize("variant", ["plain", "weighted", "interweave"])
def test_quality_gates_at_full_budget_on_the_cpu(variant):
    """quality_chip.py's gates through the port on the CPU at its own
    budget (n = 250, 50 trees, 3 chains x 1000 iterations)."""
    rec = quality.run_gaussian(variant, device="cpu")
    assert rec["all_pass"], quality.report(rec)
