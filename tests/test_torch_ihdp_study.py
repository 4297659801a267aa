"""The port's IHDP causal study (``stan4bart_torch/utils/ihdp_study.py``)
against ``benchmarks/ihdp_sim.py``, on the CPU.

- The port's ``run_synthetic`` at 2 replications of 8 iterations prints
  one line per replication and the aggregate line with ihdp_sim.py's
  keys.
- ihdp_sim.py's ``run_synthetic`` with ``stan4bart_tpu.stan4bart``
  replaced by a recorder passes the formula, data, treatment, chains,
  iterations, warmup and seed that the port's passes; given the port's
  fits of those replications, it prints the port's rows and aggregate
  to 1e-12.
- ``metrics_for_fit`` and ``aggregate`` equal ihdp_sim.py's
  ``_metrics_for_fit`` and ``_aggregate`` to 1e-12 on one of those fits.
- ``run_real`` raises FileNotFoundError, naming the path, without the
  IHDP table, and fetches nothing."""

import contextlib
import importlib.util
import io
import json
import os
import sys

import numpy as np
import pytest
import torch

import stan4bart_torch
import stan4bart_tpu
from stan4bart_torch.utils import ihdp_study

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPS, ITERS = 2, 8


def lines(text):
    return [json.loads(s) for s in text.splitlines() if s.startswith("{")]


def assert_rows_close(got, want):
    assert list(got) == list(want)
    for k, v in want.items():
        if isinstance(v, float):
            assert got[k] == pytest.approx(v, rel=1e-12, abs=1e-12), k
        else:
            assert got[k] == v, k


@pytest.fixture(scope="module")
def ref():
    """benchmarks/ihdp_sim.py, loaded by file."""
    before = list(sys.path)
    spec = importlib.util.spec_from_file_location(
        "ihdp_sim_harness", os.path.join(REPO, "benchmarks", "ihdp_sim.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    sys.path[:] = before
    return mod


@pytest.fixture(scope="module")
def studies(ref):
    """The port's synthetic study at REPS x ITERS (printed text, its
    fits) and ihdp_sim.py's on those fits (printed text, recorded
    calls)."""
    fits, calls = [], []
    real = stan4bart_torch.stan4bart

    def spy(*a, **kw):
        fits.append(real(*a, **kw))
        return fits[-1]

    def recorder(formula, data, **kw):
        calls.append((formula, data, kw))
        return fits[len(calls) - 1]

    port, jax = io.StringIO(), io.StringIO()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(stan4bart_torch, "stan4bart", spy)
        with contextlib.redirect_stdout(port):
            ihdp_study.run_synthetic(REPS, ITERS, device="cpu")
        mp.setattr(stan4bart_tpu, "stan4bart", recorder)
        with contextlib.redirect_stdout(jax):
            ref.run_synthetic(REPS, ITERS)
    return port.getvalue(), fits, jax.getvalue(), calls


def test_run_synthetic_prints_ihdp_sim_lines(studies):
    port, fits, jax, _ = studies
    got, want = lines(port), lines(jax)
    assert len(got) == REPS + 1 == len(want)
    for g, w in zip(got, want):
        assert_rows_close(g, w)
    assert [r["rep"] for r in got[:-1]] == list(range(REPS))
    assert got[-1]["metric"] == "IHDP-synthetic aggregate"
    assert all(f.prog.device.type == "cpu" for f in fits)


def test_synthetic_fit_arguments_match_ihdp_sim(studies):
    _, _, _, calls = studies
    for rep, (formula, data, kw) in enumerate(calls):
        sim, p_formula, p_data, p_kw = ihdp_study.synthetic_case(rep, ITERS)
        assert p_formula == formula
        assert list(p_data) == list(data)
        for k in data:
            np.testing.assert_array_equal(p_data[k], data[k], err_msg=k)
        assert p_kw == kw


def test_metrics_and_aggregate_match_ihdp_sim(ref, studies):
    _, fits, _, _ = studies
    sim = ihdp_study.synthetic_case(0, ITERS)[0]
    got = ihdp_study.metrics_for_fit(fits[0], sim)
    assert_rows_close(got, ref._metrics_for_fit(fits[0], sim))
    rows = [dict(got, rep=0), dict(got, rep=1, bias=-0.5, covered=False)]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        ref._aggregate(rows, "label", 2)
    assert_rows_close(ihdp_study.aggregate(rows, "label", 2),
                      lines(out.getvalue())[0])


def test_run_real_needs_the_ihdp_table(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    with pytest.raises(FileNotFoundError, match="sim.data.gz"):
        ihdp_study.run_real(1, ITERS, device="cpu")
    path = str(tmp_path / "absent.gz")
    with pytest.raises(FileNotFoundError, match="absent.gz"):
        ihdp_study.run_real(1, ITERS, device="cpu", path=path)
    assert os.listdir(tmp_path) == []
