"""The port's simulation-based calibration harness
(``stan4bart_torch/utils/sbc.py``) against ``benchmarks/sbc.py`` and the
JAX package, on the CPU.

- The prior sampler meets the moment checks of tests/test_sbc.py:44-67
  (statistical, at its tolerances).
- On shared draws (the JAX package's theta~ and prior forest, leaf and
  noise normals) the port's ``simulate`` gives the y and f of the JAX
  harness's construction (benchmarks/sbc.py:220-239) to 1e-12 in
  float64, for the gaussian, weighted and probit cells.
- ``chi2_pvalue`` equals a direct numpy / scipy computation and the JAX
  harness's, on even and uneven bins.
- A tiny ``run_cell`` (8 reps, warmup 5, 18 iterations thinned by 2,
  so L = 9) returns the JAX harness's record with ranks in [0, L].
- ``slow``: tests/test_sbc.py:28-41's in-suite gate through the port, 64
  reps of ``continuous`` and ``leaf_block``, every p above 1e-4."""

import importlib.util
import os
import sys

import numpy as np
import pytest
import torch
from scipy.stats import chisquare

from stan4bart_torch.convert import bart_state_from_numpy
from stan4bart_torch.utils import sbc

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def ref():
    """benchmarks/sbc.py, loaded once for the file's tests."""
    spec = importlib.util.spec_from_file_location(
        "sbc_harness", os.path.join(REPO, "benchmarks", "sbc.py"))
    mod = importlib.util.module_from_spec(spec)
    sys.modules["sbc_harness"] = mod
    spec.loader.exec_module(mod)
    return mod


def test_constants_and_cells_match_the_jax_harness(ref):
    for name in ("N_OBS", "WARMUP", "ITERS", "THIN", "L", "BINS",
                 "SIGMA_MU", "F_MULTI", "F_SIMPLE"):
        assert getattr(sbc, name) == getattr(ref, name), name
    assert list(sbc.CELLS) == list(ref.CELLS)
    for name, cell in sbc.CELLS.items():
        want = ref.CELLS[name]
        for key in ("formula", "binary", "weights", "stan_args"):
            assert cell[key] == want[key], (name, key)
        assert cell.get("prior_cov") == want.get("prior_cov"), name
        assert cell.get("dtype", "float64") == want.get("dtype", "float64")
        assert bool(cell.get("tiled")) == ("env" in want), name
    assert sbc.covariate_frame(50, 3).equals(ref.covariate_frame(50, 3))


def test_prior_draw_moments():
    """tests/test_sbc.py:44-67 on the port's prior sampler: aux ~
    exponential, beta sd the prior scale, tau ~ gamma(1, 1)."""
    _, pm, _, _ = sbc.build_cell(sbc.CELLS["continuous"], seed=0,
                                 device="cpu")
    us = pm.prior_draw_unconstrained(np.random.default_rng(0), 8000)
    cs = pm.constrained_draw(us).numpy()
    names = pm.constrained_names()

    def col(n):
        return cs[:, names.index(n)]

    scale = float(pm.hyper_np["prior_scale_for_aux"])
    assert abs(col("aux.1").mean() - scale) < 0.06 * scale
    bscale = float(np.atleast_1d(np.asarray(pm.hyper_np["prior_scale"]))[0])
    assert abs(col("beta.1").std() - bscale) < 0.06 * bscale
    assert abs(col("beta.1").mean()) < 0.06 * bscale
    taus = us[:, pm.layout.slices["tau"][0]].numpy()
    assert abs(float(np.exp(taus).mean()) - 1.0) < 0.06


@pytest.mark.parametrize("cell", ["continuous", "weights", "probit"])
def test_simulate_matches_jax_construction(ref, cell):
    """y and f of benchmarks/sbc.py's rep function, built here from the
    JAX package's pieces, on the JAX draws of theta~ and the forest and
    on shared leaf and noise normals (float64, 1e-12)."""
    import jax
    import jax.numpy as jnp

    from stan4bart_tpu.ops import bart as ref_bart

    spec = ref.CELLS[cell]
    _, rpm, rprog, rcfg = ref.build_cell(spec, seed=0)
    _, pm, prog, cfg = sbc.build_cell(sbc.CELLS[cell], seed=0, device="cpu")
    np.testing.assert_array_equal(prog.ranks.numpy(),
                                  np.asarray(rprog.ranks))
    R, T, M, N = 3, cfg.num_trees, cfg.max_nodes, prog.N
    rng = np.random.default_rng(5)
    leaf_z = rng.standard_normal((R, T, M))
    eps = rng.standard_normal((R, N))
    w = rprog.weights
    us, forests, ys, fs = [], [], [], []
    for r, key in enumerate(jax.random.split(jax.random.PRNGKey(3), R)):
        kp, kt = jax.random.split(key)
        u_t = rpm.prior_draw_unconstrained(kp)
        c, _ = rpm.layout.constrain(u_t)
        tp = rpm.transformed(c)
        mean = rpm.parametric_mean(c, tp)
        bs = ref_bart.sample_trees_from_prior(
            rcfg, kt, rprog.ranks, rprog.split_probs, dtype=jnp.float64)
        leaf_mask = (bs.feature == ref_bart.LEAF).astype(jnp.float64)
        lv = ref.SIGMA_MU * jnp.asarray(leaf_z[r]) * leaf_mask
        f = jnp.take_along_axis(lv, bs.leaf_idx, axis=1).sum(0)
        eta = mean + f
        if spec["binary"]:
            y = (eta + eps[r] > 0).astype(jnp.float64)
        else:
            sd = tp["aux"] / (jnp.sqrt(w) if w is not None else 1.0)
            y = eta + sd * eps[r]
        us.append(np.asarray(u_t))
        forests.append(jax.tree_util.tree_map(np.asarray, bs))
        ys.append(np.asarray(y))
        fs.append(np.asarray(f))
    forest = bart_state_from_numpy(
        {k: np.stack([getattr(b, k) for b in forests])
         for k in forests[0]._fields}, dtype=torch.float64, device="cpu")
    u_t, f, y = sbc.simulate(pm, prog, spec["binary"],
                             u_t=torch.as_tensor(np.stack(us)),
                             forest=forest, leaf_z=leaf_z, eps=eps)
    np.testing.assert_allclose(f.numpy(), np.stack(fs), rtol=0, atol=1e-12)
    np.testing.assert_allclose(y.numpy(), np.stack(ys), rtol=0, atol=1e-12)
    # the ranked truth: the JAX package's constrained draw of theta~
    want = np.stack([np.asarray(rpm.constrained_draw(jnp.asarray(u)))
                     for u in us])
    np.testing.assert_allclose(pm.constrained_draw(u_t).numpy(), want,
                               rtol=1e-12, atol=1e-12)


def _chi2_direct(ranks, n_values, bins):
    """Counts and chi-square by listing each bin's rank values."""
    ranks = np.asarray(ranks)
    members = [[v for v in range(n_values) if v * bins // n_values == b]
               for b in range(bins)]
    counts = np.array([np.isin(ranks, m).sum() for m in members])
    expected = np.array([len(ranks) * len(m) / n_values for m in members])
    stat, p = chisquare(counts, expected)
    return stat, p, counts


@pytest.mark.parametrize("L_", [99, 20])
def test_chi2_pvalue_matches_direct_computation(ref, L_):
    rng = np.random.default_rng(L_)
    for ranks in (rng.integers(0, L_ + 1, size=160),
                  np.minimum(rng.geometric(0.05, size=64), L_)):
        stat, p, counts = sbc.chi2_pvalue(ranks, L_ + 1, 10)
        d_stat, d_p, d_counts = _chi2_direct(ranks, L_ + 1, 10)
        np.testing.assert_array_equal(counts, d_counts)
        np.testing.assert_allclose(stat, d_stat, rtol=1e-12)
        np.testing.assert_allclose(p, d_p, rtol=1e-10, atol=1e-300)
        r_stat, r_p, r_counts, _ = ref.chi2_pvalue(ranks, L_ + 1, 10)
        assert (stat, p, counts) == (r_stat, r_p, r_counts)


def test_tiny_run_cell_schema():
    out = sbc.run_cell("continuous", sbc.CELLS["continuous"], 8, seed=1,
                       device="cpu", warmup=5, iters=18, thin=2,
                       verbose=False)
    assert set(out) == {"cell", "reps", "L", "quantities", "min_p", "pass",
                        "wall_s", "timings", "nuts"}
    assert out["nuts"]["leapfrogs_lockstep"] >= 18
    assert 0.0 <= out["nuts"]["divergent"] <= 1.0
    assert out["cell"] == "continuous" and out["reps"] == 8
    assert out["L"] == 9
    names = ["aux.1", "beta.1", "theta_L.1", "theta_L.2", "theta_L.3",
             "b.1", "b.2", "f.0", "f.1", "f.mean"]
    assert list(out["quantities"]) == names
    for q in out["quantities"].values():
        assert len(q["counts"]) == 10 and sum(q["counts"]) == 8
        assert np.isfinite(q["p"]) and 0.0 <= q["p"] <= 1.0
    assert out["min_p"] == min(q["p"] for q in out["quantities"].values())
    assert out["pass"] == (out["min_p"] > 1e-3)


@pytest.mark.slow
@pytest.mark.parametrize("cell", ["continuous", "leaf_block"])
def test_sbc_ranks_uniform(cell):
    """tests/test_sbc.py:28-41 through the port: 64 reps, every quantity's
    chi-square p above 1e-4 (loose against the 160-rep artifact gates; a
    real miscalibration fails hard)."""
    out = sbc.run_cell(cell, sbc.CELLS[cell], n_reps=64, seed=11,
                       device="cpu", verbose=False)
    for qn, q in out["quantities"].items():
        assert q["p"] > 1e-4, (
            f"cell {cell} quantity {qn}: SBC ranks non-uniform "
            f"(chi2 {q['chi2']}, p {q['p']:.2e}, counts {q['counts']})")
