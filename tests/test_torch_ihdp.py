"""The port's IHDP harness (``stan4bart_torch/utils/ihdp.py``) against the
JAX package's (``stan4bart_tpu/utils/ihdp.py``): both are numpy, so for
the same seeds the generators, the covariance draw, the table parser and
the metrics must agree to the bit.  The one-replication fit of
tests/test_ihdp.py:18-38 at its own shape is marked slow (it runs for
minutes on the CPU)."""

import gzip

import numpy as np
import pytest

from stan4bart_torch.utils import ihdp as port
from stan4bart_tpu.utils import ihdp as ref


def _equal_trees(a, b):
    assert type(a) is type(b)
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _equal_trees(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _equal_trees(x, y)
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_generate_ihdp_sim_equals_the_reference(seed):
    kw = dict(n=300, n_groups=8, seed=seed)
    _equal_trees(port.generate_ihdp_sim(**kw), ref.generate_ihdp_sim(**kw))


def test_generator_structure():
    sim = port.generate_ihdp_sim(n=400, seed=1)
    assert sim["X"].shape == (400, 15)
    assert set(np.unique(sim["z"])) == {0.0, 1.0}
    assert abs(sim["att"] - 4.0) < 1e-8
    assert np.linalg.det(sim["Sigma_b"]) > 0


def _table(n, seed):
    """A small IHDP-shaped table (every column the parser reads, some
    NA), as header and rows of strings."""
    rng = np.random.default_rng(seed)
    header = (["treat", "momwhite", "site.num"] + port.COVS_CONT
              + port.COVS_CAT)
    cols = {"treat": rng.integers(0, 2, n), "momwhite": rng.integers(0, 2, n),
            "site.num": rng.integers(1, 9, n)}
    for c in port.COVS_CONT:
        cols[c] = np.round(rng.normal(30, 5, n), 3)
    cols["momage"] = rng.integers(13, 43, n)
    for c in port.COVS_CAT:
        cols[c] = rng.integers(0, 2, n)
    rows = [[str(cols[h][i]) for h in header] for i in range(n)]
    rows[3][header.index("first")] = "NA"
    return header, rows


def test_load_ihdp_data_parses_a_gzipped_table(tmp_path):
    path = tmp_path / "sim.data.gz"
    header, rows = _table(80, 3)
    with gzip.open(path, "wt") as f:
        f.write("\t".join(header) + "\n")
        for r in rows:
            f.write("\t".join(r) + "\n")
    got = port.load_ihdp_data(str(path))
    _equal_trees(got, ref.load_ihdp_data(str(path)))
    keep = [(r[0] != "1") or (r[1] != "0") for r in rows]
    assert got["x"].shape == (sum(keep), 25)
    assert got["x_o2"].shape[0] == sum(keep)
    np.testing.assert_allclose(got["x_z"][:, :6].mean(0), 0.0, atol=1e-12)
    with pytest.raises(FileNotFoundError):
        port.load_ihdp_data(str(tmp_path / "absent.gz"))


def _covariates(n=120, seed=4):
    """A synthetic covariate dict in load_ihdp_data's layout."""
    rng = np.random.default_rng(seed)
    names = ["bw", "momage", "sex", "twin"]
    x_z = rng.normal(size=(n, 4))
    o2_names = ["bw:momage", "bw:sex", "sex:twin", "I(bw^2)"]
    x_o2 = np.column_stack([x_z[:, 0] * x_z[:, 1], x_z[:, 0] * x_z[:, 2],
                            x_z[:, 2] * x_z[:, 3], x_z[:, 0] ** 2])
    return dict(x=x_z, x_z=x_z, x_o2=x_o2, names=names, o2_names=o2_names,
                z=(rng.uniform(size=n) < 0.4).astype(np.float64),
                g1=rng.integers(15, 25, n), g2=rng.integers(15, 20, n),
                n_cont=2)


@pytest.mark.parametrize("setting", [1, 2])
def test_response_surface_c_equals_the_reference(setting):
    cov = _covariates()
    out = {}
    for name, mod in (("port", port), ("ref", ref)):
        rng = np.random.default_rng(11)
        sigma_b = mod.sample_sigma_b(rng, setting)
        out[name] = (sigma_b, mod.generate_response_surface_c(cov, rng,
                                                              sigma_b))
    _equal_trees(out["port"], out["ref"])
    surf = out["port"][1]
    z = cov["z"] == 1
    assert abs(surf["icate"][z].mean() - 4.0) < 1e-9


def test_causal_metrics_equal_the_reference():
    sim = port.generate_ihdp_sim(n=200, seed=5)
    rng = np.random.default_rng(6)
    draws = sim["icate"][:, None] + rng.normal(0, 0.8, (200, 50))
    _equal_trees(port.causal_metrics(draws, sim),
                 ref.causal_metrics(draws, sim))


@pytest.mark.slow
def test_ihdp_one_rep_metrics():
    """tests/test_ihdp.py:18-38 on the port, at its shape (n = 400, 2
    chains, 400 / 200, 40 trees)."""
    import stan4bart_torch

    sim = port.generate_ihdp_sim(n=400, seed=2)
    P = sim["X"].shape[1]
    xs = " + ".join(f"x{j + 1}" for j in range(P))
    fit = stan4bart_torch.stan4bart(
        f"y ~ bart({xs}) + z + (1 + z | g)", sim["data"],
        treatment="z", chains=2, iter=400, warmup=200,
        seed=77, verbose=-1, bart_args={"n.trees": 40}, device="cpu")
    ev_train = fit.extract("ev")
    ev_test = fit.extract("ev", sample="test")
    icate = (ev_train - ev_test) * (2 * sim["z"][:, None] - 1)
    m = port.causal_metrics(icate, sim)
    assert abs(m["bias"]) < 1.5, m
    assert m["pehe"] < 4.0, m
    assert m["ci_length"] > 0
