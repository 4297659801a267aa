"""IHDP semi-synthetic causal benchmark: real covariates + surface-C DGP.

Counterpart of ``stan4bart_tpu/utils/ihdp.py`` (numpy only):
the Python equivalent of the reference's IHDP simulation harness
(ihdp/{data,sim}.R; runSimulations.R).  Two generators:

* :func:`load_ihdp_data` + :func:`generate_response_surface_c` — the REAL
  IHDP covariates (sim.data.gz is a gzipped tab-separated table, parsed
  directly) with the reference's response-surface-C design: random
  main-effect + second-order coefficients over the standardized design,
  correlated group intercept/treatment-slope with the sampled |Sigma_b|=1
  covariance, ATT calibrated to 4 (sim.R generateResponseForIter;
  runSimulations.R:38-56, 96-112).  Coefficient/ranef draws use numpy's
  RNG, so individual surfaces differ bit-wise from R's set.seed streams
  while the DESIGN (covariates, coefficient distributions, calibration,
  metric definitions) is identical.  The table is not shipped: the
  default path is the reference's ihdp/sim.data.gz below the working
  directory, and nothing is fetched.
* :func:`generate_ihdp_sim` — the synthetic-covariate generator
  (surface-B style), kept for fast tests.

:func:`causal_metrics` scores ICATE draws against a simulation's truth.
"""

from __future__ import annotations

import gzip
import os

import numpy as np

_IHDP_PATH = os.path.join("reference", "ihdp", "sim.data.gz")

COVS_CONT = ["bw", "b.head", "preterm", "birth.o", "nnhealth", "momage"]
COVS_CAT = ["sex", "twin", "b.marr", "mom.lths", "mom.hs", "mom.scoll",
            "cig", "first", "booze", "drugs", "work.dur", "prenatal",
            "ark", "ein", "har", "mia", "pen", "tex", "was"]


def load_ihdp_data(path: str = _IHDP_PATH) -> dict:
    """Parse the real IHDP table and reproduce data.R's loadIHDPData:
    subset (treat != 1 | momwhite != 0), select the 6 continuous + 19
    categorical covariates, standardize the continuous block, build the
    second-order basis x_o2 (pairwise interactions + continuous
    quadratics, collinear columns dropped), grouping factors g1 (momage
    clipped to [15, 40]) and g2 (site.num)."""
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    with gzip.open(path, "rt") as f:
        header = f.readline().rstrip("\n").split("\t")
        rows = [line.rstrip("\n").split("\t") for line in f if line.strip()]
    cols = {name: np.array([r[j] for r in rows])
            for j, name in enumerate(header)}
    needed = set(COVS_CONT + COVS_CAT) | {"treat", "momwhite", "site.num",
                                          "momage"}
    num = {}
    for k in needed:
        v = cols[k]
        num[k] = np.where(v == "NA", "nan", v).astype(np.float64)

    keep = (num["treat"] != 1) | (num["momwhite"] != 0)
    num = {k: v[keep] for k, v in num.items()}

    z = num["treat"]
    x = np.column_stack([num[c] for c in COVS_CONT + COVS_CAT])
    names = COVS_CONT + COVS_CAT

    g1 = np.clip(num["momage"], 15, 40).astype(int)
    g2 = num["site.num"].astype(int)

    n_cont = len(COVS_CONT)
    m = np.zeros(x.shape[1])
    s = np.ones(x.shape[1])
    m[:n_cont] = x[:, :n_cont].mean(axis=0)
    s[:n_cont] = x[:, :n_cont].std(axis=0, ddof=1)
    x_z = (x - m) / s

    # second-order basis: pairwise interactions of all standardized
    # columns + squares of the continuous ones, collinear columns dropped
    # (data.R:34-38 builds this with a glm and drops NA coefficients)
    o2_cols, o2_names = [], []
    for i in range(x_z.shape[1]):
        for j in range(i + 1, x_z.shape[1]):
            o2_cols.append(x_z[:, i] * x_z[:, j])
            o2_names.append(f"{names[i]}:{names[j]}")
    for i in range(n_cont):
        o2_cols.append(x_z[:, i] ** 2)
        o2_names.append(f"I({names[i]}^2)")
    x_o2 = np.column_stack(o2_cols)
    # drop degenerate / collinear columns (vs [1, x_z, x_o2])
    keep_cols = []
    basis = np.concatenate([np.ones((len(z), 1)), x_z], axis=1)
    Q, _ = np.linalg.qr(basis)
    for j in range(x_o2.shape[1]):
        v = x_o2[:, j]
        if v.std() < 1e-12:
            continue
        r = v - Q @ (Q.T @ v)
        nr = np.linalg.norm(r)
        if nr < 1e-7 * max(np.linalg.norm(v), 1.0):
            continue
        keep_cols.append(j)
        Q = np.concatenate([Q, (r / nr)[:, None]], axis=1)
    x_o2 = x_o2[:, keep_cols]
    o2_names = [o2_names[j] for j in keep_cols]

    return dict(x=x, x_z=x_z, x_o2=x_o2, names=names, o2_names=o2_names,
                z=z, g1=g1, g2=g2, n_cont=n_cont)


def sample_sigma_b(rng: np.random.Generator, setting: int = 1):
    """The reference's once-per-study covariance draw
    (runSimulations.R:40-66): high beta(16,4) correlation, F(5,7)
    variance ratio, |Sigma_b| = 1 (x2 for setting 2)."""
    rho = rng.beta(16, 4)
    r_var = rng.f(5, 7)
    s1 = np.sqrt(r_var / (1 - rho**2))
    s2 = s1 / r_var
    Sigma_b = np.array([
        [s1, rho * np.sqrt(s1 * s2)],
        [rho * np.sqrt(s1 * s2), s2],
    ])
    if setting == 2:
        Sigma_b = 2.0 * Sigma_b
    return Sigma_b


def generate_response_surface_c(ihdp: dict, rng: np.random.Generator,
                                Sigma_b: np.ndarray,
                                target_att: float = 4.0,
                                ranef_dist=None) -> dict:
    """One replication of the reference's surface C with momage grouping
    (sim.R generateResponseForIter; runSimulations.R:96-112): random
    main-effect coefficients in {0,1,2} (p .6/.3/.1), second-order
    coefficients in {0,.5,1} (p .8/.15/.05), correlated group effects,
    treated surface offset-calibrated so the (sample) ATT is 4."""
    # momage is the grouping variable: remove it from the mean function
    mi = ihdp["names"].index("momage")
    xz = np.delete(ihdp["x_z"], mi, axis=1)
    keep_o2 = [j for j, nm in enumerate(ihdp["o2_names"])
               if "momage" not in nm]
    xo2 = ihdp["x_o2"][:, keep_o2]
    z = ihdp["z"]
    n, p = xz.shape

    bm0 = rng.choice([0.0, 1.0, 2.0], size=p + 1, p=[0.6, 0.3, 0.1])
    bm1 = rng.choice([0.0, 1.0, 2.0], size=p + 1, p=[0.6, 0.3, 0.1])
    bq0 = rng.choice([0.0, 0.5, 1.0], size=xo2.shape[1],
                     p=[0.8, 0.15, 0.05])
    bq1 = rng.choice([0.0, 0.5, 1.0], size=xo2.shape[1],
                     p=[0.8, 0.15, 0.05])

    g1_levels, g1_idx = np.unique(ihdp["g1"], return_inverse=True)
    g2_levels, g2_idx = np.unique(ihdp["g2"], return_inverse=True)
    n_g = len(g1_levels)
    draw = (ranef_dist(rng, n_g * 2) if ranef_dist is not None
            else rng.standard_normal(n_g * 2))
    b = draw.reshape(n_g, 2) @ np.linalg.cholesky(Sigma_b).T
    # faithful to sim.R:86-88 incl. the g2-indexed slope into the
    # g1-sized matrix (site indices are a subset of the momage range)
    b0 = b[g1_idx, 0]
    b1 = b0 + b[g2_idx, 1]

    one_xz = np.concatenate([np.ones((n, 1)), xz], axis=1)
    mu0 = one_xz @ bm0 + xo2 @ bq0
    mu1 = one_xz @ bm1 + xo2 @ bq1
    offset_c = (mu1[z == 1] + b1[z == 1]
                - mu0[z == 1] - b0[z == 1]).mean() - target_att
    mu1 = mu1 - offset_c

    sig_y = 1.0
    y0 = mu0 + b0 + rng.normal(0, sig_y, n)
    y1 = mu1 + b1 + rng.normal(0, sig_y, n)
    y = np.where(z == 1, y1, y0)

    icate = mu1 + b1 - mu0 - b0
    data = {nm: ihdp["x_z"][:, j] for j, nm in enumerate(ihdp["names"])}
    data["g1"] = ihdp["g1"].astype(str)
    data["z"] = z
    data["y"] = y
    return dict(
        data=data, y=y, z=z, g=ihdp["g1"],
        icate=icate, att=target_att, sd_y=float(np.std(y, ddof=1)),
        mu0=mu0 + b0, mu1=mu1 + b1,
    )


def generate_ihdp_sim(
    n: int = 600,
    n_cont: int = 6,
    n_bin: int = 9,
    n_groups: int = 10,
    target_att: float = 4.0,
    seed: int = 0,
) -> dict:
    rng = np.random.default_rng(seed)
    Xc = rng.standard_normal((n, n_cont))
    Xb = (rng.uniform(size=(n, n_bin))
          < rng.uniform(0.2, 0.8, size=n_bin)).astype(np.float64)
    X = np.concatenate([Xc, Xb], axis=1)
    P = X.shape[1]

    # confounded treatment assignment
    gamma = rng.choice([0.0, 0.2, -0.2, 0.4], size=P, p=[0.5, 0.2, 0.2, 0.1])
    p_z = 1.0 / (1.0 + np.exp(-(X @ gamma - 0.3)))
    z = rng.binomial(1, p_z).astype(np.float64)

    # surface B: nonlinear control surface, linear treated surface
    beta = rng.choice([0.0, 0.1, 0.2, 0.3, 0.4], size=P,
                      p=[0.6, 0.1, 0.1, 0.1, 0.1])
    mu0 = np.exp((X + 0.5) @ beta * 0.4)
    mu1 = X @ beta

    # multilevel structure (runSimulations.R:42-56): correlated random
    # intercept + treatment slope, |Sigma_b| = 1
    g = rng.integers(0, n_groups, size=n)
    rho = rng.beta(16, 4)
    r_var = rng.f(5, 7)
    s1 = np.sqrt(r_var / (1 - rho**2))
    s2 = s1 / r_var
    Sigma_b = np.array([
        [s1, rho * np.sqrt(s1 * s2)],
        [rho * np.sqrt(s1 * s2), s2],
    ])
    b = rng.standard_normal((n_groups, 2)) @ np.linalg.cholesky(Sigma_b).T
    mu0 = mu0 + b[g, 0]
    mu1 = mu1 + b[g, 0] + b[g, 1]
    # calibrate omega so the ATT equals target_att ("truthIsFour",
    # runSimulations.R:38) — after the group effects so the truth is exact
    omega = (mu1[z == 1] - mu0[z == 1]).mean() - target_att
    mu1 = mu1 - omega

    sigma = 1.0
    y0 = mu0 + rng.normal(0, sigma, n)
    y1 = mu1 + rng.normal(0, sigma, n)
    y = np.where(z == 1, y1, y0)

    cols = {f"x{j + 1}": X[:, j] for j in range(P)}
    cols.update(y=y, z=z, g=g.astype(str))
    return dict(
        data=cols, X=X, z=z, y=y, g=g,
        mu0=mu0, mu1=mu1, icate=mu1 - mu0,
        att=(mu1 - mu0)[z == 1].mean(),
        Sigma_b=Sigma_b, sigma=sigma,
    )


def causal_metrics(icate_draws: np.ndarray, sim: dict,
                   ci_level: float = 0.95) -> dict:
    """bias / coverage / interval length / PEHE / PEGSTE for ICATE draws
    (obs, draws) against the simulation truth (runSimulations.R:75-123)."""
    z = sim["z"].astype(bool)
    truth_i = sim["icate"]
    att_truth = truth_i[z].mean()

    satt_draws = icate_draws[z].mean(axis=0)
    est = satt_draws.mean()
    lo, hi = np.quantile(satt_draws, [(1 - ci_level) / 2,
                                      1 - (1 - ci_level) / 2])
    icate_est = icate_draws.mean(axis=1)
    pehe = float(np.sqrt(np.mean((icate_est - truth_i) ** 2)))

    # PEGSTE: precision in estimating group-level treatment effects
    g = sim["g"]
    gste_true = np.array([truth_i[(g == j) & z].mean()
                          for j in np.unique(g)
                          if ((g == j) & z).any()])
    gste_est = np.array([icate_est[(g == j) & z].mean()
                         for j in np.unique(g)
                         if ((g == j) & z).any()])
    pegste = float(np.sqrt(np.mean((gste_est - gste_true) ** 2)))

    return dict(
        bias=float(est - att_truth),
        covered=bool(lo <= att_truth <= hi),
        ci_length=float(hi - lo),
        pehe=pehe,
        pegste=pegste,
        satt_est=float(est),
        satt_truth=float(att_truth),
    )
