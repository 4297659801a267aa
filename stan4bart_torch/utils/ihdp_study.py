"""IHDP causal simulation study of the port (the reference's
ihdp/runSimulations.R): bias, coverage, CI length, PEHE and PEGSTE over
replications.

Counterpart of ``benchmarks/ihdp_sim.py``, through the public
``stan4bart_torch.stan4bart`` entry point:

* :func:`run_synthetic` fits ``y ~ bart(x1 + .. + x15) + z + (1 + z | g)``
  with ``treatment="z"`` (2 chains, warmup ``iters // 2``, seed ``1000 +
  rep``) to ``generate_ihdp_sim(seed=rep)`` and scores it with
  ``causal_metrics``;
* :func:`run_real` fits the real IHDP covariates
  (``reference/ihdp/sim.data.gz``, which is not shipped and is never
  fetched) under the response-surface-C design, 4 chains, seed ``2000 +
  rep``, scored by :func:`metrics_for_fit`, the sd(y)-normalised
  runSimulations.R metrics.

Each prints one JSON line per replication and the aggregate line, with
ihdp_sim.py's keys.

Usage: python -m stan4bart_torch.utils.ihdp_study [n_reps] [iter]
[--synthetic] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json

import numpy as np

from stan4bart_torch.utils.ihdp import (
    _IHDP_PATH,
    causal_metrics,
    generate_ihdp_sim,
    generate_response_surface_c,
    load_ihdp_data,
    sample_sigma_b,
)

TRUTH = 4.0   # truthIsFour (runSimulations.R:38)


def icate_draws(fit, z) -> np.ndarray:
    """(obs, draws) individual effects: observed minus counterfactual
    expected outcome, signed by the arm."""
    zcol = np.asarray(z)[:, None]
    return ((fit.extract("ev") - fit.extract("ev", sample="test"))
            * (2 * zcol - 1))


def metrics_for_fit(fit, sim) -> dict:
    """The five runSimulations.R metrics, sd(y)-normalised (:115-123):
    bias, coverage of the normal 95 % interval of the CATT, its length,
    PEHE and PEGSTE over the treated, and the CATT estimate."""
    from scipy.stats import norm

    z = np.asarray(sim["z"]).astype(bool)
    icate = icate_draws(fit, sim["z"])
    sd_y = sim["sd_y"] if "sd_y" in sim else float(np.std(sim["y"], ddof=1))
    icatt_truth = sim["icate"][z]

    icatt_samples = icate[z]                             # (n_t, draws)
    catt_samples = icatt_samples.mean(axis=0)            # (draws,)
    catt = float(catt_samples.mean())
    catt_se = float(catt_samples.std(ddof=1))
    lo = catt - norm.ppf(0.975) * catt_se
    hi = catt + norm.ppf(0.975) * catt_se
    icatt = icatt_samples.mean(axis=1)

    g = np.asarray(sim["g"])
    icate_est = icate.mean(axis=1)
    gl = [j for j in np.unique(g) if ((g == j) & z).any()]
    gcatt_truth = np.array([sim["icate"][(g == j) & z].mean() for j in gl])
    gcatt_est = np.array([icate_est[(g == j) & z].mean() for j in gl])

    return dict(
        bias=float((catt - TRUTH) / sd_y),
        covered=bool(lo <= TRUTH <= hi),
        ci_length=float((hi - lo) / sd_y),
        pehe=float(np.sqrt(np.mean((icatt - icatt_truth) ** 2)) / sd_y),
        pegste=float(np.sqrt(np.mean((gcatt_est - gcatt_truth) ** 2))
                     / sd_y),
        satt_est=catt,
    )


def aggregate(rows, label: str, n_reps: int) -> dict:
    """The study's aggregate line: mean bias, RMSE of the SATT, coverage,
    CI length, PEHE and PEGSTE over ``rows``."""
    return dict(
        metric=label,
        n_reps=n_reps,
        bias=float(np.mean([r["bias"] for r in rows])),
        rmse_satt=float(np.sqrt(np.mean([r["bias"] ** 2 for r in rows]))),
        coverage=float(np.mean([r["covered"] for r in rows])),
        ci_length=float(np.mean([r["ci_length"] for r in rows])),
        pehe=float(np.mean([r["pehe"] for r in rows])),
        pegste=float(np.mean([r["pegste"] for r in rows])),
    )


def synthetic_case(rep: int, iters: int):
    """(sim, formula, data, kwargs) of replication ``rep``'s fit."""
    sim = generate_ihdp_sim(seed=rep)
    xs = " + ".join(f"x{j + 1}" for j in range(sim["X"].shape[1]))
    kw = dict(treatment="z", chains=2, iter=iters, warmup=iters // 2,
              seed=1000 + rep, verbose=-1)
    return sim, f"y ~ bart({xs}) + z + (1 + z | g)", sim["data"], kw


def synthetic_rep(rep: int, iters: int, device="cuda"):
    """Replication ``rep`` of the synthetic study: (its metrics row, the
    fit object)."""
    import stan4bart_torch

    sim, formula, data, kw = synthetic_case(rep, iters)
    fit = stan4bart_torch.stan4bart(formula, data, device=device, **kw)
    m = causal_metrics(icate_draws(fit, sim["z"]), sim)
    m["rep"] = rep
    return m, fit


def run_synthetic(n_reps: int, iters: int, device="cuda"):
    """The synthetic-covariate study over ``n_reps`` replications; prints
    each row and the aggregate; returns (rows, aggregate)."""
    rows = []
    for rep in range(n_reps):
        m, _ = synthetic_rep(rep, iters, device)
        rows.append(m)
        print(json.dumps(m), flush=True)
    agg = aggregate(rows, "IHDP-synthetic aggregate", n_reps)
    print(json.dumps(agg), flush=True)
    return rows, agg


def run_real(n_reps: int, iters: int, device="cuda", path: str = _IHDP_PATH):
    """The real-covariate study (response surface C, momage groups) over
    ``n_reps`` replications; raises FileNotFoundError naming ``path``
    where the IHDP table is absent.  Prints each row and the aggregate;
    returns (rows, aggregate)."""
    import stan4bart_torch

    ihdp = load_ihdp_data(path)
    study_rng = np.random.default_rng(1)
    Sigma_b = sample_sigma_b(study_rng)  # once per study (runSim.R:40-56)
    covs = " + ".join(n.replace(".", "_") for n in ihdp["names"]
                      if n != "momage")
    rows = []
    for rep in range(n_reps):
        rng = np.random.default_rng(565 + rep * 5)
        sim = generate_response_surface_c(ihdp, rng, Sigma_b)
        data = {k.replace(".", "_"): v for k, v in sim["data"].items()}
        fit = stan4bart_torch.stan4bart(
            f"y ~ bart({covs}) + z + (1 + z | g1)", data,
            treatment="z", chains=4, iter=iters, warmup=iters // 2,
            seed=2000 + rep, verbose=-1, device=device)
        m = metrics_for_fit(fit, sim)
        m["rep"] = rep
        rows.append(m)
        print(json.dumps(m), flush=True)
    agg = aggregate(rows, "IHDP-real surface-C aggregate", n_reps)
    print(json.dumps(agg), flush=True)
    return rows, agg


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n_reps", nargs="?", type=int, default=50)
    ap.add_argument("iters", nargs="?", type=int, default=1000)
    ap.add_argument("--synthetic", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    run = run_synthetic if args.synthetic else run_real
    run(args.n_reps, args.iters, args.device)


if __name__ == "__main__":
    main()
