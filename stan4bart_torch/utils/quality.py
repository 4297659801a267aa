"""Statistical quality gates of the port's fit at the reference's budgets.

Counterpart of ``benchmarks/quality_chip.py`` (gaussian),
``benchmarks/probit_quality_chip.py`` (probit) and the held-out RMSE gate
of tests/test_e2e_continuous.py:147-189, through the public
``stan4bart_torch.stan4bart`` entry point:

* **gaussian** (``plain``, ``weighted``, ``interweave``): the flagship
  Friedman model at n = 250, 50 trees, 3 chains x 1000 iterations (300
  warmup), seed 7, float32, gated on cor(indiv.bart / fixef / ranef,
  truth), the posterior mean of sigma, the ppd noise ratio and the SATE.
  ``weighted`` gives each row the noise sd 1 / sqrt(w), w ~ U(0.5, 2)
  (``default_rng(11)``), and passes w as likelihood weights, so the
  weighted model is correctly specified and the same gates apply;
  ``interweave`` turns on centered random effects with the linear and
  level Gibbs refreshes.
* **probit**: the probit flagship at n = 10 000, 8 chains, warmup 400 of
  900 iterations, seed 11, centered random effects, gated on
  cor(P(y = 1), truth), the deviance against the null model and the ppd;
  the record keeps PROBIT_QUALITY_r05.json's schema.
* **rmse**: 300 rows split 220 / 80 by ``default_rng(3)``; BART's
  held-out RMSE must not exceed least squares on [1, X1..X10, g.1
  dummies, X4:g.1 dummies, g.2 dummies] (the reference gates against
  lme4::lmer; at n >> p unpenalized least squares is its fixed + BLUP
  fit without shrinkage).

Each ``*_case`` function returns exactly what its harness passes to
``stan4bart``; each ``*_gates`` function computes the gates from a fit
object (the port's or the JAX package's), with the reference harness's
arithmetic and names.

Usage: python -m stan4bart_torch.utils.quality [--gates
weighted,rmse,plain,interweave,probit] [--device cuda|cpu] [--out
QUALITY.json]
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

from stan4bart_torch.utils.device import card
from stan4bart_torch.utils.friedman import (
    friedman_dataframe,
    generate_friedman_data,
)

FORMULA = ("y ~ bart(. - g.1 - g.2 - X4 - z) + X4 + z + (1 + X4 | g.1) "
           "+ (1 | g.2)")
N = 250
CHAINS, WARMUP, ITER, SEED, TREES = 3, 300, 1000, 7, 50
WEIGHT_SEED = 11
VARIANTS = {
    "plain": None,
    "weighted": None,
    "interweave": {"centered_ranef": True, "linear_gibbs": True,
                   "level_gibbs": True},
}

PROBIT_FORMULA = ("y ~ bart(. - g.1 - g.2 - X4) + X4 + (1 + X4 | g.1) "
                  "+ (1 | g.2)")
PROBIT_N, PROBIT_CHAINS, PROBIT_WARMUP, PROBIT_ITER = 10_000, 8, 400, 900
PROBIT_SEED = 11
PROBIT_STAN_ARGS = {"centered_ranef": True}

RMSE_FORMULA = PROBIT_FORMULA
RMSE_N, RMSE_TRAIN, RMSE_SPLIT_SEED = 300, 220, 3
RMSE_CHAINS, RMSE_WARMUP, RMSE_ITER, RMSE_SEED = 2, 250, 600, 9

GATES = ("weighted", "rmse", "plain", "interweave", "probit")


def centered_cor(a, b) -> float:
    """cor(a - mean a, b - mean b), as the reference harnesses take it."""
    return float(np.corrcoef(a - a.mean(), b - b.mean())[0, 1])


# ---- gaussian gates (benchmarks/quality_chip.py) ---------------------------

def gaussian_case(variant: str = "plain"):
    """(d, formula, data, kwargs) of quality_chip.py's fit of
    ``variant``: the Friedman fixture ``d``, and the frame and keyword
    arguments it passes to ``stan4bart`` (the port's float32)."""
    if variant not in VARIANTS:
        raise ValueError(f"variant must be one of {tuple(VARIANTS)}")
    d = generate_friedman_data(N, ranef=True, causal=True)
    df = friedman_dataframe(d)
    weights = None
    if variant == "weighted":
        weights = np.random.default_rng(WEIGHT_SEED).uniform(0.5, 2.0,
                                                             len(df["y"]))
        mu_true = np.where(d["z"] == 1, d["mu_1"], d["mu_0"])
        df = dict(df, y=mu_true + (d["y"] - mu_true) / np.sqrt(weights))
    kw = dict(treatment="z", weights=weights, chains=CHAINS, warmup=WARMUP,
              iter=ITER, seed=SEED, verbose=-1,
              bart_args={"n.trees": TREES}, stan_args=VARIANTS[variant],
              dtype="float32")
    return d, FORMULA, df, kw


def gaussian_gates(fit, d) -> dict:
    """quality_chip.py's six gates on ``fit``: {name: {value, bound,
    pass}} in its order, names and arithmetic."""
    gates = {}

    def gate(name, value, bound, ok):
        gates[name] = {"value": value, "bound": bound, "pass": bool(ok)}

    c = centered_cor(fit.fitted("indiv.bart"), d["mu_bart"])
    gate("cor(indiv.bart, truth)", c, ">= 0.95", c >= 0.95)
    mu_fx = np.where(d["z"] == 1, d["mu_fixef_1"], d["mu_fixef_0"])
    c = centered_cor(fit.fitted("indiv.fixef"), mu_fx)
    gate("cor(indiv.fixef, truth)", c, ">= 0.99", c >= 0.99)
    c = float(np.corrcoef(fit.fitted("indiv.ranef"), d["mu_ranef"])[0, 1])
    gate("cor(indiv.ranef, truth)", c, ">= 0.68", c >= 0.68)
    sig = float(fit.extract("sigma").mean())
    gate("sigma posterior mean", sig, "in [0.8, 1.4]", 0.8 <= sig <= 1.4)
    ev = fit.extract("ev")
    ratio = float(np.std(fit.extract("ppd") - ev)) / sig
    gate("ppd noise sd / sigma", ratio, "in [1/1.15, 1.15]",
         1 / 1.15 <= ratio <= 1.15)
    icate = ((ev - fit.extract("ev", sample="test"))
             * (2 * d["z"][:, None] - 1))
    sate = float(icate.mean(axis=0).mean())
    gate("SATE (truth tau=5)", sate, "within 1 of 5",
         abs(sate - d["tau"]) <= 1.0)
    return gates


def run_gaussian(variant: str = "plain", device="cuda", warmup=WARMUP,
                 iters=ITER) -> dict:
    """``variant``'s fit (at ``iters`` iterations, ``warmup`` of them
    warmup; the harness's budget by default) and gates: the record {gate,
    gates, all_pass, warmup, iter, wall_s, timings}.  The fit object is
    ``record["fit"]``."""
    import stan4bart_torch

    d, formula, df, kw = gaussian_case(variant)
    kw.update(warmup=warmup, iter=iters)
    t0 = time.perf_counter()
    fit = stan4bart_torch.stan4bart(formula, df, device=device, **kw)
    wall = time.perf_counter() - t0
    gates = gaussian_gates(fit, d)
    return {"gate": variant, "gates": gates,
            "all_pass": all(g["pass"] for g in gates.values()),
            "warmup": warmup, "iter": iters,
            "wall_s": round(wall, 1), "timings": _timings(fit), "fit": fit}


# ---- probit gates (benchmarks/probit_quality_chip.py) ----------------------

def probit_case(n: int = PROBIT_N):
    """(d, formula, data, kwargs) of probit_quality_chip.py's fit."""
    d = generate_friedman_data(n, ranef=True, binary=True)
    kw = dict(chains=PROBIT_CHAINS, warmup=PROBIT_WARMUP, iter=PROBIT_ITER,
              seed=PROBIT_SEED, verbose=0, dtype="float32",
              stan_args=dict(PROBIT_STAN_ARGS))
    return d, PROBIT_FORMULA, friedman_dataframe(d), kw


def probit_gates(fit, d, y) -> dict:
    """probit_quality_chip.py's numbers and four gates on ``fit`` of the
    binary ``y``: cor(P(y = 1), norm.cdf(mu)), the deviance and the null
    model's, the ppd's mean against P(y = 1), rounded as it writes
    them."""
    from scipy.stats import norm

    y = np.asarray(y, dtype=np.float64)
    ev = fit.extract("ev").mean(axis=-1)
    eps = 1e-12
    p = np.clip(ev, eps, 1 - eps)
    dev = -2.0 * float(np.sum(y * np.log(p) + (1 - y) * np.log1p(-p)))
    p0 = np.clip(np.mean(y), eps, 1 - eps)
    dev0 = -2.0 * float(len(y) * (p0 * np.log(p0)
                                  + (1 - p0) * np.log1p(-p0)))
    cor = float(np.corrcoef(ev, norm.cdf(d["mu"]))[0, 1])
    ppd_gap = float(np.abs(fit.extract("ppd").mean(axis=-1) - ev).mean())
    gates = {
        "cor_ev_ptrue >= 0.90": cor >= 0.90,
        "deviance < 0.8 * null": dev < 0.8 * dev0,
        "ppd_mean_matches_ev < 0.05": ppd_gap < 0.05,
        "ev_in_unit_interval": bool(np.all((ev > 0) & (ev < 1))),
    }
    return {"cor_ev_ptrue": round(cor, 4), "deviance": round(dev, 1),
            "null_deviance": round(dev0, 1),
            "deviance_ratio": round(dev / dev0, 4),
            "ppd_gap": round(ppd_gap, 5), "gates": gates,
            "all_pass": all(gates.values())}


def run_probit(device="cuda") -> dict:
    """The probit fit and gates as PROBIT_QUALITY_r05.json's record, its
    config with the backend and, on the card, the card's name and power
    limit (``nvidia-smi``).  The fit object is ``record["fit"]``."""
    import torch

    import stan4bart_torch

    d, formula, df, kw = probit_case()
    t0 = time.perf_counter()
    fit = stan4bart_torch.stan4bart(formula, df, device=device, **kw)
    wall = time.perf_counter() - t0
    backend = torch.device(device).type
    out = {"config": {"n": len(df["y"]), "chains": kw["chains"],
                      "warmup": kw["warmup"], "iter": kw["iter"],
                      "backend": backend,
                      "path": "public stan4bart_torch.stan4bart(), "
                              f"{kw['dtype']}, single-pass sweep kernel",
                      "card": card() if backend == "cuda" else None}}
    gates = probit_gates(fit, d, df["y"])
    out.update({k: gates[k] for k in ("cor_ev_ptrue", "deviance",
                                      "null_deviance", "deviance_ratio",
                                      "ppd_gap")})
    out["timings"] = {k: round(v, 1) for k, v in fit.timings.items()
                      if isinstance(v, float)}
    out.update(wall_s=round(wall, 1), gates=gates["gates"],
               all_pass=gates["all_pass"], fit=fit)
    return out


# ---- held-out RMSE (tests/test_e2e_continuous.py:147-189) -----------------

def rmse_case():
    """(formula, train frame, test frame, kwargs, full frame) of the
    held-out RMSE gate: 300 Friedman rows permuted by default_rng(3)
    into 220 to fit and 80 to predict."""
    rng = np.random.default_rng(RMSE_SPLIT_SEED)
    df = friedman_dataframe(generate_friedman_data(RMSE_N, ranef=True,
                                                   causal=False))
    idx = rng.permutation(RMSE_N)
    tr, te = idx[:RMSE_TRAIN], idx[RMSE_TRAIN:]
    df_tr = {k: np.asarray(v)[tr] for k, v in df.items()}
    df_te = {k: np.asarray(v)[te] for k, v in df.items()}
    kw = dict(test=df_te, chains=RMSE_CHAINS, warmup=RMSE_WARMUP,
              iter=RMSE_ITER, seed=RMSE_SEED, verbose=-1,
              bart_args={"n.trees": TREES})
    return RMSE_FORMULA, df_tr, df_te, kw, df


def linear_rmse(df, df_tr, df_te) -> float:
    """Held-out RMSE of least squares on [1, X1..X10, g.1 dummies, X4:g.1
    dummies, g.2 dummies], the levels those of the full frame ``df``."""
    def design(dd):
        cols = [np.ones(len(dd["y"]))]
        for j in range(1, 11):
            cols.append(np.asarray(dd[f"X{j}"], float))
        for g, inter in (("g.1", False), ("g.1", True), ("g.2", False)):
            levels = np.unique(np.asarray(df[g]))
            onehot = (np.asarray(dd[g])[:, None] == levels[None, :]
                      ).astype(float)
            cols.append(onehot * np.asarray(dd["X4"], float)[:, None]
                        if inter else onehot)
        return np.column_stack(cols)

    coef, *_ = np.linalg.lstsq(design(df_tr), np.asarray(df_tr["y"], float),
                               rcond=None)
    return float(np.sqrt(np.mean((design(df_te) @ coef - df_te["y"]) ** 2)))


def bart_rmse(fit, df_te) -> float:
    """Held-out RMSE of ``fit``'s posterior mean on its test frame."""
    yhat = fit.fitted(sample="test")
    return float(np.sqrt(np.mean((yhat - df_te["y"]) ** 2)))


def run_rmse(device="cuda") -> dict:
    """The held-out fit and its gate: {gate, rmse_bart, rmse_lin,
    all_pass, wall_s, timings}.  The fit object is ``record["fit"]``."""
    import stan4bart_torch

    formula, df_tr, df_te, kw, df = rmse_case()
    t0 = time.perf_counter()
    fit = stan4bart_torch.stan4bart(formula, df_tr, device=device, **kw)
    wall = time.perf_counter() - t0
    rb, rl = bart_rmse(fit, df_te), linear_rmse(df, df_tr, df_te)
    return {"gate": "rmse", "rmse_bart": rb, "rmse_lin": rl,
            "all_pass": rb <= rl, "wall_s": round(wall, 1),
            "timings": _timings(fit), "fit": fit}


def _timings(fit) -> dict:
    return {k: round(v, 2) for k, v in fit.timings.items()
            if isinstance(v, float)}


def run(gate: str, device="cuda", **budget) -> dict:
    """Gate ``gate`` (one of ``GATES``) at its harness's budget; a
    gaussian variant at ``budget`` (``warmup``, ``iters``) where given."""
    if gate in VARIANTS:
        return run_gaussian(gate, device, **budget)
    if gate == "probit":
        return run_probit(device)
    if gate == "rmse":
        return run_rmse(device)
    raise ValueError(f"gate must be one of {GATES}")


def report(rec: dict) -> str:
    """A record's values beside their limits, on one line."""
    if rec.get("gate") == "rmse":
        return (f"rmse: held-out RMSE of BART {rec['rmse_bart']:.4f} <= "
                f"least squares {rec['rmse_lin']:.4f}: "
                f"{'PASS' if rec['all_pass'] else 'FAIL'}")
    if "config" in rec:
        return (f"probit n={rec['config']['n']}: cor_ev_ptrue "
                f"{rec['cor_ev_ptrue']} (>= 0.90), deviance_ratio "
                f"{rec['deviance_ratio']} (< 0.8), ppd_gap {rec['ppd_gap']} "
                f"(< 0.05): {'PASS' if rec['all_pass'] else 'FAIL'}")
    return f"{rec['gate']}: " + "; ".join(
        f"{'PASS' if g['pass'] else 'FAIL'} {name} = {g['value']:.4f} "
        f"({g['bound']})" for name, g in rec["gates"].items())


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--gates", default=",".join(GATES),
                    help=f"comma-separated, of {', '.join(GATES)}")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None,
                    help="write the records here as JSON")
    args = ap.parse_args(argv)
    records = {}
    for gate in args.gates.split(","):
        rec = run(gate, args.device)
        rec.pop("fit")
        records[gate] = rec
        print(report(rec) + f" ({rec['wall_s']} s)", flush=True)
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(records, fh, indent=1)
    ok = all(r["all_pass"] for r in records.values())
    print(json.dumps({"harness": "quality", "gates": list(records),
                      "all_pass": ok}))
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
