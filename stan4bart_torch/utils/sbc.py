"""Simulation-based calibration (SBC) of the port's composed sampler.

Counterpart of ``benchmarks/sbc.py``: it certifies the whole Gibbs stack
at once (NUTS with its adaptation, the conjugate refreshes, the probit
latents, the BART sweep kernels) against the joint density of the model
and the CGM tree prior:

    theta~ ~ p(theta);  y ~ p(y | theta~);  fit;  rank(theta~ | draws)

If and only if the sampler targets the exact posterior, the ranks are
uniform over {0..L} (Talts et al. 2018).  Each cell of the model matrix
(continuous / probit, weights, QR, decov p=1 and p=2, lkj, interweave
on/off, the blocked-leaf draw, float32) runs R replications, gated per
quantity by a chi-square over B bins.

Where the JAX harness vmaps a whole single-chain fit over the reps, the
port runs ONE ``GibbsProgram`` with C = reps chains, each fitting its
own simulated response (a (C, N) ``y``).  On the card every cell sweeps
through the CUDA kernels of its dtype (the single-pass kernel; the
obs-tiled one in ``kernel_f32_tiled``, forced; the per-chain one with
the ``chain`` driver); on the CPU through their plain versions.

Validity, as in the JAX harness: ``sigma_mu_fixed`` pins the leaf prior
(the default range(y)-scaled one is data-dependent), the priors are
explicit with autoscale off, theta~ is drawn by
``ParametricModel.prior_draw_unconstrained`` (the block-by-block
complement of its prior density), and the draws are thinned by 5.

Usage: python -m stan4bart_torch.utils.sbc [--reps 128] [--cells a,b/chain]
[--seed 20260819] [--out SBC.json] [--device cuda|cpu]; a cell named
``<cell>/chain`` runs through the per-chain driver (``GibbsProgram.step``).
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import pandas as pd
import torch

from stan4bart_torch.formula import build_model_frame
from stan4bart_torch.gibbs import GibbsProgram
from stan4bart_torch.models import priors
from stan4bart_torch.models.assemble import build_parametric_model
from stan4bart_torch.ops import bart as bart_ops
from stan4bart_torch.ops.bart import BartConfig
from stan4bart_torch.utils.device import resolve_device

N_OBS = 100
WARMUP = 300
ITERS = 495
THIN = 5
L = ITERS // THIN  # 99 -> ranks in {0..99}, 10 exact bins
BINS = 10
SIGMA_MU = 0.3
SEED = 20260819


def covariate_frame(n, seed):
    """Fixed covariates (shared by every rep of a cell; only y varies)."""
    rng = np.random.default_rng(seed)
    return pd.DataFrame({
        "X1": rng.uniform(size=n),
        "X2": rng.uniform(size=n),
        "X4": rng.normal(size=n),
        "X5": rng.normal(size=n),
        "g": pd.Categorical(rng.integers(0, 8, size=n)),
        "y": np.zeros(n),
    })


def base_priors():
    return dict(
        prior=priors.normal(0.0, 2.5, autoscale=False),
        prior_aux=priors.exponential(1.0, autoscale=False),
        prior_covariance=priors.decov(regularization=1.0,
                                      concentration=1.0,
                                      shape=1.0, scale=0.5),
    )


def lkj_priors():
    pc = priors.lkj(regularization=1.0, df=3.0, scale=0.5, autoscale=False)
    return dict(
        prior=priors.normal(0.0, 2.5, autoscale=False),
        prior_aux=priors.exponential(1.0, autoscale=False),
        prior_covariance=pc,
    )


# formula with both a scalar-intercept term (p=1 decov) and a
# correlated-slope term (p=2: exercises zeta/rho onion ladder)
F_MULTI = "y ~ bart(X1 + X2) + X4 + (1 + X4 | g)"
F_SIMPLE = "y ~ bart(X1 + X2) + X4 + (1 | g)"

CELLS = {
    # reference-parity sampler class, multi-column decov
    "continuous": dict(formula=F_MULTI, binary=False, weights=False,
                       stan_args={"linear_gibbs": False,
                                  "level_gibbs": False}),
    "probit": dict(formula=F_MULTI, binary=True, weights=False,
                   stan_args={"linear_gibbs": False,
                              "level_gibbs": False}),
    "weights": dict(formula=F_SIMPLE, binary=False, weights=True,
                    stan_args={"linear_gibbs": False,
                               "level_gibbs": False}),
    # QR needs >= 2 fixed-effect predictors (stan4bart_fit.R:241-242)
    "qr": dict(formula="y ~ bart(X1 + X2) + X4 + X5 + (1 + X4 | g)",
               binary=False, weights=False,
               stan_args={"qr": True, "linear_gibbs": False,
                          "level_gibbs": False}),
    # lkj runs with the production interweave pair ON: with it off, the
    # ~10% of prior reps with sigma ~ exp(1) near 0 (near-noiseless data)
    # relax sigma too slowly for L=99 thinned ranks and pile up at rank 0
    # (a MIXING artifact at extreme SNR, conservative direction — the
    # decov cells certify the interweave-off stack; measured: min_p
    # 7.5e-4 off / passing on, aux.1 bin-0 spike 33/160 vs 16 expected)
    "lkj": dict(formula=F_MULTI, binary=False, weights=False,
                prior_cov="lkj",
                stan_args={"linear_gibbs": True, "level_gibbs": True}),
    # the full production kernel stack: conjugate interweaving pair on
    "interweave": dict(formula=F_MULTI, binary=False, weights=False,
                       stan_args={"linear_gibbs": True,
                                  "level_gibbs": True}),
    # the blocked-leaf draw, applied every 2nd iteration
    "leaf_block": dict(formula=F_MULTI, binary=False, weights=False,
                       stan_args={"linear_gibbs": True,
                                  "level_gibbs": True, "leaf_block": 2}),
    # ---- the float32 stack of a default fit on the card ---------------
    "kernel_f32": dict(formula=F_MULTI, binary=False, weights=False,
                       dtype="float32",
                       stan_args={"linear_gibbs": True,
                                  "level_gibbs": True}),
    "kernel_f32_probit": dict(formula=F_MULTI, binary=True,
                              weights=False, dtype="float32",
                              stan_args={"linear_gibbs": False,
                                         "level_gibbs": False}),
    # the obs-tiled sweep forced at n = 100 (GibbsProgram.sweep_tiled), so
    # its tile loop is the one certified
    "kernel_f32_tiled": dict(formula=F_MULTI, binary=False,
                             weights=False, dtype="float32", tiled=True,
                             stan_args={"linear_gibbs": True,
                                        "level_gibbs": True}),
}

DTYPES = {"float32": torch.float32, "float64": torch.float64}


def build_cell(cell, seed=0, device="cuda", warmup=WARMUP, iters=ITERS):
    """The cell's model frame, parametric model, program (its y the
    frame's zeros until a simulated (C, N) response replaces it) and
    BART configuration."""
    dev = resolve_device(device)
    df = covariate_frame(N_OBS, seed)
    w = (np.linspace(0.5, 2.0, N_OBS) if cell["weights"] else None)
    mf = build_model_frame(cell["formula"], df, weights=w)
    family = "binomial" if cell["binary"] else "gaussian"
    sa = dict(base_priors() if cell.get("prior_cov") != "lkj"
              else lkj_priors())
    sa.update(cell.get("stan_args", {}))
    dtype = DTYPES[cell.get("dtype", "float64")]
    pm, resolved, _ = build_parametric_model(mf, family, sa, dtype=dtype,
                                             device=dev)
    cfg = BartConfig(num_trees=8, max_depth=3, n_cuts=50,
                     node_scale=0.5, sigma_mu_fixed=SIGMA_MU)
    prog = GibbsProgram(
        pm, cfg, mf.y, mf.bart_X,
        weights=mf.weights if cell["weights"] else None,
        warmup=warmup, iterations=iters, dtype=dtype, device=dev,
        linear_gibbs=resolved.linear_gibbs,
        level_gibbs=resolved.level_gibbs,
        leaf_gibbs=resolved.leaf_gibbs,
        leaf_block=resolved.leaf_block,
        sigma_gibbs=resolved.sigma_gibbs,
    )
    if cell.get("tiled"):
        prog.sweep_tiled = True
    return mf, pm, prog, cfg


def rank_quantities(pm, binary):
    """Names ranked in this cell: sigma, the fixed effect, covariance
    entries, two ranef coords (the BART-fit functionals f.0, f.1 and
    f.mean follow them)."""
    cn = pm.constrained_names()
    names = []
    if not binary:
        names.append("aux.1")
    names += [n for n in cn if n.startswith("beta.")][:2]
    names += [n for n in cn if n.startswith("theta_L.")][:3]
    names += [n for n in cn if n.startswith("b.")][:2]
    return names


def simulate(pm, prog, binary, rng=None, n_reps=None, u_t=None,
             forest=None, leaf_z=None, eps=None):
    """One data set per rep from the prior: theta~ (``u_t``, (C, D)
    unconstrained), a CGM forest (``forest``, a BartState of C chains)
    with leaves ``SIGMA_MU * leaf_z`` ((C, T, M) standard normals) on its
    leaf slots, and y = eta + aux / sqrt(w) * eps (gaussian) or
    1[eta + eps > 0] (probit), eta the parametric mean plus the forest's
    fit and eps (C, N) standard normals.  Each input not given is drawn
    from the numpy Generator ``rng``, in that order.  Returns (u_t, f, y),
    f the forest's fit (C, N)."""
    cfg = prog.bart_cfg
    dt, dev = prog.dtype, prog.device
    if u_t is None:
        u_t = pm.prior_draw_unconstrained(rng, n_reps)
    C = u_t.shape[0]
    if forest is None:
        forest = bart_ops.sample_trees_from_prior(
            cfg, None, prog.ranks, prog.split_probs, C, dtype=dt,
            u=rng.random((C, 3, cfg.num_trees, cfg.max_nodes)))
    if leaf_z is None:
        leaf_z = rng.standard_normal((C, cfg.num_trees, cfg.max_nodes))
    if eps is None:
        eps = rng.standard_normal((C, prog.N))
    leaf_mask = (forest.feature == bart_ops.LEAF).to(dt)
    lv = SIGMA_MU * torch.as_tensor(leaf_z, dtype=dt, device=dev) * leaf_mask
    f = torch.gather(lv, 2, forest.leaf_idx.long()).sum(1)
    c, _ = pm.layout.constrain(u_t)
    tp = pm.transformed(c, C)
    eta = pm.parametric_mean(c, tp) + f
    eps = torch.as_tensor(eps, dtype=dt, device=dev)
    if binary:
        y = (eta + eps > 0).to(dt)
    else:
        sd = tp["aux"][:, None]
        if prog.weights is not None:
            sd = sd / torch.sqrt(prog.weights)
        y = eta + sd * eps
    return u_t, f, y


def chi2_pvalue(ranks, n_values=L + 1, bins=BINS):
    """Exact-expected-count chi-square over rank bins: (statistic,
    p-value, counts)."""
    from scipy.stats import chi2

    # bin of rank r = r * bins // n_values; expected = width / n_values
    binned = np.asarray(ranks) * bins // n_values
    counts = np.bincount(binned, minlength=bins)
    widths = np.bincount(np.arange(n_values) * bins // n_values,
                         minlength=bins)
    exp = len(ranks) * widths / n_values
    stat = float(np.sum((counts - exp) ** 2 / exp))
    return stat, float(chi2.sf(stat, bins - 1)), counts.tolist()


def run_cell(name, cell, n_reps, seed, device="cuda", driver="batched",
             warmup=WARMUP, iters=ITERS, thin=THIN, verbose=True):
    """One cell at ``n_reps`` reps, run as one program of ``n_reps``
    chains through ``step_batched`` (``driver="batched"``) or the
    per-chain ``step`` (``"chain"``).  The ranks are of ``iters // thin``
    thinned draws, binned into ``min(BINS, L + 1)`` bins.  Returns the
    cell's record: cell, reps, L, quantities {chi2, p, counts}, min_p,
    pass (every p above 1e-3) and wall_s, then the fit's timings and its
    sampling phase's NUTS leapfrogs and divergent share."""
    if driver not in ("batched", "chain"):
        raise ValueError("driver must be 'batched' or 'chain'")
    t0 = time.time()
    _, pm, prog, _ = build_cell(cell, seed=seed, device=device,
                                warmup=warmup, iters=iters)
    rng = np.random.default_rng(seed + 0x5BC)
    u_t, f, y = simulate(pm, prog, cell["binary"], rng, n_reps)
    prog.y = y
    gen = torch.Generator(device=prog.device)
    gen.manual_seed(int(rng.integers(2 ** 31)))
    def progress(phase, done, total):
        print(f"  [{name}] {phase} {done}/{total} "
              f"({time.time() - t0:.0f} s)", flush=True)

    _, draws, info = prog.run_chains_chunked(
        gen, n_reps, chunk_size=100 if verbose else None, keep_warmup=False,
        per_chain=driver == "chain", progress=progress if verbose else None)
    cols = {n: i for i, n in enumerate(prog.stan_names())}
    leap = draws.stan[:, :, cols["n_leapfrog__"]]
    stan = draws.stan[:, thin - 1:: thin]          # (R, L, S)
    ftr = draws.bart_train[:, thin - 1:: thin]     # (R, L, N)
    n_draws = stan.shape[1]

    cidx = {n: i for i, n in enumerate(pm.constrained_names())}
    rnames = rank_quantities(pm, cell["binary"])
    theta = pm.constrained_draw(u_t).double().cpu().numpy()
    f = f.double().cpu().numpy()
    ranks = [(stan[:, :, cols[n]] < theta[:, None, cidx[n]]).sum(1)
             for n in rnames]
    ranks += [(ftr[:, :, 0] < f[:, None, 0]).sum(1),
              (ftr[:, :, 1] < f[:, None, 1]).sum(1),
              (ftr.mean(-1) < f.mean(-1)[:, None]).sum(1)]

    out = {"cell": name, "reps": int(n_reps), "L": n_draws,
           "quantities": {}}
    worst = 1.0
    for qn, r in zip(rnames + ["f.0", "f.1", "f.mean"], ranks):
        stat, p, counts = chi2_pvalue(r, n_draws + 1,
                                      min(BINS, n_draws + 1))
        out["quantities"][qn] = {"chi2": round(stat, 2), "p": p,
                                 "counts": counts}
        worst = min(worst, p)
    out["min_p"] = worst
    out["pass"] = bool(worst > 1e-3)
    out["wall_s"] = round(time.time() - t0, 1)
    # where the wall went (host clock), and the sampling phase's NUTS:
    # leapfrogs per transition, the sum over iterations of the most any
    # chain took (what chains in lock step cost) and divergent draws
    out["timings"] = {k: round(info[k], 2) for k in (
        "warmup_s", "sample_s", "nuts_gibbs", "sweep", "post")}
    out["nuts"] = {
        "leapfrogs_mean": round(float(leap.mean()), 2),
        "leapfrogs_lockstep": int(leap.max(0).sum()),
        "divergent": round(float(
            draws.stan[:, :, cols["divergent__"]].mean()), 4)}
    if verbose:
        print(f"  [{name}] {n_reps} reps, min_p {worst:.4g} "
              f"({out['wall_s']} s)", flush=True)
    return out


def run_cells(specs, n_reps, seed=SEED, device="cuda", verbose=True):
    """``run_cell`` of each ``<cell>`` or ``<cell>/chain`` in ``specs``;
    returns the summary of ``benchmarks/sbc.py``'s JSON."""
    results = []
    for spec in specs:
        cell, _, driver = spec.partition("/")
        results.append(run_cell(spec, CELLS[cell], n_reps, seed,
                                device=device, driver=driver or "batched",
                                verbose=verbose))
    return {"harness": "sbc", "reps": n_reps, "L": L, "bins": BINS,
            "alpha": 1e-3, "cells": results,
            "all_pass": all(r["pass"] for r in results)}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=128)
    ap.add_argument("--cells", type=str, default=",".join(CELLS),
                    help="comma-separated cells; <cell>/chain runs the "
                    "per-chain driver")
    ap.add_argument("--seed", type=int, default=SEED)
    ap.add_argument("--out", type=str, default="SBC_torch.json")
    ap.add_argument("--device", type=str, default="cuda")
    args = ap.parse_args(argv)
    summary = run_cells(args.cells.split(","), args.reps, args.seed,
                        args.device)
    with open(args.out, "w") as fh:
        json.dump(summary, fh, indent=1)
    print(json.dumps({k: summary[k] for k in
                      ("harness", "reps", "all_pass")}))


if __name__ == "__main__":
    main()
