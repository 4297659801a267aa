"""Assemble a ParametricModel from a ModelFrame + user prior specs.

Counterpart of ``stan4bart_tpu/models/assemble.py``: default priors,
autoscaling by sd(y) and per-column sd(x), the QR rotation of the fixed
effects, decov / lkj hyperparameter broadcasting, the R2 prior's eta,
and the control-argument defaults and validation.  ``obs_shards``
(observation sharding over the ranks of a ``torch.distributed`` world,
``parallel/mesh.py``) is validated here as the JAX package validates it;
``stan4bart`` dispatches on it.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from stan4bart_torch.formula.design import ModelFrame
from stan4bart_torch.models import priors as priors_mod
from stan4bart_torch.models.parametric import (
    ParametricConfig,
    ParametricModel,
    decov_delta,
)


@dataclass
class StanArgs:
    """Resolved stan-side arguments (Stan's control defaults)."""

    prior: dict | None = None
    prior_aux: dict | None = None
    prior_covariance: dict | None = None
    qr: bool = False
    centered_ranef: bool = False
    init_r: float = 2.0
    adapt_gamma: float = 0.05
    adapt_delta: float = 0.8
    adapt_kappa: float = 0.75
    adapt_t0: float = 10.0
    adapt_init_buffer: int = 75
    adapt_term_buffer: int = 50
    adapt_base_window: int = 25
    max_treedepth: int = 10
    stepsize: float = 1.0
    stepsize_jitter: float = 0.0
    freeze_rule: str = "bar"
    pooled_adaptation: bool = False
    pooled_parts: str = "metric"
    pooled_between: bool = False
    sigma_gibbs: bool = False
    # exact conjugate refresh of [beta | b] and the additive-level
    # interweave; None = auto (on together when the model is eligible)
    linear_gibbs: bool | None = None
    level_gibbs: bool | None = None
    leaf_gibbs: int = 0
    leaf_block: int = 0
    leaf_block_dim: int = 0
    # VI-within-Gibbs knobs (algorithm="vi" / "advi"); vi_family applies
    # to algorithm="advi" only
    vi_family: str = "meanfield"
    vi_steps: int = 5
    vi_mc: int = 4
    vi_eta: float = 0.5
    # Gram-compressed likelihood in the NUTS loop; None = auto by D
    gram_lik: bool | None = None
    obs_shards: int = 0
    seed: int | None = None
    keep_trees: bool = False




def _sd(x):
    return float(np.std(x, ddof=1)) if len(x) > 1 else 1.0


def _validate_stan_args(sa: StanArgs):
    """Bounds validation of the resolved control surface."""
    def check(name, value, lo=None, hi=None, lo_open=False, hi_open=False):
        v = float(value)
        if lo is not None and (v < lo or (lo_open and v == lo)):
            raise ValueError(
                f"stan_args {name} must be {'>' if lo_open else '>='} {lo}")
        if hi is not None and (v > hi or (hi_open and v == hi)):
            raise ValueError(
                f"stan_args {name} must be {'<' if hi_open else '<='} {hi}")

    check("init_r", sa.init_r, lo=0.0)
    check("adapt_gamma", sa.adapt_gamma, lo=0.0, lo_open=True)
    check("adapt_delta", sa.adapt_delta, lo=0.0, hi=1.0,
          lo_open=True, hi_open=True)
    check("adapt_kappa", sa.adapt_kappa, lo=0.0, lo_open=True)
    check("adapt_t0", sa.adapt_t0, lo=0.0, lo_open=True)
    check("adapt_init_buffer", sa.adapt_init_buffer, lo=0)
    check("adapt_term_buffer", sa.adapt_term_buffer, lo=0)
    check("adapt_base_window", sa.adapt_base_window, lo=1)
    check("max_treedepth", sa.max_treedepth, lo=1)
    check("stepsize", sa.stepsize, lo=0.0, lo_open=True)
    check("stepsize_jitter", sa.stepsize_jitter, lo=0.0, hi=1.0)
    check("leaf_gibbs", sa.leaf_gibbs, lo=0)
    check("obs_shards", sa.obs_shards, lo=0)
    check("leaf_block", sa.leaf_block, lo=0)
    check("leaf_block_dim", sa.leaf_block_dim, lo=0)
    check("vi_steps", sa.vi_steps, lo=1)
    check("vi_mc", sa.vi_mc, lo=1)
    check("vi_eta", sa.vi_eta, lo=0.0, lo_open=True)
    if sa.vi_family not in ("meanfield", "fullrank"):
        raise ValueError("stan_args vi_family must be meanfield or "
                         "fullrank")
    if sa.freeze_rule not in ("bar", "mid", "last"):
        raise ValueError("stan_args freeze_rule must be bar, mid, or last")
    if sa.pooled_parts not in ("metric", "stepsize", "both"):
        raise ValueError(
            "stan_args pooled_parts must be metric, stepsize, or both")


def build_parametric_model(
    mf: ModelFrame,
    family: str,
    stan_args: StanArgs | dict | None = None,
    dtype=torch.float64,
    device="cuda",
):
    """-> (ParametricModel, resolved StanArgs, info dict)."""
    if stan_args is None:
        stan_args = StanArgs()
    elif isinstance(stan_args, dict):
        known = {k: v for k, v in stan_args.items()
                 if k in StanArgs.__dataclass_fields__}
        unknown = sorted(set(stan_args) - set(known))
        if unknown:
            import warnings

            if "prior_intercept" in unknown:
                warnings.warn(
                    "the intercept is part of the BART component, so "
                    "'prior_intercept' is ignored")
                unknown.remove("prior_intercept")
            if unknown:
                warnings.warn(f"ignoring unsupported stan_args: {unknown}")
        stan_args = StanArgs(**known)

    is_binary = family == "binomial"
    _validate_stan_args(stan_args)
    prior = (stan_args.prior if stan_args.prior is not None
             else priors_mod.default_prior_coef())
    prior_aux = (stan_args.prior_aux if stan_args.prior_aux is not None
                 else priors_mod.default_prior_aux())
    decov = (stan_args.prior_covariance
             if stan_args.prior_covariance is not None
             else priors_mod.decov())

    xtemp = np.asarray(mf.X, dtype=np.float64)
    y = np.asarray(mf.y, dtype=np.float64)
    K = xtemp.shape[1]

    ps = priors_mod.handle_glm_prior(prior, K, default_scale=2.5)
    pa = priors_mod.handle_glm_prior(prior_aux, 1, default_scale=1.0)

    if ps["prior_dist"] == 8:
        # the R2 prior is joint over the QR-rotated, unit-variance
        # coefficients (stan_lm always uses QR)
        if is_binary:
            raise ValueError("the R2 prior requires a gaussian response")
        if not stan_args.qr:
            raise ValueError("the R2 prior requires stan_args qr=True "
                             "(stan_lm semantics)")
        if K < 2:
            raise ValueError("the R2 prior requires multiple predictors")

    if decov.get("dist") not in ("decov", "lkj"):
        raise ValueError("prior_covariance must be decov() or lkj() "
                         f"(got {decov.get('dist')!r})")
    cov_prior = 1 if decov["dist"] == "lkj" else 0

    if not is_binary:
        ss = _sd(y)
        if ps["prior_dist"] > 0 and ps["prior_autoscale"]:
            ps["prior_scale"] = ss * ps["prior_scale"]
        if pa["prior_dist"] > 0 and pa["prior_autoscale"]:
            pa["prior_scale"] = ss * pa["prior_scale"]

    R_inv = None
    if not stan_args.qr and ps["prior_dist"] > 0 and ps["prior_autoscale"]:
        col_scale = np.ones(K)
        for j in range(K):
            if len(np.unique(xtemp[:, j])) > 1:
                col_scale[j] = _sd(xtemp[:, j])
        ps["prior_scale"] = np.maximum(1e-12,
                                       ps["prior_scale"] / col_scale)
    elif stan_args.qr and K > 0:
        if K <= 1:
            raise ValueError("'qr' requires multiple predictors")
        Q, R = np.linalg.qr(xtemp)
        if ps["prior_autoscale"] or ps["prior_dist"] == 8:
            # R2 needs X = Q sqrt(N - 1), so that var(X beta) = |beta|^2
            scale_factor = np.sqrt(xtemp.shape[0] - 1.0)
        else:
            scale_factor = np.diag(R)[-1]
        R_inv = np.linalg.solve(R, np.eye(K)) * scale_factor
        xtemp = Q * scale_factor

    num_normals = ()
    if ps["prior_dist"] == 7:
        num_normals = tuple(int(v) for v in ps["prior_df"])

    cfg = ParametricConfig(
        N=mf.N,
        K=K,
        is_binary=is_binary,
        has_weights=mf.weights is not None and len(mf.weights) > 0,
        prior_dist=int(ps["prior_dist"]),
        prior_dist_for_aux=0 if is_binary else int(pa["prior_dist"]),
        t=len(mf.re_terms),
        p=tuple(mf.p),
        l=tuple(mf.l),
        num_normals=num_normals,
        centered=bool(stan_args.centered_ranef),
        cov_prior=cov_prior,
    )

    t = cfg.t
    concentration = np.broadcast_to(
        np.atleast_1d(decov.get("concentration", 1.0)),
        (cfg.len_concentration,)
    ).astype(np.float64) if cfg.len_concentration else np.zeros(0)
    regularization = np.broadcast_to(
        np.atleast_1d(decov["regularization"]), (cfg.len_regularization,)
    ).astype(np.float64) if cfg.len_regularization else np.zeros(0)

    hyper = dict(
        prior_mean=ps["prior_mean"],
        prior_scale=np.asarray(ps["prior_scale"], dtype=np.float64),
        prior_df=ps["prior_df"],
        global_prior_df=ps["global_prior_df"],
        global_prior_scale=ps["global_prior_scale"],
        slab_df=ps["slab_df"],
        slab_scale=ps["slab_scale"],
        prior_mean_for_aux=float(np.atleast_1d(pa["prior_mean"])[0]),
        prior_scale_for_aux=(
            0.0 if is_binary
            else float(np.atleast_1d(pa["prior_scale"])[0])
        ),
        prior_df_for_aux=float(np.atleast_1d(pa["prior_df"])[0]),
        shape_decov=np.broadcast_to(
            np.atleast_1d(decov.get("shape", 1.0)), (t,)).astype(np.float64),
        scale_decov=np.broadcast_to(
            np.atleast_1d(decov.get("scale", 1.0)), (t,)).astype(np.float64),
        regularization=regularization,
    )
    hyper["delta"] = decov_delta(cfg, concentration)
    if cov_prior == 1:
        lkj_scale = np.broadcast_to(
            np.atleast_1d(decov.get("scale", 10.0)), (t,)
        ).astype(np.float64).copy()
        if decov.get("autoscale", True) and not is_binary:
            lkj_scale = lkj_scale * _sd(y)
        hyper["lkj_scale"] = lkj_scale
        hyper["lkj_df"] = np.broadcast_to(
            np.atleast_1d(decov.get("df", 1.0)), (t,)).astype(np.float64)
    if ps["prior_dist"] == 8:
        hyper["R2_eta"] = priors_mod.make_eta(ps["R2_location"],
                                              ps["R2_what"], K)
        hyper["R2_s"] = _sd(y)

    z_structs = [(rt.lhs, rt.group_idx) for rt in mf.re_terms]
    model = ParametricModel(cfg, xtemp, z_structs, hyper,
                            weights=mf.weights, dtype=dtype, device=device)
    info = dict(R_inv=R_inv, x=xtemp,
                prior_summary=dict(coef=ps, aux=pa, covariance=decov))
    return model, stan_args, info
