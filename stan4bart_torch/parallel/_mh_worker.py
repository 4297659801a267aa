"""The small multi-process fits of the tests and ``chip_smoke.py``.

Counterpart of ``stan4bart_tpu/parallel/_mh_worker.py``.  Each function
here is one case that every rank of a ``parallel.mesh.spawn`` world runs
(the spawn start method imports it by name): ``run_cases(rank, world,
device, cases)`` runs a list of ``(name, kwargs)`` cases in order and
returns each case's result by name, so that one world (one process start
per rank) serves several checks.  The fits are the JAX worker's tiny
model: n = 60 Friedman rows with random effects, 4 trees.
"""

from __future__ import annotations

import numpy as np
import torch

FORMULA = "y ~ bart(X1+X2) + X4 + (1 | g.2)"


def _df(n: int = 60, binary: bool = False, seed: int = 99):
    from stan4bart_torch.utils.friedman import (
        friedman_dataframe,
        generate_friedman_data,
    )

    return friedman_dataframe(generate_friedman_data(n, ranef=True,
                                                     binary=binary,
                                                     seed=seed))


def _draws(fit) -> dict:
    d = fit.draws
    return {k: getattr(d, k) for k in d._fields if getattr(d, k) is not None}


def fit_case(rank, world, device, n=60, binary=False, weights=False,
             dtype="float64", diagnostics=False, **kw):
    """``stan4bart`` of the tiny model in the world (``kw`` its arguments:
    chains, iter, warmup, seed, stan_args, chunk_size, ...).  Returns the
    gathered draws as a dict of arrays, the run_info's layout and
    all-reduce count, and with ``diagnostics`` the sharded split-R-hat and
    ESS of sigma and lp__ from this rank's block of chains."""
    from stan4bart_torch import stan4bart
    from stan4bart_torch.parallel import multihost

    df = _df(n, binary)
    if weights:
        df["w"] = np.random.default_rng(7).uniform(0.5, 2.0, n)
    args = dict(chains=4, warmup=15, iter=40, seed=42, verbose=-1,
                bart_args={"n.trees": 4})
    args.update(kw)
    fit = stan4bart(FORMULA, df, device=device,
                    dtype=getattr(torch, dtype),
                    weights=df["w"] if weights else None, **args)
    out = {"draws": _draws(fit),
           "info": {k: fit.run_info[k] for k in
                    ("world_size", "rank", "chain_groups", "obs_shards",
                     "backend") if k in fit.run_info},
           "all_reduces": fit.run_info.get("all_reduces")}
    if diagnostics:
        names = fit.stan_names
        W, r = multihost.world()
        C = fit.draws.stan.shape[0] // W
        block = fit.draws.stan[r * C:(r + 1) * C, fit.warmup:]
        out["diag"] = multihost.sharded_diagnostics(
            block, [names.index("aux.1"), names.index("lp__")])
    return out


def pooled_metric_case(rank, world, device, count, mean, m2,
                       between=False):
    """``pooled_welford_variance`` over every chain of every rank: this
    rank holds rows [rank C, (rank + 1) C) of the (W C, D) Welford state
    (count, mean, m2)."""
    from stan4bart_torch.ops.nuts import WelfordState, pooled_welford_variance
    from stan4bart_torch.parallel.multihost import ChainPool

    C = len(count) // world
    sl = slice(rank * C, (rank + 1) * C)
    t = lambda a: torch.as_tensor(np.asarray(a)[sl], dtype=torch.float64,  # noqa: E731
                                  device=device)
    w = WelfordState(t(count), t(mean), t(m2))
    return pooled_welford_variance(w, between,
                                   ChainPool(len(count))).cpu().numpy()


def sweep_case(rank, world, device, inputs):
    """The plain observation-sharded sweep of this rank's shard of
    ``inputs`` (``sweep_inputs``' dict), the reduce hook an all-reduce
    over the world.  Returns the forest and the local fits."""
    from stan4bart_torch.ops import bart as ops
    from stan4bart_torch.parallel.mesh import DataAxis

    n = inputs["y"].shape[0] // world
    sl = slice(rank * n, (rank + 1) * n)
    f64 = torch.float64
    T = lambda a: torch.as_tensor(np.asarray(a), device=device)  # noqa: E731
    cfg = ops.BartConfig(**inputs["cfg"])
    C = inputs["feature"].shape[0]
    state = ops.BartState(
        feature=T(inputs["feature"]), cut=T(inputs["cut"]),
        leaf_value=T(inputs["leaf_value"]).to(f64),
        leaf_idx=T(inputs["leaf_idx"][..., sl]),
        allfit=T(inputs["allfit"][..., sl]).to(f64),
        k=torch.full((C,), 2.0, dtype=f64, device=device),
        sigma_mu=T(inputs["sigma_mu"]).to(f64),
        tree_fit=T(inputs["tree_fit"][..., sl]).to(f64))
    w = inputs.get("weights")
    axis = DataAxis()
    out, _ = ops.bart_sweep(
        cfg, state, T(inputs["y"][sl]).to(f64).expand(C, -1),
        T(inputs["ranks"][sl]), inputs["split_probs"],
        T(inputs["sigma"]).to(f64), weights=None if w is None
        else T(w[sl]).to(f64),
        variates=(T(inputs["u"]), T(inputs["zn"])), reduce=axis.sum)
    res = {k: getattr(out, k).cpu().numpy()
           for k in ("feature", "cut", "leaf_value", "leaf_idx", "allfit",
                     "tree_fit")}
    res["reductions"] = axis.calls
    return res


def _callback(draw):
    return {"sigma": draw["aux.1"]}


def refusal_case(rank, world, device):
    """The obs-sharded fits the port refuses, as the JAX package does:
    each one's ValueError message (None if it ran)."""
    obs = {"obs_shards": 2}
    out = {}
    for name, kw in (
            ("no_gram", dict(stan_args=dict(obs, gram_lik=False))),
            ("pooled", dict(stan_args=dict(obs, pooled_adaptation=True))),
            ("callback", dict(stan_args=obs, callback=_callback)),
            ("keep_fits", dict(stan_args=obs, keep_fits=False)),
            ("divide", dict(stan_args={"obs_shards": 3}))):
        try:
            fit_case(rank, world, device, iter=2, warmup=1, chains=2, **kw)
            out[name] = None
        except ValueError as e:
            out[name] = str(e)
    return out


def fail_case(rank, world, device):
    """Rank 1 raises; rank 0 waits in a collective that rank 1 never
    joins (spawn must raise, not hang)."""
    import torch.distributed as dist

    if rank == 1:
        raise RuntimeError("rank 1 fails on purpose")
    dist.all_reduce(torch.ones(1))
    return "rank 0 was not stopped"


def run_cases(rank, world, device, cases):
    """Every ``(name, kwargs)`` of ``cases`` in order (name a function of
    this module); returns {name or kwargs["key"]: result}."""
    out = {}
    for name, kw in cases:
        kw = dict(kw)
        key = kw.pop("key", name)
        out[key] = globals()[name](rank, world, device, **kw)
    return out
