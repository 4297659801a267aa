"""Top-level user API: ``stan4bart(formula, data, ...)``.

Counterpart of ``stan4bart_tpu/fit.py``: validates arguments, builds
model frames, detects the family ({0,1} response -> probit, else
gaussian), builds the treatment counterfactual frame, computes the
parametric initialization, assembles the samplers, runs the chains and
packages the draws into a :class:`~stan4bart_torch.results.Stan4bartFit`.

The chains run as one batch on ``device``; inside an initialized
``torch.distributed`` world of several ranks (``torchrun``, or
``parallel.mesh.spawn``) they are sharded over the ranks, with
``stan_args={"obs_shards": k}`` over chain groups of k ranks that split
the observations (``parallel/mesh.py``); and ``cores > 1`` with several
visible cards spawns one rank per card.
"""

from __future__ import annotations

import inspect
import time
import warnings

import numpy as np
import torch

from stan4bart_torch.formula.design import ModelFrame, build_model_frame
from stan4bart_torch.gibbs import OFFSET_TYPES, GibbsDraw, GibbsProgram
from stan4bart_torch.models.assemble import build_parametric_model
from stan4bart_torch.ops.bart import BartConfig
from stan4bart_torch.ops.bart_sweep_kernel import check_kernel_dtype
from stan4bart_torch.ops.nuts import NutsConfig
from stan4bart_torch.utils.device import resolve_device


def _detect_family(y: np.ndarray) -> str:
    vals = np.unique(y[~np.isnan(y)])
    if len(vals) <= 2 and np.all(np.isin(vals, (0.0, 1.0))):
        return "binomial"
    return "gaussian"


def _dense_Z(mf: ModelFrame) -> np.ndarray:
    """Dense (N, q) random-effects design in lme4 flat-b order."""
    from stan4bart_torch.native import dense_z

    Z = np.zeros((mf.N, mf.q))
    off = 0
    for t in mf.re_terms:
        dense_z(Z, np.asarray(t.group_idx, dtype=np.int32),
                np.ascontiguousarray(t.lhs, dtype=np.float64), off, t.p)
        off += t.p * t.l
    return Z


def _init_parametric_fit(mf: ModelFrame, family: str):
    """Ridge least squares (gaussian) or a few probit IRLS steps
    (binomial) on [1, X, Z] — the stand-in for the reference's
    lmer -> lm -> intercept init ladder.  Returns (bart_offset_init,
    sigma_init)."""
    y = np.asarray(mf.y, dtype=np.float64)
    N = mf.N
    A = np.concatenate([np.ones((N, 1)), np.asarray(mf.X), _dense_Z(mf)],
                       axis=1)
    ridge = 1e-2 * np.eye(A.shape[1])
    ridge[0, 0] = 1e-8  # do not shrink the intercept
    try:
        if family == "gaussian":
            w = np.linalg.solve(A.T @ A + ridge, A.T @ y)
            fitted = A @ w
            resid = y - fitted
            dof = max(N - A.shape[1], 1)
            sigma = float(np.sqrt(resid @ resid / dof))
            return fitted, max(sigma, 1e-6)
        from scipy.stats import norm

        w = np.zeros(A.shape[1])
        for _ in range(15):
            eta = np.clip(A @ w, -8, 8)
            p = np.clip(norm.cdf(eta), 1e-6, 1 - 1e-6)
            phi = norm.pdf(eta)
            wls = phi ** 2 / (p * (1 - p))
            z = eta + (y - p) / phi
            Aw = A * wls[:, None]
            w = np.linalg.solve(A.T @ Aw + ridge, Aw.T @ z)
        return np.clip(A @ w, -8, 8), 1.0
    except np.linalg.LinAlgError:
        if family == "gaussian":
            return np.full(N, y.mean()), max(float(np.std(y, ddof=1)), 1e-6)
        return np.zeros(N), 1.0


def _resolve_bart_args(bart_args: dict | None, is_binary: bool):
    """Map user bart_args (dbarts-style names) onto BartConfig; returns
    (BartConfig, split_probs, keep_trees)."""
    ba = dict(bart_args or {})

    def pop(*names, default=None):
        for n in names:
            if n in ba:
                return ba.pop(n)
        return default

    n_trees = int(pop("n.trees", "n_trees", "ntree", default=75))
    power = float(pop("power", default=2.0))
    base = float(pop("base", default=0.95))
    n_cuts = int(pop("n.cuts", "n_cuts", default=100))
    max_depth = int(pop("max_depth", default=6))
    split_probs = pop("split.probs", "split_probs")
    k = pop("k")
    sigma_mu_fixed = pop("sigma_mu_fixed", default=None)
    if sigma_mu_fixed is not None:
        sigma_mu_fixed = float(sigma_mu_fixed)
    keep_trees = bool(pop("keepTrees", "keep_trees", default=False))
    # the probability of a subtree-regrow MH move after each tree's move,
    # inside the sweep (ops/bart.py:_subtree_regrow; the sweep kernels
    # take it); 0 = the reference's move set
    p_regrow = float(pop("p_regrow", default=0.0))
    # random subtree regrows after each sweep (GibbsProgram._regrow)
    regrow_per_sweep = int(pop("regrow_per_sweep", default=0))
    if regrow_per_sweep < 0:
        raise ValueError("bart_args regrow_per_sweep must be >= 0")
    pop("sweep_kernel")   # the port always runs its sweep kernel

    # k: numeric -> fixed; chi spec (dict or ("chi", df, scale)) ->
    # sampled from k = 2; default = fixed k = 2
    k_init, k_df, k_scale = 2.0, 0.0, float("inf")
    if k is not None:
        if isinstance(k, (int, float)):
            k_init = float(k)
        elif isinstance(k, dict) and k.get("dist") == "chi":
            k_df, k_scale = float(k["df"]), float(k["scale"])
        elif isinstance(k, (tuple, list)) and k and k[0] == "chi":
            k_df, k_scale = float(k[1]), float(k[2])
        else:
            raise ValueError(f"cannot interpret bart k spec: {k!r}")

    if ba:
        warnings.warn(f"ignoring unsupported bart_args: {sorted(ba)}")

    cfg = BartConfig(
        num_trees=n_trees, max_depth=max_depth, n_cuts=n_cuts,
        power=power, base=base, node_scale=3.0 if is_binary else 0.5,
        k_init=k_init, k_df=k_df, k_scale=k_scale,
        sigma_mu_fixed=sigma_mu_fixed, regrow_per_sweep=regrow_per_sweep,
        p_regrow=p_regrow,
    )
    return cfg, split_probs, keep_trees


def _print_initial_summary(mf, family, bart_cfg, warmup, iterations, chains,
                           skip_bart, skip_stan, stan_args, sigma_init):
    """The reference's printInitialSummary (init.cpp:971-993): the
    resolved control and model configuration before sampling."""
    print(
        f"stan4bart: {family} model, n = {mf.N}, "
        f"fixed effects K = {mf.K}, bart predictors = {mf.bart_X.shape[1]}, "
        f"ranef terms t = {len(mf.re_terms)} (q = {mf.q})"
    )
    print(
        f"  chains = {chains}, warmup = {warmup}, draws = {iterations}, "
        f"skip (bart, stan) = ({skip_bart}, {skip_stan})"
    )
    print(
        f"  bart: trees = {bart_cfg.num_trees}, power = {bart_cfg.power}, "
        f"base = {bart_cfg.base}, k = {bart_cfg.k_init}"
        f"{' (chi hyperprior)' if bart_cfg.k_df > 0 else ''}, "
        f"n.cuts = {bart_cfg.n_cuts}"
    )
    print(
        f"  stan: adapt_delta = {stan_args.adapt_delta}, "
        f"max_treedepth = {stan_args.max_treedepth}, "
        f"init_r = {stan_args.init_r}, sigma_init = {sigma_init:.4g}"
    )


def chi(df=1.25, scale=float("inf")):
    """k hyperprior spec for ``bart_args={"k": chi(...)}``, mirroring the
    reference's chi() quoting (stan4bart.R:202-210)."""
    return {"dist": "chi", "df": df, "scale": scale}


class CallbackDraw:
    """Named per-iteration view of ONE chain handed to user callbacks —
    parity with the reference's (yhat.train, yhat.test, stan named vector)
    environment (init.cpp:849-911; test-11-callback.R).

    Attributes: ``yhat_train`` (n,), ``yhat_test`` (n_test,) or None,
    ``stan_pars`` (full diagnostic+constrained row), ``names``; index by
    parameter name: ``draw["beta.1"]``.  ``raw`` is the underlying
    GibbsDraw.  The callback runs under ``torch.func.vmap`` over the
    chains, so every value is one chain's tensor and the callback must
    return a tensor or a dict / tuple of tensors."""

    def __init__(self, draw, names, name_idx, has_test):
        self.raw = draw
        self.yhat_train = draw.bart_train
        self.yhat_test = draw.bart_test if has_test else None
        self.stan_pars = draw.stan
        self.names = names
        self._idx = name_idx

    def __getitem__(self, name):
        return self.raw.stan[self._idx[name]]


def _per_chain_callback(callback, names, has_test):
    """``callback`` of one chain's CallbackDraw as a function of the
    chain-batched GibbsDraw (vmapped over the chain dimension)."""
    idx = {n: i for i, n in enumerate(names)}

    def one(*leaves):
        return callback(CallbackDraw(GibbsDraw(*leaves), names, idx,
                                     has_test))

    def batched(draw):
        # the stored forests are None without keep_trees
        dims = tuple(None if x is None else 0 for x in draw)
        return torch.func.vmap(one, in_dims=dims)(*draw)

    return batched


def _data_columns(data) -> dict:
    return {k: np.asarray(v).copy() for k, v in (
        data.items() if isinstance(data, dict)
        else {c: data[c] for c in data.columns}.items())}


def stan4bart(
    formula: str,
    data,
    *,
    test=None,
    treatment: str | None = None,
    family: str | None = None,
    subset=None,
    offset_test=None,
    iter: int = 2000,
    warmup: int | None = None,
    skip=None,
    chains: int = 4,
    cores: int | None = None,
    verbose: int = 0,
    seed: int | None = None,
    keep_fits: bool = True,
    callback=None,
    stan_args: dict | None = None,
    bart_args: dict | None = None,
    offset=None,
    weights=None,
    refresh: int | None = None,
    offset_type: str = "default",
    na_action: str = "omit",
    chunk_size: int | None = None,
    algorithm: str = "nuts",
    dtype=None,
    device="cuda",
    _progress=None,
):
    """Fit a semiparametric BART + multilevel model; returns a
    Stan4bartFit.  ``iter`` is the TOTAL per-chain iterations including
    ``warmup`` (default iter/2); ``skip`` thins (int, pair, or dict with
    'bart'/'stan' entries).

    ``callback``: optional ``f(draw) -> tensor | dict | tuple`` of one
    chain's :class:`CallbackDraw`, stored per iteration and read back with
    ``fit.extract("callback")``; ``keep_fits=False`` stores only the
    callback's outputs (nothing without a callback).  Either runs the
    per-chain driver (``GibbsProgram.step``).

    ``device`` (default ``"cuda"``) is where every chain runs; without a
    CUDA device this raises unless ``device="cpu"`` is given.  ``cores``
    spreads chains over devices, as in the JAX package: on one device (the
    CPU, or one visible card) it runs the single-device path; with more
    than one visible card ``cores > 1`` spawns one rank per card on
    min(cores, cards, chains) cards (fewer where that count does not
    divide the chains), joined by NCCL, and returns rank 0's fit
    (``parallel.mesh.fit_on_devices``; the arguments must pickle, so a
    callback must be a module-level function).  Inside an initialized
    ``torch.distributed`` world of W > 1 ranks every rank runs the same
    call: the chains are sharded over the ranks (W must divide
    ``chains``), each chain group with its own generator
    (``parallel.multihost.rank_seed``), and the draws are gathered to
    every rank; ``stan_args={"obs_shards": k}`` (k >= 2 dividing W)
    makes W / k chain groups of k ranks, each rank holding 1 / k of the
    observations, with every sufficient statistic all-reduced over its
    group (``parallel/mesh.py``; no callback, ``keep_fits=False`` or
    pooled adaptation).  A fit from several ranks keeps its final states
    on the ranks (``final_states`` is None), so it cannot
    ``continue_sampling``.  ``dtype`` is float32 (the default) or
    float64; on the card each sweep launches the CUDA kernels' build for
    it (``ops/bart_sweep_kernel.py``: a float64 fit runs their
    double-precision builds).  ``chunk_size`` bounds the iterations
    between progress reports and interrupt checks.

    ``algorithm`` selects the parametric block's sampler within Gibbs:
    ``"nuts"`` (default; the only one with exact posterior contracts),
    ``"advi"`` (stan::variational's adagrad rule on a meanfield q, or
    fullrank with ``stan_args={"vi_family": "fullrank"}``, warm-started
    across iterations: point estimates track NUTS, spreads are
    approximate) or ``"vi"`` (streaming RMSProp on a meanfield q: the
    fastest exploratory fits, with the sigma posterior biased high; a
    post-fit warning says so).  ``stan_args`` ``vi_steps``, ``vi_mc`` and
    ``vi_eta`` set the optimizer steps per iteration, the draws per ELBO
    gradient and the base rate.
    """
    from stan4bart_torch.parallel import mesh, multihost
    from stan4bart_torch.results import Stan4bartFit

    if cores is not None and cores <= 0:
        raise ValueError("'cores' must be a positive integer")
    world_size, _ = multihost.world()
    # as in the JAX package, chains spread over cores only where the
    # device type has more than one device; on one device (the CPU, or a
    # single card) cores > 1 runs the single-device path
    if (cores is not None and cores > 1 and world_size == 1
            and torch.device(device).type == "cuda"
            and torch.cuda.device_count() > 1 and chains > 1):
        n_dev = min(int(cores), torch.cuda.device_count(), int(chains))
        while chains % n_dev != 0:      # the ranks must divide the chains
            n_dev -= 1
        if n_dev > 1:
            # every argument but those that place the fit goes to the ranks
            args = locals()
            kwargs = {k: args[k] for k in
                      inspect.signature(stan4bart).parameters
                      if k not in ("formula", "data", "cores", "device",
                                   "_progress")}
            if seed is None and not (stan_args or {}).get("seed"):
                # every rank must draw from one seed
                kwargs["seed"] = int(np.random.SeedSequence().entropy
                                     % (2 ** 31))
            return mesh.fit_on_devices(
                [f"cuda:{i}" for i in range(n_dev)], "cpu:gloo,cuda:nccl",
                formula, data, kwargs)
    dev = resolve_device(device)
    if offset_type not in OFFSET_TYPES:
        raise ValueError(f"offset_type must be one of {OFFSET_TYPES}")
    if algorithm not in ("nuts", "vi", "advi"):
        raise ValueError("algorithm must be 'nuts', 'vi', or 'advi'")
    if not isinstance(iter, (int, np.integer)) or iter <= 0:
        raise ValueError("'iter' must be a positive integer")
    if warmup is not None and (warmup < 0 or int(warmup) != warmup):
        raise ValueError("'warmup' must be a non-negative integer")
    if chains <= 0:
        raise ValueError("'chains' must be a positive integer")
    if skip is not None:
        flat = (list(skip.values()) if isinstance(skip, dict)
                else np.atleast_1d(skip).tolist())
        if any(s <= 0 for s in flat):
            raise ValueError("'skip' must be one or two positive integers")
    if warmup is None:
        warmup = iter // 2
    iterations = iter - warmup
    if iterations < 0:
        raise ValueError("'warmup' cannot exceed 'iter'")
    if skip is None:
        skip_bart = 1
        skip_stan = max(1, (2000 - warmup) // 1000)
    elif isinstance(skip, dict):
        skip_bart = int(skip.get("bart", 1))
        skip_stan = int(skip.get("stan", 1))
    elif isinstance(skip, (tuple, list)):
        skip_bart = int(skip[0])
        skip_stan = int(skip[1] if len(skip) > 1 else skip[0])
    else:
        skip_bart = skip_stan = int(skip)
    if dtype is None:
        dtype = torch.float32
    if dev.type == "cuda":
        check_kernel_dtype(dtype)

    if subset is not None:
        subset = np.asarray(subset)
        if subset.dtype == bool:
            subset = np.flatnonzero(subset)
        data = {k: v[subset] for k, v in _data_columns(data).items()}
        if weights is not None:
            weights = np.asarray(weights)[subset]
        if offset is not None:
            offset = np.asarray(offset)[subset]

    mf = build_model_frame(formula, data, weights=weights, offset=offset,
                           na_action=na_action)
    y = np.asarray(mf.y)
    if family is None:
        family = _detect_family(y)
    if family not in ("gaussian", "binomial"):
        raise ValueError("family must be gaussian or binomial")
    is_binary = family == "binomial"

    test_frame = None
    if treatment is not None:
        if test is not None:
            raise ValueError("cannot give both 'test' and 'treatment'")
        cols = _data_columns(data)
        z = np.asarray(cols[treatment], dtype=np.float64)
        if not np.all(np.isin(np.unique(z[~np.isnan(z)]), (0.0, 1.0))):
            raise ValueError("treatment variable must be binary/logical")
        flipped = 1.0 - z
        orig = cols[treatment]
        cols[treatment] = (flipped.astype(orig.dtype)
                           if orig.dtype.kind == "f" else flipped)
        test_frame = mf.build_test_frame(cols)
    elif test is not None:
        test_frame = mf.build_test_frame(test)
    if test_frame is not None and offset is not None:
        uo = np.asarray(offset, dtype=np.float64)
        if len(uo) == test_frame.n_original:
            extra = uo[np.asarray(test_frame.complete_rows)]
            test_frame.offset = (extra if test_frame.offset is None
                                 else test_frame.offset + extra)
        else:
            warnings.warn(
                "user 'offset' vector length does not match the test "
                "frame; the test predictions will omit it")
    if test_frame is not None and offset_test is not None:
        test_frame.offset = np.asarray(offset_test, dtype=np.float64)

    pm, resolved_stan_args, assemble_info = build_parametric_model(
        mf, family, stan_args, dtype=dtype, device=dev)
    bart_cfg, split_probs, keep_trees = _resolve_bart_args(bart_args,
                                                           is_binary)
    keep_trees = keep_trees or resolved_stan_args.keep_trees
    nuts_cfg = NutsConfig(
        max_treedepth=resolved_stan_args.max_treedepth,
        delta=resolved_stan_args.adapt_delta,
        gamma=resolved_stan_args.adapt_gamma,
        kappa=resolved_stan_args.adapt_kappa,
        t0=resolved_stan_args.adapt_t0,
        stepsize_jitter=resolved_stan_args.stepsize_jitter,
        freeze_rule=resolved_stan_args.freeze_rule,
        pooled=resolved_stan_args.pooled_adaptation,
        pooled_parts=resolved_stan_args.pooled_parts,
        pooled_between=resolved_stan_args.pooled_between,
    )
    bart_offset_init, sigma_init = _init_parametric_fit(mf, family)

    # everything GibbsProgram takes besides the model and the device, kept
    # in the fit so that Stan4bartFit.load can rebuild the program
    program_args = dict(
        bart_cfg=bart_cfg,
        split_probs=split_probs,
        bart_X_test=test_frame.bart_X if test_frame is not None else None,
        weights=mf.weights,
        user_offset=mf.offset,
        offset_type=offset_type,
        warmup=warmup, iterations=iterations,
        skip_stan=skip_stan, skip_bart=skip_bart,
        nuts_cfg=nuts_cfg,
        init_r=resolved_stan_args.init_r,
        adapt_init_buffer=resolved_stan_args.adapt_init_buffer,
        adapt_term_buffer=resolved_stan_args.adapt_term_buffer,
        adapt_base_window=resolved_stan_args.adapt_base_window,
        stepsize_init=resolved_stan_args.stepsize,
        sigma_gibbs=resolved_stan_args.sigma_gibbs,
        linear_gibbs=resolved_stan_args.linear_gibbs,
        level_gibbs=resolved_stan_args.level_gibbs,
        leaf_gibbs=resolved_stan_args.leaf_gibbs,
        leaf_block=resolved_stan_args.leaf_block,
        leaf_block_dim=resolved_stan_args.leaf_block_dim,
        # the obs-sharded driver requires the Gram-compressed likelihood
        # (GibbsProgram.local_view), so obs_shards turns the auto default
        # on; an explicit gram_lik=False fails there
        gram_lik=(True if resolved_stan_args.obs_shards >= 2
                  and resolved_stan_args.gram_lik is None
                  else resolved_stan_args.gram_lik),
        keep_trees=keep_trees,
        parametric_method="vi" if algorithm in ("vi", "advi") else "nuts",
        vi_method="adagrad" if algorithm == "advi" else "rmsprop",
        vi_family=(resolved_stan_args.vi_family if algorithm == "advi"
                   else "meanfield"),
        vi_steps=resolved_stan_args.vi_steps,
        vi_mc=resolved_stan_args.vi_mc,
        vi_eta=resolved_stan_args.vi_eta,
        dtype=dtype,
    )
    prog = GibbsProgram(pm, y=y, bart_X=mf.bart_X, device=dev,
                        **program_args)

    if verbose >= 1:
        _print_initial_summary(mf, family, bart_cfg, warmup, iterations,
                               chains, skip_bart, skip_stan,
                               resolved_stan_args, sigma_init)

    if seed is None and resolved_stan_args.seed is not None:
        seed = resolved_stan_args.seed
    if seed is None:
        if world_size > 1:
            raise ValueError(
                "a fit inside a torch.distributed world needs a 'seed' "
                "(every rank must draw the same chains' streams)")
        seed = np.random.SeedSequence().entropy % (2 ** 31)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    n_data = int(resolved_stan_args.obs_shards)

    # callback semantics (init.cpp:849-911; test-11-callback.R): the user
    # callback gets a NAMED view of one chain's draw; its results are
    # stored beside the raw draws, and with keep_fits=False ONLY the
    # callback results are stored.  keep_fits=False with no callback
    # stores nothing at all (the reference allocates no sample storage,
    # init.cpp:691-720): only the final sampler states survive.  Any
    # of these runs the per-chain GibbsProgram.step.
    if callback is not None:
        named = _per_chain_callback(callback, prog.stan_names(),
                                    test_frame is not None)
    if callback is not None and keep_fits:
        cb = lambda d: {"draw": d, "callback": named(d)}  # noqa: E731
    elif callback is not None:
        cb = named
    elif not keep_fits:
        cb = lambda d: None  # noqa: E731 — store nothing
    else:
        cb = None

    if refresh is None:
        refresh = max(iter // 10, 1)
    if verbose > 1:
        chunk_size = min(chunk_size or refresh, max(int(refresh), 1))

    t_start = time.perf_counter()
    run_kw = dict(chunk_size=chunk_size, bart_offset_init=bart_offset_init,
                  sigma_init=sigma_init, keep_warmup=True, verbose=verbose,
                  refresh=refresh, progress=_progress)
    if n_data >= 2:
        # the chains x data layout: every sufficient statistic is an
        # all-reduce over the rank's data group (parallel/mesh.py)
        if cb is not None:
            raise ValueError(
                "obs_shards does not compose with callback / "
                "keep_fits=False (the shard_map program stores full "
                "draws); run those on the default driver")
        if world_size % n_data != 0:
            raise ValueError(
                f"obs_shards ({n_data}) must divide the global device "
                f"count ({world_size})")
        # as the JAX package shrinks its chain mesh: the chain groups must
        # divide the chains; the ranks outside the layout sit out the run
        n_chain = max(world_size // n_data, 1)
        while chains % n_chain != 0:
            n_chain -= 1
        final_states, draws, run_info = mesh.run_chains_obs_sharded(
            prog, int(seed), chains, n_chain, n_data, **run_kw)
        gen.set_state(run_info.pop("rng_state"))
    elif world_size > 1:
        # the chains sharded over the ranks, draws gathered to every rank
        final_states, draws, run_info = multihost.run_chains_multihost(
            prog, int(seed), chains, callback=cb, **run_kw)
        gen.set_state(run_info.pop("rng_state"))
    else:
        final_states, draws, run_info = prog.run_chains_chunked(
            gen, chains, callback=cb, **run_kw)
    callback_draws = None
    if callback is not None and keep_fits:
        callback_draws = draws["callback"]
        draws = draws["draw"]
    timings = dict(
        total=time.perf_counter() - t_start,
        warmup=run_info["warmup_s"],
        sample=run_info["sample_s"],
        nuts_gibbs=run_info["nuts_gibbs"],
        sweep=run_info["sweep"],
        post=run_info["post"],
    )
    if world_size > 1:
        timings.update(run=run_info["run_s"], gather=run_info["gather_s"])
    if run_info["interrupted"]:
        timings["interrupted"] = True
        warmup = min(warmup, run_info["warmup_done"])

    fit = Stan4bartFit(
        mf=mf, pm=pm, prog=prog, family=family,
        draws=draws, warmup=warmup, chains=chains,
        stan_names=prog.stan_names(),
        test_frame=test_frame, treatment=treatment,
        final_states=final_states,
        R_inv=assemble_info.get("R_inv"),
        keep_fits=keep_fits,
        sigma_init=sigma_init,
        seed=int(seed),
        callback_draws=callback_draws,
        prior_info=assemble_info.get("prior_summary"),
        timings=timings,
        per_chain=cb is not None,
        # the generator after the run: continue_sampling draws on from it
        rng_state=gen.get_state(),
        stan_args=resolved_stan_args,
        program_args=program_args,
        run_info=run_info,
    )
    if verbose >= 0:
        fit.check_sampler_diagnostics()
    if algorithm == "vi":
        warnings.warn(
            "algorithm='vi' is a streaming variational approximation: "
            "point estimates track NUTS but the residual-sd (sigma) "
            "posterior is biased high (~1.8x measured) — do not report "
            "sigma or interval widths from this fit; use "
            "algorithm='nuts' for inference",
            stacklevel=2,
        )
    return fit
