"""The coupled BART + NUTS Gibbs sampler over a batch of chains.

Counterpart of ``stan4bart_tpu/gibbs.py`` on its single-device paths:
``GibbsProgram.step_batched`` (the main path) and the per-chain
``GibbsProgram.step`` (fits with a callback or ``keep_fits=False``), both
driven by ``run_chains_chunked``.  Every state tensor carries the chain as
its leading dimension; one iteration advances all chains:

1. ``skip_stan`` NUTS transitions over the parametric posterior given the
   current BART fit as offset (Gram-anchored likelihood), with Stan's
   windowed adaptation during warmup; or, with ``parametric_method="vi"``,
   a few stochastic-gradient steps of a variational approximation q of
   that conditional (warm-started across iterations) and one draw from q;
2. optionally an exact slice-sampling draw of sigma from its full
   conditional (``sigma_gibbs``, gaussian only);
3. the exact conjugate refresh of the linear block (``linear_gibbs``);
4. parametric mean -> BART offset, sigma handoff, and the warmup leaf-scale
   rescale schedule ``1 << (8 it / warmup)``;
5. ``skip_bart`` BART sweeps over all chains in one call of the sweep
   kernel (probit: truncated-normal latents first): for ``step_batched``
   the single-pass kernel, the obs-tiled one past n = 10368; for ``step``
   the per-chain kernel, the obs-tiled one past n = 51840; with
   ``p_regrow`` each tree's move followed by a subtree-regrow move inside
   the kernel; each sweep optionally followed by random subtree regrows
   (``regrow_per_sweep``);
6. optionally ``leaf_gibbs`` conjugate draws of the leaf values along
   random Walsh directions, and every ``leaf_block`` iterations the joint
   draw of every leaf value of every tree;
7. the additive-level interweave between the trees and the random-effect
   intercepts (``level_gibbs``);
8. BART fit -> Stan offset, and the draw row: 7 NUTS diagnostics then the
   constrained parameters, the train/test BART fits, varcount and k, and
   with ``keep_trees`` the swept forest.

A user offset enters steps 3 and 6 by ``offset_type``: added to the
whole mean (default), or replacing the fixed effects, the random
effects, the BART fit or the whole parametric mean.

All randomness comes from one ``torch.Generator`` on the program's device,
passed in explicitly.  ``continue_chunked`` resumes the sampling phase
from a final state.  ``local_view`` is the program on one shard of the
observations, whose sufficient statistics are all-reduced over a data
group of ranks (parallel/mesh.py).
"""

from __future__ import annotations

import math
import time
import warnings
from typing import NamedTuple

import numpy as np
import torch

from stan4bart_torch.models.parametric import ParametricModel
from stan4bart_torch.ops import bart as bart_ops
from stan4bart_torch.ops.bart import BartConfig, BartState
from stan4bart_torch.ops.bart_sweep_kernel import (
    MAX_N_CHAIN,
    MAX_NPAD,
    NODE_PAD,
    bart_sweep_fused,
    bart_sweep_fused_batch,
    bart_sweep_fused_batch_tiled,
    bart_sweep_fused_sharded,
    make_sweep_consts,
    on_chip_ceilings,
)
from stan4bart_torch.ops.nuts import (
    NutsConfig,
    NutsInfo,
    NutsState,
    init_stepsize,
    make_adapt_schedule,
    nuts_init,
    nuts_transition,
)
from stan4bart_torch.utils.device import resolve_device

OFFSET_TYPES = ("default", "fixef", "ranef", "bart", "parametric")
GRAM_MAX_D = 1024
LINEAR_GIBBS_MAX_D = 512


class ViState(NamedTuple):
    """The streaming variational state of VI-within-Gibbs, per chain: the
    mean, the log-sds, the optimizer's second-moment accumulator, the
    step count and, fullrank only, the strict lower triangle of the
    factor L = diag(exp(omega)) + strict_tril(L_off).  Under NUTS every
    field has zero width."""

    mu: torch.Tensor       # (C, P), or (C, 0)
    omega: torch.Tensor    # (C, P), or (C, 0)
    acc: torch.Tensor      # (C, 2P [+ P*P fullrank]), or (C, 0)
    count: torch.Tensor    # (C,)
    L_off: torch.Tensor    # (C, P, P) fullrank, else (C, 0, 0)


class GibbsState(NamedTuple):
    nuts: NutsState
    bart: BartState
    bart_offset: torch.Tensor   # (C, N) parametric mean fed to BART
    stan_offset: torch.Tensor   # (C, N) BART fit fed to Stan
    latents: torch.Tensor       # (C, N) probit latent response (0 o.w.)
    vi: ViState


class GibbsDraw(NamedTuple):
    stan: torch.Tensor          # (C, 7 + n_constrained)
    bart_train: torch.Tensor    # (C, N) pure f(x), no offset
    bart_test: torch.Tensor     # (C, N_test)
    varcount: torch.Tensor      # (C, P_bart) int32
    k: torch.Tensor             # (C,)
    # the swept forest, (C, T, M) each, with keep_trees; None otherwise
    tree_feature: torch.Tensor | None = None
    tree_cut: torch.Tensor | None = None
    tree_leaf_value: torch.Tensor | None = None


def tree_map(fn, *trees):
    """``fn`` over the leaves of same-structured dicts, tuples, lists and
    NamedTuples; None stays None."""
    t = trees[0]
    if t is None:
        return None
    if isinstance(t, dict):
        return {k: tree_map(fn, *(x[k] for x in trees)) for k in t}
    if isinstance(t, (tuple, list)):
        items = [tree_map(fn, *xs) for xs in zip(*trees)]
        return type(t)(*items) if hasattr(t, "_fields") else type(t)(items)
    return fn(*trees)


class GibbsProgram:
    """Static and iteration-constant data of one model on one device; all
    sampler state lives in GibbsState.

    ``y`` is the response of every chain, (N,), or one response per chain,
    (C, N), for C chains each fitting its own data set over the same
    design (simulation-based calibration, ``utils/sbc.py``)."""

    def __init__(
        self,
        pm: ParametricModel,
        bart_cfg: BartConfig,
        y: np.ndarray,
        bart_X: np.ndarray,
        split_probs: np.ndarray | None = None,
        bart_X_test: np.ndarray | None = None,
        weights: np.ndarray | None = None,
        user_offset: np.ndarray | None = None,
        offset_type: str = "default",
        warmup: int = 1000,
        iterations: int = 1000,
        skip_stan: int = 1,
        skip_bart: int = 1,
        nuts_cfg: NutsConfig = NutsConfig(),
        init_r: float = 2.0,
        adapt_init_buffer: int = 75,
        adapt_term_buffer: int = 50,
        adapt_base_window: int = 25,
        stepsize_init: float = 1.0,
        sigma_gibbs: bool = False,
        linear_gibbs: bool | None = None,
        level_gibbs: bool | None = None,
        leaf_gibbs: int = 0,
        leaf_block: int = 0,
        leaf_block_dim: int = 0,
        gram_lik: bool | None = None,
        keep_trees: bool = False,
        # "vi": the parametric block by VI-within-Gibbs in place of NUTS;
        # vi_method "rmsprop" (slow-decay, tracks the moving conditional:
        # algorithm="vi") or "adagrad" (stan::variational's rule:
        # algorithm="advi"), on a "meanfield" or "fullrank" q
        parametric_method: str = "nuts",
        vi_method: str = "rmsprop",
        vi_family: str = "meanfield",
        vi_steps: int = 5,
        vi_mc: int = 4,
        vi_eta: float = 0.5,
        dtype=torch.float32,
        device="cuda",
    ):
        if offset_type not in OFFSET_TYPES:
            raise ValueError(f"offset_type must be one of {OFFSET_TYPES}")
        if parametric_method not in ("nuts", "vi"):
            raise ValueError("parametric_method must be 'nuts' or 'vi'")
        if vi_method not in ("rmsprop", "adagrad"):
            raise ValueError("vi_method must be 'rmsprop' or 'adagrad'")
        if vi_family not in ("meanfield", "fullrank"):
            raise ValueError("vi_family must be 'meanfield' or 'fullrank'")
        self.parametric_method = parametric_method
        self.vi_method = vi_method
        self.vi_family = vi_family
        self.vi_steps = int(vi_steps)
        self.vi_mc = int(vi_mc)
        self.vi_eta = float(vi_eta)
        self.offset_type = offset_type
        self.keep_trees = bool(keep_trees)
        self.pm = pm
        self.bart_cfg = bart_cfg
        self.dtype = dtype
        self.device = resolve_device(device)
        self.is_binary = pm.cfg.is_binary
        self.N = np.shape(y)[-1]
        self.y = self._t(y)
        self.warmup = int(warmup)
        self.iterations = int(iterations)
        self.skip_stan = int(skip_stan)
        self.skip_bart = int(skip_bart)
        self.nuts_cfg = nuts_cfg
        self.init_r = float(init_r)
        self.stepsize_init = float(stepsize_init)

        bart_X = np.asarray(bart_X)
        self.cuts = bart_ops.make_cut_grid(bart_X, bart_cfg.n_cuts)
        ranks = bart_ops.compute_ranks(bart_X, self.cuts)
        self.ranks = torch.as_tensor(ranks, device=self.device)
        self.has_test = bart_X_test is not None
        if self.has_test:
            self.ranks_test = torch.as_tensor(
                bart_ops.compute_ranks(np.asarray(bart_X_test), self.cuts),
                device=self.device)
            self.n_test = bart_X_test.shape[0]
        else:
            self.n_test = 1
        P = bart_X.shape[1]
        self.split_probs = np.asarray(
            split_probs if split_probs is not None else np.full(P, 1.0 / P),
            dtype=np.float64)
        self.user_offset = (self._t(user_offset)
                            if user_offset is not None else None)
        self.weights = (self._t(weights)
                        if weights is not None and len(np.asarray(weights))
                        else None)
        self.sweep_consts = make_sweep_consts(
            bart_cfg, ranks, self.split_probs, device=self.device,
            dtype=dtype)
        # the obs-tiled sweep kernel past the single-pass kernel's shared
        # memory, and the per-chain step's kernel up to its ceiling: at
        # depth <= 6 the JAX package's boundaries (npad 10368 and 51840,
        # which hold on chip in float32 and float64), deeper what the build
        # for the heap and dtype holds on chip (``on_chip_ceilings``)
        pad = self.sweep_consts.node_pad
        single, chain = ((MAX_NPAD, MAX_N_CHAIN) if pad == NODE_PAD
                         else on_chip_ceilings(pad, bart_cfg.num_trees,
                                               dtype))
        self.sweep_tiled = self.sweep_consts.npad > single
        self.sweep_single_ok = self.sweep_consts.npad <= chain

        D = pm.cfg.K + pm.cfg.q
        if gram_lik is None:
            gram_lik = 0 < D <= GRAM_MAX_D
        self.use_gram = bool(gram_lik) and pm.enable_gram()

        # interweaving pair: linear_gibbs + level_gibbs, auto-on together
        lg_elig = 0 < D <= LINEAR_GIBBS_MAX_D and pm.enable_linear_gibbs()
        terms = []
        for ti, ((lhs, _), pi) in enumerate(zip(pm.z_structs, pm.cfg.p)):
            lhs_np = lhs.double().cpu().numpy()
            for j in range(pi):
                if np.allclose(lhs_np[:, j], 1.0):
                    terms.append((ti, j))
                    break
        # the level interweave moves the parametric mean's intercepts,
        # which a non-default offset_type replaces or decouples
        lvl_elig = offset_type == "default" and bool(terms)
        if linear_gibbs is None and level_gibbs is None:
            lg_on = lvl_on = lg_elig and lvl_elig
        else:
            lg_on = bool((linear_gibbs is True and lg_elig)
                         or (linear_gibbs is None and lg_elig
                             and level_gibbs is True and lvl_elig))
            lvl_on = bool((level_gibbs is True and lvl_elig)
                          or (level_gibbs is None and lvl_elig and lg_on))
        if linear_gibbs is True and not lg_elig:
            warnings.warn(
                "linear_gibbs requested but the model is ineligible "
                "(needs normal/flat beta priors and "
                f"D <= {LINEAR_GIBBS_MAX_D}); running without it")
        if level_gibbs is True and not lvl_elig:
            warnings.warn(
                "level_gibbs requested but the model is ineligible (needs "
                "a random-effect intercept term and the default "
                "offset_type); running without it")
        self.linear_gibbs = lg_on
        self.level_gibbs = lvl_on
        self._level_terms = terms
        # the optional exact Gibbs steps; sigma is fixed at 1 for probit
        self.sigma_gibbs = bool(sigma_gibbs) and not self.is_binary
        self.leaf_gibbs = int(leaf_gibbs)
        self.leaf_block = int(leaf_block)
        T_, M_ = bart_cfg.num_trees, bart_cfg.max_nodes
        if leaf_block_dim:
            self.leaf_block_dim = min(int(leaf_block_dim), T_ * M_)
        else:
            # about 8 active leaves per tree of headroom (about 2-3 at
            # the CGM prior's equilibrium), in whole 128s
            self.leaf_block_dim = min(-(-8 * T_ // 128) * 128, T_ * M_)

        sched = make_adapt_schedule(
            self.warmup * self.skip_stan,
            init_buffer=int(adapt_init_buffer),
            term_buffer=int(adapt_term_buffer),
            base_window=int(adapt_base_window))
        self.sched = (sched["adapt_stepsize"], sched["collect"],
                      sched["window_end"])
        self.n_sched = len(sched["adapt_stepsize"])
        it = np.arange(max(self.warmup, 1))
        mod = 1 << (8 * it // max(self.warmup, 1))
        self.rescale_sched = (it % mod) == 0
        # wall-clock seconds per phase of step / step_batched, summed over
        # calls
        self.phase_s = {"nuts_gibbs": 0.0, "sweep": 0.0, "post": 0.0}
        # the observation axis of a shard's view (local_view): the data
        # group's all-reduces, the global and padded row counts and this
        # shard's first row; None on the whole data
        self.obs_axis = None
        self.N_global = self.N_global_pad = self.N
        self.obs_start = 0
        # pooled adaptation over the chains of every rank
        # (parallel/multihost.ChainPool); None pools this program's chains
        self.chain_pool = None

    def _t(self, x):
        return torch.as_tensor(np.asarray(x, dtype=np.float64),
                               dtype=self.dtype, device=self.device)

    def _mark(self, key, t0):
        """Add the seconds since t0 to phase ``key``; returns now."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        self.phase_s[key] += now - t0
        return now

    # ------------------------------------------------------------------

    def _bart_offset_from_draw(self, c, tp):
        """Parametric mean with the offset_type substitution, (C, N)."""
        pm, ot, uo = self.pm, self.offset_type, self.user_offset
        if uo is None or ot == "bart":
            return pm.parametric_mean(c, tp)
        if ot == "default":
            return pm.parametric_mean(c, tp) + uo
        if ot == "ranef":      # the user offset replaces Z b
            return pm.parametric_mean(c, tp, include_random=False) + uo
        if ot == "fixef":      # the user offset replaces X beta
            return pm.parametric_mean(c, tp, include_fixed=False) + uo
        # parametric: the user offset replaces the whole mean; a view, and
        # nothing writes into the offsets in place
        return uo.expand(tp["aux"].shape[0], self.N)

    def _stan_offset_from_fit(self, bart_fit):
        """BART fit -> Stan offset with the offset_type semantics."""
        ot, uo = self.offset_type, self.user_offset
        if uo is None:
            return bart_fit
        if ot == "bart":       # the user offset replaces the BART fit
            return uo.expand(bart_fit.shape)
        if ot == "default":
            return bart_fit + uo
        return bart_fit

    def _sigma_mu(self, bart_offset, k):
        """Leaf-prior sd in original units, per chain (C,)."""
        cfg = self.bart_cfg
        if cfg.sigma_mu_fixed is not None:
            return torch.full_like(k, cfg.sigma_mu_fixed)
        if self.is_binary:
            rng_scale = torch.ones_like(k)
        else:
            resp = self.y - bart_offset
            if self.obs_axis is None:
                rng_scale = resp.amax(-1) - resp.amin(-1)
            else:
                # the global range, by one all-reduce of (max, -min)
                m = self.obs_axis.max(torch.stack([resp.amax(-1),
                                                   -resp.amin(-1)]))
                rng_scale = m[0] + m[1]
        return cfg.node_scale * rng_scale / (k * math.sqrt(cfg.num_trees))

    def _probit_latents(self, mean, gen):
        """Truncated-normal probit latents of every chain.  A shard's view
        draws the uniforms of the global (padded) rows and takes its own,
        so every observation sees the variate it sees unsharded (with no
        padding) whatever the shard count."""
        if self.obs_axis is None:
            return bart_ops.sample_probit_latents(mean, self.y, gen)
        u = torch.rand((mean.shape[0], self.N_global_pad), generator=gen,
                       dtype=mean.dtype, device=mean.device)
        u = 1e-7 + u[:, self.obs_start: self.obs_start + self.N] \
            * (1.0 - 2e-7)
        return bart_ops.sample_probit_latents(mean, self.y, u=u)

    def _sweep(self, bart_state, y_target, sigma, gen, per_chain):
        """One sweep of every chain.  ``step_batched`` (not per_chain)
        takes the single-pass kernel, the obs-tiled one past npad 10368;
        ``step`` (per_chain) the per-chain kernel up to npad 51840 (past
        max_depth 6 the deep and heap builds' own ceilings).  Past
        that the JAX package's ``step`` runs its XLA sweep; the port must
        not run its plain sweep on the card, so it takes the obs-tiled
        kernel, which computes the same function.  The three kernels run
        one on-chip sweep in clusters of K blocks per chain and give
        bit-identical forests at equal K (a change of route, not of
        result).  A shard's view (``local_view``) runs the
        observation-sharded sweep, ``csrc/bart_sweep_sharded.cu`` on the
        card, with one all-reduce over the data group per tree update."""
        if self.obs_axis is not None:
            return bart_sweep_fused_sharded(
                self.bart_cfg, bart_state, y_target, self.sweep_consts,
                sigma, gen, weights=self.weights, reduce=self.obs_axis.sum)
        if per_chain and self.sweep_single_ok:
            sweep = bart_sweep_fused
        elif per_chain or self.sweep_tiled:
            sweep = bart_sweep_fused_batch_tiled
        else:
            sweep = bart_sweep_fused_batch
        return sweep(self.bart_cfg, bart_state, y_target, self.sweep_consts,
                     sigma, gen, weights=self.weights)

    def _regrow(self, bart_state, y_target, sigma, gen):
        """``regrow_per_sweep`` subtree regrows of every chain after the
        sweep kernel (the JAX package's ``_maybe_regrow``: with a sampled
        k, the kernel's k draw lands before them), and the new
        varcount."""
        bart_state = bart_ops.regrow_refresh(
            self.bart_cfg, bart_state, y_target, self.ranks,
            self.split_probs, sigma, gen, weights=self.weights,
            reduce=None if self.obs_axis is None else self.obs_axis.sum)
        return bart_state, bart_ops.count_variable_use(
            bart_state.feature, self.ranks.shape[1])

    def _logp(self, q_anchor, stan_offset, y_stan, reps: int = 1):
        """The per-chain log-density NUTS runs on this iteration.  With
        ``reps`` > 1 it takes ``reps`` points of each chain, chain-major
        ((C * reps, D) rows, row c * reps + m of chain c), each against
        its own chain's anchor or offset."""
        pm = self.pm
        if self.use_gram:
            anchor = pm.gram_anchor(q_anchor, stan_offset, y_stan)
            if reps > 1:
                anchor = tuple(a.repeat_interleave(reps, 0) for a in anchor)
            return pm.gram_logp(anchor)
        if reps > 1:
            stan_offset = stan_offset.repeat_interleave(reps, 0)
            if y_stan.dim() == 2:
                y_stan = y_stan.repeat_interleave(reps, 0)
        return lambda u: pm.log_prob(u, stan_offset, y_stan)

    # ------------------------------------------------------------------

    @torch.no_grad()
    def init_state(self, gen, n_chains: int, bart_offset_init=None,
                   sigma_init=1.0, per_chain: bool = False) -> GibbsState:
        """Prior-drawn tree structures, one BART sweep (and its regrows)
        to seed the Stan offset (through ``step``'s sweep when
        ``per_chain``), probit latents from that forest, uniform(-init_r,
        init_r) parametric starts and Stan's initial stepsize search."""
        pm, cfg = self.pm, self.bart_cfg
        C, N, dev, dt = n_chains, self.N, self.device, self.dtype
        if self.y.dim() == 2 and self.y.shape[0] != C:
            raise ValueError(f"a per-chain y of {self.y.shape[0]} rows "
                             f"cannot start {C} chains")
        q0 = (torch.rand((C, pm.num_upars), generator=gen, dtype=dt,
                         device=dev) * 2.0 - 1.0) * self.init_r
        bart_offset = (self._t(bart_offset_init).expand(C, N).clone()
                       if bart_offset_init is not None
                       else torch.zeros((C, N), dtype=dt, device=dev))
        bart_state = bart_ops.sample_trees_from_prior(
            cfg, gen, self.ranks, self.split_probs, C, dtype=dt)
        bart_state = bart_state._replace(
            sigma_mu=self._sigma_mu(bart_offset, bart_state.k))
        if self.is_binary:
            latents = self._probit_latents(bart_state.allfit + bart_offset,
                                           gen)
            y_target = latents - bart_offset
            sigma = torch.ones(C, dtype=dt, device=dev)
        else:
            latents = torch.zeros((C, N), dtype=dt, device=dev)
            y_target = self.y - bart_offset
            sigma = torch.full((C,), float(sigma_init), dtype=dt, device=dev)
        bart_state, _ = self._sweep(bart_state, y_target, sigma, gen,
                                    per_chain)
        if cfg.regrow_per_sweep > 0:
            # the JAX package's init sweep runs its regrows in-line
            bart_state, _ = self._regrow(bart_state, y_target, sigma, gen)
        stan_offset = self._stan_offset_from_fit(bart_state.allfit)

        nuts = nuts_init(q0, stepsize=self.stepsize_init)
        y_stan = latents if self.is_binary else self.y
        if self.obs_axis is None:
            if self.is_binary:
                inv_mass0 = pm.initial_inv_mass(1.0, N)
            else:
                # from each chain's own y where it has one
                ys = self.y.double().cpu().numpy()
                inv_mass0 = (
                    pm.initial_inv_mass(float(np.std(ys, ddof=1)), N)
                    if ys.ndim == 1 else np.stack([
                        pm.initial_inv_mass(float(np.std(y, ddof=1)), N)
                        for y in ys]))
            logp = lambda u: pm.log_prob(u, stan_offset, y_stan)  # noqa: E731
        else:
            # a shard's view carries the global heuristics, and its
            # stepsize search differentiates the Gram form anchored at q0
            # (no gradient crosses the all-reduce)
            inv_mass0 = self._inv_mass0_global
            logp = self._logp(q0, stan_offset, y_stan)
        inv_mass0 = torch.as_tensor(np.asarray(inv_mass0), dtype=dt,
                                    device=dev).expand(C, -1)
        nuts = nuts._replace(inv_mass=inv_mass0.clone())
        eps = init_stepsize(logp, q0, nuts.inv_mass, self.stepsize_init, gen)
        nuts = nuts._replace(da=nuts.da._replace(
            log_eps=torch.log(eps), mu=torch.log(10.0 * eps)))
        if self.parametric_method == "vi":
            # q starts at the chain's start with the initial metric's sds
            P, fullrank = pm.num_upars, self.vi_family == "fullrank"
            vi = ViState(
                mu=q0.clone(), omega=0.5 * torch.log(inv_mass0),
                acc=q0.new_zeros((C, 2 * P + (P * P if fullrank else 0))),
                count=q0.new_zeros(C),
                L_off=q0.new_zeros((C,) + ((P, P) if fullrank else (0, 0))))
        else:
            vi = ViState(q0.new_zeros((C, 0)), q0.new_zeros((C, 0)),
                         q0.new_zeros((C, 0)), q0.new_zeros(C),
                         q0.new_zeros((C, 0, 0)))
        return GibbsState(nuts=nuts, bart=bart_state,
                          bart_offset=bart_offset, stan_offset=stan_offset,
                          latents=latents, vi=vi)

    # ------------------------------------------------------------------

    def _sigma_gibbs_update(self, q, stan_offset, y_stan, gen,
                            variates=None):
        """An exact draw of the unconstrained aux (sigma) coordinate of
        every chain from its full conditional, by Neal's slice sampler
        (step-out of width 0.5, at most 16 steps out and 32 shrinks),
        through the full ``log_prob``: under decov sigma scales theta_L,
        so b moves with it in the non-centered model.  The chains step
        together under masks, with one host check per step.

        variates: optional ``(u_h (C,), u_w (C,), u_shrink (C, 32))``
        uniforms (slice height, interval placement, shrink proposals)
        replacing the draw from ``gen``.  Returns the updated q."""
        pm = self.pm
        off = pm.layout.slices["aux_unscaled"][0]
        C = q.shape[0]
        if variates is None:
            u = torch.rand((C, 34), generator=gen, dtype=q.dtype,
                           device=q.device)
            variates = (u[:, 0], u[:, 1], u[:, 2:])
        u_h, u_w, u_shrink = variates

        def logpost(x):
            """log_prob at aux coordinates x (reps C,), chain-major in
            blocks of C; it carries the positivity Jacobian, so slicing in
            the unconstrained coordinate is exact."""
            reps = x.shape[0] // C
            qx = q.repeat(reps, 1)
            qx[:, off] = x
            if reps == 1:
                return pm.log_prob(qx, stan_offset, y_stan)
            return pm.log_prob(qx, stan_offset.repeat(reps, 1),
                               y_stan.repeat(reps, 1) if y_stan.dim() == 2
                               else y_stan)

        x0 = q[:, off]
        log_y = logpost(x0) + torch.log(u_h)
        w = 0.5
        L, R = x0 - w * u_w, x0 + w * (1.0 - u_w)
        for _ in range(16):
            above = logpost(torch.cat([L, R])) > log_y.repeat(2)
            up_L, up_R = above[:C], above[C:]
            if not bool((up_L | up_R).any()):
                break
            L = torch.where(up_L, L - w, L)
            R = torch.where(up_R, R + w, R)
        x = x0
        done = torch.zeros_like(x0, dtype=torch.bool)
        for j in range(32):
            x_prop = L + u_shrink[:, j] * (R - L)
            ok = ~done & (logpost(x_prop) > log_y)
            miss = ~done & ~ok
            x = torch.where(ok, x_prop, x)
            L = torch.where(miss & (x_prop < x0), x_prop, L)
            R = torch.where(miss & (x_prop >= x0), x_prop, R)
            done = done | ok
            if bool(done.all()):
                break
        q = q.clone()
        q[:, off] = x
        return q

    @staticmethod
    def _walsh_signs(x, mask, dtype):
        """d = +-1 from the parity of ``popcount(x & mask)``: the
        Walsh-Hadamard sign pattern indexed by ``mask``, elementwise."""
        v = x & mask
        v = v ^ (v >> 16)
        v = v ^ (v >> 8)
        v = v ^ (v >> 4)
        v = v ^ (v >> 2)
        v = v ^ (v >> 1)
        return (1 - 2 * (v & 1)).to(dtype)

    def _leaf_gibbs_update(self, bart_state, bart_offset, latents, sigma,
                           gen, masks=None, z=None):
        """One exact conjugate draw per chain of per-tree leaf shifts
        along random Walsh directions,

            leaf_value[t, leaf] += c_t d_t[leaf],
            d_t[node] = Walsh(node, m_t),  m_t ~ U{1 .. 2^bits(M) - 1}:

        restricted to this rank-T subspace the conditional of c is
        Gaussian, with likelihood precision V V' / sigma^2 (V[t] =
        d_t[leaf_idx[t]], +-1, so the Gram matrix is exact) and leaf-prior
        precision diag(L_t) / sigma_mu^2.  masks (C, T) and z (C, T)
        optional, replacing the draws from ``gen``.  The new tree fits are
        gathered from the new leaf values."""
        cfg = self.bart_cfg
        T, M = cfg.num_trees, cfg.max_nodes
        C = bart_state.feature.shape[0]
        dt, dev = self.dtype, self.device
        y_stan = latents if self.is_binary else self.y
        r = y_stan - bart_state.allfit - bart_offset
        inv_s2 = 1.0 / (sigma * sigma)
        inv_smu2 = 1.0 / (bart_state.sigma_mu * bart_state.sigma_mu)
        if masks is None:
            nbits = max(int(M).bit_length(), 1)
            masks = torch.randint(1, 2 ** nbits, (C, T), generator=gen,
                                  device=dev)
        if z is None:
            z = torch.randn((C, T), generator=gen, dtype=dt, device=dev)
        node_ids = torch.arange(M, device=dev)
        leaf_mask = bart_state.feature == bart_ops.LEAF
        d_leaf = torch.where(
            leaf_mask,
            self._walsh_signs(node_ids, masks.long()[..., None], dt), 0.0)
        # every observation lands in a leaf: V = d_leaf[leaf_idx]
        lidx = bart_state.leaf_idx.long()
        V = torch.gather(d_leaf, 2, lidx)                      # (C, T, N)
        if self.weights is not None:
            G = torch.bmm(V * self.weights, V.transpose(1, 2))
            h_lik = torch.bmm(V, (self.weights * r)[..., None])[..., 0]
        else:
            G = torch.bmm(V, V.transpose(1, 2))
            h_lik = torch.bmm(V, r[..., None])[..., 0]
        del V
        G, h_lik = self.pm._psum(G, h_lik)
        h_lik = h_lik * inv_s2[:, None]
        L_t = leaf_mask.sum(-1).to(dt)
        h = h_lik - (d_leaf * bart_state.leaf_value).sum(-1) \
            * inv_smu2[:, None]
        Pm = G * inv_s2[:, None, None] + torch.diag_embed(
            L_t * inv_smu2[:, None])
        Lm, info = torch.linalg.cholesky_ex(Pm)
        mean = torch.cholesky_solve(h[..., None], Lm)[..., 0]
        c = mean + torch.linalg.solve_triangular(
            Lm.transpose(-1, -2), z.to(dt)[..., None], upper=True)[..., 0]
        # a chain whose precision does not factor keeps its leaves (the
        # factorization depends on the structures and sigma alone)
        c = torch.where((info == 0)[:, None], c, 0.0)
        leaf_value = bart_state.leaf_value + c[..., None] * d_leaf
        tree_fit = torch.gather(leaf_value, 2, lidx)
        return bart_state._replace(leaf_value=leaf_value, tree_fit=tree_fit,
                                   allfit=tree_fit.sum(1))

    def _leaf_block_update(self, bart_state, bart_offset, latents, sigma,
                           gen, z=None):
        """The joint draw of every leaf value of every tree per chain from
        its Gaussian conditional given the structures,

            mu ~ N(P^-1 h, P^-1),  P = W' diag(w) W / sigma^2
            + I / sigma_mu^2,  h = W' (w r) / sigma^2,  r = y - offset,

        W the (N, D) membership matrix of the active leaves, ranked into
        [0, D) tree by tree (D = ``leaf_block_dim``).  W is written tree
        by tree as exact ones and every sum is a matrix product, so the
        draw sums in a fixed order.  A chain whose active leaves exceed D,
        or whose precision does not factor, keeps its leaves (a choice by
        the structures and sigma, which the draw leaves alone, among
        invariant kernels).  z (C, D) optional normals replacing the draw from
        ``gen``."""
        cfg = self.bart_cfg
        T, D = cfg.num_trees, self.leaf_block_dim
        C = bart_state.feature.shape[0]
        dt, dev = self.dtype, self.device
        y_stan = latents if self.is_binary else self.y
        r = y_stan - bart_offset
        inv_s2 = 1.0 / (sigma * sigma)
        inv_smu2 = 1.0 / (bart_state.sigma_mu * bart_state.sigma_mu)
        if z is None:
            z = torch.randn((C, D), generator=gen, dtype=dt, device=dev)

        leaf_mask = bart_state.feature == bart_ops.LEAF          # (C, T, M)
        L_t = leaf_mask.sum(-1)
        base_t = torch.cumsum(L_t, -1) - L_t
        within = torch.cumsum(leaf_mask.long(), -1) - 1
        # ranks past the cap (a chain that overflows) land in column D
        compact = torch.where(leaf_mask, base_t[..., None] + within,
                              D).clamp(max=D)
        ok = L_t.sum(-1) <= D                                   # (C,)

        lidx = bart_state.leaf_idx.long()
        W = torch.zeros((C, self.N, D + 1), dtype=dt, device=dev)
        for t in range(T):
            comp_t = torch.gather(compact[:, t], 1, lidx[:, t])  # (C, N)
            W.scatter_(2, comp_t[..., None], 1.0)
        W = W[..., :D]
        Wt = W.transpose(1, 2)
        if self.weights is not None:
            G = torch.bmm(Wt * self.weights, W)
            h = torch.bmm(Wt, (self.weights * r)[..., None])[..., 0]
        else:
            G = torch.bmm(Wt, W)
            h = torch.bmm(Wt, r[..., None])[..., 0]
        del W, Wt
        G, h = self.pm._psum(G, h)
        h = h * inv_s2[:, None]
        eye = torch.eye(D, dtype=dt, device=dev)
        Pm = G * inv_s2[:, None, None] + inv_smu2[:, None, None] * eye
        Lm, info = torch.linalg.cholesky_ex(Pm)
        ok = ok & (info == 0)
        mean = torch.cholesky_solve(h[..., None], Lm)[..., 0]
        mu = mean + torch.linalg.solve_triangular(
            Lm.transpose(-1, -2), z.to(dt)[..., None], upper=True)[..., 0]
        mu_pad = torch.cat([mu, mu.new_zeros((C, 1))], -1)
        new_lv = torch.gather(mu_pad, 1, compact.reshape(C, -1)
                              ).reshape(compact.shape)
        okc = ok[:, None, None]
        leaf_value = torch.where(okc & leaf_mask, new_lv,
                                 bart_state.leaf_value)
        tree_fit = torch.where(okc, torch.gather(leaf_value, 2, lidx),
                               bart_state.tree_fit)
        allfit = torch.where(ok[:, None], tree_fit.sum(1),
                             bart_state.allfit)
        return bart_state._replace(leaf_value=leaf_value, tree_fit=tree_fit,
                                   allfit=allfit)

    def _level_gibbs_update(self, nuts, bart_state, bart_offset, latents,
                            gen, z=None):
        """One conjugate draw per chain of the additive-shift coordinates
        s = (c_1..c_T, a_i per intercept ranef term):

            leaf_value[t, leaves] += c_t   (=> f += sum c_t)
            b[term i, all levels, intercept col] += a_i

        The likelihood sees only the total shift (rank-one precision
        sum(w)/sigma^2), the leaf prior gives diag L_t/sigma_mu^2 and the
        ranef prior diag l_i Prec_i[j0, j0]; written back through
        z_b += a T^{-1} e_j0.  z: optional (C, dim) normals."""
        pm, cfg = self.pm, self.bart_cfg
        y_stan = latents if self.is_binary else self.y
        c, _ = pm.layout.constrain(nuts.q)
        C = nuts.q.shape[0]
        tp = pm.transformed(c, C)
        sigma = (torch.ones(C, dtype=self.dtype, device=self.device)
                 if self.is_binary else tp["aux"])
        inv_s2 = 1.0 / (sigma * sigma)

        r = y_stan - bart_state.allfit - bart_offset
        if self.weights is not None:
            sw, swr = self.pm._psum(self.weights.sum(),
                                    (self.weights * r).sum(-1))
        else:
            sw = float(self.N_global)
            swr = self.pm._psum(r.sum(-1))

        leaf_mask = (bart_state.feature == bart_ops.LEAF).to(self.dtype)
        L_t = leaf_mask.sum(-1)                                  # (C, T)
        S_t = (bart_state.leaf_value * leaf_mask).sum(-1)
        inv_smu2 = (1.0 / (bart_state.sigma_mu * bart_state.sigma_mu))
        diag = [L_t * inv_smu2[:, None]]
        lin = [-S_t * inv_smu2[:, None]]

        th, b = tp["theta_L"], tp["b"]
        th_offs, off = [], 0
        for nc in pm.cfg.p:
            th_offs.append(off)
            off += nc + (nc * (nc - 1)) // 2
        term_tinv = {}
        for ti, j0 in self._level_terms:
            nc, li = pm.cfg.p[ti], pm.cfg.l[ti]
            tm = th_offs[ti]
            b0 = pm.b_offsets[ti]
            if nc == 1:
                prec_jj = 1.0 / (th[:, tm] * th[:, tm])
                term_tinv[ti] = 1.0 / th[:, tm]
                diag.append((li * prec_jj)[:, None])
                lin.append((-(prec_jj * b[:, b0: b0 + li].sum(-1)))[:, None])
            else:
                rows, cols = [], []
                for ci in range(nc):
                    for ri in range(ci, nc):
                        rows.append(ri)
                        cols.append(ci)
                T = th.new_zeros((C, nc, nc))
                T[:, rows, cols] = th[:, tm: tm + len(rows)]
                eye = torch.eye(nc, dtype=self.dtype, device=self.device)
                Tinv = torch.linalg.solve_triangular(
                    T, eye.expand(C, nc, nc), upper=False)
                term_tinv[ti] = Tinv
                prec = Tinv.transpose(-1, -2) @ Tinv
                b_mat = b[:, b0: b0 + nc * li].reshape(C, li, nc)
                diag.append((li * prec[:, j0, j0])[:, None])
                lin.append(-(b_mat * prec[:, j0][:, None, :])
                           .sum((1, 2))[:, None])

        # the system in float64: a wide ranef prior's diagonal entry is
        # below float32 rounding of the rank-one likelihood block
        f64 = torch.float64
        d = torch.cat(diag, -1).to(f64)
        h = torch.cat(lin, -1).to(f64) + (swr * inv_s2).to(f64)[:, None]
        dim = d.shape[1]
        Mat = (sw * inv_s2).to(f64)[:, None, None] * torch.ones(
            (dim, dim), dtype=f64, device=self.device) + torch.diag_embed(d)
        Lm, info = torch.linalg.cholesky_ex(Mat)
        mean = torch.cholesky_solve(h[:, :, None], Lm)[..., 0]
        if z is None:
            z = torch.randn((C, dim), generator=gen, dtype=self.dtype,
                            device=self.device)
        s = (mean + torch.linalg.solve_triangular(
            Lm.transpose(-1, -2), z.to(f64)[:, :, None],
            upper=True)[..., 0]).to(self.dtype)

        T_trees = cfg.num_trees
        c_t = s[:, :T_trees]
        new_bart = bart_state._replace(
            leaf_value=bart_state.leaf_value + c_t[..., None] * leaf_mask,
            tree_fit=bart_state.tree_fit + c_t[..., None],
            allfit=bart_state.allfit + c_t.sum(-1, keepdim=True))
        q = nuts.q.clone()
        b_off0 = (pm.layout.slices["b_raw" if pm.cfg.centered else "z_b"][0]
                  if pm.cfg.q > 0 else 0)
        pos = T_trees
        for ti, j0 in self._level_terms:
            nc, li = pm.cfg.p[ti], pm.cfg.l[ti]
            start = b_off0 + pm.b_offsets[ti]
            if pm.cfg.centered:
                # b[level, j0] += a for every level
                idx = start + torch.arange(li, device=self.device) * nc + j0
                q[:, idx] += s[:, pos: pos + 1]
            elif nc == 1:
                q[:, start: start + li] += s[:, pos: pos + 1] \
                    * term_tinv[ti][:, None]
            else:
                w = term_tinv[ti][:, :, j0]                      # (C, nc)
                q[:, start: start + li * nc] += w.repeat(1, li) \
                    * s[:, pos: pos + 1]
            pos += 1
        # a chain whose precision does not factor, or whose draw is not
        # finite (a theta_L singular in float32, as linear_gibbs_refresh
        # says), keeps its state: the
        # choice depends on what this draw leaves alone (sigma, sigma_mu,
        # theta_L and the structures), so both branches keep the posterior
        ok = ((info == 0) & torch.isfinite(s).all(-1)
              & torch.isfinite(q).all(-1))
        q = torch.where(ok[:, None], q, nuts.q)
        bart_state = bart_state._replace(**{
            k: torch.where(ok.view((C,) + (1,) * (v.dim() - 1)),
                           getattr(new_bart, k), v)
            for k, v in (("leaf_value", bart_state.leaf_value),
                         ("tree_fit", bart_state.tree_fit),
                         ("allfit", bart_state.allfit))})
        return nuts._replace(q=q), bart_state

    def _vi_update(self, state: GibbsState, y_stan, gen, z=None,
                   z_draw=None):
        """VI-within-Gibbs on the current conditional posterior of every
        chain: ``vi_steps`` reparameterized stochastic-gradient steps on
        the negative ELBO of q, then one draw u from q, which becomes the
        chain's parametric state (the JAX package's ``_vi_update``).

        q is N(mu, diag(exp(2 omega))) (meanfield) or theta = mu + L z with
        L = diag(exp(omega)) + strict_tril(L_off) (fullrank, entropy
        sum(omega)).  Each step's ELBO averages ``vi_mc`` draws of each
        chain, all chains' draws in one batched log-density call.  The
        step is ``rate / (1 + sqrt(acc)) * g``, acc the running second
        moment of g (g * g at count 0, then 0.9 acc + 0.1 g * g), rate
        ``vi_eta (count + 1)^-1/2`` for adagrad or ``vi_eta (1 + 0.02
        count)^-1/2`` for rmsprop, count carried across iterations; the
        fullrank L_off steps are damped 5x, omega is kept in [-12, 4] and
        L_off in [-30, 30].

        z: optional (vi_steps, C, vi_mc, P) normals of the ELBO draws and
        z_draw (C, P) of the draw from q, replacing the draws from
        ``gen`` (drawn in that order).  Returns (nuts, info, vi): the
        NUTS state with q = u, the draw row's sampler columns (lp__ =
        logp(u), accept_stat__ 1, stepsize__ vi_eta, treedepth__ 0,
        n_leapfrog__ vi_steps * vi_mc, divergent__ 0, energy__ -lp) and
        the new ViState."""
        pm, vi = self.pm, state.vi
        P, M = pm.num_upars, self.vi_mc
        C = state.nuts.q.shape[0]
        dt, dev = self.dtype, self.device
        fullrank = self.vi_family == "fullrank"
        if z is None:
            z = torch.randn((self.vi_steps, C, M, P), generator=gen,
                            dtype=dt, device=dev)
        if z_draw is None:
            z_draw = torch.randn((C, P), generator=gen, dtype=dt, device=dev)
        logp = self._logp(state.nuts.q, state.stan_offset, y_stan)
        logp_mc = self._logp(state.nuts.q, state.stan_offset, y_stan,
                             reps=M)

        def q_sample(v, z):
            """Draws mu + L z of every chain, z (C, m, P) -> (C, m, P)."""
            th = v[:, None, :P] + z * torch.exp(v[:, None, P:2 * P])
            if fullrank:
                L = torch.tril(v[:, 2 * P:].reshape(C, P, P), -1)
                th = th + z @ L.transpose(1, 2)
            return th

        v = torch.cat([vi.mu, vi.omega]
                      + ([vi.L_off.reshape(C, P * P)] if fullrank else []),
                      -1)
        acc, cnt = vi.acc, vi.count
        for j in range(self.vi_steps):
            with torch.enable_grad():
                vg = v.detach().requires_grad_(True)
                lp = logp_mc(q_sample(vg, z[j]).reshape(C * M, P))
                neg_elbo = -(lp.reshape(C, M).mean(1)
                             + vg[:, P:2 * P].sum(1))
                (g,) = torch.autograd.grad(neg_elbo.sum(), vg)
            g = torch.where(torch.isfinite(g), g, 0.0)
            acc = torch.where((cnt == 0.0)[:, None], g * g,
                              0.9 * acc + 0.1 * g * g)
            if self.vi_method == "adagrad":
                rate = self.vi_eta * (cnt + 1.0) ** -0.5
            else:
                rate = self.vi_eta * (1.0 + 0.02 * cnt) ** -0.5
            step = rate[:, None] / (1.0 + torch.sqrt(acc)) * g
            if fullrank:
                step[:, 2 * P:] *= 0.2
            v = v - step
            v[:, P:2 * P] = v[:, P:2 * P].clamp(-12.0, 4.0)
            if fullrank:
                v[:, 2 * P:] = v[:, 2 * P:].clamp(-30.0, 30.0)
            cnt = cnt + 1.0
        u = q_sample(v, z_draw[:, None])[:, 0]
        lp_u = logp(u)
        one = torch.ones_like(lp_u)
        info = NutsInfo(lp=lp_u, accept_stat=one, stepsize=one * self.vi_eta,
                        treedepth=torch.zeros_like(lp_u),
                        n_leapfrog=one * float(self.vi_steps * M),
                        divergent=torch.zeros_like(lp_u), energy=-lp_u)
        L_off = (v[:, 2 * P:].reshape(C, P, P) if fullrank
                 else vi.L_off)
        return (state.nuts._replace(q=u), info,
                ViState(mu=v[:, :P], omega=v[:, P:2 * P], acc=acc,
                        count=cnt, L_off=L_off))

    def _pre_sweep(self, state: GibbsState, it, is_warmup: bool, gen):
        """NUTS transition(s) or the VI update, the sigma slice draw, the
        linear-block refresh, parametric mean -> BART offset and the
        warmup leaf-scale rescale."""
        pm = self.pm
        y_stan = state.latents if self.is_binary else self.y
        logp = self._logp(state.nuts.q, state.stan_offset, y_stan)
        nuts, vi = state.nuts, state.vi
        if self.parametric_method == "vi":
            # one update per iteration whatever skip_stan, as in the JAX
            # package
            nuts, info, vi = self._vi_update(state, y_stan, gen)
        else:
            for j in range(self.skip_stan):
                if is_warmup:
                    tr = min(it * self.skip_stan + j, self.n_sched - 1)
                    flags = tuple(bool(s[tr]) for s in self.sched)
                else:
                    flags = (False, False, False)
                nuts, info = nuts_transition(logp, nuts, gen,
                                             self.nuts_cfg, *flags,
                                             pool=self.chain_pool)
        if self.sigma_gibbs:
            nuts = nuts._replace(q=self._sigma_gibbs_update(
                nuts.q, state.stan_offset, y_stan, gen))
        if self.linear_gibbs:
            q_lg = pm.linear_gibbs_refresh(nuts.q, state.stan_offset,
                                           y_stan, gen)
            nuts = nuts._replace(q=q_lg)
            info = info._replace(lp=logp(q_lg))

        c, _ = pm.layout.constrain(nuts.q)
        tp = pm.transformed(c, nuts.q.shape[0])
        bart_offset = self._bart_offset_from_draw(c, tp)
        sigma = torch.ones_like(tp["aux"]) if self.is_binary else tp["aux"]

        bart_state = state.bart
        if is_warmup and not self.is_binary and \
                self.rescale_sched[min(it, self.warmup - 1)]:
            bart_state = bart_state._replace(
                sigma_mu=self._sigma_mu(bart_offset, bart_state.k))
        return nuts, vi, info, bart_state, bart_offset, sigma

    def _post_sweep(self, nuts, vi, info, bart_state, bart_offset, latents,
                    varcount, gen, it):
        """The leaf draws, the level interweave, BART fit -> Stan offset,
        draw packaging.

        The sweep carries a running residual, so its ``allfit`` (the
        response minus the residual) drifts from the sum of the trees by
        the rounding of every tree update, a random walk over the
        iterations in float32.  Here ``allfit`` becomes the sum of the
        tree fits again, so the stored BART fit equals the stored forests
        walked over the training rows (``Stan4bartFit.predict``)."""
        pm, cfg = self.pm, self.bart_cfg
        if self.leaf_gibbs > 0 or self.leaf_block > 0:
            if self.is_binary:
                sigma = torch.ones_like(bart_state.k)
            else:
                c, _ = pm.layout.constrain(nuts.q)
                sigma = pm.transformed(c, nuts.q.shape[0])["aux"]
            for _ in range(self.leaf_gibbs):
                bart_state = self._leaf_gibbs_update(
                    bart_state, bart_offset, latents, sigma, gen)
            if self.leaf_block > 0 and \
                    it % self.leaf_block == self.leaf_block - 1:
                bart_state = self._leaf_block_update(
                    bart_state, bart_offset, latents, sigma, gen)
        if self.level_gibbs:
            nuts, bart_state = self._level_gibbs_update(
                nuts, bart_state, bart_offset, latents, gen)
        bart_state = bart_state._replace(allfit=bart_state.tree_fit.sum(1))
        bart_fit = bart_state.allfit
        stan_offset = self._stan_offset_from_fit(bart_fit)
        if self.level_gibbs or self.leaf_gibbs > 0 or self.leaf_block > 0:
            y_stan = latents if self.is_binary else self.y
            info = info._replace(
                lp=self._logp(nuts.q, stan_offset, y_stan)(nuts.q))
        stan_row = torch.cat([
            torch.stack([info.lp, info.accept_stat, info.stepsize,
                         info.treedepth, info.n_leapfrog, info.divergent,
                         info.energy], -1),
            pm.constrained_draw(nuts.q),
        ], -1)
        C = bart_fit.shape[0]
        if self.has_test:
            bart_test = bart_ops.predict_trees(
                cfg, bart_state.feature, bart_state.cut,
                bart_state.leaf_value, self.ranks_test)
        else:
            bart_test = bart_fit.new_zeros((C, self.n_test))
        new_state = GibbsState(nuts=nuts, bart=bart_state,
                               bart_offset=bart_offset,
                               stan_offset=stan_offset, latents=latents,
                               vi=vi)
        trees = ((bart_state.feature, bart_state.cut, bart_state.leaf_value)
                 if self.keep_trees else (None, None, None))
        draw = GibbsDraw(stan_row, bart_fit, bart_test, varcount,
                         bart_state.k, *trees)
        return new_state, draw

    @torch.no_grad()
    def step_batched(self, states: GibbsState, it: int, is_warmup: bool,
                     gen):
        """One Gibbs iteration of every chain; the BART sweep of all
        chains is one call of the sweep kernel.  Returns (states, draw)."""
        return self._iterate(states, it, is_warmup, gen, per_chain=False)

    @torch.no_grad()
    def step(self, states: GibbsState, it: int, is_warmup: bool, gen):
        """The JAX package's per-chain iteration (``GibbsProgram.step``,
        vmapped there), which serves callbacks and ``keep_fits=False``:
        ``step_batched``'s phases with the per-chain sweep kernel.  It
        consumes ``gen`` as ``step_batched`` does and gives the same
        states and draws (on the card, wherever the two sweep kernels
        choose the same K, as at the bench shape).  Returns (states,
        draw)."""
        return self._iterate(states, it, is_warmup, gen, per_chain=True)

    def _iterate(self, states: GibbsState, it: int, is_warmup: bool, gen,
                 per_chain: bool):
        t0 = time.perf_counter()
        nuts, vi, info, bart_state, bart_offset, sigma = self._pre_sweep(
            states, it, is_warmup, gen)
        t0 = self._mark("nuts_gibbs", t0)
        latents = states.latents
        varcount = None
        for _ in range(self.skip_bart):
            if self.is_binary:
                latents = self._probit_latents(
                    bart_state.allfit + bart_offset, gen)
                y_target = latents - bart_offset
            else:
                y_target = self.y - bart_offset
            bart_state, varcount = self._sweep(bart_state, y_target, sigma,
                                               gen, per_chain)
            if self.bart_cfg.regrow_per_sweep > 0:
                bart_state, varcount = self._regrow(bart_state, y_target,
                                                    sigma, gen)
        t0 = self._mark("sweep", t0)
        out = self._post_sweep(nuts, vi, info, bart_state, bart_offset,
                               latents, varcount, gen, it)
        self._mark("post", t0)
        return out

    def local_view(self, local: dict, axis, inv_mass0, n_global_pad: int,
                   start: int):
        """This program on one shard of the observations, for the
        observation-sharded driver (parallel/mesh.run_chains_obs_sharded;
        the JAX package's ``local_view``): every obs-sized member is
        replaced by the shard's rows and every sufficient statistic is
        all-reduced over the data group by ``axis`` (``sum`` and ``max``
        of a tensor).

        ``local`` holds the shard's tensors on this program's device: y,
        ranks (numpy), X, z_structs (list of (lhs, gidx)), gram_A,
        gram_AW, and optionally weights and user_offset.  ``inv_mass0`` is
        the initial metric from the global data, ``n_global_pad`` the
        padded global row count and ``start`` the shard's first row.

        Requires the Gram-compressed likelihood (NUTS differentiates only
        the anchored O(D^2) form, whose all-reduce is forward only) and
        refuses pooled adaptation, as the JAX package does."""
        import copy
        import dataclasses

        if not self.use_gram:
            raise ValueError(
                "the obs-sharded driver requires the Gram-compressed "
                "likelihood (gram_lik=True): NUTS gradients may not "
                "cross the observation psum")
        if self.nuts_cfg.pooled:
            raise ValueError(
                "pooled_adaptation is not supported obs-sharded (the "
                "chain pool would silently become per-device-group)")
        if self.y.dim() == 2:
            raise ValueError("a per-chain y is not supported obs-sharded")
        lpm = copy.copy(self.pm)
        lpm.obs_axis = axis
        lpm.X = local["X"]
        lpm.z_structs = [tuple(zs) for zs in local["z_structs"]]
        if "weights" in local:
            lpm.weights = local["weights"]
            lpm.cfg = dataclasses.replace(lpm.cfg, has_weights=True)
        lpm.N_rows = int(local["y"].shape[0])
        lpm.gram_A = local["gram_A"]
        lpm.gram_AW = local["gram_AW"]

        lp = copy.copy(self)
        lp.pm = lpm
        lp.obs_axis = axis
        lp.y = local["y"]
        lp.ranks = torch.as_tensor(local["ranks"], device=self.device)
        lp.weights = local.get("weights")
        if self.user_offset is not None:
            lp.user_offset = local["user_offset"]
        lp.N = int(local["y"].shape[0])
        lp.N_global = self.N
        lp.N_global_pad = int(n_global_pad)
        lp.obs_start = int(start)
        lp._inv_mass0_global = np.asarray(inv_mass0)
        lp.sweep_consts = make_sweep_consts(
            self.bart_cfg, local["ranks"], self.split_probs,
            device=self.device, dtype=self.dtype)
        lp.phase_s = {k: 0.0 for k in self.phase_s}
        return lp

    def _disengage(self, state: GibbsState) -> GibbsState:
        """Freeze the sampling stepsize (rule: bar, last or mid)."""
        da = state.nuts.da
        rule = self.nuts_cfg.freeze_rule
        if rule == "last":
            frozen = da.log_eps
        elif rule == "mid":
            frozen = 0.5 * (da.log_eps + da.log_eps_bar)
        else:
            frozen = da.log_eps_bar
        frozen = torch.where(da.count > 0, frozen, da.log_eps)
        return state._replace(nuts=state.nuts._replace(
            da=da._replace(log_eps=frozen, log_eps_bar=frozen)))

    def run_chains_chunked(self, gen, n_chains: int,
                           chunk_size: int | None = None,
                           bart_offset_init=None, sigma_init=1.0,
                           keep_warmup: bool = True, callback=None,
                           verbose: int = 0, refresh: int | None = None,
                           progress=None, per_chain: bool = False):
        """Warmup then sampling for ``n_chains`` chains, in chunks of at
        most ``chunk_size`` iterations (None = one chunk per phase).
        After each chunk the draws move to the host, ``progress(phase,
        done, total)`` is called and progress is printed; a
        KeyboardInterrupt between iterations returns the draws completed
        so far as a valid partial fit.

        ``callback``: optional ``f(draw) -> outputs``, a dict, tuple or
        NamedTuple of tensors with a leading chain dimension (or None to
        store nothing), stored in place of each GibbsDraw.  As in the JAX
        package, a fit with a callback runs the per-chain ``step``; one
        without runs ``step_batched`` unless ``per_chain``.

        Returns ``(final_states, draws, info)``: draws a GibbsDraw (or the
        callback's outputs) of numpy arrays with leading (chains,
        iterations); info the measured wall-clock ``warmup_s`` /
        ``sample_s``, the per-phase seconds of the iterations, the
        completed counts and an ``interrupted`` flag.
        """
        per_chain = per_chain or callback is not None
        states = self.init_state(gen, n_chains, bart_offset_init, sigma_init,
                                 per_chain=per_chain)
        phases = (("warmup", self.warmup, keep_warmup, None),
                  ("sample", self.iterations, True, self._disengage))
        return self._drive(states, phases, gen, per_chain, chunk_size,
                           callback, verbose, refresh, progress)

    def continue_chunked(self, states: GibbsState, iterations: int,
                         chunk_size: int | None, gen, progress=None,
                         per_chain: bool = False):
        """Resume the sampling phase from chain-batched ``states`` (a fit's
        final states) for ``iterations`` more draws: ``step_batched``, or
        ``step`` for a per-chain fit, with ``run_chains_chunked``'s
        chunking, progress and interrupt handling.  Returns ``(states,
        draws, info)`` as ``run_chains_chunked`` does."""
        phases = (("sample", int(iterations), True, None),)
        return self._drive(states, phases, gen, per_chain, chunk_size,
                           None, 0, None, progress)

    def _drive(self, states, phases, gen, per_chain, chunk_size, callback,
               verbose, refresh, progress):
        """The chunked loop of ``run_chains_chunked`` and
        ``continue_chunked``: each phase ``(name, total, keep, start)``
        applies ``start`` (if any) to the states, then runs ``total``
        iterations, keeping their draws (or the callback's outputs) when
        ``keep``."""
        step = self.step if per_chain else self.step_batched
        pieces, draws, keep = [], [], False

        def flush():
            if draws and keep:
                pieces.append(tree_map(
                    lambda *x: torch.stack(x, 1).cpu().numpy(), *draws))
            draws.clear()

        info = {"interrupted": False}
        for phase, _, _, _ in phases:
            info.update({f"{phase}_s": 0.0, f"{phase}_done": 0})
        try:
            for phase, total, keep, start in phases:
                if start is not None:
                    states = start(states)
                if verbose > 0 and total > 0:
                    print(f"starting {phase}, {total} draws", flush=True)
                next_print = refresh if refresh else None
                chunk = max(int(chunk_size or total), 1)
                it0 = 0
                while it0 < total:
                    n = min(chunk, total - it0)
                    t0 = time.perf_counter()
                    for i in range(n):
                        states, d = step(states, it0 + i, phase == "warmup",
                                         gen)
                        draws.append(d if callback is None else callback(d))
                        info[f"{phase}_done"] = it0 + i + 1
                    flush()
                    info[f"{phase}_s"] += time.perf_counter() - t0
                    it0 += n
                    if progress is not None:
                        progress(phase, it0, total)
                    if verbose > 1 and next_print is not None:
                        while it0 >= next_print:
                            print(f"  iter {next_print} / {total}",
                                  flush=True)
                            next_print += refresh
                    elif verbose > 0:
                        print(f"  {phase} {it0} / {total}", flush=True)
        except KeyboardInterrupt:
            flush()
            if not pieces:
                raise
            info["interrupted"] = True
            done = " + ".join(f"{info[f'{p}_done']} {p}"
                              for p, _, _, _ in phases)
            warnings.warn(
                f"sampling interrupted: returning the {done} draws "
                "completed so far as a partial fit")
        info.update(self.phase_s)
        merged = tree_map(lambda *x: np.concatenate(x, axis=1), *pieces)
        return states, merged, info

    def stan_names(self) -> list[str]:
        return [
            "lp__", "accept_stat__", "stepsize__", "treedepth__",
            "n_leapfrog__", "divergent__", "energy__",
        ] + self.pm.constrained_names()
