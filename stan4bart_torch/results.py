"""Fit object and posterior consumption: extract / fitted / summary,
log_lik / loo / waic, predict / trees / print_trees from stored forests,
save / load / continue_sampling, and SMC adjudication of the parametric
block (``adjudicate_parametric_smc``).

Counterpart of ``stan4bart_tpu/results.py`` in numpy: draw types

    ev, ppd, fixef, indiv.fixef, ranef, indiv.ranef, indiv.bart,
    sigma, Sigma, k, varcount, stan, callback

for train or test samples, with warmup inclusion, chain combining, probit
``Phi`` transforms, ppd noise injection (incl. weights), and new-group
posterior sampling from the per-draw covariance Cholesky.  ``predict``
and ``trees`` walk the stored forests on the fit's device, one
iteration's forests at a time.

Array convention: draws are returned with observation/parameter axes first
and the draw axis LAST; ``combine_chains=True`` (default) flattens
(chains x iterations) into one draw axis, else a trailing (iter, chain)
pair.
"""

from __future__ import annotations

import math
import pickle
import warnings
from dataclasses import dataclass, field, fields, replace
from typing import Any

import numpy as np
import torch
from scipy.special import ndtr  # Phi: scipy.stats.norm.cdf's values, faster

from stan4bart_torch.gibbs import GibbsProgram, tree_map
from stan4bart_torch.models.assemble import build_parametric_model
from stan4bart_torch.ops.bart import compute_ranks, predict_trees, walk_tree
from stan4bart_torch.ops.bart_sweep_kernel import check_kernel_dtype
from stan4bart_torch.utils.device import resolve_device

# observations per block of the r_eff computation in loo(): bounds the
# host memory of the batched FFT
R_EFF_BLOCK = 1024
# entries of the largest dense random-effects design (q x n) that Z b is
# computed with; past it (many levels) each row gathers its levels' draws
DENSE_Z_MAX = 2 ** 24

EXTRACT_TYPES = (
    "ev", "ppd", "fixef", "indiv.fixef", "ranef", "indiv.ranef",
    "indiv.bart", "sigma", "Sigma", "k", "varcount", "stan", "callback",
)


@dataclass
class Stan4bartFit:
    mf: Any
    pm: Any
    prog: Any
    family: str
    # GibbsDraw of numpy, leading (chains, iter); with keep_fits=False the
    # callback's outputs instead, or None without a callback
    draws: Any
    warmup: int
    chains: int
    stan_names: list
    test_frame: Any = None
    treatment: str | None = None
    final_states: Any = None
    # with qr=True: beta_orig = R_inv beta_qr, since X_qr = X R_inv (None
    # without QR)
    R_inv: np.ndarray | None = None
    keep_fits: bool = True
    sigma_init: float = 1.0
    seed: int = 0
    # the callback's outputs beside the raw draws (keep_fits=True)
    callback_draws: Any = None
    # resolved prior info (assemble info dict) for prior_summary()
    prior_info: dict | None = None
    # measured wall-clock seconds: 'total', 'warmup', 'sample', and the
    # iteration phases 'nuts_gibbs', 'sweep', 'post' (from several ranks
    # this rank's, with 'run' and 'gather'); 'interrupted': True on
    # partial fits
    timings: dict | None = None
    # whether the chains ran the per-chain GibbsProgram.step (a callback
    # or keep_fits=False); continue_sampling resumes on the same driver
    per_chain: bool = False
    # the torch.Generator's state after the last iteration (a CPU byte
    # tensor); None after loading on another device type
    rng_state: Any = None
    # the resolved StanArgs and GibbsProgram's arguments besides the
    # model and the device: what load() rebuilds the program from
    stan_args: Any = None
    program_args: dict | None = None
    # the sampling driver's record: measured warmup / sample seconds,
    # completed counts, the per-phase seconds and, from several ranks, the
    # layout (world_size, rank, chain_groups, obs_shards, backend), the
    # data group's all-reduce count and the run / gather seconds
    run_info: dict | None = None
    # True once the stored stan draws hold un-rotated betas: an init field,
    # so that replace() and load() carry it and __post_init__ never
    # applies R_inv to draws it has already un-rotated
    qr_unrotated: bool = False
    _name_idx: dict = field(default_factory=dict, init=False)
    _rng_calls: int = field(default=0, init=False)

    def __post_init__(self):
        self._name_idx = {n: i for i, n in enumerate(self.stan_names)}
        if (self.R_inv is not None and self.keep_fits
                and not self.qr_unrotated):
            self.draws = self.draws._replace(
                stan=self._unrotate_stan(self.draws.stan))
            self.qr_unrotated = True

    def _unrotate_stan(self, stan):
        """The beta columns of raw stan draws (..., S) in the original
        coordinates: beta_orig = R_inv beta_qr, a row times R_inv^T."""
        K = self.mf.K
        bi = [self._name_idx[f"beta.{j + 1}"] for j in range(K)]
        out = np.array(stan)
        out[..., bi] = stan[..., bi] @ np.asarray(self.R_inv).T
        return out

    # -- internals ----------------------------------------------------------

    @property
    def is_binary(self) -> bool:
        return self.family == "binomial"

    @property
    def iterations(self) -> int:
        if self.draws is None:  # keep_fits=False with no callback
            return self.warmup + self.prog.iterations
        if self.keep_fits:
            return self.draws.stan.shape[1]
        shapes = []
        tree_map(lambda a: shapes.append(a.shape), self.draws)
        return shapes[0][1]

    def _require_raw(self):
        if not self.keep_fits:
            raise ValueError(
                "raw draws were not stored (keep_fits=False); only "
                "type='callback' is available (man/stan4bart.Rd:227-242)")

    def _slice(self, arr, include_warmup):
        """arr leading axes (chains, iter, ...) -> iteration slice."""
        if include_warmup:
            return arr
        return arr[:, self.warmup :]

    def _flatten(self, arr, combine_chains):
        """(chains, iter, ...) -> (..., draws) or (..., iter, chains)."""
        arr = np.asarray(arr)
        moved = np.moveaxis(arr, (0, 1), (-1, -2))  # (..., iter, chains)
        if combine_chains:
            return moved.reshape(
                moved.shape[:-2] + (moved.shape[-2] * moved.shape[-1],)
            )
        return moved

    def _stan_rows(self, names, include_warmup):
        idx = [self._name_idx[n] for n in names]
        return self._slice(self.draws.stan, include_warmup)[..., idx]

    def _rng(self):
        # fresh stream per call: repeated extract("ppd") calls must return
        # fresh noise, and the ppd / new-level-ranef streams must not be
        # correlated (the reference draws from R's global RNG each call,
        # generics.R:419-461); still reproducible per fit + call sequence
        self._rng_calls += 1
        return np.random.default_rng((self.seed, 0x5EED, self._rng_calls))

    # -- component draws (internal, (chains, iter, ...) layout) -------------

    def _beta_draws(self, include_warmup):
        K = self.mf.K
        if K == 0:
            sl = self._slice(self.draws.stan, include_warmup)
            return np.zeros(sl.shape[:2] + (0,))
        return self._stan_rows([f"beta.{j + 1}" for j in range(K)],
                               include_warmup)

    def _b_draws(self, include_warmup):
        q = self.mf.q
        if q == 0:
            sl = self._slice(self.draws.stan, include_warmup)
            return np.zeros(sl.shape[:2] + (0,))
        return self._stan_rows([f"b.{j + 1}" for j in range(q)],
                               include_warmup)

    def _theta_L_draws(self, include_warmup):
        L = self.mf.len_theta_L
        if L == 0:
            sl = self._slice(self.draws.stan, include_warmup)
            return np.zeros(sl.shape[:2] + (0,))
        return self._stan_rows([f"theta_L.{j + 1}" for j in range(L)],
                               include_warmup)

    def _sigma_draws(self, include_warmup):
        if self.is_binary:
            raise ValueError("sigma is not defined for binary outcomes")
        return self._stan_rows(["aux.1"], include_warmup)[..., 0]

    def _term_keys(self):
        """Dict keys per ranef term: the group name, disambiguated when a
        factor carries several independent terms (|| splits; R's VarCorr
        allows duplicate list names, Python dicts cannot)."""
        keys, seen = [], {}
        for t in self.mf.re_terms:
            n = seen.get(t.group_name, 0)
            seen[t.group_name] = n + 1
            keys.append(t.group_name if n == 0
                        else f"{t.group_name}.{n + 1}")
        return keys

    def _Sigma_draws(self, include_warmup):
        """Per-term covariance draws from theta_L (mkVarCorr semantics,
        lme4_functions.R:1199-1224; dispersion already folded in)."""
        th = self._theta_L_draws(include_warmup)  # (C, I, L)
        out = {}
        mark = 0
        for t, key in zip(self.mf.re_terms, self._term_keys()):
            p = t.p
            if p == 1:
                out[key] = (th[..., mark] ** 2)[..., None, None]
                mark += 1
            else:
                ntri = p + math.comb(p, 2)
                seg = th[..., mark : mark + ntri]
                mark += ntri
                T = np.zeros(seg.shape[:2] + (p, p))
                k = 0
                for c in range(p):
                    for r in range(c, p):
                        T[..., r, c] = seg[..., k]
                        k += 1
                out[key] = T @ np.swapaxes(T, -1, -2)
        return out

    def _frame_for(self, sample):
        return self.mf if sample == "train" else self._require_test()

    def _indiv_fixef(self, include_warmup, sample="train", frame=None):
        """(X - X_mean) beta per draw (generics.R:510-551 fitted_fixed)."""
        beta = self._beta_draws(include_warmup)  # (C, I, K)
        X = np.asarray((frame or self._frame_for(sample)).X)
        return np.einsum("nk,cik->cin", X, beta)

    def _indiv_ranef(self, include_warmup, sample="train",
                     sample_new_levels=True, frame=None):
        """Z b per draw; unseen test levels get draws from N(0, Sigma_draw)
        (generics.R:553-612)."""
        b = self._b_draws(include_warmup)  # (C, I, q)
        fr = frame or self._frame_for(sample)
        re_terms = fr.re_terms
        C, I, q = b.shape
        n = re_terms[0].lhs.shape[0] if re_terms else np.asarray(fr.X).shape[0]
        if not re_terms:
            return np.zeros((C, I, n))
        rng = self._rng()
        Sigmas = (self._Sigma_draws(include_warmup)
                  if sample_new_levels else None)
        dense = q * n <= DENSE_Z_MAX
        if dense:
            # the design of the seen rows as a dense (q, n) matrix: Z b of
            # every draw is one BLAS product into one new array, 4-5x
            # faster than gathering each row's level over 10^8 entries
            Z = np.zeros((q, n))
        else:
            eta = np.zeros((C, I, n))
        off = 0
        for t_train, t in zip(self.mf.re_terms, re_terms):
            p, l = t_train.p, t_train.l
            gidx = np.asarray(t.group_idx)
            seen = gidx >= 0
            lhs = np.asarray(t.lhs)
            if dense:
                rows = off + gidx[seen, None] * p + np.arange(p)
                Z[rows.ravel(), np.repeat(np.flatnonzero(seen), p)] = \
                    lhs[seen].ravel()
            else:
                b_term = b[..., off : off + p * l].reshape(C, I, l, p)
                contrib = np.einsum("np,cinp->cin", lhs[seen],
                                    b_term[:, :, gidx[seen], :])
                eta[:, :, seen] += contrib
            off += p * l
        if dense:
            eta = (b.reshape(C * I, q) @ Z).reshape(C, I, n)
        if not sample_new_levels:
            return eta
        for t_train, t, key in zip(self.mf.re_terms, re_terms,
                                   self._term_keys()):
            p = t_train.p
            unseen = np.asarray(t.group_idx) < 0
            if unseen.any():
                chol = np.linalg.cholesky(Sigmas[key] + 1e-12 * np.eye(p))
                # one b draw per (chain, iter, distinct NEW LEVEL), shared
                # across that level's rows (levelfun semantics,
                # generics.R:553-612) — preserves within-draw correlation
                # of observations in the same new group
                if t.new_level_ids is not None:
                    lev_of_row = t.new_level_ids[unseen]
                else:
                    lev_of_row = np.arange(unseen.sum())
                n_lev = int(lev_of_row.max()) + 1
                z = rng.standard_normal((C, I, n_lev, p))
                b_lev = np.einsum("cipq,cilq->cilp", chol, z)
                eta[:, :, unseen] += np.einsum(
                    "np,cinp->cin", np.asarray(t.lhs)[unseen],
                    b_lev[:, :, lev_of_row, :])
        return eta

    def _indiv_bart(self, include_warmup, sample="train"):
        arr = (self.draws.bart_train if sample == "train"
               else self._require_test_draws())
        return self._slice(arr, include_warmup)

    def _require_test(self):
        if self.test_frame is None:
            raise ValueError("no test data was provided to stan4bart()")
        return self.test_frame

    def _require_test_draws(self):
        self._require_test()
        return self.draws.bart_test

    def _ev(self, include_warmup, sample="train", sample_new_levels=True):
        ev = self._indiv_bart(include_warmup, sample)
        ev = ev + self._indiv_fixef(include_warmup, sample)
        if self.mf.q > 0:
            ev = ev + self._indiv_ranef(include_warmup, sample,
                                        sample_new_levels)
        off = (self.mf.offset if sample == "train"
               else self._require_test().offset)
        if off is not None:
            ev = ev + np.asarray(off)
        if self.is_binary:
            ev = ndtr(ev)
        return ev

    # -- public API ----------------------------------------------------------

    def _na_expand(self, arr, sample):
        """na_action='exclude': re-insert NaN rows at the original
        positions of incomplete observations (test-03-na_action.R:45-92).
        arr has the observation axis first."""
        fr = self._frame_for(sample)
        if (self.mf.na_action != "exclude"
                or bool(np.all(fr.complete_rows))):
            return arr
        out = np.full((fr.n_original,) + arr.shape[1:], np.nan,
                      dtype=np.float64)
        out[np.asarray(fr.complete_rows)] = arr
        return out

    def extract(self, type: str = "ev", sample: str = "train",
                combine_chains: bool = True, include_warmup: bool = False,
                sample_new_levels: bool = True):
        """Posterior draws of the requested quantity (generics.R:169-472)."""
        if type not in EXTRACT_TYPES:
            raise ValueError(f"type must be one of {EXTRACT_TYPES}")
        if sample not in ("train", "test"):
            raise ValueError("sample must be 'train' or 'test'")

        if type == "callback":
            src = self.callback_draws if self.keep_fits else self.draws
            if src is None:
                raise ValueError(
                    "no callback was supplied to stan4bart()"
                    + ("" if self.keep_fits else
                       " and keep_fits=False stored no raw draws"))
            return tree_map(
                lambda a: self._flatten(self._slice(a, include_warmup),
                                        combine_chains), src)
        self._require_raw()
        if type == "stan":
            return self._flatten(
                self._slice(self.draws.stan, include_warmup), combine_chains
            )
        if type == "k":
            if not hasattr(self.draws, "k"):
                raise ValueError("k draws unavailable")
            return self._flatten(self._slice(self.draws.k, include_warmup),
                                 combine_chains)
        if type == "sigma":
            return self._flatten(self._sigma_draws(include_warmup),
                                 combine_chains)
        if type == "varcount":
            return self._flatten(
                self._slice(self.draws.varcount, include_warmup),
                combine_chains,
            )
        if type == "fixef":
            return self._flatten(self._beta_draws(include_warmup),
                                 combine_chains)
        if type == "ranef":
            b = self._b_draws(include_warmup)
            C, I = b.shape[:2]
            out = {}
            off = 0
            for t, key in zip(self.mf.re_terms, self._term_keys()):
                arr = b[..., off : off + t.p * t.l].reshape(C, I, t.l, t.p)
                out[key] = self._flatten(arr, combine_chains)
                off += t.p * t.l
            return out
        if type == "Sigma":
            sig = self._Sigma_draws(include_warmup)
            return {
                k: self._flatten(v, combine_chains) for k, v in sig.items()
            }
        if type == "indiv.fixef":
            return self._na_expand(
                self._flatten(self._indiv_fixef(include_warmup, sample),
                              combine_chains), sample)
        if type == "indiv.ranef":
            return self._na_expand(
                self._flatten(
                    self._indiv_ranef(include_warmup, sample,
                                      sample_new_levels),
                    combine_chains,
                ), sample)
        if type == "indiv.bart":
            return self._na_expand(
                self._flatten(self._indiv_bart(include_warmup, sample),
                              combine_chains), sample)
        if type == "ev":
            return self._na_expand(
                self._flatten(
                    self._ev(include_warmup, sample, sample_new_levels),
                    combine_chains,
                ), sample)
        # ppd: ev + observation noise (generics.R:419-461)
        ev = self._ev(include_warmup, sample, sample_new_levels)
        rng = self._rng()
        if self.is_binary:
            ppd = rng.binomial(1, ev).astype(np.float64)
        else:
            sigma = self._sigma_draws(include_warmup)[..., None]
            if self.mf.weights is not None and sample == "train":
                sigma = sigma / np.sqrt(np.asarray(self.mf.weights))
            ppd = ev + rng.standard_normal(ev.shape) * sigma
        return self._na_expand(self._flatten(ppd, combine_chains), sample)

    def fitted(self, type: str = "ev", sample: str = "train", **kw):
        """Posterior mean of extract(type) (generics.R:476-508)."""
        draws = self.extract(type=type, sample=sample, combine_chains=True,
                             **kw)
        if isinstance(draws, dict):
            return {k: v.mean(axis=-1) for k, v in draws.items()}
        return draws.mean(axis=-1)

    # -- information criteria ------------------------------------------------

    def _log_lik_raw(self, include_warmup=False):
        """Pointwise log p(y_i | draw) on the training data, internal
        (chains, iter, n) layout.  Gaussian: Normal(ev, sigma/sqrt(w_i));
        probit: Bernoulli(Phi(lin)), the weights scaling the log-density
        as in the weighted Stan target."""
        if not self.keep_fits:
            raise ValueError("log_lik requires keep_fits=True")
        ev = self._ev(include_warmup, "train")       # probit: P(y = 1)
        y = np.asarray(self.mf.y, dtype=np.float64)
        w = (None if self.mf.weights is None
             else np.asarray(self.mf.weights, dtype=np.float64))
        if self.is_binary:
            p = np.clip(ev, 1e-12, 1.0 - 1e-12)
            ll = np.where(y > 0, np.log(p), np.log1p(-p))
            if w is not None:
                ll = ll * w
        else:
            sigma = self._sigma_draws(include_warmup)[..., None]
            var = sigma ** 2 if w is None else sigma ** 2 / w
            ll = -0.5 * (np.log(2.0 * np.pi * var) + (y - ev) ** 2 / var)
        return ll

    def log_lik(self, combine_chains: bool = True,
                include_warmup: bool = False):
        """Pointwise log-likelihood, (n_obs, draws) with the draws axis
        last (same layout as extract); na_action='exclude' re-inserts
        NaN rows.  Feeds fit.loo() / fit.waic()."""
        return self._na_expand(
            self._flatten(self._log_lik_raw(include_warmup),
                          combine_chains), "train")

    def loo(self, include_warmup: bool = False,
            use_r_eff: bool = True) -> dict:
        """PSIS-LOO expected log predictive density (loo.py): elpd_loo,
        p_loo, looic with standard errors, plus per-observation
        pareto_k diagnostics (k > 0.7 flags unreliable points).

        use_r_eff: correct the PSIS tail length for MCMC
        autocorrelation with the per-observation relative efficiency
        ESS/S of the chain-structured draws (the loo package's r_eff);
        False assumes independent draws."""
        from stan4bart_torch.loo import psis_loo
        from stan4bart_torch.parallel.diagnostics import ess

        raw = self._log_lik_raw(include_warmup)     # (chains, iter, n)
        ll = self._flatten(raw, True)
        r_eff = None
        if use_r_eff and raw.shape[0] * raw.shape[1] >= 8:
            S = raw.shape[0] * raw.shape[1]
            by_obs = np.moveaxis(raw, -1, 0)         # (n, chains, iter)
            r_eff = np.concatenate([
                np.atleast_1d(ess(by_obs[j: j + R_EFF_BLOCK]))
                for j in range(0, by_obs.shape[0], R_EFF_BLOCK)]) / S
        out = psis_loo(ll, r_eff=r_eff)
        if out["n_high_k"]:
            warnings.warn(
                f"{out['n_high_k']} of {out['n_obs']} observations have "
                "pareto_k > 0.7: their PSIS-LOO contributions are "
                "unreliable (consider exact refits for those points)")
        return out

    def waic(self, include_warmup: bool = False) -> dict:
        """WAIC (pWAIC2 penalty) from the pointwise log-likelihood."""
        from stan4bart_torch.loo import waic as _waic

        return _waic(self._flatten(self._log_lik_raw(include_warmup),
                                   True))

    # -- out-of-sample prediction from the stored forests (keep_trees) -------

    def _tree_draws(self, include_warmup):
        self._require_raw()
        if getattr(self.draws, "tree_feature", None) is None:
            raise ValueError(
                "predict/trees require keep_trees=True at fit time "
                "(bart_args keep_trees or keepTrees, or stan_args "
                "keep_trees)")
        return (
            self._slice(self.draws.tree_feature, include_warmup),
            self._slice(self.draws.tree_cut, include_warmup),
            self._slice(self.draws.tree_leaf_value, include_warmup),
        )

    def _iteration_forests(self, *arrays):
        """Each stored iteration's (C, T, M) tree arrays on the fit's
        device, one iteration at a time: the tree walk of every chain's
        trees over all rows is the largest allocation (int64 node
        indices, 1.5 GB at 256 chains x 75 trees x 10 000 rows), so the
        device holds one iteration's, and an iteration that does not fit
        raises."""
        dev = self.prog.device
        for i in range(arrays[0].shape[1]):
            yield i, tuple(
                torch.as_tensor(np.ascontiguousarray(a[:, i]), device=dev)
                for a in arrays)

    @torch.no_grad()
    def _predict_bart(self, bart_X_new):
        """Walk every stored post-warmup forest over new data: (C, I,
        n_new)."""
        feature, cut, leaf_value = self._tree_draws(False)
        prog = self.prog
        ranks_new = torch.as_tensor(
            compute_ranks(np.asarray(bart_X_new), prog.cuts),
            device=prog.device)
        out = np.empty(feature.shape[:2] + (ranks_new.shape[0],),
                       dtype=leaf_value.dtype)
        for i, (f, c, lv) in self._iteration_forests(feature, cut,
                                                     leaf_value):
            out[:, i] = predict_trees(prog.bart_cfg, f, c, lv,
                                      ranks_new).cpu().numpy()
        return out

    def predict(self, newdata, type: str = "ev", combine_chains: bool = True,
                sample_new_levels: bool = True, offset=None):
        """Posterior draws on new data from the stored tree ensembles
        (generics.R:614-723).  types: ev, ppd, indiv.bart, indiv.fixef,
        indiv.ranef."""
        ok = ("ev", "ppd", "indiv.bart", "indiv.fixef", "indiv.ranef")
        if type not in ok:
            raise ValueError(f"predict type must be one of {ok}")
        tf = self.mf.build_test_frame(newdata)

        if type == "indiv.fixef":
            out = self._indiv_fixef(False, frame=tf)
        elif type == "indiv.ranef":
            out = self._indiv_ranef(False, sample_new_levels=sample_new_levels,
                                    frame=tf)
        elif type == "indiv.bart":
            out = self._predict_bart(tf.bart_X)
        else:
            out = self._predict_bart(tf.bart_X)
            out = out + self._indiv_fixef(False, frame=tf)
            if self.mf.q > 0:
                out = out + self._indiv_ranef(
                    False, sample_new_levels=sample_new_levels, frame=tf
                )
            if tf.offset is not None:
                out = out + np.asarray(tf.offset)
            if offset is not None:
                out = out + np.asarray(offset)
            if self.is_binary:
                out = ndtr(out)
            if type == "ppd":
                rng = self._rng()
                if self.is_binary:
                    out = rng.binomial(1, out).astype(np.float64)
                else:
                    sigma = self._sigma_draws(False)[..., None]
                    out = out + rng.standard_normal(out.shape) * sigma
        return self._flatten(out, combine_chains)

    # -- flattened-tree export -------------------------------------------------

    @torch.no_grad()
    def _node_counts(self, feature, cut):
        """Training observations in every node of every stored tree,
        (C, I, T, M): leaf counts of the walk over the training ranks,
        summed up the heap one depth at a time."""
        cfg = self.prog.bart_cfg
        C, I, T, M = feature.shape
        counts = np.empty(feature.shape, dtype=np.int32)
        for i, (f, c) in self._iteration_forests(feature, cut):
            f, c = f.reshape(-1, M), c.reshape(-1, M)
            node = walk_tree(f, c, self.prog.ranks, cfg.max_depth)
            cnt = torch.zeros(f.shape, dtype=torch.long, device=f.device)
            cnt.scatter_add_(1, node, torch.ones_like(node))
            for d in range(cfg.max_depth - 1, -1, -1):
                idx = torch.arange(2 ** d - 1, 2 ** (d + 1) - 1,
                                   device=f.device)
                below = cnt[:, 2 * idx + 1] + cnt[:, 2 * idx + 2]
                cnt[:, idx] += torch.where(f[:, idx] >= 0, below, 0)
            counts[:, i] = cnt.reshape(C, T, M).cpu().numpy()
        return counts

    def trees(self, include_warmup: bool = False) -> dict:
        """Flattened tree ensemble draws as columns chain/sample/tree/n/var/
        value (the reference's extract(fit, "trees") via dbarts
        FlattenedTrees; init.cpp:577-671).  Nodes appear in depth-first
        preorder with the left (condition-true) child first; indices are
        0-based with -1 for leaves.  ``var`` is the split variable of an
        internal node and -1 for a leaf; ``value`` is the split cut value
        or the leaf value; ``n`` is the training-observation count in the
        node.  One row per node: keep it to small fits."""
        feature, cut, leaf_value = self._tree_draws(include_warmup)
        C, I, T, M = feature.shape
        counts = self._node_counts(feature, cut)

        # static preorder permutation of the full heap
        preorder = []

        def visit(i):
            if i >= M:
                return
            preorder.append(i)
            visit(2 * i + 1)
            visit(2 * i + 2)

        visit(0)
        preorder = np.asarray(preorder)

        f = np.asarray(feature)[..., preorder]
        cu = np.asarray(cut)[..., preorder]
        lv = np.asarray(leaf_value)[..., preorder]
        cn = counts[..., preorder]
        active = f >= -1

        chain_col = np.broadcast_to(
            np.arange(C)[:, None, None, None], f.shape
        )[active]
        sample_col = np.broadcast_to(
            np.arange(I)[None, :, None, None], f.shape
        )[active]
        tree_col = np.broadcast_to(
            np.arange(T)[None, None, :, None], f.shape
        )[active]
        var_col = f[active]
        is_internal = var_col >= 0
        cut_vals = self.prog.cuts[
            np.clip(var_col, 0, None), cu[active]
        ]
        value_col = np.where(is_internal, cut_vals, lv[active])
        out = dict(
            sample=sample_col, tree=tree_col, n=cn[active],
            var=np.where(is_internal, var_col, -1),
            value=value_col,
        )
        if C > 1:
            out = {"chain": chain_col, **out}
        return out

    def print_trees(self, chains=None, samples=None, trees=None,
                    include_warmup: bool = False, max_print: int = 50):
        """Human-readable tree dump (the reference's printTrees,
        init.cpp:505-576): indented internal nodes as 'X[var] <= cut' and
        leaves with their values, restricted to the requested chain/sample/
        tree indices (all when None)."""
        feature, cut, leaf_value = self._tree_draws(include_warmup)
        feature = np.asarray(feature)
        cut_arr = np.asarray(cut)
        lv = np.asarray(leaf_value)
        C, I, T, M = feature.shape
        chains = range(C) if chains is None else np.atleast_1d(chains)
        samples = range(I) if samples is None else np.atleast_1d(samples)
        trees = range(T) if trees is None else np.atleast_1d(trees)
        names = self.mf.bart_names
        printed = 0

        def emit(c, s, t, node, depth):
            nonlocal printed
            if node >= M or printed >= max_print * 100:
                return
            f = feature[c, s, t, node]
            pad = "  " * (depth + 1)
            if f >= 0:
                cutv = self.prog.cuts[f, cut_arr[c, s, t, node]]
                print(f"{pad}{names[f]} <= {cutv:.6g}")
                emit(c, s, t, 2 * node + 1, depth + 1)
                emit(c, s, t, 2 * node + 2, depth + 1)
            elif f == -1:
                print(f"{pad}leaf {lv[c, s, t, node]:.6g}")

        for c in chains:
            for s in samples:
                for t in trees:
                    if printed >= max_print:
                        print(f"... (stopped after {max_print} trees)")
                        return
                    print(f"[chain {c + 1}] sample {s + 1} tree {t + 1}:")
                    emit(c, s, t, 0, 0)
                    printed += 1

    def prior_summary(self):
        """Print the resolved priors — the reference's prior summary
        (rstanarm_functions.R:270-365): family, location/scale, and the
        autoscale-adjusted scales actually used."""
        if not self.prior_info:
            print("prior information was not recorded")
            return

        def show_block(title, ps):
            dist = ps.get("prior_dist_name")
            if dist is None:
                print(f"{title}: flat (improper uniform)")
                return
            scale = np.atleast_1d(ps.get("prior_scale", np.nan))
            mean = np.atleast_1d(ps.get("prior_mean", 0.0))
            df = np.round(np.atleast_1d(ps.get("prior_df", 1.0)), 3)
            if dist in ("hs", "hs_plus"):
                # hs_plus's second df rides in the prior_scale slot
                desc = (f"{dist}(df = {df.tolist()}, "
                        + (f"df2 = {np.round(scale, 3).tolist()}, "
                           if dist == "hs_plus" else "")
                        + f"global_df = {ps['global_prior_df']:.3g}, "
                        f"global_scale = {ps['global_prior_scale']:.3g}, "
                        f"slab_df = {ps['slab_df']:.3g}, "
                        f"slab_scale = {ps['slab_scale']:.3g})")
            elif dist == "R2":
                desc = (f"R2(location = {ps['R2_location']:.3g}, "
                        f"what = {ps['R2_what']!r})")
            else:
                desc = (f"{dist}(location = {np.round(mean, 3).tolist()}, "
                        f"scale = {np.round(scale, 3).tolist()}"
                        + (f", df = {df.tolist()}"
                           if dist in ("t", "lasso", "product_normal")
                           else "") + ")")
            if ps.get("prior_autoscale"):
                desc += "  [autoscaled]"
            print(f"{title}: {desc}")

        print("Priors:")
        show_block("  coefficients", self.prior_info.get("coef", {}))
        if not self.is_binary:
            show_block("  aux (sigma)", self.prior_info.get("aux", {}))
        cov = self.prior_info.get("covariance")
        if cov and self.mf.q > 0:
            args = ", ".join(f"{k} = {v}" for k, v in cov.items()
                             if k != "dist")
            print(f"  covariance: {cov.get('dist')}({args})")

    # -- pretty-named draw matrix ----------------------------------------------

    def parameter_names(self) -> list:
        """Pretty names for the constrained block (as.array dimnames,
        generics.R:18-112)."""
        names = []
        for n in self.stan_names:
            if n.endswith("__"):
                continue
            base, _, idx = n.rpartition(".")
            j = int(idx) - 1 if idx.isdigit() else 0
            if base == "beta":
                names.append(f"beta_{self.mf.X_names[j]}")
            elif base == "b":
                names.append(self.mf.b_names()[j])
            elif base == "aux":
                names.append("sigma")
            elif base == "theta_L":
                names.append(self._theta_L_name(j))
            else:
                names.append(n)
        return names

    def _theta_L_name(self, j):
        mark = 0
        for t in self.mf.re_terms:
            ntri = t.p + math.comb(t.p, 2)
            if j < mark + ntri:
                local = j - mark
                k = 0
                for c in range(t.p):
                    for r in range(c, t.p):
                        if k == local:
                            return (f"Sigma[{t.group_name}:"
                                    f"{t.coef_names[r]},{t.coef_names[c]}]")
                        k += 1
            mark += ntri
        return f"theta_L.{j + 1}"

    def as_array(self, include_warmup: bool = False):
        """(iterations, chains, params) with pretty names — the reference's
        as.array.stan4bartFit (generics.R:18-112)."""
        self._require_raw()
        stan = self._slice(self.draws.stan, include_warmup)
        keep = [i for i, n in enumerate(self.stan_names)
                if not n.endswith("__")]
        arr = np.moveaxis(stan[..., keep], 0, 1)  # (iter, chains, params)
        return arr, self.parameter_names()

    def as_matrix(self, include_warmup: bool = False):
        """(iterations * chains, params) with pretty names — the
        reference's as.matrix.stan4bartFit (chains flattened)."""
        arr, names = self.as_array(include_warmup)
        return arr.reshape(-1, arr.shape[-1]), names

    # -- checkpoint / resume ---------------------------------------------------

    def save(self, path: str):
        """Checkpoint the fit: its host draws and design, the final
        sampler state as CPU tensors, the generator state, and the
        arguments that rebuild the model and the program (no live device
        object is written, so the file loads on any device)."""
        skip = ("pm", "prog", "final_states")
        payload = {f.name: getattr(self, f.name) for f in fields(self)
                   if f.init and f.name not in skip}
        payload["final_states"] = tree_map(lambda t: t.cpu(),
                                           self.final_states)
        payload["rng_device"] = self.prog.device.type
        with open(path, "wb") as fh:
            pickle.dump(payload, fh)

    @staticmethod
    def load(path: str, device=None) -> "Stan4bartFit":
        """Read a fit written by ``save`` and rebuild its model and program
        on ``device`` (None = the card, like every entry point; pass
        ``device="cpu"`` for the CPU).  The generator state carries over
        between devices of one type; loaded on another type the fit
        serves every accessor but ``continue_sampling``."""
        dev = resolve_device("cuda" if device is None else device)
        with open(path, "rb") as fh:
            payload = pickle.load(fh)
        final = payload.pop("final_states")
        if payload.pop("rng_device") != dev.type:
            payload["rng_state"] = None
        pa = payload["program_args"]
        if dev.type == "cuda":
            check_kernel_dtype(pa["dtype"])
        mf = payload["mf"]
        pm, _, _ = build_parametric_model(
            mf, payload["family"], payload["stan_args"], dtype=pa["dtype"],
            device=dev)
        prog = GibbsProgram(pm, y=np.asarray(mf.y), bart_X=mf.bart_X,
                            device=dev, **pa)
        return Stan4bartFit(
            pm=pm, prog=prog,
            final_states=tree_map(lambda t: t.to(dev), final), **payload)

    def continue_sampling(self, iterations: int,
                          chunk_size: int | None = None) -> "Stan4bartFit":
        """Resume the chains from their final state for ``iterations`` more
        post-warmup draws, in chunks of at most ``chunk_size``; returns a
        new fit with the draws (trees included) appended.  The generator
        restarts from a copy of the stored state, so this fit is left as
        it was and a second call draws the same.  The callback's outputs
        of a fit with a callback are not extended."""
        self._require_raw()
        if self.final_states is None:
            raise ValueError("no final sampler state was stored")
        if self.rng_state is None:
            raise ValueError(
                "the generator state was saved on another device type; "
                "load the fit on that device type to resume it")
        if int(iterations) < 1:
            raise ValueError("'iterations' must be a positive integer")
        gen = torch.Generator(device=self.prog.device)
        gen.set_state(self.rng_state.clone())
        states, new_draws, _ = self.prog.continue_chunked(
            self.final_states, iterations, chunk_size, gen,
            per_chain=self.per_chain)
        if self.qr_unrotated:
            # the stored draws are un-rotated already: un-rotate only the
            # fresh ones
            new_draws = new_draws._replace(
                stan=self._unrotate_stan(new_draws.stan))
        merged = tree_map(lambda a, b: np.concatenate([a, b], axis=1),
                          self.draws, new_draws)
        return replace(self, draws=merged, final_states=states,
                       rng_state=gen.get_state())

    # -- diagnostics ----------------------------------------------------------

    def check_sampler_diagnostics(self):
        """Post-fit warnings: divergences, treedepth saturation, E-BFMI
        (stan4bart.R:255-297); none without raw draws (keep_fits=False)."""
        if not self.keep_fits:
            return
        stan = self.draws.stan[:, self.warmup :]
        div = stan[..., self._name_idx["divergent__"]].sum()
        if div > 0:
            warnings.warn(
                f"{int(div)} of {stan.shape[0] * stan.shape[1]} "
                "post-warmup draws were divergent transitions"
            )
        td = stan[..., self._name_idx["treedepth__"]]
        max_td = self.prog.nuts_cfg.max_treedepth
        n_max = (td >= max_td).sum()
        if n_max > 0:
            warnings.warn(
                f"{int(n_max)} draws hit the maximum treedepth of {max_td}"
            )
        energy = stan[..., self._name_idx["energy__"]]
        for c in range(energy.shape[0]):
            e = energy[c]
            if len(e) > 3:
                num = np.sum(np.diff(e) ** 2) / len(e)
                den = np.var(e, ddof=1)
                if den > 0 and num / den < 0.2:
                    warnings.warn(
                        f"chain {c + 1} E-BFMI = {num / den:.3f} < 0.2: "
                        "the posterior may be poorly explored"
                    )
                    break
        # equilibration check (beyond reference; motivated by a measured
        # case, BENCH_NOTES round 3: at n=2000 a 300-iteration warmup
        # left a residual RSS/sigma transient that depressed lp ESS and
        # biased sigma ~3% — the BART ensemble-complexity relaxation runs
        # on a hundreds-of-iterations timescale).  A monotone lp trend
        # ACROSS the sampling phase means warmup ended early: compare
        # first- and last-quarter means against the MC error of chain
        # quarters (a loose 6-sigma gate so healthy chains never warn).
        lp = np.asarray(stan[..., self._name_idx["lp__"]], np.float64)
        n_it = lp.shape[1]
        if n_it >= 40:
            from stan4bart_torch.parallel.diagnostics import ess as _ess

            q = n_it // 4
            head = lp[:, :q].mean(axis=1)
            tail = lp[:, -q:].mean(axis=1)
            # error scale from the DETRENDED series (a trend would
            # otherwise inflate its own error estimate), stretched by
            # the autocorrelation time n/ESS
            t_idx = np.arange(n_it) - (n_it - 1) / 2.0
            slope = (lp @ t_idx) / (t_idx @ t_idx)
            resid = lp - slope[:, None] * t_idx[None, :]
            resid = resid - resid.mean(axis=1, keepdims=True)
            zmax, worst = 0.0, 0
            for c in range(lp.shape[0]):
                sd = float(np.std(resid[c], ddof=1))
                if sd == 0.0:
                    continue
                ess_c = float(np.asarray(_ess(resid[c][None, :])))
                tau = n_it / max(ess_c, 1.0)
                se = sd * np.sqrt(2.0 * tau / q) + 1e-12
                z = float((tail[c] - head[c]) / se)
                if abs(z) > abs(zmax):
                    zmax, worst = z, c
            if abs(zmax) > 6.0:
                warnings.warn(
                    f"chain {worst + 1}'s log-posterior trends "
                    f"monotonically across the sampling phase (drift "
                    f"{float(tail[worst] - head[worst]):+.1f}, "
                    f"{zmax:.1f} SEs): warmup likely ended before the "
                    "BART ensemble equilibrated — increase warmup (the "
                    "complexity relaxation runs on a hundreds-of-"
                    "iterations timescale at large n; BENCH_NOTES "
                    "round 3)"
                )

    def adjudicate_parametric_smc(self, n_particles: int = 1024,
                                  n_mcmc: int = 8,
                                  seed: int | None = None) -> dict:
        """Independent tempered-SMC adjudication of the parametric block:
        ``ops.smc.smc_sample`` (adaptive tempering and HMC moves, no
        kernel in common with the Gibbs / NUTS fit) on the parametric
        conditional posterior with the BART component fixed at its
        posterior-mean fit, on the fit's device.

        This targets the conditional given the mean BART fit, not the
        marginal parametric posterior: conditional spreads are a lower
        bound on marginal ones.  Agreement of means within Monte Carlo
        error is the check; a gap flags a mixing or implementation
        problem in the main sampler.  Gaussian family only.  The
        generator is seeded from ``seed`` (default the fit's seed +
        0x5AC).

        Returns a dict with ``names``, ``draws`` (n_particles, P),
        ``log_evidence``, ``final_temp`` (1.0 = bridged to the target),
        and ``mcmc_mean`` / ``smc_mean`` aligned to ``names``."""
        if self.is_binary:
            raise NotImplementedError(
                "SMC adjudication targets the Gaussian parametric "
                "conditional; the probit conditional depends on latent "
                "responses that have no fixed value to condition on"
            )
        from stan4bart_torch.ops.smc import smc_sample

        prog, pm = self.prog, self.pm
        bart_mean = np.asarray(self.extract("indiv.bart")).mean(axis=-1)
        offset = prog._stan_offset_from_fit(
            torch.as_tensor(bart_mean, dtype=prog.dtype, device=prog.device))
        gen = torch.Generator(device=prog.device)
        gen.manual_seed((self.seed + 0x5AC) if seed is None else int(seed))
        res = smc_sample(
            lambda u: pm.log_prob(u, offset, prog.y),
            pm.num_upars, int(n_particles), gen, n_mcmc=int(n_mcmc),
            dtype=prog.dtype, device=prog.device,
        )
        names = pm.constrained_names()
        draws = pm.constrained_draw(res.particles).double().cpu().numpy()
        mcmc = self._slice(self.draws.stan, False)[
            ..., [self._name_idx[n] for n in names]
        ].reshape(-1, len(names))
        return {
            "names": names,
            "draws": draws,
            "log_evidence": float(res.log_evidence),
            "final_temp": float(res.final_temp),
            "smc_mean": draws.mean(axis=0),
            "mcmc_mean": mcmc.mean(axis=0),
        }

    def summary(self, include_diagnostics: bool = True):
        """Per-parameter posterior summary: mean, sd, 5%/95% quantiles,
        split-R-hat, ESS.  The reference vendors Stan's R-hat/ESS without
        calling them (SURVEY.md section 5); here they are part of the fit
        surface.  Returns a dict of column arrays keyed by statistic, plus
        'names'."""
        from stan4bart_torch.parallel.diagnostics import ess, split_rhat

        arr, names = self.as_array()          # (iter, chains, params)
        chains_first = np.moveaxis(arr, 1, 0)  # (chains, iter, params)
        mean = chains_first.mean(axis=(0, 1))
        sd = chains_first.std(axis=(0, 1), ddof=1)
        q5, q95 = np.quantile(chains_first, [0.05, 0.95], axis=(0, 1))
        rhat = np.asarray(split_rhat(chains_first))
        ess_vals = np.array([ess(chains_first[..., j])
                             for j in range(chains_first.shape[-1])])
        out = dict(names=names, mean=mean, sd=sd, q5=q5, q95=q95,
                   rhat=rhat, ess=ess_vals)
        if include_diagnostics:
            stan = self.draws.stan[:, self.warmup :]
            out["divergences"] = int(
                stan[..., self._name_idx["divergent__"]].sum()
            )
            out["mean_treedepth"] = float(
                stan[..., self._name_idx["treedepth__"]].mean()
            )
        return out

    def print_summary(self, max_rows: int = 40):
        """Readable posterior table (the reference's print/summary
        generics)."""
        s = self.summary()
        print(self.__repr__())
        header = f"{'parameter':<28}{'mean':>10}{'sd':>10}{'5%':>10}" \
                 f"{'95%':>10}{'rhat':>8}{'ess':>8}"
        print(header)
        for j, name in enumerate(s["names"][:max_rows]):
            print(f"{name:<28}{s['mean'][j]:>10.3f}{s['sd'][j]:>10.3f}"
                  f"{s['q5'][j]:>10.3f}{s['q95'][j]:>10.3f}"
                  f"{s['rhat'][j]:>8.3f}{s['ess'][j]:>8.0f}")
        if len(s["names"]) > max_rows:
            print(f"... ({len(s['names']) - max_rows} more parameters)")
        print(f"divergences: {s['divergences']}  "
              f"mean treedepth: {s['mean_treedepth']:.1f}")

    # -- per-component accessors (formula/terms/model.frame S3 methods,
    # lme4_functions.R:1403-1482)

    @property
    def formula(self) -> str:
        return self.mf.parsed.raw

    def terms(self, component: str = "fixed") -> list:
        """Term strings of one model component (fixed | bart | random)."""
        p = self.mf.parsed
        if component == "fixed":
            return list(p.fixed_terms)
        if component == "bart":
            return list(p.bart_terms)
        if component == "random":
            return [t.raw for t in p.random_terms]
        raise ValueError("component must be fixed, bart, or random")

    def model_frame(self, component: str = "fixed"):
        """Design data of one component: (matrix, column names) for
        fixed/bart, the ReTermData list for random."""
        if component == "fixed":
            return np.asarray(self.mf.X), list(self.mf.X_names)
        if component == "bart":
            return np.asarray(self.mf.bart_X), list(self.mf.bart_names)
        if component == "random":
            return self.mf.re_terms
        raise ValueError("component must be fixed, bart, or random")

    def __repr__(self):
        post = self.iterations - self.warmup
        return (
            f"Stan4bartFit({self.family}; n={self.mf.N}, K={self.mf.K}, "
            f"bart_vars={self.mf.bart_X.shape[1]}, q={self.mf.q}; "
            f"chains={self.chains}, warmup={self.warmup}, draws={post})"
        )
