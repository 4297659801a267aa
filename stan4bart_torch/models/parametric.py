"""The parametric multilevel log-posterior ("continuous" model) in torch,
batched over chains.

Counterpart of ``stan4bart_tpu/models/parametric.py``: every rstanarm
coefficient prior the JAX package takes (flat, normal, Student-t through
the Cornish-Fisher ``cft``, hs, hs_plus, laplace, lasso, product_normal
and R2), normal / Student-t / exponential aux priors, random effects
non-centered (``b = T z_b``) or centered (``b`` sampled directly under
MVN(0, T T')) with the decov (onion-method Cholesky ``make_theta_L``) or
lkj (``make_theta_L_lkj``) covariance prior, the gaussian (optionally
weighted) likelihood with the mutable offset, constraint transforms with
log-Jacobians, the Gram-compressed likelihood (``gram_anchor`` +
``log_prob_gram``) and the conjugate refresh of the linear block
(``linear_gibbs_refresh``).

Every function takes the unconstrained vectors of C chains as a (C, D)
tensor and returns per-chain values; gradients come from autograd of the
sum over chains (the chains are independent).  The random-effects matvec
Z b is a gather by group index (its gradient an index add).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from stan4bart_torch.models import dists
from stan4bart_torch.utils.device import resolve_device

_LOG_HALF = -0.6931471805599452862
_LOG_2 = 0.6931471805599453


@dataclass(frozen=True)
class ParametricConfig:
    """Static model structure (shapes & prior codes only)."""

    N: int
    K: int
    is_binary: bool
    has_weights: bool
    # 0 flat, 1 normal, 2 student_t, 3 hs, 4 hs_plus, 5 laplace, 6 lasso,
    # 7 product_normal, 8 R2
    prior_dist: int
    prior_dist_for_aux: int         # 0 flat, 1 normal, 2 t, 3 exponential
    t: int                          # random-effect terms
    p: tuple = ()
    l: tuple = ()
    num_normals: tuple = ()         # only for prior_dist == 7
    # centered random effects: b sampled directly under MVN(0, T T')
    # instead of b = T z_b, z_b ~ N(0, 1) (the same posterior)
    centered: bool = False
    # covariance prior: 0 decov, 1 lkj (half-t sds, LKJ correlation)
    cov_prior: int = 0

    def __post_init__(self):
        if self.prior_dist not in range(9):
            raise ValueError(f"unknown prior_dist {self.prior_dist}")

    @property
    def q(self) -> int:
        return int(sum(pi * li for pi, li in zip(self.p, self.l)))

    @property
    def len_theta_L(self) -> int:
        return int(sum(pi + math.comb(pi, 2) for pi in self.p))

    @property
    def len_rho(self) -> int:
        return int(sum(self.p)) - self.t

    @property
    def len_concentration(self) -> int:
        return int(sum(pi for pi in self.p if pi > 1))

    @property
    def len_regularization(self) -> int:
        return int(sum(1 for pi in self.p if pi > 1))

    @property
    def len_z_T(self) -> int:
        return int(sum(max(0, pi - 2) * (pi - 1) for pi in self.p))

    @property
    def hs(self) -> int:
        return {3: 2, 4: 4}.get(self.prior_dist, 0)

    @property
    def z_beta_dim(self) -> int:
        if self.prior_dist == 7:
            return int(sum(self.num_normals))
        return self.K


_POS, _ID, _UNIT = "pos", "id", "unit"


def make_layout(cfg: ParametricConfig):
    """Ordered (name, size, transform) blocks — Stan's declaration order."""
    blocks = []

    def add(name, size, kind):
        if size > 0:
            blocks.append((name, int(size), kind))

    add("z_beta", cfg.z_beta_dim, _ID)
    add("global", cfg.hs, _POS)
    add("local", cfg.hs * cfg.K, _POS)
    add("caux", 1 if cfg.hs > 0 else 0, _POS)
    add("mix", cfg.K if cfg.prior_dist in (5, 6) else 0, _POS)
    add("one_over_lambda", 1 if cfg.prior_dist == 6 else 0, _POS)
    add("R2", 1 if cfg.prior_dist == 8 else 0, _UNIT)
    add("b_raw" if cfg.centered else "z_b", cfg.q, _ID)
    add("z_T", cfg.len_z_T, _ID)
    add("rho", cfg.len_rho, _UNIT)
    if cfg.cov_prior == 1:
        # lkj: per-coefficient sds replace decov's zeta and tau
        add("sds", sum(cfg.p), _POS)
    else:
        add("zeta", cfg.len_concentration, _POS)
        add("tau", cfg.t, _POS)
    add("aux_unscaled", 0 if cfg.is_binary else 1, _POS)
    return blocks


class ParamLayout:
    def __init__(self, cfg: ParametricConfig):
        self.blocks = make_layout(cfg)
        self.slices = {}
        off = 0
        for name, size, kind in self.blocks:
            self.slices[name] = (off, size, kind)
            off += size
        self.num_upars = off

    def constrain(self, u):
        """(C, D) unconstrained -> dict of (C, size) constrained blocks and
        the (C,) log|Jacobian|: exp for positive blocks, logistic for unit
        blocks, each unit block x with ``x_log`` = log x and ``x_log1m`` =
        log(1 - x) taken from u, finite wherever u is (a float32 x rounds
        to 0 or 1 past |u| of about 17)."""
        out = {}
        log_jac = u.new_zeros(u.shape[0])
        for name, (off, size, kind) in self.slices.items():
            x = u[:, off: off + size]
            if kind == _POS:
                log_jac = log_jac + x.sum(-1)
                x = torch.exp(x)
            elif kind == _UNIT:
                lo = torch.nn.functional.logsigmoid(x)
                hi = torch.nn.functional.logsigmoid(-x)
                log_jac = log_jac + (lo + hi).sum(-1)
                out[name + "_log"], out[name + "_log1m"] = lo, hi
                x = torch.sigmoid(x)
            out[name] = x
        return out, log_jac


def cft(z, df):
    """Cornish-Fisher expansion: standard normal -> Student-t quantile."""
    z2 = z * z
    z3 = z2 * z
    z5 = z2 * z3
    z7 = z2 * z5
    z9 = z2 * z7
    df2 = df * df
    df3 = df2 * df
    df4 = df2 * df2
    return (
        z
        + (z3 + z) / (4.0 * df)
        + (5.0 * z5 + 16.0 * z3 + 3.0 * z) / (96.0 * df2)
        + (3.0 * z7 + 19.0 * z5 + 17.0 * z3 - 15.0 * z) / (384.0 * df3)
        + (79.0 * z9 + 776.0 * z7 + 1482.0 * z5 - 1920.0 * z3 - 945.0 * z)
        / (92160.0 * df4)
    )


def _hs_lambda_tilde(lam, tau, c2):
    lam2 = lam * lam
    return torch.sqrt(c2 * lam2 / (c2 + tau * tau * lam2))


def compute_beta(cfg: ParametricConfig, c, hyper, aux):
    """beta (C, K) from z_beta per prior family; aux (C,) is the residual
    sd, which scales the horseshoe's global scale."""
    pd = cfg.prior_dist
    z_beta = c["z_beta"]
    if pd == 0:
        return z_beta
    if pd == 1:
        return z_beta * hyper["prior_scale"] + hyper["prior_mean"]
    if pd == 2:
        return (cft(z_beta, hyper["prior_df"]) * hyper["prior_scale"]
                + hyper["prior_mean"])
    if pd in (3, 4):
        C = z_beta.shape[0]
        loc = c["local"].reshape(C, cfg.hs, cfg.K)
        glob = c["global"]
        c2 = hyper["slab_scale"] ** 2 * c["caux"][:, 0]
        error_scale = 1.0 if cfg.is_binary else aux
        tau_g = (glob[:, 0] * torch.sqrt(glob[:, 1])
                 * hyper["global_prior_scale"] * error_scale)
        lam = loc[:, 0] * torch.sqrt(loc[:, 1])
        if pd == 4:
            lam = lam * loc[:, 2] * torch.sqrt(loc[:, 3])
        return (z_beta * _hs_lambda_tilde(lam, tau_g[:, None], c2[:, None])
                * tau_g[:, None])
    if pd == 5:
        return (hyper["prior_mean"]
                + hyper["prior_scale"] * torch.sqrt(2.0 * c["mix"]) * z_beta)
    if pd == 6:
        return (hyper["prior_mean"]
                + c["one_over_lambda"] * hyper["prior_scale"]
                * torch.sqrt(2.0 * c["mix"]) * z_beta)
    if pd == 7:
        segs = []
        z_pos = 0
        for k, nn in enumerate(cfg.num_normals):
            prod = torch.prod(z_beta[:, z_pos: z_pos + nn], -1)
            z_pos += nn
            segs.append(prod * hyper["prior_scale"][k] ** nn
                        + hyper["prior_mean"][k])
        return torch.stack(segs, -1)
    # pd == 8, R2 (stan_lm): a unit direction z / |z| scaled by
    # sqrt(R2) sd(y) over the QR-rotated, unit-variance columns
    r2 = c["R2"]
    norm = torch.sqrt((z_beta * z_beta).sum(-1, keepdim=True) + 1e-30)
    return z_beta / norm * torch.sqrt(r2) * hyper["R2_s"]


def _vech_to_tri(vals, nc):
    """Lower-triangular (C, nc, nc) from its column-major vech entries
    (a list of (C,) tensors)."""
    zero = torch.zeros_like(vals[0])
    entry = {}
    k = 0
    for ci in range(nc):
        for ri in range(ci, nc):
            entry[ri, ci] = vals[k]
            k += 1
    return torch.stack([torch.stack([entry.get((ri, ci), zero)
                                     for ci in range(nc)], -1)
                        for ri in range(nc)], -2)


def _sqrt_1m_sq(rho_log, j):
    """sqrt(1 - (2 rho_j - 1)^2) = 2 sqrt(rho_j (1 - rho_j)), from the logs
    of rho_j and 1 - rho_j."""
    return 2.0 * torch.exp(0.5 * (rho_log[0][:, j] + rho_log[1][:, j]))


def make_theta_L(cfg: ParametricConfig, dispersion, tau, scale, zeta, rho,
                 rho_log, z_T):
    """Scaled onion-method Cholesky blocks (C, len_theta_L).

    dispersion (C,), tau (C, t), scale t floats, zeta (C, len_concentration),
    rho (C, len_rho) with rho_log = (log rho, log(1 - rho)), z_T (C,
    len_z_T).  sqrt(1 - (2 rho - 1)^2) is taken as 2 exp((log rho +
    log(1 - rho)) / 2) and sqrt(1 - rho) as exp(log(1 - rho) / 2): in
    float32 a correlation rounded to -1 or 1 would otherwise make theta_L
    singular."""
    theta_L = []
    zeta_mark = rho_mark = z_T_mark = 0
    for i, nc in enumerate(cfg.p):
        if nc == 1:
            theta_L.append(tau[:, i] * scale[i] * dispersion)
            continue
        trace_T_i = (tau[:, i] * scale[i] * dispersion) ** 2 * nc
        pi_seg = zeta[:, zeta_mark: zeta_mark + nc]
        pi_seg = pi_seg / pi_seg.sum(-1, keepdim=True)
        zeta_mark += nc
        T = [[None] * nc for _ in range(nc)]
        std_dev = torch.sqrt(pi_seg[:, 0] * trace_T_i)
        T[0][0] = std_dev
        std_dev = torch.sqrt(pi_seg[:, 1] * trace_T_i)
        T21 = 2.0 * rho[:, rho_mark] - 1.0
        T[1][1] = std_dev * _sqrt_1m_sq(rho_log, rho_mark)
        rho_mark += 1
        T[1][0] = std_dev * T21
        for r in range(1, nc - 1):
            T_row = z_T[:, z_T_mark: z_T_mark + r + 1]
            z_T_mark += r + 1
            scale_factor = (torch.sqrt(rho[:, rho_mark]
                                       / (T_row * T_row).sum(-1)) * std_dev)
            std_dev = torch.sqrt(pi_seg[:, r + 1] * trace_T_i)
            for ci in range(r + 1):
                T[r + 1][ci] = T_row[:, ci] * scale_factor
            T[r + 1][r + 1] = (torch.exp(0.5 * rho_log[1][:, rho_mark])
                               * std_dev)
            rho_mark += 1
        for ci in range(nc):
            for ri in range(ci, nc):
                theta_L.append(T[ri][ci])
    if not theta_L:
        return dispersion.new_zeros((dispersion.shape[0], 0))
    return torch.stack(theta_L, -1)


def make_theta_L_lkj(cfg: ParametricConfig, sds, rho, rho_log, z_T):
    """Cholesky blocks (C, len_theta_L) under the lkj covariance prior:
    diag(sds_i) times the correlation Cholesky of the same onion
    recursion (the rho beta ladder with shape ``regularization`` is the
    LKJ onion sampler).  The dispersion is not folded in: sds are in
    response units.  sds (C, sum p), rho (C, len_rho) and rho_log (as in
    ``make_theta_L``), z_T (C, len_z_T)."""
    theta_L = []
    sd_mark = rho_mark = z_T_mark = 0
    for nc in cfg.p:
        if nc == 1:
            theta_L.append(sds[:, sd_mark])
            sd_mark += 1
            continue
        sd_seg = sds[:, sd_mark: sd_mark + nc]
        sd_mark += nc
        T = [[None] * nc for _ in range(nc)]
        T[0][0] = sd_seg[:, 0]
        T21 = 2.0 * rho[:, rho_mark] - 1.0
        T[1][1] = sd_seg[:, 1] * _sqrt_1m_sq(rho_log, rho_mark)
        rho_mark += 1
        T[1][0] = sd_seg[:, 1] * T21
        for r in range(1, nc - 1):
            T_row = z_T[:, z_T_mark: z_T_mark + r + 1]
            z_T_mark += r + 1
            scale_factor = (torch.sqrt(rho[:, rho_mark]
                                       / (T_row * T_row).sum(-1))
                            * sd_seg[:, r + 1])
            for ci in range(r + 1):
                T[r + 1][ci] = T_row[:, ci] * scale_factor
            T[r + 1][r + 1] = (torch.exp(0.5 * rho_log[1][:, rho_mark])
                               * sd_seg[:, r + 1])
            rho_mark += 1
        for ci in range(nc):
            for ri in range(ci, nc):
                theta_L.append(T[ri][ci])
    if not theta_L:
        return sds.new_zeros((sds.shape[0], 0))
    return torch.stack(theta_L, -1)


def _term_factors(cfg: ParametricConfig, theta_L):
    """Per random-effect term: (nc, theta (C,)) for nc == 1, else (nc,
    T (C, nc, nc) lower triangular)."""
    out = []
    mark = 0
    for nc in cfg.p:
        if nc == 1:
            out.append((nc, theta_L[:, mark]))
            mark += 1
        else:
            n_tri = nc + math.comb(nc, 2)
            vals = [theta_L[:, mark + k] for k in range(n_tri)]
            out.append((nc, _vech_to_tri(vals, nc)))
            mark += n_tri
    return out


def make_b(cfg: ParametricConfig, z_b, theta_L):
    """b = blockdiag(T_i x I_{l_i}) z_b, level-major within each term."""
    out = []
    b_mark = 0
    for (nc, fac), li in zip(_term_factors(cfg, theta_L), cfg.l):
        if nc == 1:
            out.append(z_b[:, b_mark: b_mark + li] * fac[:, None])
            b_mark += li
        else:
            zseg = z_b[:, b_mark: b_mark + nc * li].reshape(-1, li, nc)
            out.append((zseg @ fac.transpose(-1, -2)).reshape(-1, li * nc))
            b_mark += nc * li
    if not out:
        return z_b.new_zeros((z_b.shape[0], 0))
    return torch.cat(out, -1)


def decov_delta(cfg: ParametricConfig, concentration: np.ndarray):
    """delta vector for the zeta ~ gamma(delta, 1) prior."""
    delta = []
    pos = 0
    for nc in cfg.p:
        if nc > 1:
            for _ in range(nc):
                delta.append(concentration[pos])
                pos += 1
    return np.asarray(delta)


class ParametricModel:
    """Static structure + iteration-constant data on one device; exposes
    the batched ``log_prob(u, offset_, y)`` and the draw accessors."""

    def __init__(self, cfg: ParametricConfig, X, z_structs, hyper,
                 weights=None, dtype=torch.float64, device="cuda"):
        """z_structs: list of (lhs (N, p_i), group_idx (N,)) per term."""
        self.cfg = cfg
        self.layout = ParamLayout(cfg)
        self.dtype = dtype
        self.device = resolve_device(device)

        def T(x):
            return torch.as_tensor(np.asarray(x, dtype=np.float64),
                                   dtype=dtype, device=self.device)

        self.X = T(X)
        self.z_structs = [
            (T(lhs), torch.as_tensor(np.asarray(gidx), dtype=torch.long,
                                     device=self.device))
            for lhs, gidx in z_structs
        ]
        self.weights = T(weights) if cfg.has_weights else None
        # observation sharding (parallel/mesh.py): when set, X / z_structs
        # / weights / gram_A / gram_AW hold this rank's shard of the rows
        # and every likelihood sum is all-reduced over the data group by
        # ``obs_axis.sum``; cfg.N stays the global count (it enters only
        # normalizing constants), N_rows is the local row count
        self.obs_axis = None
        self.N_rows = self.X.shape[0]
        self.hyper_np = dict(hyper)
        self.hyper = {
            k: (T(v) if isinstance(v, (np.ndarray, list, float, int))
                and not isinstance(v, bool) else v)
            for k, v in hyper.items()
        }
        self.b_offsets = []
        off = 0
        for pi, li in zip(cfg.p, cfg.l):
            self.b_offsets.append(off)
            off += pi * li
        self.scale_decov = [float(v) for v in
                            np.atleast_1d(hyper.get("scale_decov", []))]
        # prior-term shapes as device tensors, made once (the rho beta
        # ladder of every term concatenated in block order)
        rho_a, rho_b = [], []
        reg_mark = 0
        for nc in cfg.p:
            if nc > 1:
                reg = float(hyper["regularization"][reg_mark])
                reg_mark += 1
                rho_a.append(reg + 0.5 * (nc - 2))
                rho_b.append(reg + 0.5 * (nc - 2))
                nu_run = reg + 0.5 * (nc - 2)
                for j in range(2, nc):
                    nu_run = nu_run - 0.5
                    rho_a.append(0.5 * j)
                    rho_b.append(nu_run)
        # the default prior terms' normalizing constants, summed once on
        # the host; the per-call terms below keep only what depends on
        # the parameters.  The other families' terms carry their own.
        lg = math.lgamma
        n_std_normal = cfg.len_z_T
        if cfg.z_beta_dim > 0 and cfg.prior_dist > 0:
            n_std_normal += cfg.z_beta_dim
        if cfg.q > 0 and not cfg.centered:
            n_std_normal += cfg.q
        const = -n_std_normal * dists._LOG_SQRT_2PI
        const += sum(lg(a + b) - lg(a) - lg(b) for a, b in zip(rho_a, rho_b))
        delta = np.asarray(hyper.get("delta", []), np.float64)
        shape = np.asarray(hyper.get("shape_decov", []), np.float64)
        if cfg.q > 0 and cfg.cov_prior == 0:
            const -= sum(lg(a) for a in delta) + sum(lg(a) for a in shape)
        if self._aux_prior() == 1:
            const -= dists._LOG_SQRT_2PI + _LOG_HALF
        self._prior_const = const
        self._prior_shapes_m1 = (T(np.asarray(rho_a) - 1.0),
                                 T(np.asarray(rho_b) - 1.0),
                                 T(delta - 1.0), T(shape - 1.0))

    def _aux_prior(self) -> int:
        """The aux prior family that enters the density (0 = none)."""
        cfg = self.cfg
        if (cfg.is_binary or cfg.prior_dist_for_aux == 0
                or float(self.hyper_np["prior_scale_for_aux"]) <= 0):
            return 0
        return cfg.prior_dist_for_aux

    @property
    def num_upars(self) -> int:
        return self.layout.num_upars

    def _psum(self, *xs):
        """The tensors ``xs`` summed over the observation shards in one
        all-reduce (unchanged when not sharded); one tensor for one."""
        if self.obs_axis is None:
            return xs[0] if len(xs) == 1 else xs
        flat = self.obs_axis.sum(torch.cat([x.reshape(-1) for x in xs]))
        out, off = [], 0
        for x in xs:
            out.append(flat[off: off + x.numel()].reshape(x.shape))
            off += x.numel()
        return out[0] if len(out) == 1 else tuple(out)

    # -- transformed parameters ---------------------------------------------

    def _aux(self, c):
        cfg, h = self.cfg, self.hyper
        au = c["aux_unscaled"][:, 0]
        if cfg.prior_dist_for_aux == 0:
            return au
        aux = float(h["prior_scale_for_aux"]) * au
        if cfg.prior_dist_for_aux <= 2:
            aux = aux + float(h["prior_mean_for_aux"])
        return aux

    def _empty(self, c):
        C = next(iter(c.values())).shape[0] if c else 1
        return torch.zeros((C, 0), dtype=self.dtype, device=self.device)

    def transformed(self, c):
        """-> dict(aux (C,), beta (C, K), theta_L (C, L), b (C, q))."""
        cfg, h = self.cfg, self.hyper
        C = next(iter(c.values())).shape[0]
        aux = (torch.ones(C, dtype=self.dtype, device=self.device)
               if cfg.is_binary else self._aux(c))
        beta = (compute_beta(cfg, c, h, aux) if cfg.K > 0
                else self._empty(c))
        get = lambda n: c.get(n, self._empty(c))  # noqa: E731
        rho_log = (get("rho_log"), get("rho_log1m"))
        if cfg.cov_prior == 1:
            theta_L = make_theta_L_lkj(cfg, get("sds"), get("rho"), rho_log,
                                       get("z_T"))
        else:
            theta_L = make_theta_L(cfg, aux, get("tau"), self.scale_decov,
                                   get("zeta"), get("rho"), rho_log,
                                   get("z_T"))
        b = (get("b_raw") if cfg.centered
             else make_b(cfg, get("z_b"), theta_L))
        return dict(aux=aux, beta=beta, theta_L=theta_L, b=b)

    # -- linear predictor pieces --------------------------------------------

    def eta_fixed(self, beta):
        """X beta per chain: (C, N)."""
        return beta @ self.X.T

    def eta_random(self, b):
        """Z b per chain (C, N), by group-index gather; unseen levels
        (group index -1) contribute nothing."""
        eta = b.new_zeros((b.shape[0], self.X.shape[0]))
        for (lhs, gidx), off, pi, li in zip(
                self.z_structs, self.b_offsets, self.cfg.p, self.cfg.l):
            b_mat = b[:, off: off + pi * li].reshape(-1, li, pi)
            per_obs = b_mat[:, gidx.clamp(min=0), :]            # (C, N, p)
            per_obs = torch.where((gidx >= 0)[None, :, None], per_obs, 0.0)
            eta = eta + (lhs[None] * per_obs).sum(-1)
        return eta

    def parametric_mean(self, c, tp, include_fixed=True,
                        include_random=True):
        """eta_param = X beta + Z b per chain, (C, N); the flags leave a
        component out.  The model has no intercept (BART carries the
        level), so there is no gamma term."""
        assert "gamma" not in c, "the parametric block has no intercept"
        beta = tp["beta"]
        eta = (self.eta_fixed(beta) if include_fixed
               else beta.new_zeros((beta.shape[0], self.X.shape[0])))
        if include_random and self.cfg.q > 0:
            eta = eta + self.eta_random(tp["b"])
        return eta

    # -- log posterior --------------------------------------------------------

    def log_prob(self, u, offset_, y):
        """Full log-posterior of each chain's unconstrained vector
        (C, D), with constraint Jacobians: (C,)."""
        cfg = self.cfg
        c, log_jac = self.layout.constrain(u)
        tp = self.transformed(c)
        eta = offset_ + self.parametric_mean(c, tp)
        aux = tp["aux"]
        if self.obs_axis is not None:
            # the local quadratic, one all-reduce, the global N; forward
            # only (NUTS differentiates the Gram form instead)
            r = y - eta
            quad = self._psum((r * r * self.weights).sum(-1)
                              if cfg.has_weights else (r * r).sum(-1))
            lp = (-0.5 * cfg.N * torch.log(2.0 * math.pi * aux * aux)
                  - 0.5 * quad / (aux * aux))
        elif not cfg.has_weights:
            lp = dists.normal_lpdf(y, eta, aux[:, None])
        else:
            lp = (-0.5 * cfg.N * torch.log(2.0 * math.pi * aux * aux)
                  - 0.5 * (self.weights * (y - eta) ** 2).sum(-1)
                  / (aux * aux))
        return lp + self._prior_lp(c, tp) + log_jac

    def _prior_lp(self, c, tp):
        """Every prior term of the model block (N-independent): the
        coefficient prior of its family, the standard-normal z blocks (or
        the centered MVN prior on b), the onion beta ladder on rho, the
        decov gammas on zeta and tau or the lkj half-t sds, and the aux
        prior.  The default terms' normalizing constants are summed once
        in ``_prior_const``."""
        cfg, h, hn = self.cfg, self.hyper, self.hyper_np
        rho_a1, rho_b1, delta1, shape1 = self._prior_shapes_m1
        lp = self._prior_const

        aux_prior = self._aux_prior()
        if aux_prior:
            au = c["aux_unscaled"][:, 0]
            if aux_prior == 1:
                lp = lp - 0.5 * au * au
            elif aux_prior == 2:
                lp = lp + dists.student_t_lpdf(
                    c["aux_unscaled"],
                    float(hn["prior_df_for_aux"])) - _LOG_HALF
            else:
                lp = lp - au

        def sq(name):
            x = c[name]
            return 0.5 * (x * x).sum(-1)

        # coefficient priors; an empty z_beta leaves the block out
        pd = cfg.prior_dist if cfg.z_beta_dim > 0 else 0
        if pd > 0:
            lp = lp - sq("z_beta")
        if pd in (3, 4):
            C = c["local"].shape[0]
            loc = c["local"].reshape(C, cfg.hs, cfg.K)
            glob = c["global"]
            half_df = 0.5 * h["prior_df"]
            lp = lp + dists.normal_lpdf(loc[:, 0]) - cfg.K * _LOG_HALF
            lp = lp + dists.inv_gamma_lpdf(loc[:, 1], half_df, half_df)
            if pd == 4:
                # hs_plus's second df rides in the prior_scale slot
                half_df2 = 0.5 * h["prior_scale"]
                lp = lp + dists.normal_lpdf(loc[:, 2]) - cfg.K * _LOG_HALF
                lp = lp + dists.inv_gamma_lpdf(loc[:, 3], half_df2,
                                               half_df2)
            lp = lp + dists.normal_lpdf(glob[:, :1]) - _LOG_HALF
            g_df = 0.5 * float(hn["global_prior_df"])
            lp = lp + dists.inv_gamma_lpdf(glob[:, 1:2], g_df, g_df)
            s_df = 0.5 * float(hn["slab_df"])
            lp = lp + dists.inv_gamma_lpdf(c["caux"], s_df, s_df)
        elif pd in (5, 6):
            lp = lp + dists.exponential_lpdf(c["mix"])
            if pd == 6:
                lp = lp + dists.chi_square_lpdf(
                    c["one_over_lambda"],
                    float(np.asarray(hn["prior_df"]).reshape(-1)[0]))
        elif pd == 8:
            # R2 ~ Beta(K/2, eta); the unit-interval Jacobian is in log_jac
            lp = lp + dists.beta_lpdf(c["R2"], 0.5 * cfg.K,
                                      float(hn["R2_eta"]))

        if cfg.q > 0:
            if cfg.centered:
                lp = lp + self._centered_b_lpdf(c["b_raw"], tp["theta_L"])
            else:
                lp = lp - sq("z_b")
            if cfg.len_z_T > 0:
                lp = lp - sq("z_T")
            if cfg.len_rho > 0:
                lp = lp + (rho_a1 * c["rho_log"]
                           + rho_b1 * c["rho_log1m"]).sum(-1)
            if cfg.cov_prior == 1:
                # lkj: sds ~ half-Student-t(df, 0, scale) per term
                sd_mark = 0
                for i, nc in enumerate(cfg.p):
                    seg = c["sds"][:, sd_mark: sd_mark + nc]
                    sd_mark += nc
                    lp = lp + dists.student_t_lpdf(
                        seg, float(hn["lkj_df"][i]), 0.0,
                        float(hn["lkj_scale"][i])) + nc * _LOG_2
            else:
                if cfg.len_concentration > 0:
                    zeta = c["zeta"]
                    lp = lp + (delta1 * torch.log(zeta) - zeta).sum(-1)
                tau = c["tau"]
                lp = lp + (shape1 * torch.log(tau) - tau).sum(-1)
        return lp + torch.zeros_like(tp["aux"])

    def _centered_b_lpdf(self, b, theta_L):
        """Sum over terms and levels of MVN(b_level | 0, T_i T_i'), T_i
        the lower-triangular blocks of theta_L: (C,)."""
        cfg = self.cfg
        lp = b.new_zeros(b.shape[0])
        b_mark = 0
        for (nc, fac), li in zip(_term_factors(cfg, theta_L), cfg.l):
            if nc == 1:
                z = b[:, b_mark: b_mark + li] / fac[:, None]
                lp = lp + (-0.5 * z * z).sum(-1) \
                    - li * (torch.log(torch.abs(fac)) + dists._LOG_SQRT_2PI)
                b_mark += li
            else:
                seg = b[:, b_mark: b_mark + nc * li].reshape(-1, li, nc)
                w = torch.linalg.solve_triangular(
                    fac, seg.transpose(-1, -2), upper=False)
                logdet = torch.log(torch.abs(
                    torch.diagonal(fac, dim1=-2, dim2=-1))).sum(-1)
                lp = lp + (-0.5 * w * w).sum((-1, -2)) \
                    - li * (logdet + nc * dists._LOG_SQRT_2PI)
                b_mark += nc * li
        return lp

    # -- Gram-compressed likelihood (NUTS hot loop, O(D^2) per leapfrog) --

    def dense_design(self) -> np.ndarray:
        """Host-side dense design A (N, D), columns [beta | b] so that
        eta - offset = A @ v (b columns in make_b's flat layout)."""
        cfg = self.cfg
        N = cfg.N
        cols = []
        if cfg.K > 0:
            cols.append(self.X.double().cpu().numpy())
        for (lhs, gidx), pi, li in zip(self.z_structs, cfg.p, cfg.l):
            lhs = lhs.double().cpu().numpy()
            gidx = gidx.cpu().numpy()
            Z = np.zeros((N, li * pi))
            valid = gidx >= 0
            rows = np.arange(N)[valid]
            for j in range(pi):
                Z[rows, gidx[valid] * pi + j] = lhs[valid, j]
            cols.append(Z)
        if not cols:
            return np.zeros((N, 0))
        return np.concatenate(cols, axis=1)

    def enable_gram(self) -> bool:
        """Precompute A, A' W and G = A' W A (f64 on the host, then cast).
        False when the model has no linear coefficients."""
        if getattr(self, "_gram_ready", False):
            return True
        A = self.dense_design()
        if A.shape[1] == 0:
            return False
        AW = (A * self.weights.double().cpu().numpy()[:, None]
              if self.cfg.has_weights else A)
        cast = lambda a: torch.as_tensor(a, dtype=self.dtype,  # noqa: E731
                                         device=self.device)
        self.gram_A = cast(A)
        self.gram_AW = self.gram_A if AW is A else cast(AW)
        self.gram_G = cast(A.T @ AW)
        self._gram_ready = True
        return True

    def _coef_vector(self, c, tp):
        """v = [beta | b] per chain, matching dense_design's columns."""
        parts = []
        if self.cfg.K > 0:
            parts.append(tp["beta"])
        if self.cfg.q > 0:
            parts.append(tp["b"])
        return torch.cat(parts, -1) if parts else self._empty(c)

    def gram_anchor(self, u, offset_, y):
        """Per-iteration sufficient statistics of the gaussian likelihood
        anchored at the current draws: (v_hat (C, D), rr (C,), g (C, D))
        with rr = ||y - offset - A v_hat||_W^2 and g = A' W r_hat."""
        with torch.no_grad():
            c, _ = self.layout.constrain(u)
            tp = self.transformed(c)
            vhat = self._coef_vector(c, tp)
            r = y - (offset_ + vhat @ self.gram_A.T)
            rw = r * self.weights if self.cfg.has_weights else r
            rr = (r * rw).sum(-1)
            g = r @ self.gram_AW
            # observation-sharded: one all-reduce carries the likelihood
            # into every leapfrog of the iteration
            rr, g = self._psum(rr, g)
        return vhat, rr, g

    def log_prob_gram(self, u, anchor):
        """``log_prob`` with the likelihood from the anchored statistics:
        ||y_eff - A v||_W^2 = rr - 2 d'g + d'Gd, d = v - v_hat — O(D^2)
        per evaluation."""
        cfg = self.cfg
        vhat, rr, g = anchor
        c, log_jac = self.layout.constrain(u)
        tp = self.transformed(c)
        aux = tp["aux"]
        d = self._coef_vector(c, tp) - vhat
        quad = (rr - 2.0 * (d * g).sum(-1)
                + (d * (d @ self.gram_G)).sum(-1))
        lp = (-0.5 * cfg.N * torch.log(2.0 * math.pi * aux * aux)
              - 0.5 * quad / (aux * aux))
        return lp + self._prior_lp(c, tp) + log_jac

    # -- exact conjugate refresh of the linear block ----------------------

    def enable_linear_gibbs(self) -> bool:
        """Eligibility + setup for ``linear_gibbs_refresh``: normal or
        flat coefficient priors and the Gram structures."""
        if getattr(self, "_lg_ready", False):
            return True
        cfg = self.cfg
        if cfg.K > 0 and cfg.prior_dist not in (0, 1):
            return False
        if not self.enable_gram():
            return False
        D = self.gram_G.shape[0]
        mu = np.zeros(D)
        prec = np.zeros(D)
        if cfg.K > 0 and cfg.prior_dist == 1:
            h = self.hyper_np
            s = np.broadcast_to(np.asarray(h["prior_scale"], np.float64)
                                .reshape(-1), (cfg.K,))
            if np.any(s <= 0):
                return False
            mu[: cfg.K] = np.broadcast_to(
                np.asarray(h["prior_mean"], np.float64).reshape(-1),
                (cfg.K,))
            prec[: cfg.K] = 1.0 / (s * s)
        self._lg_mu = torch.as_tensor(mu, dtype=self.dtype,
                                      device=self.device)
        self._lg_prec_head = torch.as_tensor(prec, dtype=self.dtype,
                                             device=self.device)
        self._lg_ready = True
        return True

    def linear_gibbs_refresh(self, u, offset_, y, gen=None, z=None):
        """One exact draw per chain from the full conditional of
        v = [beta | b] given (aux, theta_L, offset_, y), written back
        into the unconstrained vectors:

            Q  = G / aux^2 + P(theta_L)
            d* = Q^{-1} (g / aux^2 - P (v_hat - mu))
            v  = v_hat + d* + L^{-T} z,   L = chol(Q),  z ~ N(0, I_D)

        Q is formed and factored in float64.  A chain whose Q still does
        not factor, or whose draw is not finite (a theta_L singular in
        float32, as an unconstrained correlation past |u| of about 200
        makes it), keeps its coefficients: both depend only on (aux, theta_L), which this draw
        leaves alone, so the skip is a state-dependent choice between two
        kernels that both leave the posterior invariant (the JAX
        package's Cholesky gives that chain NaN).

        z: optional (C, D) standard normals replacing the draw."""
        cfg = self.cfg
        with torch.no_grad():
            c, _ = self.layout.constrain(u)
            tp = self.transformed(c)
            aux = tp["aux"]
            vhat = self._coef_vector(c, tp)
            C, D = vhat.shape
            r = y - (offset_ + vhat @ self.gram_A.T)
            rw = r * self.weights if cfg.has_weights else r
            g = self._psum(rw @ self.gram_A)

            P = torch.diag_embed(self._lg_prec_head.expand(C, D)).clone()
            col = cfg.K
            term_tinv = []
            for (nc, fac), li in zip(_term_factors(cfg, tp["theta_L"]),
                                     cfg.l):
                if nc == 1:
                    idx = torch.arange(col, col + li, device=self.device)
                    P[:, idx, idx] += (1.0 / (fac * fac))[:, None]
                    term_tinv.append(1.0 / fac)
                    col += li
                else:
                    eye = torch.eye(nc, dtype=self.dtype, device=self.device)
                    Tinv = torch.linalg.solve_triangular(
                        fac, eye.expand(C, nc, nc), upper=False)
                    term_tinv.append(Tinv)
                    Pi = Tinv.transpose(-1, -2) @ Tinv
                    eye_l = torch.eye(li, dtype=self.dtype,
                                      device=self.device)
                    Pb = torch.einsum("ij,cab->ciajb", eye_l, Pi).reshape(
                        C, li * nc, li * nc)
                    P[:, col: col + li * nc, col: col + li * nc] += Pb
                    col += li * nc

            # the system in float64: where the Gram matrix is singular (the
            # intercept columns of crossed terms are collinear) only P
            # holds Q's null directions, and a wide prior's P is below
            # float32 rounding of G
            f64 = torch.float64
            inv_aux2 = (1.0 / (aux * aux)).to(f64)[:, None]
            P = P.to(f64)
            Q = self.gram_G.to(f64) * inv_aux2[:, :, None] + P
            rhs = g.to(f64) * inv_aux2 - (P @ (vhat - self._lg_mu).to(f64)
                                          [:, :, None])[..., 0]
            L, info = torch.linalg.cholesky_ex(Q)
            d_mean = torch.cholesky_solve(rhs[:, :, None], L)[..., 0]
            if z is None:
                z = torch.randn((C, D), generator=gen, dtype=self.dtype,
                                device=self.device)
            d = d_mean + torch.linalg.solve_triangular(
                L.transpose(-1, -2), z.to(f64)[:, :, None],
                upper=True)[..., 0]
            v_new = (vhat + d).to(self.dtype)

            u_in, u = u, u.clone()
            if cfg.K > 0:
                beta_new = v_new[:, : cfg.K]
                if cfg.prior_dist == 1:
                    zb = ((beta_new - self.hyper["prior_mean"])
                          / self.hyper["prior_scale"])
                else:
                    zb = beta_new
                off = self.layout.slices["z_beta"][0]
                u[:, off: off + cfg.K] = zb
            if cfg.q > 0 and cfg.centered:
                off = self.layout.slices["b_raw"][0]
                u[:, off: off + cfg.q] = v_new[:, cfg.K:]
            elif cfg.q > 0:
                b_new = v_new[:, cfg.K:]
                parts = []
                b_mark = 0
                for (nc, li), tinv in zip(zip(cfg.p, cfg.l), term_tinv):
                    if nc == 1:
                        parts.append(b_new[:, b_mark: b_mark + li]
                                     * tinv[:, None])
                        b_mark += li
                    else:
                        b_mat = b_new[:, b_mark: b_mark + nc * li].reshape(
                            C, li, nc)
                        parts.append((b_mat @ tinv.transpose(-1, -2))
                                     .reshape(C, -1))
                        b_mark += nc * li
                off = self.layout.slices["z_b"][0]
                u[:, off: off + cfg.q] = torch.cat(parts, -1)
        ok = (info == 0) & torch.isfinite(u).all(-1)
        return torch.where(ok[:, None], u, u_in)

    def initial_inv_mass(self, scale_y: float, n_obs: int) -> np.ndarray:
        """Analytic initial diagonal inverse metric: early-chain UPPER
        bounds on the posterior scales of the unconstrained coordinates."""
        cfg = self.cfg
        out = np.ones(self.num_upars)
        prior_scale = np.asarray(self.hyper_np["prior_scale"], np.float64)
        safety = 4.0
        for name, size, _ in self.layout.blocks:
            off = self.layout.slices[name][0]
            if name == "z_beta" and cfg.prior_dist in (1, 2) and cfg.K > 0:
                X = self.X.double().cpu().numpy()
                sd_x = np.maximum(np.std(X, axis=0), 1e-8)
                beta_sd = safety * scale_y / (sd_x * np.sqrt(n_obs))
                out[off: off + size] = (beta_sd / prior_scale) ** 2
            elif name == "aux_unscaled" and not cfg.is_binary:
                out[off] = safety ** 2 / (2.0 * n_obs)
            elif name == "b_raw":
                # centered b: the marginal prior sd is about tau scale
                # sigma; over-wide is safe, adaptation shrinks it
                out[off: off + size] = max(float(scale_y), 1.0) ** 2
        return out

    # -- output packaging -----------------------------------------------------

    def constrained_draw(self, u):
        """(C, S) constrained draws: upars then aux, beta, b, theta_L."""
        c, _ = self.layout.constrain(u)
        tp = self.transformed(c)
        parts = [c[name] for name, _, _ in self.layout.blocks]
        if not self.cfg.is_binary:
            parts.append(tp["aux"][:, None])
        if self.cfg.K > 0:
            parts.append(tp["beta"])
        if self.cfg.q > 0:
            parts.append(tp["b"])
            parts.append(tp["theta_L"])
        return torch.cat(parts, -1)

    def constrained_names(self) -> list[str]:
        names = []

        def push(base, n):
            names.extend(f"{base}.{i + 1}" for i in range(n))

        for name, size, _ in self.layout.blocks:
            push(name, size)
        if not self.cfg.is_binary:
            push("aux", 1)
        if self.cfg.K > 0:
            push("beta", self.cfg.K)
        if self.cfg.q > 0:
            push("b", self.cfg.q)
            push("theta_L", self.cfg.len_theta_L)
        return names

    def prior_draw_unconstrained(self, rng: np.random.Generator,
                                 n_draws: int = 1):
        """Draws (n_draws, D) of the UNCONSTRAINED vector from the model's
        prior, block by block (the generative complement of ``_prior_lp``;
        for simulation-based calibration).  Supports the normal /
        Student-t / product-normal / R2 coefficient priors and
        non-centered random effects under decov or lkj; raises for the
        flat priors, which are not generative, for hs and laplace, and
        for the centered parameterization.  ``rng`` is a numpy
        Generator."""
        cfg, h = self.cfg, self.hyper_np
        if cfg.z_beta_dim > 0 and cfg.prior_dist not in (1, 2, 7, 8):
            raise NotImplementedError(
                f"prior_draw: coefficient prior_dist {cfg.prior_dist} "
                "(flat/hs/laplace) is not supported")
        if not cfg.is_binary and cfg.prior_dist_for_aux == 0:
            raise NotImplementedError("prior_draw: flat aux prior")
        if cfg.centered:
            raise NotImplementedError(
                "prior_draw: centered ranef (draw non-centered and "
                "transform)")

        def logit(p):
            return np.log(p) - np.log1p(-p)

        parts = []
        for name, size, _ in self.layout.blocks:
            shape = (n_draws, size)
            if name in ("z_beta", "z_b", "z_T"):
                v = rng.standard_normal(shape)
            elif name == "R2":
                v = logit(rng.beta(0.5 * cfg.K, float(h["R2_eta"]),
                                   size=shape))
            elif name == "rho":
                s1, s2 = [], []
                reg_mark = 0
                for nc in cfg.p:
                    if nc > 1:
                        reg = float(h["regularization"][reg_mark])
                        reg_mark += 1
                        s1.append(reg + 0.5 * (nc - 2))
                        s2.append(reg + 0.5 * (nc - 2))
                        nu_run = reg + 0.5 * (nc - 2)
                        for j in range(2, nc):
                            nu_run = nu_run - 0.5
                            s1.append(0.5 * j)
                            s2.append(nu_run)
                v = logit(rng.beta(s1, s2, size=shape))
            elif name == "zeta":
                v = np.log(rng.gamma(np.asarray(h["delta"]), size=shape))
            elif name == "tau":
                v = np.log(rng.gamma(np.asarray(h["shape_decov"]),
                                     size=shape))
            elif name == "sds":
                # half-Student-t(df, 0, scale) per term coefficient
                term = np.concatenate([[i] * nc for i, nc in
                                       enumerate(cfg.p)]).astype(int)
                dfs = np.asarray(h["lkj_df"], np.float64)[term]
                scales = np.asarray(h["lkj_scale"], np.float64)[term]
                v = np.log(scales * np.abs(rng.standard_t(dfs, size=shape)))
            elif name == "aux_unscaled":
                if cfg.prior_dist_for_aux == 1:
                    a = np.abs(rng.standard_normal(shape))
                elif cfg.prior_dist_for_aux == 2:
                    a = np.abs(rng.standard_t(h["prior_df_for_aux"],
                                              size=shape))
                else:
                    a = rng.exponential(size=shape)
                v = np.log(a)
            else:
                raise NotImplementedError(f"prior_draw: block {name}")
            parts.append(v)
        return torch.as_tensor(np.concatenate(parts, axis=1),
                               dtype=self.dtype, device=self.device)
