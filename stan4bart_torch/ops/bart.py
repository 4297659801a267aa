"""BART sum-of-trees Gibbs sweep over heap-array trees, batched over chains.

PyTorch counterpart of ``stan4bart_tpu/ops/bart.py`` (same model: the
CGM'98 tree prior ``p(split at depth d) = base (1 + d)^-power`` with
``split_probs`` variable weights and uniform cutpoints, conjugate normal
leaves ``mu ~ N(0, sigma_mu^2)``, grow/prune/change Metropolis-Hastings
with integrated-likelihood ratios, truncated-normal probit latents).

Trees are fixed-shape heap arrays: node ``i`` has children ``2i+1`` /
``2i+2``, ``feature == LEAF`` marks a leaf and ``INACTIVE`` an unused
slot.  Every array carries the chain as its leading dimension, where the
JAX package used ``vmap``; the sequential dependence over trees is a
Python loop.  Table lookups (child features, leaf values, cut ranks) are
plain indexing — the one-hot matrix products of the JAX package exist
only for the TPU's matrix unit.

The subtree-regrow move (``_subtree_regrow``) runs in two places: inside
the sweep after each tree's grow/prune/change move with probability
``p_regrow`` (``tree_step``), and as random single-tree regrows appended
to a sweep (``regrow_refresh``, the JAX package's ``regrow_per_sweep``);
its per-node statistics are one-hot matrix products, so they sum in a
fixed order on the card.

Every random draw can be supplied by the caller (``variates=`` of
``bart_sweep`` and ``regrow_refresh``, ``u=`` of ``sample_probit_latents``
and ``sample_trees_from_prior``), so the port can be held against the JAX
package on identical randomness.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from stan4bart_torch.utils.device import resolve_device

class BartConfig(NamedTuple):
    num_trees: int = 75
    max_depth: int = 6
    n_cuts: int = 100
    power: float = 2.0
    base: float = 0.95
    p_grow: float = 0.25
    p_prune: float = 0.25
    # p_change = 1 - p_grow - p_prune
    node_scale: float = 0.5      # 3.0 for binary
    k_init: float = 2.0          # leaf-prior k (its start when sampled)
    # chi(df, scale) hyperprior on k; k_df = 0 keeps k fixed at k_init
    k_df: float = 0.0
    k_scale: float = float("inf")
    # fixed leaf-prior sd replacing the data-driven range scaling
    sigma_mu_fixed: float | None = None
    # random single-tree subtree regrows (with a leaf redraw) appended to
    # every sweep (``regrow_refresh``); 0 = off
    regrow_per_sweep: int = 0
    # probability of a subtree-regrow MH move after each tree's
    # grow/prune/change move, inside the sweep (``_subtree_regrow``);
    # 0 = off
    p_regrow: float = 0.0

    @property
    def max_nodes(self) -> int:
        return 2 ** (self.max_depth + 1) - 1


LEAF = -1
INACTIVE = -2

# heap slots of the CUDA sweep kernels' static builds: 128 (max_depth <=
# 6, max_nodes <= 127), 512 (max_depth 7 and 8) and 1024 (max_depth 9); a
# heap of pad slots holds max_nodes + 1 <= pad (the sharded kernel keeps
# a pair in slot M).  Deeper trees take 2 ** (max_depth + 1) slots, the
# kernels' heap builds
HEAP_PADS = (128, 512, 1024)


def node_pad(cfg: BartConfig) -> int:
    """Heap slots per tree row of the sweep's variates and kernels: 128
    up to max_depth 6, the smallest of ``HEAP_PADS`` that holds
    ``max_nodes + 1`` above that, and ``max_nodes + 1`` past the deepest
    (max_depth 10 and up: the kernels' heap builds)."""
    need = cfg.max_nodes + 1
    return next((p for p in HEAP_PADS if p >= need), need)


class BartState(NamedTuple):
    """Forest state of C chains; every leading dimension is the chain."""
    feature: torch.Tensor     # (C, T, M) int32: var index | LEAF | INACTIVE
    cut: torch.Tensor         # (C, T, M) int32 cut index
    leaf_value: torch.Tensor  # (C, T, M) float
    leaf_idx: torch.Tensor    # (C, T, N) int32 node each obs lands in
    allfit: torch.Tensor      # (C, N) float: sum of tree fits (no offset)
    k: torch.Tensor           # (C,) node-prior k
    sigma_mu: torch.Tensor    # (C,) current leaf prior sd
    tree_fit: torch.Tensor    # (C, T, N) per-tree fitted values


def make_cut_grid(X: np.ndarray, n_cuts: int) -> np.ndarray:
    """Per-feature uniform cut grids over the observed range (dbarts
    'uniform' rule)."""
    P = X.shape[1]
    cuts = np.zeros((P, n_cuts))
    for j in range(P):
        lo, hi = float(np.min(X[:, j])), float(np.max(X[:, j]))
        if hi <= lo:
            hi = lo + 1.0
        cuts[j] = lo + (hi - lo) * (np.arange(1, n_cuts + 1) / (n_cuts + 1))
    return cuts


def compute_ranks(X: np.ndarray, cuts: np.ndarray) -> np.ndarray:
    """rank[n, v] = first cut index with cuts[v, c] >= x[n, v]; an obs goes
    left of split (v, c) iff rank[n, v] <= c."""
    from stan4bart_torch.native import rank_matrix

    return rank_matrix(X, cuts)


def node_depths(cfg: BartConfig) -> np.ndarray:
    return np.floor(np.log2(np.arange(cfg.max_nodes) + 1)).astype(np.int32)


def split_prob_by_depth(cfg: BartConfig) -> np.ndarray:
    """p_split(d) = base (1+d)^-power, truncated to 0 at max_depth."""
    d = np.arange(cfg.max_depth + 2, dtype=np.float64)
    p = cfg.base * (1.0 + d) ** (-cfg.power)
    p[cfg.max_depth:] = 0.0
    return p


def _initial_sigma_mu(cfg: BartConfig) -> float:
    if cfg.sigma_mu_fixed is not None:
        return cfg.sigma_mu_fixed
    return cfg.node_scale / (cfg.k_init * np.sqrt(cfg.num_trees))


def bart_init(cfg: BartConfig, n_chains: int, n_obs: int,
              dtype=torch.float64, device="cuda") -> BartState:
    """All trees start as stumps (root leaf, value 0)."""
    C, T, M = n_chains, cfg.num_trees, cfg.max_nodes
    device = resolve_device(device)
    feature = torch.full((C, T, M), INACTIVE, dtype=torch.int32,
                         device=device)
    feature[:, :, 0] = LEAF
    return BartState(
        feature=feature,
        cut=torch.zeros((C, T, M), dtype=torch.int32, device=device),
        leaf_value=torch.zeros((C, T, M), dtype=dtype, device=device),
        leaf_idx=torch.zeros((C, T, n_obs), dtype=torch.int32,
                             device=device),
        allfit=torch.zeros((C, n_obs), dtype=dtype, device=device),
        k=torch.full((C,), cfg.k_init, dtype=dtype, device=device),
        sigma_mu=torch.full((C,), _initial_sigma_mu(cfg), dtype=dtype,
                            device=device),
        tree_fit=torch.zeros((C, T, n_obs), dtype=dtype, device=device),
    )


def walk_tree(feature, cut, ranks, max_depth: int):
    """Leaf membership of every observation: feature/cut (B, M) heap
    rows, ranks (N, P) -> (B, N) int64 node indices."""
    B = feature.shape[0]
    N, P = ranks.shape
    feature = feature.long()
    cut = cut.long()
    flat_ranks = ranks.reshape(-1).long()
    row_base = torch.arange(N, device=ranks.device) * P
    node = torch.zeros((B, N), dtype=torch.long, device=ranks.device)
    for _ in range(max_depth):
        f = torch.gather(feature, 1, node)
        c = torch.gather(cut, 1, node)
        rank_v = flat_ranks[row_base + f.clamp(min=0)]
        child = 2 * node + torch.where(rank_v <= c, 1, 2)
        node = torch.where(f >= 0, child, node)
    return node


def sample_trees_from_prior(cfg: BartConfig, gen, ranks, split_probs,
                            n_chains: int, dtype=torch.float64,
                            u=None) -> BartState:
    """Draw tree STRUCTURES from the CGM prior level by level (the
    reference's chain init): each active leaf splits with probability
    base (1+d)^-power, variable ~ split_probs, cutpoint uniform.  Leaf
    values start at 0 (sampled by the first sweep).

    u: optional (C, 3, T, M) uniforms replacing the draw."""
    C, T, M = n_chains, cfg.num_trees, cfg.max_nodes
    dev = ranks.device
    n_obs = ranks.shape[0]
    p_split = torch.as_tensor(split_prob_by_depth(cfg), dtype=dtype,
                              device=dev)
    depths = torch.as_tensor(node_depths(cfg), dtype=torch.long, device=dev)
    sp = torch.as_tensor(np.asarray(split_probs), dtype=dtype, device=dev)
    sp_cum = torch.cumsum(sp, 0)
    if u is None:
        u = torch.rand((C, 3, T, M), generator=gen, dtype=dtype, device=dev)
    else:
        u = torch.as_tensor(u, dtype=dtype, device=dev)
    want_split = u[:, 0] < p_split[depths]
    v = torch.searchsorted(sp_cum, u[:, 1].contiguous(), right=True)
    v = v.clamp(max=sp.shape[0] - 1)
    c = torch.floor(u[:, 2] * cfg.n_cuts).long().clamp(max=cfg.n_cuts - 1)

    feature = torch.full((C, T, M), INACTIVE, dtype=torch.long, device=dev)
    active = torch.zeros((C, T, M), dtype=torch.bool, device=dev)
    active[:, :, 0] = True
    for i in range((M - 1) // 2):
        is_internal = active[:, :, i] & want_split[:, :, i]
        active[:, :, 2 * i + 1] = is_internal
        active[:, :, 2 * i + 2] = is_internal
        feature[:, :, i] = torch.where(
            is_internal, v[:, :, i],
            torch.where(active[:, :, i], LEAF, INACTIVE))
    bottom = (M - 1) // 2
    feature[:, :, bottom:] = torch.where(active[:, :, bottom:], LEAF,
                                         INACTIVE)
    cut = torch.where(feature >= 0, c, 0)
    leaf_idx = walk_tree(feature.reshape(C * T, M), cut.reshape(C * T, M),
                         ranks, cfg.max_depth).reshape(C, T, n_obs)
    return BartState(
        feature=feature.to(torch.int32), cut=cut.to(torch.int32),
        leaf_value=torch.zeros((C, T, M), dtype=dtype, device=dev),
        leaf_idx=leaf_idx.to(torch.int32),
        allfit=torch.zeros((C, n_obs), dtype=dtype, device=dev),
        k=torch.full((C,), cfg.k_init, dtype=dtype, device=dev),
        sigma_mu=torch.full((C,), _initial_sigma_mu(cfg), dtype=dtype,
                            device=dev),
        tree_fit=torch.zeros((C, T, n_obs), dtype=dtype, device=dev),
    )


def _pick_marked(mask, count, u):
    """Per chain, the index of the target-th True entry of ``mask``
    (C, M), target = min(floor(u count), count - 1); 0 when none."""
    target = torch.floor(u * count.to(u.dtype)).long()
    target = torch.minimum(target, count - 1)
    csum = torch.cumsum(mask.long(), dim=1)
    return (csum > target[:, None]).int().argmax(dim=1)


def _leaf_marginal(n, s, sigma2, tau2):
    """0.5 log(sigma2/(sigma2 + n tau2)) + tau2 s^2 / (2 sigma2 (sigma2
    + n tau2)) — the integrated-likelihood terms that do not cancel."""
    denom = sigma2 + n * tau2
    return (0.5 * torch.log(sigma2 / denom)
            + tau2 * s * s / (2.0 * sigma2 * denom))


def tree_step(cfg: BartConfig, feature, cut, lidx, r, sigma2, tau2, u6, zn,
              ranks_t, spcum, depths, p_split, w=None, reduce=None,
              rg=None):
    """One grow/prune/change MH step, with ``rg`` a subtree-regrow MH
    step after it, and the conjugate leaf draws of one tree, for C chains
    at once.

    feature/cut (C, M) int64 heap rows, lidx (C, N) int64, r (C, N) the
    partial residual (response minus every other tree), sigma2/tau2 (C,),
    u6 (C, 6) proposal uniforms (move, leaf pick, NOG pick, variable,
    cut, accept), zn (C, >= M) leaf normals, ranks_t (P, N) int64,
    spcum (P,) split-prob cumsum, depths (M,) int64 node depths,
    p_split (max_depth + 2,) by depth, w (N,) optional likelihood
    weights (every statistic becomes (sum w, sum w r)).

    reduce: the observation-sharded form (the JAX package's
    ``_tree_move(axis_name=)``).  The observations here are one shard of
    the data, and ``reduce`` sums a (C, 2, M + 2) block over the shards
    (an all-reduce over the data group).  The tree update then does ONE
    reduction: the per-node (sum w, sum w r) of the current partition,
    the proposed-left pair and the proposed-right pair.  The other move
    statistics follow from the per-node sums, and the accepted
    partition's per-node sums are the current ones with the three nodes
    whose membership changes (eta, its children) set from the move's
    totals.  The right pair is summed, not taken as the move's total less
    the left pair as the JAX package takes it: with weights that
    difference can leave a rounding residue where no observation goes
    right, which passes the move's non-empty check.  The local sums are
    taken in float64 and rounded once, so they are the exact sums up to
    one rounding, as the sharded kernel's fixed-point sums are.

    rg: optional (C, 3 + 3 M) regrow variates (``draw_tree_regrow_variates``'
    row of this tree).  With it, after the move each chain whose gate
    rg[:, 0] < cfg.p_regrow opens tries a subtree regrow of the
    post-move tree (``_subtree_regrow``, the JAX package's per-tree
    ``p_regrow`` move), and the leaves are drawn from the statistics of
    the partition it leaves; sharded, that takes one more reduction,
    made only where some chain's gate opens.

    Returns (feature, cut, lidx, leaf_value (C, M), fit (C, N)).
    """
    C, M = feature.shape
    dev = feature.device
    dtype = r.dtype
    rows = torch.arange(C, device=dev)
    node_ids = torch.arange(M, device=dev)
    left_ids = (2 * node_ids + 1).clamp(max=M - 1)
    right_ids = (2 * node_ids + 2).clamp(max=M - 1)

    u_move, u_leaf, u_nog, u_var, u_cut, u_acc = u6.unbind(1)

    is_leaf = feature == LEAF
    is_internal = feature >= 0
    is_nog = (is_internal & (feature[:, left_ids] == LEAF)
              & (feature[:, right_ids] == LEAF))
    n_leaf = is_leaf.sum(1)
    n_nog = is_nog.sum(1)

    do_grow = u_move < cfg.p_grow
    do_prune = ~do_grow & (u_move < cfg.p_grow + cfg.p_prune)

    # proposal draws: categorical variable by inverse CDF, uniform cut
    v_new = torch.searchsorted(spcum, u_var.contiguous(), right=True)
    v_new = v_new.clamp(max=spcum.shape[0] - 1)
    c_new = torch.floor(u_cut * cfg.n_cuts).long().clamp(max=cfg.n_cuts - 1)
    go_left = ranks_t[v_new] <= c_new[:, None]               # (C, N)
    log_u = torch.log(u_acc)

    # node selection: a leaf for grow, a NOG node for prune/change
    eta_grow = _pick_marked(is_leaf, n_leaf, u_leaf)
    eta_pc = _pick_marked(is_nog, n_nog.clamp(min=1), u_nog)
    eta = torch.where(do_grow, eta_grow, eta_pc)
    lft = (2 * eta + 1).clamp(max=M - 1)
    rgt = (2 * eta + 2).clamp(max=M - 1)

    is_lft = lidx == lft[:, None]
    members = torch.where(do_grow[:, None], lidx == eta[:, None],
                          is_lft | (lidx == rgt[:, None]))
    dest = torch.where(do_prune[:, None], eta[:, None],
                       torch.where(go_left, lft[:, None], rgt[:, None]))
    new_lidx = torch.where(members, dest, lidx)

    wr = r if w is None else w * r

    def masked_stats(mask):
        n = mask.sum(1).to(dtype) if w is None else (mask * w).sum(1)
        return n, torch.where(mask, wr, 0.0).sum(1)

    if reduce is None:
        n_all, s_all = masked_stats(members)
        n_ln, s_ln = masked_stats(members & go_left)
        n_lo, s_lo = masked_stats(is_lft)
        n_rn, s_rn = n_all - n_ln, s_all - s_ln
    else:
        f64 = torch.float64
        w64 = None if w is None else w.to(f64)
        wr64 = wr.to(f64)
        cnt_old, sum_old = node_stats(lidx, wr64, M, w64)

        def local(mask):
            n = mask.to(f64).sum(1) if w is None else (mask * w64).sum(1)
            return n, torch.where(mask, wr64, 0.0).sum(1)

        pairs = (local(members & go_left), local(members & ~go_left))
        blk = torch.stack([torch.cat([cnt_old] + [p[0][:, None]
                                                  for p in pairs], 1),
                           torch.cat([sum_old] + [p[1][:, None]
                                                  for p in pairs], 1)],
                          1).to(dtype)
        blk = reduce(blk)                                 # (C, 2, M + 2)
        cnt_old, sum_old = blk[:, 0, :M], blk[:, 1, :M]
        n_ln, s_ln = blk[:, 0, M], blk[:, 1, M]
        n_rn, s_rn = blk[:, 0, M + 1], blk[:, 1, M + 1]
        n_eta, s_eta = cnt_old[rows, eta], sum_old[rows, eta]
        n_lo, s_lo = cnt_old[rows, lft], sum_old[rows, lft]
        n_rgt, s_rgt = cnt_old[rows, rgt], sum_old[rows, rgt]
        n_all = torch.where(do_grow, n_eta, n_lo + n_rgt)
        s_all = torch.where(do_grow, s_eta, s_lo + s_rgt)
    n_ro, s_ro = n_all - n_lo, s_all - s_lo

    m_all = _leaf_marginal(n_all, s_all, sigma2, tau2)
    m_ln = _leaf_marginal(n_ln, s_ln, sigma2, tau2)
    m_rn = _leaf_marginal(n_rn, s_rn, sigma2, tau2)
    m_lo = _leaf_marginal(n_lo, s_lo, sigma2, tau2)
    m_ro = _leaf_marginal(n_ro, s_ro, sigma2, tau2)

    # structure-prior and transition terms
    d = depths[eta]
    ps_d = p_split[d]
    split_term = (torch.log(ps_d)
                  + 2.0 * torch.log1p(-p_split[(d + 1).clamp(
                      max=cfg.max_depth + 1)])
                  - torch.log1p(-ps_d))
    parent = torch.div(eta - 1, 2, rounding_mode="floor").clamp(min=0)
    parent_was_nog = (eta > 0) & is_nog[rows, parent]
    n_nog_grow = n_nog + 1 - parent_was_nog.long()
    lg, lp_ = math.log(cfg.p_grow), math.log(cfg.p_prune)
    log_trans_grow = (lp_ - lg + torch.log(n_leaf.to(dtype))
                      - torch.log(n_nog_grow.to(dtype)))
    log_trans_prune = (lg - lp_ + torch.log(n_nog.to(dtype))
                       - torch.log((n_leaf - 1).clamp(min=1).to(dtype)))

    log_accept = torch.where(
        do_grow, split_term + log_trans_grow + (m_ln + m_rn - m_all),
        torch.where(do_prune,
                    -split_term + log_trans_prune + (m_all - m_lo - m_ro),
                    m_ln + m_rn - m_lo - m_ro))
    valid = torch.where(
        do_grow, (d < cfg.max_depth) & (n_ln > 0) & (n_rn > 0),
        torch.where(do_prune, n_nog > 0,
                    (n_nog > 0) & (n_ln > 0) & (n_rn > 0)))
    accept = valid & (log_u < log_accept)

    # tree update of the accepted move
    f_eta = torch.where(do_prune, LEAF, v_new)
    f_child = torch.where(do_prune, INACTIVE, LEAF)
    new_feature = feature.clone()
    new_feature[rows, eta] = f_eta
    new_feature[rows, lft] = f_child
    new_feature[rows, rgt] = f_child
    new_cut = cut.clone()
    new_cut[rows, eta] = torch.where(do_prune, cut[rows, eta], c_new)
    acc = accept[:, None]
    feature = torch.where(acc, new_feature, feature)
    cut = torch.where(acc, new_cut, cut)
    lidx = torch.where(acc, new_lidx, lidx)

    # conjugate leaf draws from the accepted partition
    if reduce is None:
        cw = (torch.ones_like(r) if w is None else w.expand_as(r))
        counts = torch.zeros((C, M), dtype=dtype, device=dev).scatter_add_(
            1, lidx, cw)
        sums = torch.zeros((C, M), dtype=dtype, device=dev).scatter_add_(
            1, lidx, wr)
    else:
        # the current partition's sums, with eta and its children set
        # from the move's totals where the move was accepted
        zero = torch.zeros_like(n_all)
        prune = do_prune
        new_n = (torch.where(prune, n_all, zero),
                 torch.where(prune, zero, n_ln),
                 torch.where(prune, zero, n_rn))
        new_s = (torch.where(prune, s_all, zero),
                 torch.where(prune, zero, s_ln),
                 torch.where(prune, zero, s_rn))
        counts, sums = cnt_old.clone(), sum_old.clone()
        # rgt, then lft, then eta: at the bottom row lft and rgt clamp to
        # one slot, where no grow is valid
        for node, vn, vs in ((rgt, new_n[2], new_s[2]),
                             (lft, new_n[1], new_s[1]),
                             (eta, new_n[0], new_s[0])):
            counts[rows, node] = torch.where(accept, vn,
                                             counts[rows, node])
            sums[rows, node] = torch.where(accept, vs, sums[rows, node])
    if rg is not None:
        feature, cut, lidx, counts, sums = _subtree_regrow(
            cfg, feature, cut, lidx, wr, ranks_t, spcum, depths, p_split,
            sigma2, tau2, rg[:, :3], rg[:, 3:].reshape(C, 3, M), w=w,
            reduce=reduce, p_regrow=cfg.p_regrow, old=(counts, sums))
    s2, t2 = sigma2[:, None], tau2[:, None]
    post_var = 1.0 / (counts / s2 + 1.0 / t2)
    post_mean = post_var * sums / s2
    mu = post_mean + torch.sqrt(post_var) * zn[:, :M]
    leaf_value = torch.where(feature == LEAF, mu, 0.0)
    fit = torch.gather(leaf_value, 1, lidx)
    return feature, cut, lidx, leaf_value, fit


# the most elements of one one-hot block of ``node_stats``
NODE_STATS_BLOCK = 1 << 27


def node_stats(lidx, wr, max_nodes: int, w=None):
    """Per-node (count, sum of w r) of C chains: lidx (C, N) int, wr (C,
    N) the weighted residual, w (N,) optional weights (unit counts
    otherwise) -> two (C, M).  A one-hot product, so every sum is taken
    in one fixed order (a scatter-add of floats on the card is not); past
    ``NODE_STATS_BLOCK`` elements the one-hot is made for a block of
    nodes at a time (deep trees at large n), each node's sum still one
    product over all N."""
    C, N = lidx.shape
    lidx = lidx.long()
    cw = torch.ones_like(wr) if w is None else w.expand_as(wr)
    pair = torch.stack([cw, wr], 1)
    width = max(1, min(max_nodes, NODE_STATS_BLOCK // max(C * N, 1)))
    outs = []
    for lo in range(0, max_nodes, width):
        ids = torch.arange(lo, min(lo + width, max_nodes),
                           device=lidx.device)
        outs.append(torch.bmm(pair, (lidx[..., None] == ids).to(wr.dtype)))
    out = outs[0] if len(outs) == 1 else torch.cat(outs, 2)
    return out[:, 0], out[:, 1]


def _subtree_regrow(cfg: BartConfig, feature, cut, lidx, wr, ranks_t, spcum,
                    depths, p_split, sigma2, tau2, g, u3, w=None,
                    reduce=None, p_regrow=1.0, old=None):
    """Subtree-regrow MH move of one tree of each of C chains: pick an
    active node eta uniformly, propose the whole subtree at eta redrawn
    from the CGM structure prior (at eta's absolute depth), and accept
    with min(1, m(T') / m(T) * n_active(T) / n_active(T')), m the
    integrated likelihood of the subtree's leaves (the prior terms
    cancel against the proposal).  A proposal with an empty leaf is
    rejected, and the move is tried only where the gate g[:, 0] <
    p_regrow.

    feature/cut (C, M) int64, lidx (C, N) int64, wr (C, N) the weighted
    partial residual, ranks_t (P, N) int, sigma2/tau2 (C,), g (C, 3)
    uniforms (gate, node pick, accept), u3 (C, 3, M) uniforms (split,
    variable, cut per node), w (N,) optional weights.  Returns (feature,
    cut, lidx, counts, sums), the last two the accepted partition's
    per-node statistics.

    old: the current partition's per-node (counts, sums), already summed
    over the shards (the in-sweep move passes the accepted
    grow/prune/change partition's).  Then only the proposed partition's
    statistics are taken, ``reduce`` (observation-sharded) sums them in
    one (C, 2, M + 1) block (slot M zero: the sharded kernel's block),
    the accepted statistics take them on eta's subtree only, and where no
    chain's gate opens nothing is computed or reduced.  Without ``old``
    both partitions' statistics are taken and ``reduce`` sums them in
    one (C, 4, M) block."""
    C, M = feature.shape
    dev = feature.device
    dtype = wr.dtype
    rows = torch.arange(C, device=dev)
    node_ids = torch.arange(M, device=dev)
    parent_ids = torch.div(node_ids - 1, 2,
                           rounding_mode="floor").clamp(min=0)
    u_gate, u_sel, u_acc = g.unbind(1)
    gate = u_gate < p_regrow
    if old is not None and not bool(gate.any()):
        return (feature, cut, lidx) + tuple(old)

    active = feature != INACTIVE
    n_act = active.sum(1)
    eta = _pick_marked(active, n_act, u_sel)

    # eta's subtree (eta included): each node's ancestor chain
    anc = node_ids
    in_sub = torch.zeros((C, M), dtype=torch.bool, device=dev)
    for _ in range(cfg.max_depth + 1):
        in_sub = in_sub | (anc[None, :] == eta[:, None])
        anc = torch.div(anc - 1, 2, rounding_mode="floor").clamp(min=0)

    # a prior draw over the subtree: splits at absolute depth, activity
    # propagated down from eta (p_split is 0 at max_depth)
    want_split = u3[:, 0] < p_split[depths]
    v_prop = torch.searchsorted(spcum, u3[:, 1].contiguous(), right=True)
    v_prop = v_prop.clamp(max=spcum.shape[0] - 1)
    c_prop = torch.floor(u3[:, 2] * cfg.n_cuts).long().clamp(
        max=cfg.n_cuts - 1)
    act_new = torch.zeros((C, M), dtype=torch.bool, device=dev)
    act_new[rows, eta] = True
    for _ in range(cfg.max_depth):
        act_new = act_new | (act_new[:, parent_ids]
                             & want_split[:, parent_ids]
                             & (node_ids != 0))
    feat_prop = torch.where(act_new & want_split, v_prop,
                            torch.where(act_new, LEAF, INACTIVE))
    cut_prop = torch.where(feat_prop >= 0, c_prop, 0)
    new_feature = torch.where(in_sub, feat_prop, feature)
    new_cut = torch.where(in_sub, cut_prop, cut)
    new_lidx = walk_tree(new_feature, new_cut, ranks_t.t(), cfg.max_depth)

    if old is None:
        counts_old, sums_old = node_stats(lidx, wr, M, w)
        counts_new, sums_new = node_stats(new_lidx, wr, M, w)
        if reduce is not None:
            counts_old, sums_old, counts_new, sums_new = reduce(torch.stack(
                [counts_old, sums_old, counts_new, sums_new], 1)).unbind(1)
    else:
        counts_old, sums_old = old
        if reduce is None:
            counts_new, sums_new = node_stats(new_lidx, wr, M, w)
        else:
            # the local sums in float64, rounded once
            f64 = torch.float64
            cnt, sm = node_stats(new_lidx, wr.to(f64), M,
                                 None if w is None else w.to(f64))
            pad = torch.zeros((C, 1), dtype=f64, device=dev)
            blk = torch.stack([torch.cat([cnt, pad], 1),
                               torch.cat([sm, pad], 1)], 1).to(dtype)
            blk = reduce(blk)                             # (C, 2, M + 1)
            counts_new, sums_new = blk[:, 0, :M], blk[:, 1, :M]
    s2, t2 = sigma2[:, None], tau2[:, None]
    leaf_old = (feature == LEAF) & in_sub
    leaf_new = (new_feature == LEAF) & in_sub
    m_old = torch.where(leaf_old, _leaf_marginal(counts_old, sums_old, s2,
                                                 t2), 0.0).sum(1)
    m_new = torch.where(leaf_new, _leaf_marginal(counts_new, sums_new, s2,
                                                 t2), 0.0).sum(1)
    n_act_new = (new_feature != INACTIVE).sum(1)
    log_accept = (m_new - m_old + torch.log(n_act.to(dtype))
                  - torch.log(n_act_new.to(dtype)))
    valid = ~(leaf_new & (counts_new <= 0)).any(1)
    accept = gate & valid & (torch.log(u_acc) < log_accept)

    acc = accept[:, None]
    take = acc if old is None else acc & in_sub
    return (torch.where(acc, new_feature, feature),
            torch.where(acc, new_cut, cut),
            torch.where(acc, new_lidx, lidx),
            torch.where(take, counts_new, counts_old),
            torch.where(take, sums_new, sums_old))


def draw_regrow_variates(gen, n_chains: int, cfg: BartConfig, dtype,
                         device):
    """The draws of ``cfg.regrow_per_sweep`` regrows of C chains: the
    tree (C, R) int64, the gate / node-pick / accept uniforms (C, R, 3),
    the per-node split / variable / cut uniforms (C, R, 3, M) and the
    leaf normals (C, R, M)."""
    C, R, M = n_chains, cfg.regrow_per_sweep, cfg.max_nodes
    tree = torch.randint(0, cfg.num_trees, (C, R), generator=gen,
                         device=device)
    g = torch.rand((C, R, 3), generator=gen, dtype=dtype, device=device)
    u3 = torch.rand((C, R, 3, M), generator=gen, dtype=dtype,
                    device=device)
    zn = torch.randn((C, R, M), generator=gen, dtype=dtype, device=device)
    return tree, g, u3, zn


def regrow_refresh(cfg: BartConfig, state: BartState, y_target, ranks,
                   split_probs, sigma, gen=None, weights=None,
                   variates=None, reduce=None) -> BartState:
    """``cfg.regrow_per_sweep`` random-scan subtree regrows of every
    chain's forest: pick a tree uniformly, attempt one whole-subtree
    regrow (``_subtree_regrow``, exact MH), then redraw its leaves from
    the conjugate conditional.  A Metropolis-within-Gibbs step after the
    sweep; k and sigma_mu are carried through.

    y_target (C, N), ranks (N, P), sigma (C,), weights (N,) optional;
    variates: optional ``(tree, g, u3, zn)`` as ``draw_regrow_variates``
    makes them, replacing the draw from ``gen``.  The new tree's fit is
    a gather of its new leaf values, so ``tree_fit`` equals
    ``leaf_value[leaf_idx]`` to the bit.  ``reduce``: the
    observation-sharded form, one reduction per regrow
    (``_subtree_regrow``)."""
    R = cfg.regrow_per_sweep
    if R <= 0:
        return state
    dtype = state.allfit.dtype
    dev = state.allfit.device
    C, T, M = state.feature.shape
    if variates is None:
        variates = draw_regrow_variates(gen, C, cfg, dtype, dev)
    tree, g, u3, zn = variates
    if tree.shape != (C, R):
        raise ValueError(f"regrow variates for {tuple(tree.shape)} "
                         f"(chains, regrows), expected {(C, R)}")
    sigma2 = sigma * sigma
    tau2 = state.sigma_mu * state.sigma_mu
    spcum = torch.cumsum(torch.as_tensor(np.asarray(split_probs),
                                         dtype=dtype, device=dev), 0)
    depths = torch.as_tensor(node_depths(cfg), dtype=torch.long, device=dev)
    p_split = torch.as_tensor(split_prob_by_depth(cfg), dtype=dtype,
                              device=dev)
    w = None if weights is None else torch.as_tensor(weights, dtype=dtype,
                                                     device=dev)
    ranks_t = ranks.t()
    rows = torch.arange(C, device=dev)
    feature, cut = state.feature.clone(), state.cut.clone()
    leaf_value, leaf_idx = state.leaf_value.clone(), state.leaf_idx.clone()
    tree_fit, allfit = state.tree_fit.clone(), state.allfit
    s2, t2 = sigma2[:, None], tau2[:, None]
    for r in range(R):
        j = tree[:, r].long()
        fit_j = tree_fit[rows, j]
        resid = y_target - allfit + fit_j
        wr = resid if w is None else w * resid
        f2, c2, li2, counts, sums = _subtree_regrow(
            cfg, feature[rows, j].long(), cut[rows, j].long(),
            leaf_idx[rows, j].long(), wr, ranks_t, spcum, depths, p_split,
            sigma2, tau2, g[:, r].to(dtype), u3[:, r].to(dtype), w,
            reduce=reduce)
        post_var = 1.0 / (counts / s2 + 1.0 / t2)
        post_mean = post_var * sums / s2
        mu = post_mean + torch.sqrt(post_var) * zn[:, r].to(dtype)
        lv2 = torch.where(f2 == LEAF, mu, 0.0)
        new_fit = torch.gather(lv2, 1, li2)
        feature[rows, j] = f2.to(feature.dtype)
        cut[rows, j] = c2.to(cut.dtype)
        leaf_value[rows, j] = lv2
        leaf_idx[rows, j] = li2.to(leaf_idx.dtype)
        tree_fit[rows, j] = new_fit
        allfit = allfit + new_fit - fit_j
    return state._replace(feature=feature, cut=cut, leaf_value=leaf_value,
                          leaf_idx=leaf_idx, tree_fit=tree_fit,
                          allfit=allfit)


def draw_variates(gen, n_chains: int, num_trees: int, dtype, device,
                  pad: int = 128):
    """Per (chain, tree): 8 proposal uniforms (6 used) and ``pad`` leaf
    normals (``node_pad(cfg)``: 128 up to max_depth 6) — the variate
    layout the sweep kernels consume."""
    u = torch.rand((n_chains, num_trees, 8), generator=gen, dtype=dtype,
                   device=device)
    zn = torch.randn((n_chains, num_trees, pad), generator=gen, dtype=dtype,
                     device=device)
    return u, zn


def draw_tree_regrow_variates(gen, n_chains: int, cfg: BartConfig, dtype,
                              device):
    """The in-sweep regrow's draws (``cfg.p_regrow``), per (chain, tree)
    one row of 3 + 3 M uniforms: ``_subtree_regrow``'s g (gate, node
    pick, accept), then its u3 (split, variable and cut of each node),
    row-major -> (C, T, 3 + 3 M), the layout the sweep kernels consume."""
    M = cfg.max_nodes
    return torch.rand((n_chains, cfg.num_trees, 3 + 3 * M), generator=gen,
                      dtype=dtype, device=device)


def sweep_trees(cfg: BartConfig, feature, cut, lidx, tfit, resid0, sigma2,
                tau2, u, zn, ranks_t, spcum, depths, p_split, weights=None,
                reduce=None, rg=None):
    """The sequential sweep over the trees of C chains, with the running
    residual carried from tree to tree as the CUDA kernel carries it —
    the plain version of ``csrc/bart_sweep_batch.cu``.

    feature/cut/lidx (C, T, M|N) int, tfit (C, T, N), resid0 (C, N) the
    response minus every tree, sigma2/tau2 (C,), u (C, T, >= 6) and zn
    (C, T, >= M) variates, ranks_t (P, N) int64, spcum, depths, p_split
    and weights as ``tree_step`` takes them; floats in resid0's dtype.
    ``reduce``: the observation-sharded sweep (``tree_step``), one
    reduction per tree update; the plain version of
    ``csrc/bart_sweep_sharded.cu``.  rg (C, T, 3 + 3 M): the in-sweep
    regrow's variates (``draw_tree_regrow_variates``), None when
    ``cfg.p_regrow`` is 0.
    Returns (feature, cut, leaf_value, leaf_idx, tree_fit, resid)."""
    R = resid0
    outs = []
    for t in range(feature.shape[1]):
        r = R + tfit[:, t]
        f, c, li, lv, new_fit = tree_step(
            cfg, feature[:, t].long(), cut[:, t].long(), lidx[:, t].long(),
            r, sigma2, tau2, u[:, t, :6], zn[:, t], ranks_t, spcum, depths,
            p_split, w=weights, reduce=reduce,
            rg=None if rg is None else rg[:, t])
        R = r - new_fit
        outs.append((f, c, lv, li, new_fit))
    f, c, lv, li, fit = (torch.stack(x, 1) for x in zip(*outs))
    return (f.to(torch.int32), c.to(torch.int32), lv, li.to(torch.int32),
            fit, R)


def bart_sweep(cfg: BartConfig, state: BartState, y_target, ranks,
               split_probs, sigma, gen=None, weights=None, variates=None,
               reduce=None):
    """One full Gibbs sweep over all trees of C chains (the reference's
    ``runSamplerWithResults`` with one sample).

    y_target (C, N): response minus the parametric offset (probit: the
    latent z minus the offset).  ranks (N, P) int tensor.  sigma (C,):
    residual sd (1 for probit).  weights (N,): optional likelihood
    weights, y_i ~ N(fit_i, sigma^2 / w_i).  variates: optional
    ``(u (C, T, >= 6), zn (C, T, >= M))``, with ``cfg.p_regrow`` ``(u,
    zn, rg (C, T, 3 + 3 M))``, replacing the draw from ``gen``.  With
    ``cfg.p_regrow`` each tree's move is followed by a subtree-regrow
    move (``tree_step``).  With ``cfg.regrow_per_sweep`` the regrows of
    ``regrow_refresh`` follow the trees (before the k update), drawn from
    ``gen``, as the JAX package's op-form sweep runs them; they take no
    pre-drawn variates here.  The draws from ``gen`` come in this order:
    u and zn (``draw_variates``), rg (``draw_tree_regrow_variates``),
    the refresh's (``draw_regrow_variates``), the k update's.
    ``reduce``: the observation-sharded sweep (the JAX package's
    ``bart_sweep(axis_name=)``): every obs-sized input is this rank's
    shard and every sufficient statistic is summed over the shards by
    ``reduce``.  Returns (state, varcount (C, P))."""
    if cfg.regrow_per_sweep > 0 and variates is not None:
        raise ValueError(
            "the regrow refresh takes no pre-drawn sweep variates; pass "
            "its own to regrow_refresh")
    if (variates is not None and cfg.p_regrow > 0) != (
            variates is not None and len(variates) == 3):
        raise ValueError(
            "pre-drawn sweep variates are (u, zn, rg) with p_regrow > 0 "
            "and (u, zn) without")
    dtype = state.allfit.dtype
    dev = state.allfit.device
    C, T = state.feature.shape[:2]
    spcum = torch.cumsum(torch.as_tensor(np.asarray(split_probs),
                                         dtype=dtype, device=dev), 0)
    w = None if weights is None else torch.as_tensor(weights, dtype=dtype,
                                                     device=dev)
    if variates is None:
        variates = draw_variates(gen, C, T, dtype, dev, node_pad(cfg))
        if cfg.p_regrow > 0:
            variates += (draw_tree_regrow_variates(gen, C, cfg, dtype, dev),)
    u, zn, *rg = (v.to(dtype) for v in variates)
    feature, cut, lv, lidx, fit, resid = sweep_trees(
        cfg, state.feature, state.cut, state.leaf_idx, state.tree_fit,
        y_target - state.allfit, sigma * sigma,
        state.sigma_mu * state.sigma_mu, u, zn,
        ranks.t().contiguous().long(), spcum,
        torch.as_tensor(node_depths(cfg), dtype=torch.long, device=dev),
        torch.as_tensor(split_prob_by_depth(cfg), dtype=dtype, device=dev),
        weights=w, reduce=reduce, rg=rg[0] if rg else None)
    new_state = state._replace(
        feature=feature, cut=cut, leaf_value=lv, leaf_idx=lidx,
        allfit=y_target - resid, tree_fit=fit)
    if cfg.regrow_per_sweep > 0:
        new_state = regrow_refresh(cfg, new_state, y_target, ranks,
                                   split_probs, sigma, gen, weights=w,
                                   reduce=reduce)
    if cfg.k_df > 0:
        k, sigma_mu = chi_k_update(cfg, new_state.feature,
                                   new_state.leaf_value, state.k,
                                   state.sigma_mu, gen)
        new_state = new_state._replace(k=k, sigma_mu=sigma_mu)
    return new_state, count_variable_use(new_state.feature, spcum.shape[0])


def standard_gamma(shape, gen):
    """One Gamma(shape, 1) draw per entry of ``shape`` (a float tensor),
    by Marsaglia and Tsang's squeeze-free rejection from the generator's
    normals and uniforms (``torch._standard_gamma`` takes no generator).
    Each round proposes 4 candidates per entry still open and keeps the
    first accepted (each is accepted with probability above 0.95, so one
    round almost always ends it); shapes below 1 draw at shape + 1 and
    scale by U^(1 / shape)."""
    n_try = 4
    dtype, dev = shape.dtype, shape.device
    tiny = torch.finfo(dtype).tiny
    boost = shape < 1.0
    a = torch.where(boost, shape + 1.0, shape)
    d = a - 1.0 / 3.0
    c = 1.0 / torch.sqrt(9.0 * d)
    out = torch.full_like(a, math.nan)
    open_ = torch.ones_like(a, dtype=torch.bool)
    while bool(open_.any()):
        x = torch.randn(a.shape + (n_try,), generator=gen, dtype=dtype,
                        device=dev)
        u = torch.rand(a.shape + (n_try,), generator=gen, dtype=dtype,
                       device=dev)
        v = (1.0 + c[..., None] * x) ** 3
        ok = (v > 0) & (torch.log(u) < 0.5 * x * x + d[..., None]
                        - d[..., None] * v
                        + d[..., None] * torch.log(v.clamp(min=tiny)))
        first = ok.int().argmax(-1, keepdim=True)
        g = (d[..., None] * v).gather(-1, first)[..., 0]
        take = open_ & ok.any(-1)
        out = torch.where(take, g, out)
        open_ = open_ & ~take
    if bool(boost.any()):
        u = torch.rand(a.shape, generator=gen, dtype=dtype, device=dev)
        out = torch.where(boost, out * u ** (1.0 / shape), out)
    return out


def chi_k_update(cfg: BartConfig, feature, leaf_value, k, sigma_mu, gen,
                 gamma=None):
    """The chi(df, scale) hyperprior draw of k after a sweep, per chain:
    with A = k sigma_mu fixed, k^2 ~ Gamma((df + m) / 2, rate) where m
    counts the leaves of every tree and rate = sum(leaf^2) / (2 A^2)
    (+ 1 / (2 scale^2) for a finite scale); sigma_mu becomes A / k.

    feature/leaf_value (C, T, M), k/sigma_mu (C,); gamma (C,) optional
    standard gamma draws replacing the draw from ``gen``.  Returns
    (k, sigma_mu)."""
    C = feature.shape[0]
    dtype = leaf_value.dtype
    is_leaf = (feature == LEAF).reshape(C, -1)
    m = is_leaf.sum(1).to(dtype)
    A = k * sigma_mu
    ssq = torch.where(is_leaf, leaf_value.reshape(C, -1), 0.0).pow(2).sum(1)
    rate = ssq / (2.0 * A * A)
    if math.isfinite(cfg.k_scale):
        rate = rate + 1.0 / (2.0 * cfg.k_scale ** 2)
    if gamma is None:
        gamma = standard_gamma((cfg.k_df + m) / 2.0, gen)
    k_new = torch.sqrt(torch.as_tensor(gamma, dtype=dtype,
                                       device=leaf_value.device) / rate)
    return k_new, A / k_new


def count_variable_use(feature, n_vars: int):
    """varcount (C, P) int32: splits per variable across all trees.  One
    histogram of the internal nodes' (chain, variable) keys: a scatter of
    every heap slot into C x (P + 1) counters made deep heaps' mostly
    inactive slots contend for one counter a chain on the card."""
    C = feature.shape[0]
    f = feature.reshape(C, -1).long()
    keys = (f + n_vars * torch.arange(C, device=f.device)[:, None])[f >= 0]
    return torch.bincount(keys, minlength=C * n_vars).reshape(
        C, n_vars).to(torch.int32)


def _ndtr(x):
    """Standard normal CDF, accurate in both tails (erf near 0, erfc of
    |x| beyond); ``torch.special.ndtr`` underflows in the lower tail."""
    half_sqrt_2 = 0.5 * math.sqrt(2.0)
    w = x * half_sqrt_2
    z = w.abs()
    y = torch.where(z < half_sqrt_2, 1.0 + torch.erf(w),
                    torch.where(w > 0, 2.0 - torch.erfc(z), torch.erfc(z)))
    return 0.5 * y


def sample_probit_latents(mean, y, gen=None, u=None):
    """z_i ~ TruncNormal(mean_i, 1) on the side implied by y_i, by the
    small-tail inverse CDF measured from the allowed side:

        y=1:  z = mean - ndtri(u * Phi(mean))   (> 0)
        y=0:  z = mean + ndtri(u * Phi(-mean))  (<= 0)

    mean (C, N); y (N,); u optional uniforms in (0, 1) of mean's shape."""
    if u is None:
        u = torch.rand(mean.shape, generator=gen, dtype=mean.dtype,
                       device=mean.device)
        u = 1e-7 + u * (1.0 - 2e-7)
    pos = y > 0
    side_prob = torch.where(pos, _ndtr(mean), _ndtr(-mean))
    v = torch.clamp(u * side_prob, 1e-30, 1.0 - 1e-7)
    q = torch.special.ndtri(v)
    z = torch.where(pos, mean - q, mean + q)
    return torch.clamp(z, -30.0, 30.0)


def predict_trees(cfg: BartConfig, feature, cut, leaf_value, ranks_new):
    """Sum over trees of the leaf value each row of ``ranks_new`` lands
    in: feature/cut/leaf_value (..., T, M) -> (..., N_new)."""
    lead = feature.shape[:-1]
    M = feature.shape[-1]
    node = walk_tree(feature.reshape(-1, M), cut.reshape(-1, M), ranks_new,
                     cfg.max_depth)
    fits = torch.gather(leaf_value.reshape(-1, M), 1, node)
    return fits.reshape(lead + (-1,)).sum(-2)
