"""Whole-sweep BART Gibbs kernels over a batch of chains.

Counterparts of the TPU kernels ``_sweep_call_batch``,
``_sweep_call_tiled`` and ``_sweep_call`` in
``stan4bart_tpu/ops/bart_sweep_kernel.py`` (public wrappers
``bart_sweep_fused_batch``, ``bart_sweep_fused_batch_tiled`` and
``bart_sweep_fused``).  One call runs the sequential sweep over all trees
of every chain:

* on a CUDA tensor it launches a hand-written Hopper kernel:
  ``stan4bart_torch/csrc/bart_sweep_batch.cu`` (one cluster of K thread
  blocks per chain, each block's slice of the running residual and a byte
  copy of its leaf indices in shared memory, n <= 10368),
  ``stan4bart_torch/csrc/bart_sweep_tiled.cu`` (the same function at any
  n: the same on-chip sweep where a block's slice fits in shared memory,
  else the residual in device memory and the observations streamed in
  tiles) or ``stan4bart_torch/csrc/bart_sweep_chain.cu`` (the per-chain
  driver's sweep: one block per chain, the residual alone in shared
  memory, n <= 51840);
* on a CPU tensor it runs the plain PyTorch version of that function,
  ``ops/bart.py:sweep_trees`` (``tree_step`` looped over trees with the
  residual carried as the kernels carry it), for every wrapper.

All consume the same pre-drawn variates ``(u (C, T, 8), zn (C, T,
128))``, drawn here from the caller's generator when not supplied, so
they compare chain for chain, and all end with the chi(df, scale) k
update (``ops/bart.py:chi_k_update``) when ``cfg.k_df > 0``.  The
varcount is counted outside the kernel.

The cluster size K of the two chain-batched kernels is ``cluster_size``'s
choice from the clusters the device holds at once, unless the caller
forces it with ``cluster=``; the K of the last launch is the wrapper's
``last_cluster``.  Every K gives a deterministic forest, and K = 1 is
bit-identical to the per-chain kernel.

``bart_sweep_ablate`` runs the ablation stubs of the single-pass kernel
(``csrc/bart_sweep_ablate.cu``, counterparts of the TPU stubs in
``benchmarks/ablate_batch_kernel.py``), a measurement aid on no fit path.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import numpy as np
import torch

from stan4bart_torch.ops.bart import (
    BartConfig,
    BartState,
    chi_k_update,
    count_variable_use,
    draw_variates,
    node_depths,
    split_prob_by_depth,
    sweep_trees,
)
from stan4bart_torch.utils.device import resolve_device

NODE_PAD = 128
# widest observation row the single-pass kernel takes (the JAX package's
# single-pass limit); wider fits go to the obs-tiled kernel
MAX_NPAD = 10_368
# widest observation row the per-chain kernel takes (the JAX package's
# per-chain limit, ``sweep_single_ok``): the residual alone fills the
# shared memory a Hopper block may opt in to
MAX_N_CHAIN = 51_840
# cluster sizes the tests and chip_smoke.py hold the kernels at; the
# kernels take any K in 1..8 (the portable cluster sizes)
CLUSTERS = (1, 2, 4, 8)
MAX_CLUSTER = 8
# fewest observations per block of a cluster: one 2048-observation tile
MIN_OBS_PER_BLOCK = 2048
# a block's fixed work per sweep in observations' worth: a wave of the
# on-chip sweep takes about (observations per block + 2700) x 4.0 ns x
# trees on an NVIDIA H100 80GB HBM3 at 700 W (fit to chip_smoke.py's
# scans over K at n = 10 000 x 256, 50 000 x 64 and 200 000 x 16 chains)
BLOCK_FIXED_OBS = 2700


class SweepConsts(NamedTuple):
    """Model-static kernel operands, built once per GibbsProgram."""
    ranks_t: torch.Tensor   # (P, N) int32 cut ranks, one row per variable
    spcum: torch.Tensor     # (P,) f32 split-probability inclusive cumsum
    psplit: torch.Tensor    # (max_depth + 2,) f32 p_split by depth
    depths: torch.Tensor    # (M,) int64 node depth by heap index
    n_obs: int
    npad: int               # n rounded up to the TPU kernel's 128 lanes


def make_sweep_consts(cfg: BartConfig, ranks, split_probs,
                      device="cuda") -> SweepConsts:
    """Static operands of the sweep from the model data (ranks (N, P))."""
    if cfg.max_nodes > NODE_PAD - 1:
        raise ValueError(
            f"the sweep kernel supports max_depth <= 6 "
            f"(max_nodes {cfg.max_nodes} > {NODE_PAD - 1})")
    device = resolve_device(device)
    ranks = np.asarray(ranks)
    n = ranks.shape[0]
    return SweepConsts(
        ranks_t=torch.as_tensor(np.ascontiguousarray(ranks.T),
                                dtype=torch.int32, device=device),
        spcum=torch.as_tensor(np.cumsum(np.asarray(split_probs,
                                                   np.float32)),
                              device=device),
        psplit=torch.as_tensor(split_prob_by_depth(cfg), dtype=torch.float32,
                               device=device),
        depths=torch.as_tensor(node_depths(cfg), dtype=torch.long,
                               device=device),
        n_obs=n,
        npad=-(-max(n, 128) // 128) * 128,
    )


def sweep_plain(cfg: BartConfig, feature, cut, lidx, tfit, resid0, sigma2,
                tau2, u, zn, consts: SweepConsts, weights=None):
    """``ops/bart.py:sweep_trees`` on the kernel's operands, in resid0's
    dtype.  Returns (feature, cut, leaf_value, leaf_idx, tree_fit,
    resid)."""
    dtype = resid0.dtype
    return sweep_trees(cfg, feature, cut, lidx, tfit, resid0, sigma2, tau2,
                       u, zn, consts.ranks_t.long(), consts.spcum.to(dtype),
                       consts.depths, consts.psplit.to(dtype),
                       weights=weights)


def cluster_size(C: int, N: int, resident) -> int:
    """Blocks per chain K of the chain-batched kernels, from ``resident``:
    resident[K - 1] clusters of K blocks fit on the device at once.
    Clusters that do not fit run in later waves, and a wave takes a
    block's fixed per-tree work (move choice, decision, leaf draw, cluster
    barriers: ``BLOCK_FIXED_OBS`` observations' worth) plus its
    observations, so K minimizes ceil(C / resident) x (ceil(N / K) +
    BLOCK_FIXED_OBS) over K = 1..8 with at least ``MIN_OBS_PER_BLOCK``
    observations per block; the smallest such K on ties."""
    best, best_cost = 1, None
    for K in range(1, MAX_CLUSTER + 1):
        if K > 1 and N / K < MIN_OBS_PER_BLOCK:
            break
        if resident[K - 1] < 1:
            continue
        cost = -(-C // resident[K - 1]) * (-(-N // K) + BLOCK_FIXED_OBS)
        if best_cost is None or cost < best_cost:
            best, best_cost = K, cost
    return best


def _check(x, name, dtype, shape):
    if x.dtype != dtype or tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name}: expected {dtype} {tuple(shape)}, got "
                         f"{x.dtype} {tuple(x.shape)}")
    if not x.is_contiguous() or x.device.type != "cuda":
        raise ValueError(f"{name} must be a contiguous CUDA tensor")


def _ptr(x):
    return ctypes.c_void_p(0 if x is None else x.data_ptr())


def _launch(name: str, cfg: BartConfig, feature, cut, lidx, tfit, resid0,
            sigma2, tau2, u, zn, consts: SweepConsts, weights=None,
            cluster=None):
    """Check the operands and launch kernel ``csrc/<name>.cu`` on the
    current stream (in clusters of ``cluster`` blocks per chain, for the
    kernels that take one); returns its fresh outputs."""
    from stan4bart_torch.ops.cuda_build import load

    C, T, M = feature.shape
    N = consts.n_obs
    P = consts.ranks_t.shape[0]
    i32, f32 = torch.int32, torch.float32
    _check(feature, "feature", i32, (C, T, M))
    _check(cut, "cut", i32, (C, T, M))
    _check(lidx, "leaf_idx", i32, (C, T, N))
    _check(tfit, "tree_fit", f32, (C, T, N))
    _check(resid0, "resid", f32, (C, N))
    _check(sigma2, "sigma2", f32, (C,))
    _check(tau2, "tau2", f32, (C,))
    _check(u, "u", f32, (C, T, 8))
    _check(zn, "zn", f32, (C, T, NODE_PAD))
    _check(consts.ranks_t, "ranks", i32, (P, N))
    _check(consts.spcum, "spcum", f32, (P,))
    _check(consts.psplit, "psplit", f32, (cfg.max_depth + 2,))
    if weights is not None:
        _check(weights, "weights", f32, (N,))

    feature_o = torch.empty_like(feature)
    cut_o = torch.empty_like(cut)
    lv_o = torch.empty((C, T, M), dtype=f32, device=feature.device)
    lidx_o = torch.empty_like(lidx)
    tfit_o = torch.empty_like(tfit)
    resid_o = torch.empty_like(resid0)

    fn = getattr(load(name), f"{name}_launch")
    fn.restype = ctypes.c_int
    k_arg = [] if cluster is None else [cluster]
    fn.argtypes = ([ctypes.c_void_p] * 19 + [ctypes.c_int] * 7
                   + [ctypes.c_float] * 4 + [ctypes.c_int] * len(k_arg)
                   + [ctypes.c_void_p])
    stream = torch.cuda.current_stream(feature.device).cuda_stream
    err = fn(_ptr(feature), _ptr(cut), _ptr(lidx), _ptr(tfit), _ptr(resid0),
             _ptr(sigma2), _ptr(tau2), _ptr(u), _ptr(zn),
             _ptr(consts.ranks_t), _ptr(consts.spcum), _ptr(consts.psplit),
             _ptr(weights), _ptr(feature_o), _ptr(cut_o), _ptr(lv_o),
             _ptr(lidx_o), _ptr(tfit_o), _ptr(resid_o),
             C, T, N, P, M, cfg.max_depth, cfg.n_cuts,
             cfg.p_grow, cfg.p_prune,
             math.log(cfg.p_prune) - math.log(cfg.p_grow),
             math.log(cfg.p_grow) - math.log(cfg.p_prune),
             *k_arg, ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    return feature_o, cut_o, lv_o, lidx_o, tfit_o, resid_o


_info_cache: dict = {}


def kernel_smem(name: str, N: int, T: int, K: int) -> dict:
    """Shared memory per block of the chain-batched kernel ``name``
    (``bart_sweep_batch`` or ``bart_sweep_tiled``) at N observations, T
    trees and clusters of K blocks, on the current CUDA device: static and
    dynamic bytes, the device's opt-in limit, how many clusters can be
    resident at once, and whether the residual stays on chip."""
    key = (name, N, T, K, torch.cuda.current_device())
    if key not in _info_cache:
        from stan4bart_torch.ops.cuda_build import load

        fn = getattr(load(name), f"{name}_info")
        fn.restype = ctypes.c_int
        st, dy = ctypes.c_longlong(), ctypes.c_longlong()
        optin, clusters, on_chip = ctypes.c_int(), ctypes.c_int(), \
            ctypes.c_int(1)
        args = [N, T, K, ctypes.byref(st), ctypes.byref(dy),
                ctypes.byref(optin), ctypes.byref(clusters)]
        if name == "bart_sweep_tiled":
            args.append(ctypes.byref(on_chip))
        err = fn(*args)
        if err != 0:
            raise RuntimeError(f"{name}_info failed: CUDA error {err}")
        _info_cache[key] = dict(static=st.value, dynamic=dy.value,
                                optin=optin.value, clusters=clusters.value,
                                resid_on_chip=bool(on_chip.value))
    return _info_cache[key]


def _cluster(name: str, C: int, T: int, consts: SweepConsts, cluster) -> int:
    """The cluster size to launch: ``cluster`` when given, else
    ``cluster_size`` from the device's resident clusters at each K."""
    if cluster is not None:
        if not 1 <= cluster <= MAX_CLUSTER:
            raise ValueError(f"cluster must be in 1..{MAX_CLUSTER}, got "
                             f"{cluster}")
        return cluster
    N = consts.n_obs
    resident = [kernel_smem(name, N, T, K)["clusters"]
                if K == 1 or N / K >= MIN_OBS_PER_BLOCK else 0
                for K in range(1, MAX_CLUSTER + 1)]
    return cluster_size(C, N, resident)


def sweep_cuda(cfg: BartConfig, feature, cut, lidx, tfit, resid0, sigma2,
               tau2, u, zn, consts: SweepConsts, weights=None, cluster=None):
    """Launch ``csrc/bart_sweep_batch.cu`` on the current stream; same
    contract as ``sweep_plain`` (all float inputs float32).  ``cluster``
    forces the blocks per chain (default: ``cluster_size``'s rule)."""
    C, T = feature.shape[:2]
    K = _cluster("bart_sweep_batch", C, T, consts, cluster)
    out = _launch("bart_sweep_batch", cfg, feature, cut, lidx, tfit, resid0,
                  sigma2, tau2, u, zn, consts, weights, K)
    bart_sweep_fused_batch.launches += 1
    bart_sweep_fused_batch.last_cluster = K
    return out


def sweep_tiled_cuda(cfg: BartConfig, feature, cut, lidx, tfit, resid0,
                     sigma2, tau2, u, zn, consts: SweepConsts,
                     weights=None, cluster=None):
    """Launch the obs-tiled ``csrc/bart_sweep_tiled.cu`` on the current
    stream; same contract as ``sweep_plain`` at any n (all float inputs
    float32).  ``cluster`` forces the blocks per chain (default:
    ``cluster_size``'s rule)."""
    C, T = feature.shape[:2]
    K = _cluster("bart_sweep_tiled", C, T, consts, cluster)
    out = _launch("bart_sweep_tiled", cfg, feature, cut, lidx, tfit, resid0,
                  sigma2, tau2, u, zn, consts, weights, K)
    bart_sweep_fused_batch_tiled.launches += 1
    bart_sweep_fused_batch_tiled.last_cluster = K
    return out


def sweep_chain_cuda(cfg: BartConfig, feature, cut, lidx, tfit, resid0,
                     sigma2, tau2, u, zn, consts: SweepConsts,
                     weights=None):
    """Launch the per-chain ``csrc/bart_sweep_chain.cu`` on the current
    stream; same contract as ``sweep_plain`` up to n = 51840 (all float
    inputs float32)."""
    out = _launch("bart_sweep_chain", cfg, feature, cut, lidx, tfit, resid0,
                  sigma2, tau2, u, zn, consts, weights)
    bart_sweep_fused.launches += 1
    return out


def chain_smem_bytes(n_obs: int) -> tuple[int, int, int]:
    """(static, dynamic, opt-in limit) shared-memory bytes per block of
    the per-chain kernel at ``n_obs`` observations, on the current CUDA
    device."""
    from stan4bart_torch.ops.cuda_build import load

    fn = load("bart_sweep_chain").bart_sweep_chain_smem
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_longlong),
                   ctypes.POINTER(ctypes.c_longlong),
                   ctypes.POINTER(ctypes.c_int)]
    st, dy, optin = ctypes.c_longlong(), ctypes.c_longlong(), ctypes.c_int()
    err = fn(n_obs, ctypes.byref(st), ctypes.byref(dy), ctypes.byref(optin))
    if err != 0:
        raise RuntimeError(f"bart_sweep_chain_smem failed: CUDA error {err}")
    return st.value, dy.value, optin.value


# each kernel's widest padded observation row (None: any n)
_MAX_NPAD = {"bart_sweep_batch": MAX_NPAD, "bart_sweep_tiled": None,
             "bart_sweep_chain": MAX_N_CHAIN}
_LAUNCH = {"bart_sweep_batch": sweep_cuda,
           "bart_sweep_tiled": sweep_tiled_cuda,
           "bart_sweep_chain": sweep_chain_cuda}


def check_kernel_supports(consts: SweepConsts, dtype,
                          kernel: str = "bart_sweep_batch") -> None:
    """Raise for a sweep CUDA kernel ``kernel`` does not take: float32
    state only; past npad 10368 (single-pass) or 51840 (per-chain) only
    the obs-tiled kernel."""
    if dtype != torch.float32:
        raise ValueError("the CUDA sweep kernels require float32 state")
    limit = _MAX_NPAD[kernel]
    if limit is not None and consts.npad > limit:
        raise ValueError(
            f"n = {consts.n_obs} (npad {consts.npad} > {limit}) is past "
            f"the shared memory of {kernel}; use "
            "bart_sweep_fused_batch_tiled")


def _fused(kernel: str, cfg: BartConfig, state: BartState, y_target,
           consts: SweepConsts, sigma, gen, weights, variates, gamma,
           **launch_kw):
    dev = state.allfit.device
    dtype = state.allfit.dtype
    C, T = state.feature.shape[:2]
    on_cuda = dev.type == "cuda"
    if on_cuda:
        check_kernel_supports(consts, dtype, kernel)
    work = torch.float32 if on_cuda else dtype
    if variates is None:
        variates = draw_variates(gen, C, T, torch.float32, dev)
    u, zn = (v.to(work).contiguous() for v in variates)
    resid0 = (y_target - state.allfit).to(work).contiguous()
    sigma2 = (sigma * sigma).to(work).contiguous()
    tau2 = (state.sigma_mu * state.sigma_mu).to(work).contiguous()
    w = (None if weights is None
         else torch.as_tensor(weights, device=dev).to(work).contiguous())
    args = (cfg, state.feature.contiguous(), state.cut.contiguous(),
            state.leaf_idx.contiguous(),
            state.tree_fit.to(work).contiguous(), resid0, sigma2, tau2,
            u, zn, consts)
    if on_cuda:
        out = _LAUNCH[kernel](*args, weights=w, **launch_kw)
    else:
        out = sweep_plain(*args, weights=w)
    feature, cut, lv, lidx, tfit, resid = out
    leaf_value = lv.to(dtype)
    k, sigma_mu = state.k, state.sigma_mu
    if cfg.k_df > 0:
        k, sigma_mu = chi_k_update(cfg, feature, leaf_value, k, sigma_mu,
                                   gen, gamma=gamma)
    new_state = state._replace(
        feature=feature, cut=cut, leaf_value=leaf_value, leaf_idx=lidx,
        tree_fit=tfit.to(dtype),
        allfit=(y_target.to(work) - resid).to(dtype), k=k,
        sigma_mu=sigma_mu)
    return new_state, count_variable_use(feature, consts.spcum.shape[0])


def bart_sweep_fused_batch(cfg: BartConfig, state: BartState, y_target,
                           consts: SweepConsts, sigma, gen, *, weights=None,
                           variates=None, gamma=None, cluster=None):
    """One sweep over all trees of a batched BartState (leading chain
    axis).  y_target (C, N), sigma (C,), weights (N,) or None, gen a
    ``torch.Generator`` on the state's device (unused when ``variates``
    are given and k is fixed), gamma (C,) optional standard gamma draws
    replacing those of the chi(df, scale) k update.  Returns (state,
    varcount (C, P)).

    On a CUDA state this launches ``csrc/bart_sweep_batch.cu`` (float32
    only, n <= 10368; wider fits raise and belong to
    ``bart_sweep_fused_batch_tiled``); ``cluster`` forces its blocks per
    chain.  On a CPU state it runs the plain version."""
    return _fused("bart_sweep_batch", cfg, state, y_target, consts, sigma,
                  gen, weights, variates, gamma, cluster=cluster)


def bart_sweep_fused_batch_tiled(cfg: BartConfig, state: BartState,
                                 y_target, consts: SweepConsts, sigma, gen,
                                 *, weights=None, variates=None, gamma=None,
                                 cluster=None):
    """``bart_sweep_fused_batch`` at any n: on a CUDA state this launches
    the obs-tiled ``csrc/bart_sweep_tiled.cu`` (float32 only; ``cluster``
    forces its blocks per chain); on a CPU state it runs the same plain
    version."""
    return _fused("bart_sweep_tiled", cfg, state, y_target, consts, sigma,
                  gen, weights, variates, gamma, cluster=cluster)


def bart_sweep_fused(cfg: BartConfig, state: BartState, y_target,
                     consts: SweepConsts, sigma, gen, *, weights=None,
                     variates=None, gamma=None):
    """The per-chain driver's sweep: ``bart_sweep_fused_batch``'s
    contract on a chain-batched state, where the JAX package vmaps its
    one-chain ``bart_sweep_fused`` (C = 1 is one chain).  The variates
    are drawn as the batch wrappers draw them, so ``GibbsProgram.step``
    and ``step_batched`` consume the generator identically.

    On a CUDA state this launches the per-chain
    ``csrc/bart_sweep_chain.cu`` (float32 only, n <= 51840; wider fits
    raise and belong to ``bart_sweep_fused_batch_tiled``); on a CPU state
    it runs the same plain version."""
    return _fused("bart_sweep_chain", cfg, state, y_target, consts, sigma,
                  gen, weights, variates, gamma)


def ablate_plain(mode: str, feature, cut, lv, lidx, tfit, resid0,
                 weights=None):
    """The ablation stubs' function (``csrc/bart_sweep_ablate.cu``):
    ``"copy"`` returns copies of the inputs; ``"obs"`` walks the trees
    with the per-observation work of the sweep and no move or node math:
    the partial residual r = R + tfit[t], the per-node leaf statistics
    (sum of w, sum of w r) over the input leaf indices, the fit lv[t][
    leaf_idx[t]] and the residual r - fit.  Returns (feature, cut, lv,
    leaf_idx, tree_fit, resid, stats (C, T, 2, M))."""
    C, T, M = feature.shape
    stats = torch.zeros((C, T, 2, M), dtype=resid0.dtype,
                        device=resid0.device)
    if mode == "copy":
        return (feature.clone(), cut.clone(), lv.clone(), lidx.clone(),
                tfit.clone(), resid0.clone(), stats)
    if mode != "obs":
        raise ValueError(f"mode must be 'copy' or 'obs', got {mode!r}")
    R = resid0.clone()
    fits = torch.empty_like(tfit)
    w = (torch.ones_like(R) if weights is None
         else weights.to(R.dtype).expand_as(R))
    for t in range(T):
        r = R + tfit[:, t]
        li = lidx[:, t].long()
        stats[:, t, 0].scatter_add_(1, li, w)
        stats[:, t, 1].scatter_add_(1, li, w * r)
        nf = torch.gather(lv[:, t], 1, li)
        fits[:, t] = nf
        R = r - nf
    return (feature.clone(), cut.clone(), lv.clone(), lidx.clone(), fits, R,
            stats)


def ablate_cuda(mode: str, feature, cut, lv, lidx, tfit, resid0, u,
                consts: SweepConsts, weights=None, cluster=None):
    """Launch stub ``mode`` of ``csrc/bart_sweep_ablate.cu`` on the current
    stream, with the grid, clusters (``cluster_size``'s rule unless
    ``cluster`` is given), shared memory and streaming of the single-pass
    kernel; same contract as ``ablate_plain`` (float32; u (C, T, 8) picks
    the cut-rank rows streamed)."""
    from stan4bart_torch.ops.cuda_build import load

    C, T, M = feature.shape
    N = consts.n_obs
    P = consts.ranks_t.shape[0]
    i32, f32 = torch.int32, torch.float32
    _check(feature, "feature", i32, (C, T, M))
    _check(cut, "cut", i32, (C, T, M))
    _check(lv, "leaf_value", f32, (C, T, M))
    _check(lidx, "leaf_idx", i32, (C, T, N))
    _check(tfit, "tree_fit", f32, (C, T, N))
    _check(resid0, "resid", f32, (C, N))
    _check(u, "u", f32, (C, T, 8))
    _check(consts.ranks_t, "ranks", i32, (P, N))
    _check(consts.spcum, "spcum", f32, (P,))
    if weights is not None:
        _check(weights, "weights", f32, (N,))
    modes = {"copy": 0, "obs": 1}
    if mode not in modes:
        raise ValueError(f"mode must be 'copy' or 'obs', got {mode!r}")
    K = _cluster("bart_sweep_batch", C, T, consts, cluster)
    outs = (torch.empty_like(feature), torch.empty_like(cut),
            torch.empty_like(lv), torch.empty_like(lidx),
            torch.empty_like(tfit), torch.empty_like(resid0),
            torch.zeros((C, T, 2, M), dtype=f32, device=feature.device))
    fn = load("bart_sweep_ablate").bart_sweep_ablate_launch
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 17
                   + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    stream = torch.cuda.current_stream(feature.device).cuda_stream
    err = fn(modes[mode], _ptr(feature), _ptr(cut), _ptr(lv), _ptr(lidx),
             _ptr(tfit), _ptr(resid0), _ptr(u), _ptr(consts.ranks_t),
             _ptr(consts.spcum), _ptr(weights), *map(_ptr, outs),
             C, T, N, P, M, K, ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"bart_sweep_ablate launch failed: CUDA error "
                           f"{err}")
    bart_sweep_ablate.launches += 1
    bart_sweep_ablate.last_cluster = K
    return outs


def bart_sweep_ablate(mode: str, feature, cut, lv, lidx, tfit, resid0, u,
                      consts: SweepConsts, weights=None, cluster=None):
    """The ablation stub ``mode`` ("copy" or "obs"): on CUDA tensors the
    kernel (``ablate_cuda``), on CPU tensors its plain version
    (``ablate_plain``)."""
    if resid0.device.type == "cuda":
        return ablate_cuda(mode, feature, cut, lv, lidx, tfit, resid0, u,
                           consts, weights, cluster)
    return ablate_plain(mode, feature, cut, lv, lidx, tfit, resid0, weights)


bart_sweep_fused_batch.launches = 0
bart_sweep_fused_batch_tiled.launches = 0
bart_sweep_fused.launches = 0
bart_sweep_ablate.launches = 0
bart_sweep_fused_batch.last_cluster = None
bart_sweep_fused_batch_tiled.last_cluster = None
bart_sweep_ablate.last_cluster = None
