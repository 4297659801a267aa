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
  driver's sweep: the single-pass kernel's on-chip sweep up to n = 51840,
  where a block's slice fits in shared memory from K = 2 on);
* on a CPU tensor it runs the plain PyTorch version of that function,
  ``ops/bart.py:sweep_trees`` (``tree_step`` looped over trees with the
  residual carried as the kernels carry it), for every wrapper.

All consume the same pre-drawn variates ``(u (C, T, 8), zn (C, T,
pad))`` (``pad = ops/bart.py:node_pad(cfg)``: 128 up to max_depth 6, 512
at depth 7 and 8, 1024 at 9, 2 ** (max_depth + 1) deeper) and, with
``cfg.p_regrow > 0``, the
in-sweep regrow's ``rg (C, T, 3 + 3 M)``
(``ops/bart.py:draw_tree_regrow_variates``), drawn here from the
caller's generator in that order when not supplied, so they compare
chain for chain, and all end with the chi(df, scale) k update
(``ops/bart.py:chi_k_update``) when ``cfg.k_df > 0``.  The varcount is
counted outside the kernel.  The regrow runs inside every kernel, after
each tree's move, where the tree's gate opens (``csrc/sweep_common.cuh``
``regrow_propose`` / ``regrow_mh``); with ``p_regrow == 0`` the kernels
get no regrow variates and run as without the move.

Each wrapper's ``launches`` counts its kernel's launches,
``regrow_launches`` those that ran the in-sweep regrow,
``deep_launches`` those of the deep builds, 512 or 1024 heap slots,
``heap_launches`` those of the heap builds (state in device memory),
``f64_launches`` those of the double-precision builds and
``weighted_launches`` those given likelihood weights (for the sharded
sweep: tree updates and regrow updates).

The cluster size K of every sweep kernel is ``cluster_size``'s choice
from the clusters the device holds at once, unless the caller forces it
with ``cluster=``; the K of the last launch is the wrapper's
``last_cluster``.  Each one-launch kernel is built twice, with the regrow
step and without: a launch with ``p_regrow == 0`` runs the one without,
the code and the shared memory of the sweep before the move existed, and
``kernel_smem`` (so the K) is the instantiation's.  Every kernel is also
built for three heap sizes (``HEAP_PADS``): 128 slots up to max_depth 6,
512 for max_depth 7 and 8 and 1024 for max_depth 9, whose per-tree state
and copy of the leaf indices (two bytes) take more shared memory, so
their ceilings on n (``on_chip_ceilings``) and their K come from their
own shared memory.  Deeper trees (``heap_build``: pads past 1024,
max_depth 10 and up) launch the heap builds, whose heap size is a
run-time argument and whose per-tree state lives in a slab of device
memory (``csrc/sweep_common.cuh:heap_bytes`` a block, allocated per
launch); their shared memory holds the observations, the ring and a few
scalars (two-byte copies of the leaf indices up to 32 768 slots,
four-byte past them), so they have ceilings of their own.  No depth is
refused: a forest that does not fit in device memory raises PyTorch's
out-of-memory error.  Every K gives a deterministic forest, the three
sweep kernels are bit-identical at equal K, and a heap build equals the
static build of its pad to the bit (``heap=True`` forces it at 512 or
1024 slots, for tests).  A K whose slice does not fit on chip has no
resident cluster and is never chosen; forced, its launch raises.

The kernels take float32 or float64 state.  Each source is built twice
(``ops/cuda_build.py``): the float32 library and ``<name>_f64``, whose
kernels hold the residual, tree fits, leaf values, variates and every sum
and decision in double, with ``_f64`` C symbols.  A float64 state
launches the double build (its ceilings on n and its K from its own
shared memory: 8 bytes of residual an observation and wider rings and
tree rows), never the float32 one; the variates are drawn in float32 as
for a float32 state and widened.

``bart_sweep_fused_sharded`` is the observation-sharded sweep of one
rank of a data group: on a CUDA tensor ``csrc/bart_sweep_sharded.cu``,
two launches per tree with the caller's all-reduce between them, and two
more with a second all-reduce per tree whose regrow gate opens in some
chain (the counterpart of the JAX package's XLA
``bart_sweep(axis_name=)``, which no Pallas kernel implements); on a CPU
tensor ``sweep_trees`` with the same ``reduce`` hook.

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
    HEAP_PADS,
    BartConfig,
    BartState,
    chi_k_update,
    count_variable_use,
    draw_tree_regrow_variates,
    draw_variates,
    node_depths,
    node_pad,
    split_prob_by_depth,
    sweep_trees,
)
from stan4bart_torch.utils.device import resolve_device

# heap slots of the depth <= 6 builds; the deep builds have 512 and 1024
NODE_PAD = HEAP_PADS[0]
# the largest heap whose heap build keeps two-byte copies of the leaf
# indices (15 bits of node and the left flag: max_depth 14); past it four
HEAP_PAD_2B = 1 << 15
# widest observation row the single-pass kernel takes at depth <= 6 (the
# JAX package's single-pass limit); wider fits go to the obs-tiled kernel
MAX_NPAD = 10_368
# widest observation row the per-chain kernel takes at depth <= 6 (the JAX
# package's per-chain limit, ``sweep_single_ok``); it always fits on chip
# at K >= 2
MAX_N_CHAIN = 51_840
# the opt-in shared memory limit of a block on an H100 (227 KB); the
# deep builds' ceilings are computed against it, and every launch checks
# the device's own
SMEM_OPTIN = 232_448
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
    spcum: torch.Tensor     # (P,) split-probability inclusive cumsum
    psplit: torch.Tensor    # (max_depth + 2,) p_split by depth
    depths: torch.Tensor    # (M,) int64 node depth by heap index
    n_obs: int
    npad: int               # n rounded up to the TPU kernel's 128 lanes
    node_pad: int = NODE_PAD  # heap slots (``ops/bart.py:node_pad``)
    num_trees: int = 0      # T, which the deep builds' ceilings read


def make_sweep_consts(cfg: BartConfig, ranks, split_probs,
                      device="cuda", dtype=torch.float32) -> SweepConsts:
    """Static operands of the sweep from the model data (ranks (N, P)),
    the split probabilities in the state's ``dtype`` (the cumsum taken in
    it).  Every sweep takes any depth: on the card past max_depth 9 the
    kernels' heap builds."""
    device = resolve_device(device)
    ranks = np.asarray(ranks)
    n = ranks.shape[0]
    np_dtype = torch.empty((), dtype=dtype).numpy().dtype
    return SweepConsts(
        ranks_t=torch.as_tensor(np.ascontiguousarray(ranks.T),
                                dtype=torch.int32, device=device),
        spcum=torch.as_tensor(np.cumsum(np.asarray(split_probs, np_dtype)),
                              device=device),
        psplit=torch.as_tensor(split_prob_by_depth(cfg), dtype=dtype,
                               device=device),
        depths=torch.as_tensor(node_depths(cfg), dtype=torch.long,
                               device=device),
        n_obs=n,
        npad=-(-max(n, 128) // 128) * 128,
        node_pad=node_pad(cfg),
        num_trees=cfg.num_trees,
    )


def heap_build(pad: int) -> bool:
    """Whether a sweep of ``pad`` heap slots launches the kernels' heap
    builds (state in device memory): past the static builds' pads."""
    return pad > HEAP_PADS[-1]


def leaf_copy_bytes(pad: int) -> int:
    """Bytes an observation of the on-chip sweep's copy of the leaf
    indices takes at ``pad`` heap slots (its top bit the left flag): 1 at
    128, 2 up to ``HEAP_PAD_2B``, 4 past it (a heap build's only)."""
    if pad <= NODE_PAD:
        return 1
    return 2 if pad <= HEAP_PAD_2B else 4


def _round(x: int, k: int) -> int:
    return -(-x // k) * k


def _real_bytes(dtype) -> int:
    """Bytes of the kernels' real type for state of ``dtype``."""
    check_kernel_dtype(dtype)
    return 8 if dtype == torch.float64 else 4


def on_chip_state(pad: int, dtype=torch.float32) -> int:
    """Shared memory per block of the per-tree state of a sweep kernel
    built for ``pad`` heap slots and state of ``dtype`` with the regrow
    step (static up to 512 slots, dynamic at 1024): ``sizeof`` of
    ``csrc/sweep_common.cuh``'s TreeShared (two int rows and a row of
    leaf values, two fixed-point histograms, the warp sums, the NOG mask,
    the scalars) and RegrowShared (two rows, a histogram, four masks,
    three ints).  A heap build's (past 1024) are TreeHeap and RegrowHeap,
    its views of the slab (pointers) beside the warp sums and scalars,
    the same at every pad: 576 B in float32, 896 B in float64."""
    b = _real_bytes(dtype)
    if heap_build(pad):
        return _round(112 + 80 * b + 44, 8) + 96
    return (_round((40 + b) * pad + pad // 8 + 80 * b + 44, 8)
            + _round(24 * pad + pad // 2 + 12, 8))


def on_chip_block_obs(pad: int, T: int, dtype=torch.float32) -> int:
    """Observations one block of ``csrc/sweep_cluster.cuh:sweep_on_chip``
    (the build with the regrow step, the larger) holds within
    ``SMEM_OPTIN`` bytes, a multiple of 32: what is left after the
    per-tree state, the ring (3 tiles of 1024 observations x (8 + b) B,
    b the real type's bytes: 4, or 8 for float64), the tree rows in
    flight (3 x (8 + b) B x pad + 24 b B; none in a heap build, which
    reads them from device memory) and the trees' variables (4 B x T), at
    b B of residual and ``leaf_copy_bytes`` of leaf index copy per
    observation (``on_chip_bytes``)."""
    b = _real_bytes(dtype)
    heads = 0 if heap_build(pad) else 3 * (8 + b) * pad + 24 * b
    left = (SMEM_OPTIN - on_chip_state(pad, dtype) - 3072 * (8 + b)
            - heads - _round(4 * T, 16))
    # a multiple of 32 observations needs no padding of its copy
    return max(left // (b + leaf_copy_bytes(pad)) // 32 * 32, 0)


def on_chip_ceilings(pad: int, T: int,
                     dtype=torch.float32) -> tuple[int, int]:
    """The widest padded observation rows (multiples of 128) of the
    single-pass and per-chain kernels at ``pad`` heap slots, T trees and
    state of ``dtype``: at 128 the JAX package's limits (``MAX_NPAD``,
    ``MAX_N_CHAIN``), which fit on chip in either type (one float64 block
    holds 18 496 observations at 75 trees); above, what the build with
    the regrow (the larger) holds in one block (single-pass, K = 1) and
    in a cluster of ``MAX_CLUSTER`` blocks (per-chain), from the type's
    own bytes (a float64 build's below float32's: each observation and
    tree row takes more)."""
    check_kernel_dtype(dtype)
    if pad == NODE_PAD:
        return MAX_NPAD, MAX_N_CHAIN
    block = on_chip_block_obs(pad, T, dtype)
    return block // 128 * 128, MAX_CLUSTER * block // 128 * 128


def _regrow_variates(cfg: BartConfig, rg):
    """The regrow variates a sweep takes: None when ``cfg.p_regrow`` is 0
    (the move is off and ``rg`` is not read), else ``rg``, which must be
    given."""
    if cfg.p_regrow <= 0:
        return None
    if rg is None:
        raise ValueError("p_regrow > 0 needs the regrow variates rg "
                         "(ops/bart.py:draw_tree_regrow_variates)")
    return rg


def sweep_plain(cfg: BartConfig, feature, cut, lidx, tfit, resid0, sigma2,
                tau2, u, zn, consts: SweepConsts, weights=None, reduce=None,
                rg=None):
    """``ops/bart.py:sweep_trees`` on the kernel's operands, in resid0's
    dtype; with ``reduce``, its observation-sharded form (the plain
    version of ``csrc/bart_sweep_sharded.cu``); ``rg`` the regrow
    variates when ``cfg.p_regrow > 0``.  Returns (feature, cut,
    leaf_value, leaf_idx, tree_fit, resid)."""
    dtype = resid0.dtype
    rg = _regrow_variates(cfg, rg)
    return sweep_trees(cfg, feature, cut, lidx, tfit, resid0, sigma2, tau2,
                       u, zn, consts.ranks_t.long(), consts.spcum.to(dtype),
                       consts.depths, consts.psplit.to(dtype),
                       weights=weights, reduce=reduce,
                       rg=None if rg is None else rg.to(dtype))


def cluster_size(C: int, N: int, resident) -> int:
    """Blocks per chain K of the sweep kernels, from ``resident``:
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


def _entry(name: str, entry: str, dtype):
    """The C entry point ``<name>_<entry>`` of sweep kernel ``name``'s
    build for state of ``dtype``, built and loaded on first use: the
    float32 library, or the double-precision one (``ops/cuda_build.py``:
    library ``<name>_f64``, whose symbols end in ``_f64``)."""
    from stan4bart_torch.ops.cuda_build import F64, load

    sfx = F64 if _real_bytes(dtype) == 8 else ""
    return getattr(load(name + sfx), f"{name}_{entry}{sfx}")


def _operands(cfg: BartConfig, feature, cut, lidx, tfit, resid0, sigma2,
              tau2, u, zn, consts: SweepConsts, weights, rg=None):
    """Check a sweep kernel's operands and allocate its outputs; returns
    (outputs, the launcher's leading ctypes arguments up to the heap
    slots, the argtypes up to the state slab's).  Every float operand is
    in resid0's dtype, float32 or float64, the kernel's real type; the
    scalars go as that type.  The regrow variates go to the kernel only
    when ``cfg.p_regrow > 0`` (else a null pointer: the move is off)."""
    C, T, M = feature.shape
    N = consts.n_obs
    P = consts.ranks_t.shape[0]
    i32, real = torch.int32, resid0.dtype
    check_kernel_dtype(real)
    _check(feature, "feature", i32, (C, T, M))
    _check(cut, "cut", i32, (C, T, M))
    _check(lidx, "leaf_idx", i32, (C, T, N))
    _check(tfit, "tree_fit", real, (C, T, N))
    _check(resid0, "resid", real, (C, N))
    _check(sigma2, "sigma2", real, (C,))
    _check(tau2, "tau2", real, (C,))
    _check(u, "u", real, (C, T, 8))
    _check(zn, "zn", real, (C, T, consts.node_pad))
    _check(consts.ranks_t, "ranks", i32, (P, N))
    _check(consts.spcum, "spcum", real, (P,))
    _check(consts.psplit, "psplit", real, (cfg.max_depth + 2,))
    if weights is not None:
        _check(weights, "weights", real, (N,))
    rg = _regrow_variates(cfg, rg)
    if rg is not None:
        _check(rg, "rg", real, (C, T, 3 + 3 * M))

    feature_o = torch.empty_like(feature)
    cut_o = torch.empty_like(cut)
    lv_o = torch.empty((C, T, M), dtype=real, device=feature.device)
    lidx_o = torch.empty_like(lidx)
    tfit_o = torch.empty_like(tfit)
    resid_o = torch.empty_like(resid0)
    outs = (feature_o, cut_o, lv_o, lidx_o, tfit_o, resid_o)
    head = ([_ptr(x) for x in (feature, cut, lidx, tfit, resid0, sigma2,
                               tau2, u, zn, consts.ranks_t, consts.spcum,
                               consts.psplit, weights)]
            + [_ptr(x) for x in outs]
            + [C, T, N, P, M, cfg.max_depth, cfg.n_cuts,
               cfg.p_grow, cfg.p_prune,
               math.log(cfg.p_prune) - math.log(cfg.p_grow),
               math.log(cfg.p_grow) - math.log(cfg.p_prune),
               cfg.p_regrow, _ptr(rg), consts.node_pad])
    scalar = ctypes.c_double if real == torch.float64 else ctypes.c_float
    argtypes = ([ctypes.c_void_p] * 19 + [ctypes.c_int] * 7
                + [scalar] * 5 + [ctypes.c_void_p, ctypes.c_int,
                                  ctypes.c_void_p])
    return outs, head, argtypes


def _use_heap(consts: SweepConsts, heap) -> bool:
    """Whether to launch the heap build: past the static builds' pads,
    or where ``heap`` forces it."""
    return heap_build(consts.node_pad) if heap is None else bool(heap)


def _slab(name: str, consts: SweepConsts, blocks: int, regrow: bool,
          dtype, device):
    """The heap build's state slab of ``blocks`` blocks (its bytes a
    block from ``kernel_smem``: the build's own ``heap_bytes``)."""
    per = kernel_smem(name, consts.n_obs, consts.num_trees, 1, regrow,
                      consts.node_pad, dtype, heap=True)["heap"]
    return torch.empty(blocks * per, dtype=torch.uint8, device=device)


def _launch(name: str, cfg: BartConfig, feature, cut, lidx, tfit, resid0,
            sigma2, tau2, u, zn, consts: SweepConsts, weights, K: int,
            rg=None, heap=False):
    """Check the operands and launch kernel ``csrc/<name>.cu`` (its
    build for resid0's dtype; the heap build with a state slab of C * K
    blocks when ``heap``) on the current stream in clusters of K blocks
    per chain; returns its fresh outputs."""
    outs, head, argtypes = _operands(cfg, feature, cut, lidx, tfit, resid0,
                                     sigma2, tau2, u, zn, consts, weights,
                                     rg)
    slab = (_slab(name, consts, feature.shape[0] * K, cfg.p_regrow > 0,
                  resid0.dtype, feature.device) if heap else None)
    fn = _entry(name, "launch", resid0.dtype)
    fn.restype = ctypes.c_int
    fn.argtypes = argtypes + [ctypes.c_int, ctypes.c_void_p]
    stream = torch.cuda.current_stream(feature.device).cuda_stream
    err = fn(*head, _ptr(slab), K, ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    return outs


_info_cache: dict = {}


def kernel_smem(name: str, N: int, T: int, K: int,
                regrow: bool = False, pad: int = NODE_PAD,
                dtype=torch.float32, heap=None) -> dict:
    """Shared memory per block of the sweep kernel ``name``
    (``bart_sweep_batch``, ``bart_sweep_tiled``, ``bart_sweep_chain`` or,
    its stats launch, ``bart_sweep_sharded``)
    at N observations, T trees and clusters of K blocks, on the current
    CUDA device, for the build with ``pad`` heap slots (the heap build
    past 1024 or where ``heap`` forces it) and state of ``dtype`` and,
    for the one-launch kernels, the instantiation with the in-sweep
    regrow when ``regrow``: static and dynamic bytes, the device's opt-in
    limit, how many clusters can be resident at once (0 where the on-chip
    kernels' slice does not fit), whether the residual stays on chip, and
    ``heap``, the heap build's state slab a block (0 in a static build;
    the sharded kernel's with its regrow launches' state)."""
    sharded = name == "bart_sweep_sharded"
    regrow = bool(regrow) and not sharded
    heap = heap_build(pad) if heap is None else bool(heap)
    key = (name, dtype, N, T, K, regrow, pad, heap,
           torch.cuda.current_device())
    if key not in _info_cache:
        fn = _entry(name, "info", dtype)
        fn.restype = ctypes.c_int
        st, dy, hb = ctypes.c_longlong(), ctypes.c_longlong(), \
            ctypes.c_longlong()
        optin, clusters, on_chip = ctypes.c_int(), ctypes.c_int(), \
            ctypes.c_int(1)
        args = ([N, T, K, pad] + ([] if sharded else [int(regrow)])
                + [int(heap), ctypes.byref(st), ctypes.byref(dy),
                   ctypes.byref(optin), ctypes.byref(clusters)])
        if name == "bart_sweep_tiled":
            args.append(ctypes.byref(on_chip))
        args.append(ctypes.byref(hb))
        err = fn(*args)
        if err != 0:
            raise RuntimeError(f"{name}_info failed: CUDA error {err}")
        _info_cache[key] = dict(static=st.value, dynamic=dy.value,
                                optin=optin.value, clusters=clusters.value,
                                resid_on_chip=bool(on_chip.value),
                                heap=hb.value)
    return _info_cache[key]


def _cluster(name: str, C: int, T: int, consts: SweepConsts, cluster,
             regrow: bool = False, dtype=torch.float32,
             heap: bool = False) -> int:
    """The cluster size to launch: ``cluster`` when given, else
    ``cluster_size`` from the device's resident clusters at each K (of
    the kernel with the regrow step when ``regrow``, of its build for
    ``dtype``, of the heap build when ``heap``)."""
    if cluster is not None:
        if not 1 <= cluster <= MAX_CLUSTER:
            raise ValueError(f"cluster must be in 1..{MAX_CLUSTER}, got "
                             f"{cluster}")
        return cluster
    N = consts.n_obs
    pad = consts.node_pad
    resident = [kernel_smem(name, N, T, K, regrow, pad, dtype,
                            heap)["clusters"]
                if K == 1 or N / K >= MIN_OBS_PER_BLOCK else 0
                for K in range(1, MAX_CLUSTER + 1)]
    return cluster_size(C, N, resident)


def _counted(wrapper, cfg: BartConfig, consts: SweepConsts, K: int, dtype,
             heap: bool, weighted: bool):
    """One launch of ``wrapper``'s kernel in clusters of K, its build for
    ``dtype`` (the heap build when ``heap``), with weights when
    ``weighted``: its counts."""
    wrapper.launches += 1
    wrapper.weighted_launches += int(weighted)
    wrapper.regrow_launches += int(cfg.p_regrow > 0)
    wrapper.deep_launches += int(consts.node_pad > NODE_PAD and not heap)
    wrapper.heap_launches += int(heap)
    wrapper.f64_launches += int(dtype == torch.float64)
    wrapper.last_cluster = K


def _one_launch(name: str, wrapper, cfg: BartConfig, args, weights, cluster,
                rg, heap):
    """Launch one-launch sweep kernel ``name`` on ``args`` (feature, cut,
    lidx, tfit, resid0, sigma2, tau2, u, zn, consts) at ``cluster_size``'s
    K (or ``cluster``), its heap build past 1024 slots or where ``heap``
    forces it; counts the launch on ``wrapper``."""
    feature, resid0, consts = args[0], args[4], args[-1]
    heap = _use_heap(consts, heap)
    C, T = feature.shape[:2]
    K = _cluster(name, C, T, consts, cluster, cfg.p_regrow > 0,
                 resid0.dtype, heap)
    out = _launch(name, cfg, *args, weights, K, rg, heap)
    _counted(wrapper, cfg, consts, K, resid0.dtype, heap,
             weights is not None)
    return out


def sweep_cuda(cfg: BartConfig, feature, cut, lidx, tfit, resid0, sigma2,
               tau2, u, zn, consts: SweepConsts, weights=None, cluster=None,
               rg=None, heap=None):
    """Launch ``csrc/bart_sweep_batch.cu`` on the current stream; same
    contract as ``sweep_plain`` (all float inputs in resid0's dtype,
    float32 or float64).  ``cluster`` forces the blocks per chain
    (default: ``cluster_size``'s rule); ``heap=True`` forces the heap
    build at 512 or 1024 slots (a test aid: it runs past 1024 anyway)."""
    return _one_launch("bart_sweep_batch", bart_sweep_fused_batch, cfg,
                       (feature, cut, lidx, tfit, resid0, sigma2, tau2, u,
                        zn, consts), weights, cluster, rg, heap)


def sweep_tiled_cuda(cfg: BartConfig, feature, cut, lidx, tfit, resid0,
                     sigma2, tau2, u, zn, consts: SweepConsts,
                     weights=None, cluster=None, rg=None, heap=None):
    """Launch the obs-tiled ``csrc/bart_sweep_tiled.cu`` on the current
    stream; same contract as ``sweep_plain`` at any n (all float inputs
    in resid0's dtype, float32 or float64).  ``cluster`` forces the
    blocks per chain (default: ``cluster_size``'s rule), ``heap=True``
    the heap build."""
    return _one_launch("bart_sweep_tiled", bart_sweep_fused_batch_tiled,
                       cfg, (feature, cut, lidx, tfit, resid0, sigma2, tau2,
                             u, zn, consts), weights, cluster, rg, heap)


def sweep_chain_cuda(cfg: BartConfig, feature, cut, lidx, tfit, resid0,
                     sigma2, tau2, u, zn, consts: SweepConsts,
                     weights=None, cluster=None, rg=None, heap=None):
    """Launch the per-chain ``csrc/bart_sweep_chain.cu`` on the current
    stream; same contract as ``sweep_plain`` up to its ceiling (all float
    inputs in resid0's dtype, float32 or float64).  ``cluster`` forces
    the blocks per chain (default: ``cluster_size``'s rule); a K whose
    slice does not fit on chip raises.  ``heap=True`` forces the heap
    build."""
    return _one_launch("bart_sweep_chain", bart_sweep_fused, cfg,
                       (feature, cut, lidx, tfit, resid0, sigma2, tau2, u,
                        zn, consts), weights, cluster, rg, heap)


def apply_blocks(C: int, N: int) -> int:
    """Blocks per chain of the sharded sweep's apply launch: enough for two
    blocks per SM of a 132-SM card over all chains, at least
    ``MIN_OBS_PER_BLOCK`` observations each."""
    return max(1, min(-(-N // MIN_OBS_PER_BLOCK), -(-264 // C)))


def sweep_sharded_cuda(cfg: BartConfig, feature, cut, lidx, tfit, resid0,
                       sigma2, tau2, u, zn, consts: SweepConsts,
                       weights=None, reduce=None, cluster=None, rg=None,
                       heap=None):
    """The observation-sharded sweep of ``csrc/bart_sweep_sharded.cu`` on
    the current stream: per tree a stats launch (clusters of K blocks per
    chain over this rank's observations), ``reduce`` of the (C, 2, M + 2)
    block over the data group (None: one rank), and an apply launch; then
    a flush launch.  With ``cfg.p_regrow > 0``, a tree whose regrow gate
    opens in some chain (read from ``rg`` once per sweep) adds a regrow
    stats launch, a ``reduce`` of a second (C, 2, M + 1) block and a
    regrow apply launch.  Same contract as ``sweep_plain`` with the same
    ``reduce`` (all float inputs, and the reduced blocks, in resid0's
    dtype, float32 or float64); ``cluster`` forces the stats launches'
    blocks per chain, ``heap=True`` the heap build (which runs past 1024
    slots, its slab of C x max(K, apply blocks) blocks allocated once a
    sweep).  ``bart_sweep_fused_sharded.launches``
    counts tree updates (one stats and one apply launch each),
    ``.regrow_launches`` regrow updates (one regrow stats and one regrow
    apply launch each)."""
    C, T, M = feature.shape
    real = resid0.dtype
    heap = _use_heap(consts, heap)
    K = _cluster("bart_sweep_sharded", C, T, consts, cluster, dtype=real,
                 heap=heap)
    nb = apply_blocks(C, consts.n_obs)
    outs, head, argtypes = _operands(cfg, feature, cut, lidx, tfit, resid0,
                                     sigma2, tau2, u, zn, consts, weights,
                                     rg)
    slab = (_slab("bart_sweep_sharded", consts, C * max(K, nb), True, real,
                  feature.device) if heap else None)
    head = head + [_ptr(slab)]
    stats, apply_, regrow_stats, regrow_apply = (
        _entry("bart_sweep_sharded", e, real)
        for e in ("stats", "apply", "regrow_stats", "regrow_apply"))
    # each launcher's pointers between t and its last int (K or nb)
    tail = ((stats, 2), (apply_, 2), (regrow_stats, 3), (regrow_apply, 2))
    for fn, ptrs in tail:
        fn.restype = ctypes.c_int
        fn.argtypes = (argtypes + [ctypes.c_int] + [ctypes.c_void_p] * ptrs
                       + [ctypes.c_int, ctypes.c_void_p])
    stream = ctypes.c_void_p(
        torch.cuda.current_stream(feature.device).cuda_stream)
    dev = feature.device
    blk = torch.empty((C, 2, M + 2), dtype=real, device=dev)
    rg = _regrow_variates(cfg, rg)
    # the trees whose regrow gate opens in some chain, and their scratch:
    # the tree's fixed-point scales and post-move sums and rows
    opens = ([False] * T if rg is None
             else (rg[..., 0] < cfg.p_regrow).any(0).tolist())
    scl = post = None
    if any(opens):
        scl = torch.empty((C, 2), dtype=torch.int32, device=dev)
        post = torch.empty((C, 4, M), dtype=real, device=dev)

    def check(err, what):
        if err != 0:
            raise RuntimeError(f"bart_sweep_sharded {what} launch failed: "
                               f"CUDA error {err}")

    def reduced(x):
        if reduce is None:
            return x
        shape = x.shape
        x = reduce(x)
        _check(x, "reduced block", real, shape)
        return x

    for t in range(T + 1):
        check(stats(*head, t, _ptr(blk), _ptr(scl), K, stream), "stats")
        if t == T:
            break
        blk = reduced(blk)
        kept = post if opens[t] else None
        check(apply_(*head, t, _ptr(blk), _ptr(kept), nb, stream), "apply")
        bart_sweep_fused_sharded.launches += 1
        bart_sweep_fused_sharded.deep_launches += int(
            consts.node_pad > NODE_PAD and not heap)
        bart_sweep_fused_sharded.heap_launches += int(heap)
        bart_sweep_fused_sharded.f64_launches += int(real == torch.float64)
        bart_sweep_fused_sharded.weighted_launches += int(
            weights is not None)
        if not opens[t]:
            continue
        rblk = torch.empty((C, 2, M + 1), dtype=real, device=dev)
        check(regrow_stats(*head, t, _ptr(rblk), _ptr(scl), _ptr(post), K,
                           stream), "regrow stats")
        rblk = reduced(rblk)
        check(regrow_apply(*head, t, _ptr(rblk), _ptr(post), nb, stream),
              "regrow apply")
        bart_sweep_fused_sharded.regrow_launches += 1
    bart_sweep_fused_sharded.last_cluster = K
    return outs


_LAUNCH = {"bart_sweep_batch": sweep_cuda,
           "bart_sweep_tiled": sweep_tiled_cuda,
           "bart_sweep_chain": sweep_chain_cuda,
           "bart_sweep_sharded": sweep_sharded_cuda}


def check_kernel_dtype(dtype) -> None:
    """Raise for a state type the CUDA sweep kernels are not built for
    (they take float32 and float64)."""
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"the CUDA sweep kernels take float32 or float64 "
                         f"state, not {dtype}")


def check_kernel_supports(consts: SweepConsts, dtype,
                          kernel: str = "bart_sweep_batch") -> None:
    """Raise for a sweep CUDA kernel ``kernel`` does not take: float32 or
    float64 state only; past the single-pass or per-chain kernel's
    ceiling (``on_chip_ceilings``: npad 10368 and 51840 at depth <= 6)
    only the obs-tiled kernel.  Every kernel takes the in-sweep regrow
    (``p_regrow``) and any depth (past max_depth 9 its heap build)."""
    check_kernel_dtype(dtype)
    single, chain = on_chip_ceilings(consts.node_pad, consts.num_trees,
                                     dtype)
    limit = {"bart_sweep_batch": single,
             "bart_sweep_chain": chain}.get(kernel)
    if limit is not None and consts.npad > limit:
        raise ValueError(
            f"n = {consts.n_obs} (npad {consts.npad} > {limit}) is past "
            f"the shared memory of {kernel}; use "
            "bart_sweep_fused_batch_tiled")


def _fused(kernel: str, cfg: BartConfig, state: BartState, y_target,
           consts: SweepConsts, sigma, gen, weights, variates, gamma,
           reduce=None, **launch_kw):
    dev = state.allfit.device
    dtype = state.allfit.dtype
    C, T = state.feature.shape[:2]
    on_cuda = dev.type == "cuda"
    if on_cuda:
        check_kernel_supports(consts, dtype, kernel)
    # the variates are drawn in float32 and consumed in the state's dtype
    work = dtype
    if variates is None:
        variates = draw_variates(gen, C, T, torch.float32, dev,
                                 consts.node_pad)
        if cfg.p_regrow > 0:
            variates += (draw_tree_regrow_variates(gen, C, cfg,
                                                   torch.float32, dev),)
    u, zn, *rg = (v.to(work).contiguous() for v in variates)
    rg = rg[0] if rg else None
    resid0 = (y_target - state.allfit).to(work).contiguous()
    sigma2 = (sigma * sigma).to(work).contiguous()
    tau2 = (state.sigma_mu * state.sigma_mu).to(work).contiguous()
    w = (None if weights is None
         else torch.as_tensor(weights, device=dev).to(work).contiguous())
    args = (cfg, state.feature.contiguous(), state.cut.contiguous(),
            state.leaf_idx.contiguous(),
            state.tree_fit.to(work).contiguous(), resid0, sigma2, tau2,
            u, zn, consts)
    if reduce is not None:
        launch_kw["reduce"] = reduce
    if on_cuda:
        out = _LAUNCH[kernel](*args, weights=w, rg=rg, **launch_kw)
    else:
        out = sweep_plain(*args, weights=w, reduce=reduce, rg=rg)
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
    are given and k is fixed), variates ``(u, zn)`` or, with
    ``cfg.p_regrow > 0``, ``(u, zn, rg)``, gamma (C,) optional standard
    gamma draws replacing those of the chi(df, scale) k update.  Returns
    (state, varcount (C, P)).

    On a CUDA state this launches ``csrc/bart_sweep_batch.cu``, its
    build for the state's dtype (float32 or float64; n up to
    ``on_chip_ceilings``, 10368 at depth <= 6; wider fits raise and
    belong to ``bart_sweep_fused_batch_tiled``); ``cluster`` forces its
    blocks per chain.  On a CPU state it runs the plain version."""
    return _fused("bart_sweep_batch", cfg, state, y_target, consts, sigma,
                  gen, weights, variates, gamma, cluster=cluster)


def bart_sweep_fused_batch_tiled(cfg: BartConfig, state: BartState,
                                 y_target, consts: SweepConsts, sigma, gen,
                                 *, weights=None, variates=None, gamma=None,
                                 cluster=None):
    """``bart_sweep_fused_batch`` at any n: on a CUDA state this launches
    the obs-tiled ``csrc/bart_sweep_tiled.cu`` (float32 or float64;
    ``cluster`` forces its blocks per chain); on a CPU state it runs the
    same plain version."""
    return _fused("bart_sweep_tiled", cfg, state, y_target, consts, sigma,
                  gen, weights, variates, gamma, cluster=cluster)


def bart_sweep_fused(cfg: BartConfig, state: BartState, y_target,
                     consts: SweepConsts, sigma, gen, *, weights=None,
                     variates=None, gamma=None, cluster=None):
    """The per-chain driver's sweep: ``bart_sweep_fused_batch``'s
    contract on a chain-batched state, where the JAX package vmaps its
    one-chain ``bart_sweep_fused`` (C = 1 is one chain).  The variates
    are drawn as the batch wrappers draw them, so ``GibbsProgram.step``
    and ``step_batched`` consume the generator identically.

    On a CUDA state this launches the per-chain
    ``csrc/bart_sweep_chain.cu`` (float32 or float64; n up to
    ``on_chip_ceilings``, 51840 at depth <= 6; wider fits raise and belong
    to ``bart_sweep_fused_batch_tiled``); ``cluster`` forces its blocks
    per chain.  On a CPU state it runs the same plain version."""
    return _fused("bart_sweep_chain", cfg, state, y_target, consts, sigma,
                  gen, weights, variates, gamma, cluster=cluster)


def bart_sweep_fused_sharded(cfg: BartConfig, state: BartState, y_target,
                             consts: SweepConsts, sigma, gen, *,
                             weights=None, reduce=None, variates=None):
    """The observation-sharded sweep: ``bart_sweep_fused_batch``'s contract
    on this rank's shard of the observations (y_target, the state's
    leaf_idx / tree_fit / allfit, the weights and ``consts`` are the
    shard's), every sufficient statistic summed over the data group by
    ``reduce`` (one call per tree update; None on one rank).  The
    variates are drawn as the other wrappers draw them, from a generator
    that every rank of the data group holds in the same state, so the
    forests are the same on every rank (or given, as theirs, the same on
    every rank).

    On a CUDA state this runs ``csrc/bart_sweep_sharded.cu``
    (``sweep_sharded_cuda``, float32 or float64).  On a CPU state it runs
    the plain sharded sweep (``sweep_plain`` with ``reduce``)."""
    return _fused("bart_sweep_sharded", cfg, state, y_target, consts, sigma,
                  gen, weights, variates, None, reduce=reduce)


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


for _wrapper in (bart_sweep_fused_batch, bart_sweep_fused_batch_tiled,
                 bart_sweep_fused, bart_sweep_fused_sharded):
    _wrapper.launches = 0
    _wrapper.regrow_launches = 0
    _wrapper.deep_launches = 0
    _wrapper.heap_launches = 0
    _wrapper.f64_launches = 0
    _wrapper.weighted_launches = 0
bart_sweep_ablate.launches = 0
bart_sweep_fused_batch.last_cluster = None
bart_sweep_fused_batch_tiled.last_cluster = None
bart_sweep_fused.last_cluster = None
bart_sweep_fused_sharded.last_cluster = None
bart_sweep_ablate.last_cluster = None
