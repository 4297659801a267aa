"""float64 state on the sweep path the card takes: the wrappers
``bart_sweep_fused_batch``, ``bart_sweep_fused_batch_tiled``,
``bart_sweep_fused`` and ``bart_sweep_fused_sharded`` on float64 states
against the JAX package's XLA ``bart_sweep`` in float64, which sweeps any
float64 fit (its Pallas kernels are float32 only).

On a CUDA state each wrapper launches its kernel's double-precision
build (``ops/cuda_build.py``: ``<name>_f64``); on these CPU states it runs
the plain float64 sweep those builds are held to on the card.  Without
the regrow the variates are drawn in float32 and widened, as ``_fused``
draws and widens them, and the JAX sweep takes the same widened values;
the JAX sweep refuses pre-drawn variates with the regrow, so at
``p_regrow = 1`` both take its own float64 draws, replayed from its keys
(``tests/test_torch_regrow_sweep.py``'s ``_replayed``).  The sharded
wrapper runs two shards in two threads of this process, its reduce hook
a sum over the shards, against the unsharded JAX sweep: the same
forests, sums that differ by rounding.  Depth 6 (128-slot heaps) and 8
(512), the latter from a prior forest reaching depth 7 and 8.

Tolerance: forests and leaf indices identical, float64 values within
1e-9 (the same arithmetic, sums taken in another order).

Beside them: the float64 builds' ceilings on n and the state types the
kernels take, and (``cuda`` marker, skipped here) each float64 kernel
against the plain float64 sweep on the card and a small float64 fit
through the user entry point on the card."""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import stan4bart_torch
from stan4bart_torch.ops import bart as tb
from stan4bart_torch.ops import bart_sweep_kernel as tk
from stan4bart_torch.utils.friedman import (
    friedman_dataframe,
    generate_friedman_data,
)
from stan4bart_tpu.ops import bart as jb
from test_torch_regrow_sweep import N, T, _replayed

torch.set_num_threads(2)

P, C, SHARDS = 4, 3, 2
TOL = dict(rtol=1e-9, atol=1e-9)
FIELDS = ("feature", "cut", "leaf_idx")
VALUES = ("leaf_value", "tree_fit", "allfit")
WRAPPERS = {"batch": tk.bart_sweep_fused_batch,
            "tiled": tk.bart_sweep_fused_batch_tiled,
            "chain": tk.bart_sweep_fused}


def _forest(depth, seed):
    """A prior forest of C chains in float64 (power 0.5 past depth 6, so
    that it reaches depth 7), its weighted data and both configs."""
    kw = dict(num_trees=T, max_depth=depth, n_cuts=16)
    if depth > 6:
        kw["power"] = 0.5
    rng = np.random.default_rng(seed)
    X = rng.uniform(size=(N, P))
    y = np.sin(4 * X[:, 0]) + X[:, 1] + rng.normal(scale=0.3, size=N)
    cfg = tb.BartConfig(**kw)
    ranks = tb.compute_ranks(X, tb.make_cut_grid(X, cfg.n_cuts))
    sp = np.full(P, 1.0 / P)
    gen = torch.Generator()
    gen.manual_seed(seed)
    state = tb.sample_trees_from_prior(cfg, gen, torch.as_tensor(ranks), sp,
                                       C, dtype=torch.float64)
    state = state._replace(sigma_mu=torch.full((C,), 0.4,
                                               dtype=torch.float64))
    if depth > 6:
        assert int((state.feature[..., 127:] != tb.INACTIVE).sum()) > 0
    y_target = torch.as_tensor(y - y.mean()).expand(C, N).clone()
    sigma = torch.tensor([0.3, 0.5, 0.8], dtype=torch.float64)
    w = np.linspace(0.5, 2.0, N)
    return cfg, jb.BartConfig(**kw), state, y_target, ranks, sp, sigma, w


def _jax_sweep(jcfg, state, y_target, ranks, sp, sigma, w, keys,
               variates=None):
    js = jb.BartState(*(jnp.asarray(x.numpy()) for x in state))
    if variates is None:
        return jax.jit(jax.vmap(lambda s, yt, sg, k: jb.bart_sweep(
            jcfg, s, yt, jnp.asarray(ranks), sp, sg, k,
            weights=jnp.asarray(w))[0]))(
                js, jnp.asarray(y_target.numpy()),
                jnp.asarray(sigma.numpy()), keys)
    return jax.jit(jax.vmap(lambda s, yt, sg, uu, zz: jb.bart_sweep(
        jcfg, s, yt, jnp.asarray(ranks), sp, sg, jax.random.PRNGKey(0),
        weights=jnp.asarray(w), variates=(uu, zz))[0]))(
            js, jnp.asarray(y_target.numpy()), jnp.asarray(sigma.numpy()),
            *(jnp.asarray(v.double().numpy()) for v in variates))


def _variates(cfg, p_regrow, keys):
    """The wrappers' variates: float32 (u (C, T, 8), zn (C, T, pad)) to be
    widened without the regrow; with it the JAX sweep's own float64 draws
    in the wrappers' layout (u padded to 8, zn to the heap's slots)."""
    pad = tb.node_pad(cfg)
    if p_regrow == 0:
        rng = np.random.default_rng(7)
        return (torch.as_tensor(rng.uniform(size=(C, T, 8)),
                                dtype=torch.float32),
                torch.as_tensor(rng.normal(size=(C, T, pad)),
                                dtype=torch.float32))
    (u6, zn, rg), _ = _replayed(keys, cfg.max_nodes)
    u = torch.cat([u6, torch.zeros((C, T, 2), dtype=u6.dtype)], -1)
    zn = torch.cat([zn, torch.zeros((C, T, pad - zn.shape[-1]),
                                    dtype=zn.dtype)], -1)
    return u, zn, rg


def _assert_same(ref, port, sl=slice(None)):
    for name in FIELDS + VALUES:
        want = np.asarray(getattr(ref, name))
        if name in ("leaf_idx", "tree_fit", "allfit"):
            want = want[..., sl]
        got = getattr(port, name)
        if name in VALUES:
            assert got.dtype == torch.float64, name
            np.testing.assert_allclose(want, got.numpy(), **TOL,
                                       err_msg=name)
        else:
            np.testing.assert_array_equal(want, got.numpy(), err_msg=name)


def _sharded(cfg, state, y_target, ranks, sp, sigma, w, variates):
    """``bart_sweep_fused_sharded`` over SHARDS shards of the
    observations, one thread each, the reduce hook the sum over the
    shards in shard order; returns the shards' states and the blocks
    each reduced."""
    n = N // SHARDS
    barrier = threading.Barrier(SHARDS)
    slots, results = [None] * SHARDS, [None] * SHARDS
    blocks = [[] for _ in range(SHARDS)]
    errors = []

    def run(d):
        sl = slice(d * n, (d + 1) * n)

        def reduce(x):
            blocks[d].append(x.dtype)
            slots[d] = x
            barrier.wait()
            out = slots[0].clone()
            for other in slots[1:]:
                out = out + other
            barrier.wait()
            return out

        local = state._replace(leaf_idx=state.leaf_idx[..., sl],
                               allfit=state.allfit[..., sl],
                               tree_fit=state.tree_fit[..., sl])
        consts = tk.make_sweep_consts(cfg, ranks[sl], sp, device="cpu",
                                      dtype=torch.float64)
        try:
            results[d], _ = tk.bart_sweep_fused_sharded(
                cfg, local, y_target[:, sl], consts, sigma, None,
                weights=torch.as_tensor(w[sl]), reduce=reduce,
                variates=variates)
        except Exception as e:      # reported by the test thread
            errors.append(e)
            barrier.abort()

    threads = [threading.Thread(target=run, args=(d,))
               for d in range(SHARDS)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    if errors:
        raise errors[0]
    return results, blocks


@pytest.mark.parametrize("p_regrow", [0.0, 1.0])
@pytest.mark.parametrize("depth", [6, 8])
def test_float64_wrappers_match_reference(depth, p_regrow):
    cfg, jcfg, state, y_target, ranks, sp, sigma, w = _forest(depth,
                                                              5 + depth)
    cfg = cfg._replace(p_regrow=p_regrow)
    jcfg = jcfg._replace(p_regrow=p_regrow)
    keys = jax.random.split(jax.random.PRNGKey(11 + depth), C)
    variates = _variates(cfg, p_regrow, keys)
    ref = _jax_sweep(jcfg, state, y_target, ranks, sp, sigma, w, keys,
                     None if p_regrow else variates)
    consts = tk.make_sweep_consts(cfg, ranks, sp, device="cpu",
                                  dtype=torch.float64)
    assert consts.spcum.dtype == consts.psplit.dtype == torch.float64
    assert consts.node_pad == (128 if depth == 6 else 512)
    for name, wrapper in WRAPPERS.items():
        port, varcount = wrapper(cfg, state, y_target, consts, sigma, None,
                                 weights=torch.as_tensor(w),
                                 variates=variates)
        _assert_same(ref, port)
        assert varcount.shape == (C, P), name
    assert not torch.equal(port.feature, state.feature)
    shards, blocks = _sharded(cfg, state, y_target, ranks, sp, sigma, w,
                              variates)
    n = N // SHARDS
    for d, part in enumerate(shards):
        _assert_same(ref, part, slice(d * n, (d + 1) * n))
    # every block the shards reduce is float64: one per tree update, one
    # more per tree whose regrow gate opens in some chain
    assert blocks[0] == blocks[1]
    assert set(blocks[0]) == {torch.float64}
    assert len(blocks[0]) == (2 * T if p_regrow else T)


def test_float64_ceilings_and_state_types():
    """The float64 builds' n ceilings from their own shared memory, never
    past float32's at the same heap; at 128 slots one block still holds
    npad 10 368 (the JAX package's single-pass limit); float32 and
    float64 state taken, no other type."""
    T75 = 75
    # the per-tree state of the float32 builds is PR 12's (9168 B and
    # 35 520 B with the regrow at 128 and 512 slots)
    assert tk.on_chip_state(128) == 9168
    assert tk.on_chip_state(512) == 35_520
    assert tk.on_chip_state(128, torch.float64) == 10_000
    assert tk.on_chip_ceilings(128, T75) == (tk.MAX_NPAD, tk.MAX_N_CHAIN)
    for pad in tb.HEAP_PADS:
        f32 = tk.on_chip_ceilings(pad, T75)
        f64 = tk.on_chip_ceilings(pad, T75, torch.float64)
        assert f64[0] <= f32[0] and f64[1] <= f32[1], pad
        assert (tk.on_chip_block_obs(pad, T75, torch.float64)
                < tk.on_chip_block_obs(pad, T75))
        if pad > 128:
            # the deep float64 builds stop short of float32's ceilings
            assert f64[0] < f32[0] and f64[1] < f32[1], pad
    assert tk.on_chip_block_obs(128, T75, torch.float64) >= tk.MAX_NPAD
    assert tk.on_chip_ceilings(128, T75, torch.float64) == (tk.MAX_NPAD,
                                                             tk.MAX_N_CHAIN)
    cfg = tb.BartConfig(num_trees=T75, max_depth=8)
    ranks = np.zeros((1000, 3), np.int32)
    consts = tk.make_sweep_consts(cfg, ranks, np.full(3, 1 / 3),
                                  device="cpu", dtype=torch.float64)
    single64 = tk.on_chip_ceilings(512, T75, torch.float64)[0]
    for dtype in (torch.float32, torch.float64):
        tk.check_kernel_supports(consts._replace(npad=single64), dtype)
    # one row past the float64 single-pass ceiling: float32 still takes
    # it in one block, float64 goes to the obs-tiled kernel
    past = consts._replace(npad=single64 + 128)
    tk.check_kernel_supports(past, torch.float32)
    with pytest.raises(ValueError, match="bart_sweep_fused_batch_tiled"):
        tk.check_kernel_supports(past, torch.float64)
    tk.check_kernel_supports(past, torch.float64, "bart_sweep_tiled")
    for dtype in (torch.float16, torch.bfloat16):
        with pytest.raises(ValueError, match="float32 or float64"):
            tk.check_kernel_supports(consts, dtype, "bart_sweep_tiled")
        with pytest.raises(ValueError, match="float32 or float64"):
            tk.on_chip_ceilings(128, T75, dtype)


def _cuda_inputs(n, chains, seed, weighted):
    """Float64 operands of one sweep on the card from a prior forest."""
    dev = torch.device("cuda")
    rng = np.random.default_rng(seed)
    X = rng.uniform(size=(n, P))
    y = np.sin(4 * X[:, 0]) + X[:, 1] + rng.normal(scale=0.3, size=n)
    cfg = tb.BartConfig(num_trees=20)
    ranks = tb.compute_ranks(X, tb.make_cut_grid(X, cfg.n_cuts))
    sp = np.full(P, 1.0 / P)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    st = tb.sample_trees_from_prior(cfg, gen, torch.as_tensor(ranks,
                                                              device=dev),
                                    sp, chains, dtype=torch.float64)
    consts = tk.make_sweep_consts(cfg, ranks, sp, device=dev,
                                  dtype=torch.float64)
    u, zn = (v.double() for v in tb.draw_variates(
        gen, chains, cfg.num_trees, torch.float32, dev))
    rg = tb.draw_tree_regrow_variates(gen, chains, cfg, torch.float32,
                                      dev).double()
    yt = torch.as_tensor(y - y.mean(), device=dev)
    args = (cfg, st.feature, st.cut, st.leaf_idx, st.tree_fit,
            (yt - st.allfit).contiguous(),
            torch.full((chains,), 0.3, dtype=torch.float64, device=dev),
            torch.full((chains,), 0.01, dtype=torch.float64, device=dev),
            u, zn, consts)
    w = (torch.as_tensor(np.linspace(0.5, 2.0, n), device=dev)
         if weighted else None)
    return args, w, rg


@pytest.mark.cuda
@pytest.mark.parametrize("kernel",
                         ["batch", "tiled", "chain", "streamed", "sharded"])
def test_cuda_float64_kernels_match_plain(kernel):
    """Each float64 build against the plain float64 sweep on the card,
    weighted, at p_regrow 0 and 1: identical forests and leaf indices in
    every chain, values within 1e-9; its launches counted as float64
    ones.  ``streamed``: the obs-tiled kernel at K = 1 over more rows
    than a block holds on chip (its residual in device memory)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    n = 30_000 if kernel == "streamed" else 4_000
    args, w, rg = _cuda_inputs(n, 8, 3, weighted=True)
    launch, wrapper = {
        "batch": (tk.sweep_cuda, tk.bart_sweep_fused_batch),
        "tiled": (tk.sweep_tiled_cuda, tk.bart_sweep_fused_batch_tiled),
        "chain": (tk.sweep_chain_cuda, tk.bart_sweep_fused),
        "streamed": (lambda *a, **kw: tk.sweep_tiled_cuda(*a, cluster=1,
                                                          **kw),
                     tk.bart_sweep_fused_batch_tiled),
        "sharded": (tk.sweep_sharded_cuda, tk.bart_sweep_fused_sharded),
    }[kernel]
    if kernel == "streamed":
        assert not tk.kernel_smem("bart_sweep_tiled", n, 20, 1, True, 128,
                                  torch.float64)["resid_on_chip"]
    before = wrapper.f64_launches
    cfg = args[0]
    for p, r in ((0.0, None), (1.0, rg)):
        a = (cfg._replace(p_regrow=p),) + args[1:]
        k = launch(*a, weights=w, rg=r)
        ref = tk.sweep_plain(*a, weights=w, rg=r,
                             reduce=(lambda x: x) if kernel == "sharded"
                             else None)
        torch.cuda.synchronize()
        for x, y in zip(k[:2], ref[:2]):
            assert torch.equal(x, y)
        assert torch.equal(k[3], ref[3])
        for i in (2, 4, 5):
            assert k[i].dtype == torch.float64
            torch.testing.assert_close(k[i], ref[i], rtol=0, atol=1e-9)
    assert wrapper.f64_launches > before


@pytest.mark.cuda
def test_cuda_float64_fit_through_the_entry_point():
    """A small float64 fit on the card: every sweep a launch of the
    single-pass kernel's float64 build, finite float64 draws."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    df = friedman_dataframe(generate_friedman_data(500, ranef=True,
                                                   causal=True))
    w = tk.bart_sweep_fused_batch
    before = (w.launches, w.f64_launches)
    fit = stan4bart_torch.stan4bart(
        "y ~ bart(. - g.1 - g.2 - X4 - z) + X4 + z + (1 + X4 | g.1) "
        "+ (1 | g.2)", df, treatment="z", chains=4, iter=20, warmup=10,
        seed=1, verbose=-1, dtype=torch.float64,
        stan_args={"max_treedepth": 4}, bart_args={"n_trees": 20})
    launches = w.launches - before[0]
    assert launches == 21 and w.f64_launches - before[1] == launches
    assert fit.final_states.bart.leaf_value.dtype == torch.float64
    assert np.all(np.isfinite(fit.extract("indiv.bart")))
