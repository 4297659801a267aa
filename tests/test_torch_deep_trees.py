"""Trees deeper than 6 (``bart_args={"max_depth": 8}``): the port's plain
sweeps against the JAX package's XLA sweep, which takes any depth.

A depth-8 heap has 511 nodes, so the port draws 512 leaf normals a tree
(``ops/bart.py:node_pad``) where a depth-6 heap takes 128; the JAX sweep
reads the first M of them.  Every case starts from a prior forest drawn
with power 0.5 (p_split 0.95 / sqrt(1 + d)), which reaches depth 7 and 8
(asserted), and sweeps under that prior:

* the plain sweep on shared (u, zn) against ``bart_sweep(variates=)``,
  unweighted and weighted;
* the in-sweep regrow (``p_regrow = 1``) against the JAX sweep on its
  replayed keys (``tests/test_torch_regrow_sweep.py``'s ``_replayed``);
* the plain observation-sharded sweep with the regrow over two shards
  (that file's ``_sharded_sweep``: two threads of this process, the
  reduce hook a sum over the shards) against the JAX sweep with
  ``axis_name`` over the same two shards;
* ``predict_trees`` / ``walk_tree`` on the swept forest.

Tolerance: forests and leaf indices identical, float64 values within
1e-9 (the same arithmetic, sums taken in another order).  The kernels'
builds for 512- and 1024-slot heaps are held against these plain sweeps
on the card (``cuda``-marked tests, skipped here, and ``chip_smoke.py``
phase 12)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stan4bart_torch.ops import bart as tb
from stan4bart_torch.ops import bart_sweep_kernel as tk
from stan4bart_tpu.ops import bart as jb
from test_torch_regrow_sweep import N, T, _replayed, _sharded_sweep

torch.set_num_threads(2)

P, C = 4, 3
CFG = dict(num_trees=T, max_depth=8, n_cuts=16, power=0.5)
TOL = dict(rtol=1e-9, atol=1e-9)
FIELDS = ("feature", "cut", "leaf_idx")
VALUES = ("leaf_value", "tree_fit", "allfit")


def _deep_nodes(feature):
    """Active nodes at depth >= 7 (heap index >= 127)."""
    return int((np.asarray(feature)[..., 127:] != tb.INACTIVE).sum())


def _forest(weighted, seed=5):
    """A prior forest of C chains reaching depth 7 and 8, its data, the
    port's config and the JAX package's."""
    rng = np.random.default_rng(seed)
    X = rng.uniform(size=(N, P))
    y = np.sin(4 * X[:, 0]) + X[:, 1] + rng.normal(scale=0.3, size=N)
    cfg = tb.BartConfig(**CFG)
    ranks = tb.compute_ranks(X, tb.make_cut_grid(X, cfg.n_cuts))
    sp = np.full(P, 1.0 / P)
    gen = torch.Generator()
    gen.manual_seed(seed)
    state = tb.sample_trees_from_prior(cfg, gen, torch.as_tensor(ranks), sp,
                                       C)
    state = state._replace(sigma_mu=torch.full((C,), 0.4,
                                               dtype=torch.float64))
    assert _deep_nodes(state.feature) > 0, "the forest must reach depth 7"
    y_target = torch.as_tensor(y - y.mean()).expand(C, N).clone()
    sigma = torch.tensor([0.3, 0.5, 0.8], dtype=torch.float64)
    w = np.linspace(0.5, 2.0, N) if weighted else None
    return cfg, jb.BartConfig(**CFG), state, y_target, ranks, sp, sigma, w


def _jstate(state):
    return jb.BartState(*(jnp.asarray(x.numpy()) for x in state))


def _assert_same(ref, port):
    for name in FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(ref, name)),
                                      getattr(port, name).numpy(),
                                      err_msg=name)
    for name in VALUES:
        np.testing.assert_allclose(np.asarray(getattr(ref, name)),
                                   getattr(port, name).numpy(), **TOL,
                                   err_msg=name)


@pytest.mark.parametrize("weighted", [False, True])
def test_deep_sweep_matches_reference(weighted):
    cfg, jcfg, state, y_target, ranks, sp, sigma, w = _forest(weighted)
    assert tb.node_pad(cfg) == 512
    rng = np.random.default_rng(7)
    u = rng.uniform(size=(C, T, 8))
    zn = rng.normal(size=(C, T, tb.node_pad(cfg)))
    ref = jax.jit(jax.vmap(lambda s, yt, sg, uu, zz: jb.bart_sweep(
        jcfg, s, yt, jnp.asarray(ranks), jnp.asarray(sp), sg,
        jax.random.PRNGKey(0), weights=None if w is None else jnp.asarray(w),
        variates=(uu, zz))[0]))(
            _jstate(state), jnp.asarray(y_target.numpy()),
            jnp.asarray(sigma.numpy()), jnp.asarray(u), jnp.asarray(zn))
    port, _ = tb.bart_sweep(cfg, state, y_target, torch.as_tensor(ranks), sp,
                            sigma, weights=w,
                            variates=(torch.as_tensor(u),
                                      torch.as_tensor(zn)))
    _assert_same(ref, port)
    assert not torch.equal(port.feature, state.feature)
    assert _deep_nodes(port.feature) > 0
    # the forest walks to its stored leaves at depth 8
    node = tb.walk_tree(port.feature.reshape(C * T, -1),
                        port.cut.reshape(C * T, -1), torch.as_tensor(ranks),
                        cfg.max_depth).reshape(C, T, N)
    assert torch.equal(node, port.leaf_idx.long())
    ranks_new = np.random.default_rng(8).integers(0, cfg.n_cuts + 1,
                                                  size=(40, P))
    ref_pred = jax.jit(jax.vmap(lambda f, c, v: jb.predict_trees(
        jcfg, f, c, v, jnp.asarray(ranks_new))))(
            jnp.asarray(port.feature.numpy()), jnp.asarray(port.cut.numpy()),
            jnp.asarray(port.leaf_value.numpy()))
    np.testing.assert_allclose(
        np.asarray(ref_pred),
        tb.predict_trees(cfg, port.feature, port.cut, port.leaf_value,
                         torch.as_tensor(ranks_new)).numpy(), **TOL)


def test_deep_sweep_draws_512_normals():
    """Without pre-drawn variates a depth-8 sweep draws 512 leaf normals
    a tree; at depth 6 it draws 128, as before, so the generator's stream
    (and every depth-6 replay and resume) is unchanged."""
    for depth, pad in ((6, 128), (7, 512), (8, 512)):
        cfg = tb.BartConfig(num_trees=2, max_depth=depth)
        assert tb.node_pad(cfg) == pad
        gen = torch.Generator()
        gen.manual_seed(0)
        u, zn = tb.draw_variates(gen, 2, 2, torch.float64, "cpu", pad)
        assert zn.shape == (2, 2, pad)
    gen = torch.Generator()
    gen.manual_seed(0)
    same = tb.draw_variates(gen, 2, 2, torch.float64, "cpu")
    gen.manual_seed(0)
    old = (torch.rand((2, 2, 8), generator=gen, dtype=torch.float64),
           torch.randn((2, 2, 128), generator=gen, dtype=torch.float64))
    assert all(torch.equal(a, b) for a, b in zip(same, old))


def test_deep_in_sweep_regrow_matches_reference():
    cfg, jcfg, state, y_target, ranks, sp, sigma, w = _forest(True, 6)
    keys = jax.random.split(jax.random.PRNGKey(11), C)
    ref = jax.jit(jax.vmap(lambda s, yt, sg, k: jb.bart_sweep(
        jcfg._replace(p_regrow=1.0), s, yt, jnp.asarray(ranks), sp, sg, k,
        weights=jnp.asarray(w))[0]))(
            _jstate(state), jnp.asarray(y_target.numpy()),
            jnp.asarray(sigma.numpy()), keys)
    variates, _ = _replayed(keys, cfg.max_nodes)
    port, _ = tb.bart_sweep(cfg._replace(p_regrow=1.0), state, y_target,
                            torch.as_tensor(ranks), sp, sigma, weights=w,
                            variates=variates)
    _assert_same(ref, port)
    assert not torch.equal(port.feature, state.feature)
    assert _deep_nodes(port.feature) > 0


def test_deep_sharded_sweep_matches_reference():
    """Two shards of the plain sharded sweep at depth 8 with p_regrow = 1
    against the JAX sharded sweep on the same shards and keys: identical
    forests on both shards, values within 1e-9; one reduction per tree
    update and one per tree whose regrow gate opens in some chain; the
    sharded (C, 2, M + 2) block at M = 511."""
    S = 2
    cfg, jcfg, state, y_target, ranks, sp, sigma, w = _forest(True, 9)
    cfg = cfg._replace(p_regrow=1.0)
    keys = jax.random.split(jax.random.PRNGKey(13), C)
    variates, _ = _replayed(keys, cfg.max_nodes)
    split = lambda a: jnp.asarray(np.stack(np.split(a, S, -1)))  # noqa: E731
    rep = lambda a: jnp.asarray(np.broadcast_to(a, (S,) + a.shape))  # noqa: E731
    js = jb.BartState(**{k: (split if k in ("leaf_idx", "allfit", "tree_fit")
                             else rep)(getattr(state, k).numpy())
                         for k in state._fields})

    def one_shard(s, y_s, rk_s, w_s):
        return jax.vmap(lambda sc, yc, sg, k: jb.bart_sweep(
            jcfg._replace(p_regrow=1.0), sc, yc, rk_s, sp, sg, k,
            weights=w_s, axis_name="data")[0])(
                s, y_s, jnp.asarray(sigma.numpy()), keys)

    ref = jax.jit(jax.vmap(one_shard, axis_name="data"))(
        js, split(y_target.numpy()),
        jnp.asarray(np.stack(np.split(ranks, S, 0))), split(w))
    shards, calls = _sharded_sweep(cfg, state, y_target, ranks, sp, sigma,
                                   w, variates, S)
    assert calls == [2 * T, 2 * T]
    for d, part in enumerate(shards):
        for name in FIELDS:
            np.testing.assert_array_equal(np.asarray(getattr(ref, name))[d],
                                          getattr(part, name).numpy(),
                                          err_msg=name)
        for name in VALUES:
            np.testing.assert_allclose(np.asarray(getattr(ref, name))[d],
                                       getattr(part, name).numpy(), **TOL,
                                       err_msg=name)
    assert not torch.equal(shards[0].feature, state.feature)
    assert _deep_nodes(shards[0].feature) > 0


def _cuda_deep_inputs(n, chains, seed, weighted=False, depth=8):
    """Operands of one sweep of trees of ``depth`` on the card from a
    prior forest (power 0.5) reaching depth 7: (args, weights, regrow
    variates)."""
    dev = torch.device("cuda")
    rng = np.random.default_rng(seed)
    X = rng.uniform(size=(n, P))
    y = np.sin(4 * X[:, 0]) + X[:, 1] + rng.normal(scale=0.3, size=n)
    cfg = tb.BartConfig(**dict(CFG, num_trees=20, max_depth=depth))
    ranks = tb.compute_ranks(X, tb.make_cut_grid(X, cfg.n_cuts))
    sp = np.full(P, 1.0 / P)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    st = tb.sample_trees_from_prior(cfg, gen, torch.as_tensor(ranks,
                                                              device=dev),
                                    sp, chains, dtype=torch.float32)
    assert _deep_nodes(st.feature.cpu()) > 0
    consts = tk.make_sweep_consts(cfg, ranks, sp, device=dev)
    assert consts.node_pad == tb.node_pad(cfg) > 128
    u, zn = tb.draw_variates(gen, chains, cfg.num_trees, torch.float32, dev,
                             consts.node_pad)
    rg = tb.draw_tree_regrow_variates(gen, chains, cfg, torch.float32, dev)
    yt = torch.as_tensor(y - y.mean(), dtype=torch.float32, device=dev)
    args = (cfg, st.feature, st.cut, st.leaf_idx, st.tree_fit,
            (yt - st.allfit).contiguous(),
            torch.full((chains,), 0.3, device=dev),
            torch.full((chains,), 0.01, device=dev), u, zn, consts)
    w = (torch.as_tensor(np.linspace(0.5, 2.0, n), dtype=torch.float32,
                         device=dev) if weighted else None)
    return args, w, rg


@pytest.mark.cuda
@pytest.mark.parametrize("depth", [8, 9])
@pytest.mark.parametrize("kernel", ["batch", "tiled", "chain", "streamed"])
def test_cuda_deep_kernels_match_plain(kernel, depth):
    """Each one-launch kernel's build for 512-slot (max_depth 8) and
    1024-slot heaps (max_depth 9) against the plain sweep, at p_regrow 0
    and 1, weighted: identical forests and leaf indices in every chain.
    ``streamed``: the obs-tiled kernel at K = 1 over more rows than a
    block holds on chip (its residual in device memory)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    n = 30_000 if kernel == "streamed" else 4_000
    args, w, rg = _cuda_deep_inputs(n, 8, 3, weighted=True, depth=depth)
    pad = args[-1].node_pad
    launch = {"batch": tk.sweep_cuda, "tiled": tk.sweep_tiled_cuda,
              "chain": tk.sweep_chain_cuda,
              "streamed": lambda *a, **kw: tk.sweep_tiled_cuda(
                  *a, cluster=1, **kw)}[kernel]
    if kernel == "streamed":
        assert not tk.kernel_smem("bart_sweep_tiled", n, 20, 1, True,
                                  pad)["resid_on_chip"]
    cfg = args[0]
    for p, r in ((0.0, None), (1.0, rg)):
        a = (cfg._replace(p_regrow=p),) + args[1:]
        k = launch(*a, weights=w, rg=r)
        ref = tk.sweep_plain(*a, weights=w, rg=r)
        torch.cuda.synchronize()
        for x, y in zip(k[:2], ref[:2]):
            assert torch.equal(x, y)
        assert torch.equal(k[3], ref[3])
        torch.testing.assert_close(k[2], ref[2], rtol=2e-4, atol=2e-5)
        torch.testing.assert_close(k[5], ref[5], rtol=5e-4, atol=5e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("depth", [8, 9])
def test_cuda_deep_sharded_kernel_matches_plain(depth):
    """The sharded kernel's builds for 512-slot and 1024-slot heaps, on
    one rank (no reduce), with p_regrow 0 and 1, against the plain
    sharded sweep: identical forests and leaf indices in every chain."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    args, w, rg = _cuda_deep_inputs(4_000, 8, 4, weighted=True, depth=depth)
    cfg = args[0]
    before = tk.bart_sweep_fused_sharded.deep_launches
    for p, r in ((0.0, None), (1.0, rg)):
        a = (cfg._replace(p_regrow=p),) + args[1:]
        k = tk.sweep_sharded_cuda(*a, weights=w, rg=r)
        ref = tk.sweep_plain(*a, weights=w, reduce=lambda x: x, rg=r)
        torch.cuda.synchronize()
        for x, y in zip(k[:2], ref[:2]):
            assert torch.equal(x, y)
        assert torch.equal(k[3], ref[3])
        torch.testing.assert_close(k[2], ref[2], rtol=2e-4, atol=2e-5)
    assert tk.bart_sweep_fused_sharded.deep_launches - before == 2 * 20
