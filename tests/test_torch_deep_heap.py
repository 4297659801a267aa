"""Trees of max_depth 10 and deeper: the port's plain sweeps against the
JAX package's XLA sweep, and the kernels' heap builds on the card.

A depth-10 heap has 2047 nodes and a depth-12 one 8191, past the 1024
slots of the kernels' static builds, so on the card such sweeps launch
the heap builds (per-tree state in device memory,
``ops/bart_sweep_kernel.py:heap_build``); the port draws 2 ** (depth + 1)
leaf normals a tree and the JAX sweep reads the first M.  Every case
starts from a prior forest that reaches the test's depth (asserted):
base 0.99 with power 0.25 at depth 10, power 0.1 at depth 12.  In
float64 at N = 150, T = 8, C = 3:

* the plain sweep on shared (u, zn) against ``bart_sweep(variates=)``
  at depth 10 and 12, unweighted and weighted;
* the in-sweep regrow (``p_regrow = 1``) at depth 10 against the JAX
  sweep on its replayed keys (``tests/test_torch_regrow_sweep.py``);
* the plain observation-sharded sweep with the regrow at depth 10 over
  two shards against the JAX sweep with ``axis_name``;
* a JAX depth-12 forest carried into a port fit's state by
  ``convert.state_from_numpy`` and swept on by both packages;
* ``predict_trees`` on a depth-12 forest;
* a port fit at max_depth 12 on the CPU with stored forests: their shape,
  ``predict`` against the JAX ``predict_trees`` on them, ``save`` /
  ``load`` to the bit;
* which build a pad launches, its ceilings and ``check_kernel_supports``;
* ``node_stats`` in blocks of nodes (the plain regrow's and sharded
  sweep's per-node sums at large C x N x M) against one product, and
  ``count_variable_use`` on a depth-12 forest.

Tolerance: forests and leaf indices identical, values within 1e-9 (the
same arithmetic, sums taken in another order).  The ``cuda``-marked tests
hold each heap build against the plain sweep at depth 10 and 12 in both
types, and the heap build forced at depth 9 against the 1024-slot static
build to the bit; they skip without a card."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import stan4bart_torch
from stan4bart_torch.convert import state_from_numpy
from stan4bart_torch.ops import bart as tb
from stan4bart_torch.ops import bart_sweep_kernel as tk
from stan4bart_tpu.ops import bart as jb
from stan4bart_tpu.utils.friedman import (
    friedman_dataframe,
    generate_friedman_data,
)
from test_torch_regrow_sweep import N, T, _replayed, _sharded_sweep

torch.set_num_threads(2)

P, C = 4, 3
# priors under which a forest of T trees reaches the depth
PRIOR = {10: dict(base=0.99, power=0.25), 12: dict(base=0.99, power=0.1)}
TOL = dict(rtol=1e-9, atol=1e-9)
FIELDS = ("feature", "cut", "leaf_idx")
VALUES = ("leaf_value", "tree_fit", "allfit")
FLAGSHIP = ("y ~ bart(. - g.1 - g.2 - X4 - z) + X4 + z + (1 + X4 | g.1) "
            "+ (1 | g.2)")


def _cfg_kw(depth, trees=T):
    return dict(num_trees=trees, max_depth=depth, n_cuts=16,
                **PRIOR.get(depth, PRIOR[10]))


def _at_depth(feature, depth):
    """Active nodes at ``depth`` (heap indices 2^depth - 1 on)."""
    return int((np.asarray(feature)[..., 2 ** depth - 1:]
                != tb.INACTIVE).sum())


def _forest(depth, weighted, seed=5):
    """A prior forest of C chains reaching ``depth``, its data, the port's
    config and the JAX package's."""
    rng = np.random.default_rng(seed)
    X = rng.uniform(size=(N, P))
    y = np.sin(4 * X[:, 0]) + X[:, 1] + rng.normal(scale=0.3, size=N)
    cfg = tb.BartConfig(**_cfg_kw(depth))
    ranks = tb.compute_ranks(X, tb.make_cut_grid(X, cfg.n_cuts))
    sp = np.full(P, 1.0 / P)
    gen = torch.Generator()
    gen.manual_seed(seed)
    state = tb.sample_trees_from_prior(cfg, gen, torch.as_tensor(ranks), sp,
                                       C)
    state = state._replace(sigma_mu=torch.full((C,), 0.4,
                                               dtype=torch.float64))
    assert _at_depth(state.feature, depth) > 0, "the forest must reach it"
    y_target = torch.as_tensor(y - y.mean()).expand(C, N).clone()
    sigma = torch.tensor([0.3, 0.5, 0.8], dtype=torch.float64)
    w = np.linspace(0.5, 2.0, N) if weighted else None
    return (cfg, jb.BartConfig(**_cfg_kw(depth)), state, y_target, ranks, sp,
            sigma, w)


def _jstate(state):
    return jb.BartState(*(jnp.asarray(np.asarray(x)) for x in state))


def _assert_same(ref, port):
    for name in FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(ref, name)),
                                      getattr(port, name).numpy(),
                                      err_msg=name)
    for name in VALUES:
        np.testing.assert_allclose(np.asarray(getattr(ref, name)),
                                   getattr(port, name).numpy(), **TOL,
                                   err_msg=name)


def _jax_sweep(jcfg, jstate, y_target, ranks, sp, sigma, w, u, zn):
    return jax.jit(jax.vmap(lambda s, yt, sg, uu, zz: jb.bart_sweep(
        jcfg, s, yt, jnp.asarray(ranks), jnp.asarray(sp), sg,
        jax.random.PRNGKey(0), weights=None if w is None else jnp.asarray(w),
        variates=(uu, zz))[0]))(
            jstate, jnp.asarray(np.asarray(y_target)),
            jnp.asarray(np.asarray(sigma)), jnp.asarray(u), jnp.asarray(zn))


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("depth", [10, 12])
def test_heap_depth_sweep_matches_reference(depth, weighted):
    cfg, jcfg, state, y_target, ranks, sp, sigma, w = _forest(depth,
                                                              weighted)
    pad = tb.node_pad(cfg)
    assert pad == 2 ** (depth + 1) and tk.heap_build(pad)
    rng = np.random.default_rng(7)
    u = rng.uniform(size=(C, T, 8))
    zn = rng.normal(size=(C, T, pad))
    ref = _jax_sweep(jcfg, _jstate(state), y_target, ranks, sp, sigma, w, u,
                     zn)
    port, _ = tb.bart_sweep(cfg, state, y_target, torch.as_tensor(ranks), sp,
                            sigma, weights=w,
                            variates=(torch.as_tensor(u),
                                      torch.as_tensor(zn)))
    _assert_same(ref, port)
    assert not torch.equal(port.feature, state.feature)
    assert _at_depth(port.feature, depth - 1) > 0


def test_heap_depth_in_sweep_regrow_matches_reference():
    cfg, jcfg, state, y_target, ranks, sp, sigma, w = _forest(10, True, 6)
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


def test_heap_depth_sharded_sweep_matches_reference():
    """Two shards of the plain sharded sweep at depth 10 with p_regrow 1
    against the JAX sharded sweep on the same shards and keys: identical
    forests on both shards, values within 1e-9, one reduction per tree
    update and one per tree whose regrow gate opens in some chain."""
    S = 2
    cfg, jcfg, state, y_target, ranks, sp, sigma, w = _forest(10, True, 9)
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


def test_heap_depth_predict_trees_matches_reference():
    cfg, jcfg, state, _, ranks, _, _, _ = _forest(12, False, 8)
    lv = torch.as_tensor(np.random.default_rng(3).normal(
        size=state.leaf_value.shape))
    lv = torch.where(state.feature == tb.LEAF, lv, 0.0)
    ranks_new = np.random.default_rng(4).integers(0, cfg.n_cuts + 1,
                                                  size=(60, P))
    ref = jax.jit(jax.vmap(lambda f, c, v: jb.predict_trees(
        jcfg, f, c, v, jnp.asarray(ranks_new))))(
            jnp.asarray(state.feature.numpy()), jnp.asarray(state.cut.numpy()),
            jnp.asarray(lv.numpy()))
    got = tb.predict_trees(cfg, state.feature, state.cut, lv,
                           torch.as_tensor(ranks_new))
    np.testing.assert_allclose(np.asarray(ref), got.numpy(), **TOL)


def test_node_stats_blocks_match_one_product(monkeypatch):
    """``node_stats`` past ``NODE_STATS_BLOCK`` elements (deep trees at
    large n on the card) makes its one-hot a block of nodes at a time:
    the same per-node sums as the one product over every node."""
    rng = np.random.default_rng(12)
    M = 2047
    lidx = torch.as_tensor(rng.integers(0, M, size=(3, 150)))
    wr = torch.as_tensor(rng.normal(size=(3, 150)))
    w = torch.as_tensor(rng.uniform(0.5, 2.0, size=150))
    whole = tb.node_stats(lidx, wr, M, w)
    monkeypatch.setattr(tb, "NODE_STATS_BLOCK", 3 * 150 * 100)
    blocked = tb.node_stats(lidx, wr, M, w)
    for a, b in zip(whole, blocked):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **TOL)
        assert a.shape == (3, M)


def test_varcount_of_a_deep_forest():
    """``count_variable_use`` on a depth-12 forest (and on stumps): the
    splits per variable of every chain, as a per-chain count of the
    internal nodes' variables."""
    _, _, state, *_ = _forest(12, False, 10)
    f = state.feature.numpy()
    want = np.stack([np.bincount(f[c][f[c] >= 0], minlength=P)
                     for c in range(C)])
    got = tb.count_variable_use(state.feature, P)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    stumps = torch.full((C, T, 8191), tb.INACTIVE, dtype=torch.int32)
    stumps[..., 0] = tb.LEAF
    assert not tb.count_variable_use(stumps, P).any()


@pytest.fixture(scope="module")
def deep_fit():
    """A port fit at max_depth 12 on the CPU with stored forests."""
    d = generate_friedman_data(120, ranef=True, causal=True)
    df = friedman_dataframe(d)
    fit = stan4bart_torch.stan4bart(
        FLAGSHIP, df, treatment="z", chains=2, iter=6, warmup=3, seed=4,
        verbose=-1, device="cpu", dtype=torch.float64,
        stan_args={"max_treedepth": 4},
        bart_args={"n.trees": 6, "max_depth": 12, "keep_trees": True,
                   **PRIOR[12]})
    return df, fit


def test_heap_depth_fit_stores_predicts_and_round_trips(deep_fit, tmp_path):
    df, fit = deep_fit
    assert fit.prog.sweep_consts.node_pad == 8192
    assert fit.draws.tree_feature.shape == (2, 6, 6, 8191)
    for name in ("stan", "bart_train", "bart_test", "k"):
        assert np.all(np.isfinite(getattr(fit.draws, name))), name
    # predict over the stored post-warmup forests against the JAX walk
    cfg = fit.prog.bart_cfg
    jcfg = jb.BartConfig(num_trees=6, max_depth=12, n_cuts=cfg.n_cuts)
    tf = fit.mf.build_test_frame(df)
    ranks_new = jnp.asarray(tb.compute_ranks(np.asarray(tf.bart_X),
                                             fit.prog.cuts))
    f, c, v = (np.asarray(a)[:, fit.warmup:].reshape((-1, 6, 8191))
               for a in (fit.draws.tree_feature, fit.draws.tree_cut,
                         fit.draws.tree_leaf_value))
    ref = jax.jit(jax.vmap(lambda ff, cc, vv: jb.predict_trees(
        jcfg, ff, cc, vv, ranks_new)))(jnp.asarray(f), jnp.asarray(c),
                                       jnp.asarray(v))
    got = fit._predict_bart(tf.bart_X)
    np.testing.assert_allclose(got.reshape(ref.shape), np.asarray(ref),
                               **TOL)
    path = str(tmp_path / "deep12.pkl")
    fit.save(path)
    back = stan4bart_torch.Stan4bartFit.load(path, device="cpu")
    assert back.prog.bart_cfg.max_depth == 12
    for name in ("stan", "bart_train", "tree_feature", "tree_cut",
                 "tree_leaf_value"):
        np.testing.assert_array_equal(getattr(back.draws, name),
                                      getattr(fit.draws, name), name)
    assert torch.equal(back.final_states.bart.feature,
                       fit.final_states.bart.feature)
    np.testing.assert_array_equal(back.predict(df, type="indiv.bart"),
                                  fit.predict(df, type="indiv.bart"))


def test_heap_depth_state_carries_into_the_port(deep_fit):
    """A depth-12 forest over the fit's data swept by the JAX package,
    carried into the fit's state by ``convert.state_from_numpy``: one more
    sweep of the carried state by the port equals the JAX sweep of the
    JAX state on shared variates, and the fit's program steps from it."""
    _, fit = deep_fit
    cfg = fit.prog.bart_cfg
    jcfg = jb.BartConfig(num_trees=6, max_depth=12, n_cuts=cfg.n_cuts,
                         base=cfg.base, power=cfg.power)
    ranks = fit.prog.ranks.numpy()
    sp = fit.prog.split_probs
    gen = torch.Generator()
    gen.manual_seed(21)
    prior = tb.sample_trees_from_prior(cfg, gen, fit.prog.ranks, sp, 2)
    prior = prior._replace(sigma_mu=torch.full((2,), 0.3,
                                               dtype=torch.float64))
    assert _at_depth(prior.feature, 10) > 0
    n = ranks.shape[0]
    rng = np.random.default_rng(2)
    y_target = rng.normal(size=(2, n))
    sigma = np.array([0.6, 0.9])
    js = _jax_sweep(jcfg, _jstate(prior), y_target, ranks, sp, sigma, None,
                    rng.uniform(size=(2, 6, 8)),
                    rng.normal(size=(2, 6, 8192)))
    state = state_from_numpy(fit.final_states._replace(bart=js),
                             device="cpu")
    assert state.bart.feature.shape == (2, 6, 8191)
    u = rng.uniform(size=(2, 6, 8))
    zn = rng.normal(size=(2, 6, 8192))
    ref = _jax_sweep(jcfg, js, y_target, ranks, sp, sigma, None, u, zn)
    port, _ = tb.bart_sweep(cfg, state.bart, torch.as_tensor(y_target),
                            torch.as_tensor(ranks), sp,
                            torch.as_tensor(sigma),
                            variates=(torch.as_tensor(u),
                                      torch.as_tensor(zn)))
    _assert_same(ref, port)
    gen = torch.Generator()
    gen.manual_seed(0)
    new, draw = fit.prog.step_batched(state, 0, False, gen)
    assert torch.isfinite(draw.stan).all()
    assert torch.isfinite(new.bart.allfit).all()
    assert new.bart.feature.shape == (2, 6, 8191)


@pytest.mark.parametrize("depth", [10, 11, 12, 13, 14, 15, 16])
def test_heap_build_selection_and_ceilings(depth):
    """Pads 2048 to 65 536 and one past the two-byte leaf copy: the heap
    build, its leaf copy, its ceilings (from the observations,
    the ring and a few scalars: the same at every pad of a leaf copy) and
    ``check_kernel_supports``; the static builds' pads stay theirs."""
    cfg = tb.BartConfig(num_trees=75, max_depth=depth)
    pad = tb.node_pad(cfg)
    assert pad == 2 ** (depth + 1) == cfg.max_nodes + 1
    assert tk.heap_build(pad)
    assert not any(tk.heap_build(p) for p in tb.HEAP_PADS)
    assert tk.leaf_copy_bytes(pad) == (2 if pad <= 32_768 else 4)
    for dtype, b in ((torch.float32, 4), (torch.float64, 8)):
        # the views and scalars, not the heap
        assert tk.on_chip_state(pad, dtype) == (576 if b == 4 else 896)
        single, chain = tk.on_chip_ceilings(pad, 75, dtype)
        block = tk.on_chip_block_obs(pad, 75, dtype)
        assert single == block // 128 * 128
        assert chain == 8 * block // 128 * 128
        assert block == (tk.SMEM_OPTIN - tk.on_chip_state(pad, dtype)
                         - 3072 * (8 + b) - 304) \
            // (b + tk.leaf_copy_bytes(pad)) // 32 * 32
        # more observations a block than the 1024-slot build holds
        assert single > tk.on_chip_ceilings(1024, 75, dtype)[0]
        consts = tk.SweepConsts(None, None, None, None, n_obs=single,
                                npad=single, node_pad=pad, num_trees=75)
        for kernel in ("bart_sweep_batch", "bart_sweep_tiled",
                       "bart_sweep_chain", "bart_sweep_sharded"):
            tk.check_kernel_supports(consts, dtype, kernel)
        with pytest.raises(ValueError, match="bart_sweep_fused_batch_tiled"):
            tk.check_kernel_supports(consts._replace(npad=single + 128),
                                     dtype)
        tk.check_kernel_supports(consts._replace(npad=10 ** 7), dtype,
                                 "bart_sweep_tiled")
    # make_sweep_consts takes the depth for the card as for the CPU
    assert tk.make_sweep_consts(cfg, np.zeros((300, 3), np.int32),
                                np.full(3, 1 / 3),
                                device="cpu").node_pad == pad


# ---------------------------------------------------------------------------
# on the card


def _cuda_inputs(n, chains, depth, dtype, seed, weighted=True, trees=20):
    """Operands of one sweep at ``depth`` on the card from a prior forest
    reaching it: (args, weights, regrow variates)."""
    dev = torch.device("cuda")
    rng = np.random.default_rng(seed)
    X = rng.uniform(size=(n, P))
    y = np.sin(4 * X[:, 0]) + X[:, 1] + rng.normal(scale=0.3, size=n)
    cfg = tb.BartConfig(**_cfg_kw(depth, trees))
    ranks = tb.compute_ranks(X, tb.make_cut_grid(X, cfg.n_cuts))
    sp = np.full(P, 1.0 / P)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    st = tb.sample_trees_from_prior(cfg, gen, torch.as_tensor(ranks,
                                                              device=dev),
                                    sp, chains, dtype=dtype)
    assert _at_depth(st.feature.cpu(), depth - 1) > 0
    consts = tk.make_sweep_consts(cfg, ranks, sp, device=dev, dtype=dtype)
    u, zn = tb.draw_variates(gen, chains, trees, torch.float32, dev,
                             consts.node_pad)
    rg = tb.draw_tree_regrow_variates(gen, chains, cfg, torch.float32, dev)
    yt = torch.as_tensor(y - y.mean(), dtype=dtype, device=dev)
    args = (cfg, st.feature, st.cut, st.leaf_idx, st.tree_fit,
            (yt - st.allfit).contiguous(),
            torch.full((chains,), 0.3, dtype=dtype, device=dev),
            torch.full((chains,), 0.01, dtype=dtype, device=dev),
            u.to(dtype).contiguous(), zn.to(dtype).contiguous(), consts)
    w = (torch.as_tensor(np.linspace(0.5, 2.0, n), dtype=dtype, device=dev)
         if weighted else None)
    return args, w, rg.to(dtype).contiguous()


def _same_chains(k, ref):
    """Chains whose forest and leaf indices equal the reference's."""
    return ((k[0] == ref[0]).flatten(1).all(1)
            & (k[1] == ref[1]).flatten(1).all(1)
            & (k[3] == ref[3]).flatten(1).all(1))


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")


LAUNCH = {"batch": "sweep_cuda", "tiled": "sweep_tiled_cuda",
          "chain": "sweep_chain_cuda", "sharded": "sweep_sharded_cuda"}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("depth", [10, 12])
@pytest.mark.parametrize("kernel", ["batch", "tiled", "chain", "sharded"])
def test_cuda_heap_builds_match_plain(kernel, depth, dtype):
    """Each kernel's heap build against the plain sweep at p_regrow 0 and
    1, weighted: identical forests and leaf indices in all chains but at
    most one (the plain sweep's sums on the card are atomics), values
    within float32's tolerance or 1e-9; each launch counted as a heap
    launch."""
    _needs_card()
    args, w, rg = _cuda_inputs(4_000, 8, depth, dtype, 3 + depth)
    launch = getattr(tk, LAUNCH[kernel])
    wrapper = {"batch": tk.bart_sweep_fused_batch,
               "tiled": tk.bart_sweep_fused_batch_tiled,
               "chain": tk.bart_sweep_fused,
               "sharded": tk.bart_sweep_fused_sharded}[kernel]
    tol = (dict(rtol=0.0, atol=1e-9) if dtype == torch.float64
           else dict(rtol=2e-4, atol=2e-5))
    cfg = args[0]
    for p, r in ((0.0, None), (1.0, rg)):
        a = (cfg._replace(p_regrow=p),) + args[1:]
        before = wrapper.heap_launches
        extra = {"reduce": lambda x: x} if kernel == "sharded" else {}
        k = launch(*a, weights=w, rg=r)
        ref = tk.sweep_plain(*a, weights=w, rg=r, **extra)
        torch.cuda.synchronize()
        assert wrapper.heap_launches - before == (20 if kernel == "sharded"
                                                  else 1)
        same = _same_chains(k, ref)
        assert int(same.sum()) >= 7, f"{int(same.sum())}/8 chains"
        torch.testing.assert_close(k[2][same], ref[2][same], **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["batch", "tiled", "chain", "sharded"])
def test_cuda_heap_build_forced_at_depth9_equals_static(kernel):
    """The heap build forced at max_depth 9 (1024 slots) equals the
    1024-slot static build to the bit at the same K, at p_regrow 0 and
    1."""
    _needs_card()
    args, w, rg = _cuda_inputs(4_000, 8, 9, torch.float32, 21)
    launch = getattr(tk, LAUNCH[kernel])
    cfg = args[0]
    for p, r in ((0.0, None), (1.0, rg)):
        a = (cfg._replace(p_regrow=p),) + args[1:]
        kw = dict(weights=w, rg=r, cluster=2)
        static = launch(*a, **kw)
        heap = launch(*a, heap=True, **kw)
        torch.cuda.synchronize()
        for x, y in zip(static, heap):
            assert torch.equal(x, y)
