"""The port's in-sweep subtree-regrow move (``bart_args={"p_regrow": p}``,
``ops/bart.tree_step(rg=)``) against the JAX package's
``bart_sweep`` with ``BartConfig(p_regrow=p)``, on the same randomness.

The JAX sweep refuses pre-drawn variates with a regrow, so the test
replays its key tree: per tree ``split(rng, 4)`` into the carry, the
move's six uniforms, the regrow's ``split`` into g (3,) and u3 (3, M),
and the leaf normals; with ``regrow_per_sweep`` one more split feeds the
refresh.  The port takes the same draws as ``variates=(u, zn, rg)``.
Tolerance: forests identical, float64 values within 1e-9 (the same
arithmetic, per-node sums taken in another order).  ``_sharded_sweep``
runs the sharded form in two shards in two threads of this process, its
reduce hook a sum over the shards; tests/test_torch_regrow_sweep_sharded.py
holds it against the JAX package's sharded sweep."""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import stan4bart_torch
from stan4bart_torch.ops import bart as tb
from stan4bart_torch.ops import bart_sweep_kernel as tk
from stan4bart_tpu.ops import bart as jb
from stan4bart_tpu.utils.friedman import (
    friedman_dataframe,
    generate_friedman_data,
)

torch.set_num_threads(2)

N, P, T, C = 150, 4, 8, 3
DEPTH, CUTS = 4, 16
TOL = dict(rtol=1e-9, atol=1e-9)
FIELDS = ("feature", "cut", "leaf_idx")
VALUES = ("leaf_value", "tree_fit", "allfit")


def _forest(weights):
    """A swept forest of C chains (port), the data and the config."""
    rng = np.random.default_rng(5)
    X = rng.uniform(size=(N, P))
    y = np.sin(4 * X[:, 0]) + X[:, 1] + rng.normal(scale=0.3, size=N)
    w = np.linspace(0.5, 2.0, N) if weights else None
    cfg = tb.BartConfig(num_trees=T, max_depth=DEPTH, n_cuts=CUTS)
    ranks = tb.compute_ranks(X, tb.make_cut_grid(X, CUTS))
    sp = np.full(P, 1.0 / P)
    gen = torch.Generator()
    gen.manual_seed(2)
    state = tb.sample_trees_from_prior(cfg, gen, torch.as_tensor(ranks), sp,
                                       C)
    state = state._replace(sigma_mu=torch.full((C,), 0.4,
                                               dtype=torch.float64))
    y_target = torch.as_tensor(y - y.mean()).expand(C, N).clone()
    sigma = torch.tensor([0.3, 0.5, 0.8], dtype=torch.float64)
    for _ in range(3):
        state, _ = tb.bart_sweep(cfg, state, y_target, torch.as_tensor(ranks),
                                 sp, sigma, gen, weights=w)
    return cfg, state, y_target, ranks, sp, sigma, w


def _replayed(keys, M, R=0):
    """The draws ``jb.bart_sweep`` with ``p_regrow > 0`` makes from each
    chain's key: u (C, T, 6), zn (C, T, M), rg (C, T, 3 + 3 M) and, with
    R regrows per sweep, the refresh's (tree, g, u3, zn)."""
    f64 = jnp.float64

    def one(rng):
        def per(rng, _):
            rng, rng_move, rng_regrow, rng_mu = jax.random.split(rng, 4)
            u6 = jax.random.uniform(rng_move, (6,), dtype=f64)
            rng_g, rng_u = jax.random.split(rng_regrow)
            g = jax.random.uniform(rng_g, (3,), dtype=f64)
            u3 = jax.random.uniform(rng_u, (3, M), dtype=f64)
            zn = jax.random.normal(rng_mu, (M,), f64)
            return rng, (u6, zn, jnp.concatenate([g, u3.reshape(-1)]))

        rng, per_tree = jax.lax.scan(per, rng, None, length=T)
        if not R:
            return per_tree, ()

        def refresh(key):
            kj, kmv, kmu = jax.random.split(key, 3)
            rng_g, rng_u = jax.random.split(kmv)
            return (jax.random.randint(kj, (), 0, T),
                    jax.random.uniform(rng_g, (3,), dtype=f64),
                    jax.random.uniform(rng_u, (3, M), dtype=f64),
                    jax.random.normal(kmu, (M,), f64))

        _, rng_rg = jax.random.split(rng)
        return per_tree, jax.vmap(refresh)(jax.random.split(rng_rg, R))

    per_tree, refresh = jax.vmap(one)(keys)
    as_t = lambda xs: tuple(torch.as_tensor(np.array(x)) for x in xs)  # noqa: E731
    return as_t(per_tree), as_t(refresh)


def _jax_sweep(p, R, state, y_target, ranks, sp, sigma, w, keys):
    jcfg = jb.BartConfig(num_trees=T, max_depth=DEPTH, n_cuts=CUTS,
                         p_regrow=p, regrow_per_sweep=R)
    js = jb.BartState(*(jnp.asarray(x.numpy()) for x in state))
    return jax.jit(jax.vmap(
        lambda s, yt, sg, k: jb.bart_sweep(
            jcfg, s, yt, jnp.asarray(ranks), sp, sg, k,
            weights=None if w is None else jnp.asarray(w))[0]))(
        js, jnp.asarray(y_target.numpy()), jnp.asarray(sigma.numpy()), keys)


def _assert_same(ref, port, start=None):
    for name in FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(ref, name)),
                                      getattr(port, name).numpy(),
                                      err_msg=name)
    for name in VALUES:
        np.testing.assert_allclose(np.asarray(getattr(ref, name)),
                                   getattr(port, name).numpy(), **TOL,
                                   err_msg=name)
    if start is not None:
        # the move fired: some chain's forest changed structure
        assert not torch.equal(port.feature, start.feature)


@pytest.mark.parametrize("weights", [False, True])
@pytest.mark.parametrize("p", [0.3, 1.0])
def test_in_sweep_regrow_matches_reference(p, weights):
    cfg, state, y_target, ranks, sp, sigma, w = _forest(weights)
    keys = jax.random.split(jax.random.PRNGKey(11), C)
    ref = _jax_sweep(p, 0, state, y_target, ranks, sp, sigma, w, keys)
    variates, _ = _replayed(keys, cfg.max_nodes)
    port, _ = tb.bart_sweep(cfg._replace(p_regrow=p), state, y_target,
                            torch.as_tensor(ranks), sp, sigma, weights=w,
                            variates=variates)
    _assert_same(ref, port, state)
    rebuilt = torch.gather(port.leaf_value, 2, port.leaf_idx.long())
    assert torch.equal(rebuilt, port.tree_fit)


def test_in_sweep_regrow_composes_with_regrow_per_sweep():
    """The JAX sweep with both p_regrow and regrow_per_sweep is the port's
    sweep with p_regrow followed by its refresh, on the replayed draws."""
    R = 2
    cfg, state, y_target, ranks, sp, sigma, w = _forest(True)
    keys = jax.random.split(jax.random.PRNGKey(12), C)
    ref = _jax_sweep(0.5, R, state, y_target, ranks, sp, sigma, w, keys)
    variates, refresh = _replayed(keys, cfg.max_nodes, R)
    port, _ = tb.bart_sweep(cfg._replace(p_regrow=0.5), state, y_target,
                            torch.as_tensor(ranks), sp, sigma, weights=w,
                            variates=variates)
    port = tb.regrow_refresh(cfg._replace(regrow_per_sweep=R), port,
                             y_target, torch.as_tensor(ranks), sp, sigma,
                             weights=w, variates=refresh)
    _assert_same(ref, port, state)


def _sharded_sweep(cfg, state, y_target, ranks, sp, sigma, w, variates,
                   shards=2):
    """``bart_sweep`` over ``shards`` shards of the observations, one
    thread each, the reduce hook the sum over the shards (in shard
    order); returns the shards' states and the reductions each made."""
    n = N // shards
    barrier = threading.Barrier(shards)
    slots, results, calls = [None] * shards, [None] * shards, [0] * shards
    errors = []

    def run(d):
        sl = slice(d * n, (d + 1) * n)

        def reduce(x):
            calls[d] += 1
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
        try:
            results[d], _ = tb.bart_sweep(
                cfg, local, y_target[:, sl], torch.as_tensor(ranks[sl]), sp,
                sigma, weights=None if w is None else w[sl],
                variates=variates, reduce=reduce)
        except Exception as e:      # reported by the test thread
            errors.append(e)
            barrier.abort()

    threads = [threading.Thread(target=run, args=(d,))
               for d in range(shards)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    if errors:
        raise errors[0]
    return results, calls


def _plain_args(cfg, state, y_target, ranks, sp, sigma, seed=3):
    consts = tk.make_sweep_consts(cfg, ranks, sp, device="cpu")
    gen = torch.Generator()
    gen.manual_seed(seed)
    u, zn = tb.draw_variates(gen, C, T, torch.float64, "cpu")
    rg = tb.draw_tree_regrow_variates(gen, C, cfg, torch.float64, "cpu")
    args = (state.feature, state.cut, state.leaf_idx, state.tree_fit,
            y_target - state.allfit, sigma * sigma,
            state.sigma_mu * state.sigma_mu, u, zn, consts)
    return args, rg


def test_closed_gate_leaves_the_sweep_unchanged():
    """p_regrow = 0 runs the sweep as without the move; regrow variates
    whose gates all stay shut give that sweep to the bit; at p_regrow = 1
    the same variates change the forests."""
    cfg, state, y_target, ranks, sp, sigma, w = _forest(False)
    args, rg = _plain_args(cfg, state, y_target, ranks, sp, sigma)
    base = tk.sweep_plain(cfg, *args)
    shut = rg.clone()
    shut[..., 0] = 1.0
    closed = tk.sweep_plain(cfg._replace(p_regrow=0.5), *args, rg=shut)
    for a, b in zip(base, closed):
        assert torch.equal(a, b)
    moved = tk.sweep_plain(cfg._replace(p_regrow=1.0), *args, rg=rg)
    assert not torch.equal(moved[0], base[0])
    with pytest.raises(ValueError, match="regrow variates"):
        tk.sweep_plain(cfg._replace(p_regrow=1.0), *args)


def test_draw_order_of_the_op_form_sweep():
    """bart_sweep draws u, zn, then the regrow variates from ``gen``; the
    same draws handed in give the same sweep to the bit."""
    cfg, state, y_target, ranks, sp, sigma, w = _forest(True)
    cfg = cfg._replace(p_regrow=0.6)
    gen = torch.Generator()
    gen.manual_seed(4)
    drawn, _ = tb.bart_sweep(cfg, state, y_target, torch.as_tensor(ranks),
                             sp, sigma, gen, weights=w)
    gen.manual_seed(4)
    u, zn = tb.draw_variates(gen, C, T, torch.float64, "cpu")
    rg = tb.draw_tree_regrow_variates(gen, C, cfg, torch.float64, "cpu")
    given, _ = tb.bart_sweep(cfg, state, y_target, torch.as_tensor(ranks),
                             sp, sigma, weights=w, variates=(u, zn, rg))
    for name in FIELDS + VALUES:
        assert torch.equal(getattr(drawn, name), getattr(given, name)), name
    with pytest.raises(ValueError, match="pre-drawn sweep variates"):
        tb.bart_sweep(cfg, state, y_target, torch.as_tensor(ranks), sp,
                      sigma, variates=(u, zn))


def test_fused_wrapper_draws_and_passes_the_regrow_variates():
    """``bart_sweep_fused_batch`` on a CPU state with p_regrow runs the
    plain sweep on variates drawn as (u, zn, rg), in float32 as on the
    card."""
    cfg, state, y_target, ranks, sp, sigma, w = _forest(False)
    cfg = cfg._replace(p_regrow=1.0)
    consts = tk.make_sweep_consts(cfg, ranks, sp, device="cpu")
    gen = torch.Generator()
    gen.manual_seed(8)
    out, _ = tk.bart_sweep_fused_batch(cfg, state, y_target, consts, sigma,
                                       gen)
    gen.manual_seed(8)
    var = tb.draw_variates(gen, C, T, torch.float32, "cpu")
    rg = tb.draw_tree_regrow_variates(gen, C, cfg, torch.float32, "cpu")
    again, _ = tk.bart_sweep_fused_batch(cfg, state, y_target, consts, sigma,
                                         None, variates=var + (rg,))
    for name in FIELDS + VALUES:
        assert torch.equal(getattr(out, name), getattr(again, name)), name
    assert not torch.equal(out.feature, state.feature)


def test_tiny_fit_with_p_regrow():
    """A tiny fit with the in-sweep regrow runs, its draws are finite, and
    it differs from the same seed's fit without it."""
    df = friedman_dataframe(generate_friedman_data(80, ranef=True,
                                                   causal=True))
    fits = {p: stan4bart_torch.stan4bart(
        "y ~ bart(. - g.1 - g.2 - X4 - z) + X4 + z + (1 | g.1)", df,
        chains=2, iter=12, warmup=6, seed=5, verbose=-1, device="cpu",
        bart_args={"n.trees": 5, "p_regrow": p}) for p in (0.0, 0.3)}
    fit = fits[0.3]
    assert fit.prog.bart_cfg.p_regrow == 0.3
    assert np.all(np.isfinite(fit.draws.stan))
    assert np.all(np.isfinite(fit.draws.bart_train))
    assert not np.array_equal(fit.draws.bart_train,
                              fits[0.0].draws.bart_train)
    # parsed as the JAX package parses it: a float
    with pytest.raises(ValueError, match="could not convert"):
        stan4bart_torch.stan4bart(
            "y ~ bart(X1 + X2) + X4", df, chains=1, iter=4, device="cpu",
            bart_args={"p_regrow": "often"})


def _cuda_sweep_inputs(n, Cc, weighted, Pc=5, Tc=20):
    """A prior-drawn forest of Cc chains over n rows on the card, its
    sweep variates and regrow variates (p_regrow = 1), and weights in
    [0.5, 2) when ``weighted``: (cfg, sweep operands, rg, weights)."""
    dev = torch.device("cuda")
    rng = np.random.default_rng(9)
    X = rng.normal(size=(n, Pc))
    y = np.sin(X[:, 0]) + X[:, 1] ** 2 + rng.normal(scale=0.5, size=n)
    cfg = tb.BartConfig(num_trees=Tc, p_regrow=1.0)
    ranks = tb.compute_ranks(X, tb.make_cut_grid(X, cfg.n_cuts))
    sp = np.full(Pc, 1.0 / Pc)
    gen = torch.Generator(device=dev)
    gen.manual_seed(9)
    st = tb.sample_trees_from_prior(cfg, gen, torch.as_tensor(ranks,
                                                              device=dev),
                                    sp, Cc, dtype=torch.float32)
    consts = tk.make_sweep_consts(cfg, ranks, sp, device=dev)
    u, zn = tb.draw_variates(gen, Cc, Tc, torch.float32, dev)
    rg = tb.draw_tree_regrow_variates(gen, Cc, cfg, torch.float32, dev)
    w = None
    if weighted:
        w = torch.as_tensor(rng.uniform(0.5, 2.0, n), dtype=torch.float32,
                            device=dev)
    args = (st.feature, st.cut, st.leaf_idx, st.tree_fit,
            torch.as_tensor(y, dtype=torch.float32,
                            device=dev).expand(Cc, n).contiguous(),
            torch.full((Cc,), 0.81, device=dev), st.sigma_mu ** 2, u, zn,
            consts)
    return cfg, args, rg, w


@pytest.mark.cuda
@pytest.mark.parametrize("weighted", [False, True])
def test_cuda_kernels_regrow_match_the_plain_sweep(weighted):
    """The three one-launch kernels and the sharded one (one rank, the
    reduce hook a copy) with p_regrow = 1 against the plain sweep on
    shared variates (float32): identical forests in every chain, leaf
    values and fits within float32 tolerance; with every gate shut the
    kernels give the p_regrow = 0 sweep to the bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    cfg, args, rg, w = _cuda_sweep_inputs(9191, 16, weighted)
    p = tk.sweep_plain(cfg, *args, weights=w, rg=rg)
    kernels = [tk.sweep_cuda, tk.sweep_tiled_cuda, tk.sweep_chain_cuda]
    for K in (1, 2):
        for fn in kernels:
            k = fn(cfg, *args, weights=w, rg=rg, cluster=K)
            torch.cuda.synchronize()
            for i in (0, 1, 3):
                assert torch.equal(k[i], p[i]), (fn.__name__, K, i)
            torch.testing.assert_close(k[2], p[2], rtol=2e-4, atol=2e-5)
            torch.testing.assert_close(k[4], p[4], rtol=5e-4, atol=5e-4)
        k = tk.sweep_sharded_cuda(cfg, *args, weights=w, rg=rg,
                                  reduce=torch.clone, cluster=K)
        ps = tk.sweep_plain(cfg, *args, weights=w, rg=rg,
                            reduce=lambda x: x)
        torch.cuda.synchronize()
        for i in (0, 1, 3):
            assert torch.equal(k[i], ps[i]), ("sharded", K, i)
        torch.testing.assert_close(k[2], ps[2], rtol=2e-4, atol=2e-5)
    # a shut gate in every chain and tree changes nothing, to the bit
    shut = rg.clone()
    shut[..., 0] = 1.0
    for fn in kernels:
        a = fn(cfg._replace(p_regrow=0.0), *args, weights=w, cluster=1)
        b = fn(cfg._replace(p_regrow=0.5), *args, weights=w, rg=shut,
               cluster=1)
        assert all(torch.equal(x, y) for x, y in zip(a, b)), fn.__name__


@pytest.mark.cuda
@pytest.mark.parametrize("weighted", [False, True])
def test_cuda_tiled_streamed_regrow_matches_the_plain_sweep(weighted):
    """The obs-tiled kernel at K = 1 over 50 000 rows, where its block's
    residual no longer fits on chip and its streaming kernel (and that
    kernel's regrow step) runs, with p_regrow = 1 against the plain sweep:
    identical forests in every chain, values within float32 tolerance;
    every gate shut gives the p_regrow = 0 sweep to the bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    n = 50_000
    cfg, args, rg, w = _cuda_sweep_inputs(n, 4, weighted)
    assert not tk.kernel_smem("bart_sweep_tiled", n, cfg.num_trees, 1,
                              True)["resid_on_chip"]
    p = tk.sweep_plain(cfg, *args, weights=w, rg=rg)
    k = tk.sweep_tiled_cuda(cfg, *args, weights=w, rg=rg, cluster=1)
    torch.cuda.synchronize()
    for i in (0, 1, 3):
        assert torch.equal(k[i], p[i]), i
    torch.testing.assert_close(k[2], p[2], rtol=2e-4, atol=2e-5)
    torch.testing.assert_close(k[4], p[4], rtol=5e-4, atol=5e-4)
    shut = rg.clone()
    shut[..., 0] = 1.0
    a = tk.sweep_tiled_cuda(cfg._replace(p_regrow=0.0), *args, weights=w,
                            cluster=1)
    b = tk.sweep_tiled_cuda(cfg._replace(p_regrow=0.5), *args, weights=w,
                            rg=shut, cluster=1)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
