"""The port's per-chain sweep wrapper and chi(df, scale) k update against
the JAX package's.

On a CPU tensor ``stan4bart_torch...bart_sweep_fused`` runs the plain
PyTorch sweep (``ops/bart.py:sweep_trees``) over a chain-batched state;
it is held here against the JAX package's one-chain ``bart_sweep_fused``
(the per-chain Pallas kernel, interpreted on the CPU), chain by chain, in
float32 on shared variates made with numpy, over 3 chained sweeps.  One
case builds the JAX operands with a 128-lane slice, so that the
reference runs its lane-sliced body (3 slices at n = 300).  Tolerances
are those of tests/test_sweep_kernel.py: the two sum the same float32
terms in another order.

The chi(df, scale) k update is held against the JAX package's in float64
given the JAX package's own gamma draw; the port's gamma sampler against
scipy by a Kolmogorov-Smirnov test.  The slice-level test checks that
``GibbsProgram.step`` takes the obs-tiled wrapper past the per-chain
kernel's limit with the same draws.  The CUDA kernel itself is checked on
the card (marker ``cuda``; skipped without a GPU) and by
``chip_smoke.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats
import torch

from stan4bart_torch import gibbs as tg
from stan4bart_torch.convert import bart_state_from_numpy
from stan4bart_torch.formula.design import build_model_frame
from stan4bart_torch.models.assemble import build_parametric_model
from stan4bart_torch.ops import bart as tb
from stan4bart_torch.ops import bart_sweep_kernel as tk
from stan4bart_torch.utils.friedman import (
    friedman_dataframe,
    generate_friedman_data,
)
from stan4bart_tpu.ops import bart as jb
from stan4bart_tpu.ops import bart_sweep_kernel as jk

torch.set_num_threads(2)

N, P, T, C = 300, 5, 8, 2
LV_TOL = dict(rtol=2e-4, atol=2e-5)
FIT_TOL = dict(rtol=5e-4, atol=5e-4)


def _setup(seed, dtype=torch.float32, **cfg_kw):
    """Data, cut ranks and a prior-drawn forest of C chains (drawn by the
    port, handed to both packages)."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(N, P))
    y = (np.sin(X[:, 0]) + X[:, 1] ** 2
         + rng.normal(scale=0.5, size=N)).astype(np.float32)
    cfg = jb.BartConfig(num_trees=T, **cfg_kw)
    tcfg = tb.BartConfig(num_trees=T, **cfg_kw)
    ranks = jb.compute_ranks(X, jb.make_cut_grid(X, cfg.n_cuts))
    sp = np.full(P, 1.0 / P, dtype=np.float32)
    gen = torch.Generator()
    gen.manual_seed(seed)
    ts = tb.sample_trees_from_prior(tcfg, gen, torch.as_tensor(ranks), sp,
                                    C, dtype=dtype)
    js = jb.BartState(**{f: jnp.asarray(getattr(ts, f).numpy())
                         for f in jb.BartState._fields})
    return cfg, tcfg, y, ranks, sp, js


def _chain(tree, c):
    return jax.tree_util.tree_map(lambda a: a[c], tree)


@pytest.mark.parametrize("weighted, lane_slice", [
    (False, None), (True, None), (False, 128)])
def test_plain_sweep_matches_interpreted_per_chain_tpu_kernel(weighted,
                                                              lane_slice):
    cfg, tcfg, y, ranks, sp, js = _setup(31 + weighted + 2 * bool(lane_slice))
    ts = bart_state_from_numpy(js, dtype=torch.float32, device="cpu")
    jc = jk.make_sweep_consts(cfg, ranks, sp, lane_slice=lane_slice)
    assert jc.n_slices == (3 if lane_slice else 1)
    tc = tk.make_sweep_consts(tcfg, ranks, sp, device="cpu")
    rng = np.random.default_rng(7)
    w = (rng.uniform(0.5, 2.0, N).astype(np.float32) if weighted
         else None)
    sigma = np.array([0.7, 1.1], np.float32)
    yb = np.ascontiguousarray(np.broadcast_to(y, (C, N)))
    jstates = [_chain(js, c) for c in range(C)]
    for sweep in range(3):
        u = rng.uniform(size=(C, T, 8)).astype(np.float32)
        zn = rng.normal(size=(C, T, 128)).astype(np.float32)
        ts, tvc = tk.bart_sweep_fused(
            tcfg, ts, torch.as_tensor(yb), tc, torch.as_tensor(sigma), None,
            weights=None if w is None else torch.as_tensor(w),
            variates=(torch.as_tensor(u), torch.as_tensor(zn)))
        for c in range(C):
            jstates[c], jvc = jk.bart_sweep_fused(
                cfg, jstates[c], jnp.asarray(y), jc, jnp.asarray(sigma[c]),
                None, weights=None if w is None else jnp.asarray(w),
                variates=(jnp.asarray(u[c]), jnp.asarray(zn[c])),
                interpret=True)
            jsc = jstates[c]
            for name in ("feature", "cut", "leaf_idx"):
                np.testing.assert_array_equal(
                    np.asarray(getattr(jsc, name)),
                    getattr(ts, name)[c].numpy(),
                    err_msg=f"sweep {sweep} chain {c}: {name}")
            np.testing.assert_array_equal(np.asarray(jvc), tvc[c].numpy())
            np.testing.assert_allclose(np.asarray(jsc.leaf_value),
                                       ts.leaf_value[c].numpy(), **LV_TOL)
            np.testing.assert_allclose(np.asarray(jsc.allfit),
                                       ts.allfit[c].numpy(), **FIT_TOL)
            np.testing.assert_allclose(np.asarray(jsc.tree_fit),
                                       ts.tree_fit[c].numpy(), **FIT_TOL)
    assert int((ts.feature >= 0).sum()) > 3 * C
    np.testing.assert_allclose(ts.tree_fit.sum(1).numpy(), ts.allfit.numpy(),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("k_scale", [float("inf"), 2.0])
def test_chi_k_update_matches_given_the_reference_gamma(k_scale):
    """The reference's fused sweep ends with the chi(df, scale) k draw
    from ``fold_in(rng, 0x6B)``; given that gamma draw the port's update
    reproduces k and sigma_mu in float64."""
    cfg, tcfg, y, ranks, sp, js = _setup(41, dtype=torch.float64, k_df=3.0,
                                         k_scale=k_scale)
    jc = jk.make_sweep_consts(cfg, ranks, sp)
    rng = np.random.default_rng(8)
    j0 = _chain(js, 0)._replace(k=jnp.asarray(1.7),
                                sigma_mu=jnp.asarray(0.15))
    key = jax.random.PRNGKey(5)
    j1, _ = jk.bart_sweep_fused(
        cfg, j0, jnp.asarray(y, jnp.float64), jc, jnp.asarray(0.8), key,
        variates=(jnp.asarray(rng.uniform(size=(T, 8)), jnp.float32),
                  jnp.asarray(rng.normal(size=(T, 128)), jnp.float32)),
        interpret=True)
    m = float(np.sum(np.asarray(j1.feature) == jb.LEAF))
    g = jax.random.gamma(jax.random.fold_in(key, 0x6B),
                         (cfg.k_df + m) / 2.0, dtype=jnp.float64)
    k, sigma_mu = tb.chi_k_update(
        tcfg, torch.as_tensor(np.array(j1.feature))[None],
        torch.as_tensor(np.array(j1.leaf_value))[None],
        torch.tensor([1.7], dtype=torch.float64),
        torch.tensor([0.15], dtype=torch.float64), None,
        gamma=torch.tensor([float(g)], dtype=torch.float64))
    assert float(j1.k) != 1.7
    np.testing.assert_allclose(k.numpy(), [float(j1.k)], rtol=1e-12)
    np.testing.assert_allclose(sigma_mu.numpy(), [float(j1.sigma_mu)],
                               rtol=1e-12)


def test_gamma_sampler_matches_scipy():
    gen = torch.Generator()
    gen.manual_seed(2024)
    x = tb.standard_gamma(torch.full((4000,), 40.0, dtype=torch.float64),
                          gen).numpy()
    assert np.all(np.isfinite(x)) and np.all(x > 0)
    assert scipy.stats.kstest(x, scipy.stats.gamma(40.0).cdf).pvalue > 0.01


def test_chain_kernel_limit_raises():
    tcfg = tb.BartConfig(num_trees=2)
    consts = tk.make_sweep_consts(tcfg, np.zeros((200, 3), np.int32),
                                  np.full(3, 1 / 3), device="cpu")
    tk.check_kernel_supports(consts._replace(npad=tk.MAX_N_CHAIN),
                             torch.float32, "bart_sweep_chain")
    # past npad 51840 only the obs-tiled kernel takes the sweep
    with pytest.raises(ValueError, match="bart_sweep_fused_batch_tiled"):
        tk.check_kernel_supports(consts._replace(npad=tk.MAX_N_CHAIN + 128),
                                 torch.float32, "bart_sweep_chain")
    with pytest.raises(ValueError, match="float32"):
        tk.check_kernel_supports(consts, torch.float64, "bart_sweep_chain")


def _program():
    d = generate_friedman_data(120, ranef=True, causal=False)
    mf = build_model_frame("y ~ bart(. - g.1 - g.2 - X4) + X4 + (1 | g.1)",
                           friedman_dataframe(d))
    pm, _, _ = build_parametric_model(mf, "gaussian", {"max_treedepth": 5},
                                      dtype=torch.float32, device="cpu")
    return tg.GibbsProgram(pm, tb.BartConfig(num_trees=6), mf.y, mf.bart_X,
                           warmup=2, iterations=2,
                           dtype=torch.float32, device="cpu")


def _two_steps(prog):
    gen = torch.Generator()
    gen.manual_seed(4)
    states = prog.init_state(gen, 3, per_chain=True)
    draws = []
    for it in range(2):
        states, d = prog.step(states, it, True, gen)
        draws.append(d)
    return draws


def test_step_routes_past_the_chain_limit_through_the_tiled_wrapper(
        monkeypatch):
    calls = {"chain": 0, "batch": 0, "tiled": 0}

    def spy(key, fn):
        def wrapped(*args, **kw):
            calls[key] += 1
            return fn(*args, **kw)
        return wrapped

    monkeypatch.setattr(tg, "bart_sweep_fused", spy("chain",
                                                    tk.bart_sweep_fused))
    monkeypatch.setattr(tg, "bart_sweep_fused_batch",
                        spy("batch", tk.bart_sweep_fused_batch))
    monkeypatch.setattr(tg, "bart_sweep_fused_batch_tiled",
                        spy("tiled", tk.bart_sweep_fused_batch_tiled))
    prog = _program()
    assert prog.sweep_single_ok
    ref = _two_steps(prog)
    assert calls == {"chain": 3, "batch": 0, "tiled": 0}

    monkeypatch.setattr(tg, "MAX_N_CHAIN", 0)
    prog = _program()
    assert not prog.sweep_single_ok
    out = _two_steps(prog)
    assert calls == {"chain": 3, "batch": 0, "tiled": 3}
    for a, b in zip(ref, out):
        for name in a._fields:
            x, y = getattr(a, name), getattr(b, name)
            assert torch.isfinite(y.float()).all(), name
            assert torch.equal(x, y), name


def _cuda_inputs(n, seed, chains=4):
    dev = torch.device("cuda")
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, P))
    y = np.sin(X[:, 0]) + X[:, 1] ** 2 + rng.normal(scale=0.5, size=n)
    tcfg = tb.BartConfig(num_trees=T)
    ranks = tb.compute_ranks(X, tb.make_cut_grid(X, tcfg.n_cuts))
    sp = np.full(P, 1.0 / P)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    state = tb.sample_trees_from_prior(
        tcfg, gen, torch.as_tensor(ranks, device=dev), sp, chains,
        dtype=torch.float32)
    consts = tk.make_sweep_consts(tcfg, ranks, sp, device=dev)
    var = tb.draw_variates(gen, chains, T, torch.float32, dev)
    yt = torch.as_tensor(y, dtype=torch.float32, device=dev)
    return (tcfg, state.feature, state.cut, state.leaf_idx, state.tree_fit,
            yt.expand(chains, n).contiguous(),
            torch.full((chains,), 0.81, device=dev),
            state.sigma_mu ** 2, var[0], var[1], consts)


@pytest.mark.cuda
def test_cuda_chain_kernel_matches_plain_and_other_kernels():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    args = _cuda_inputs(3_000, 8)
    k = tk.sweep_chain_cuda(*args)
    p = tk.sweep_plain(*args)
    b = tk.sweep_cuda(*args, cluster=1)
    torch.cuda.synchronize()
    for i in (0, 1, 3):
        assert torch.equal(k[i], p[i])
    torch.testing.assert_close(k[2], p[2], **LV_TOL)
    torch.testing.assert_close(k[4], p[4], **FIT_TOL)
    torch.testing.assert_close(k[5], p[5], **FIT_TOL)
    # the same sums in the same order as the single-pass kernel
    for x, y in zip(k, b):
        assert torch.equal(x, y)
    # at its shared-memory ceiling, bit-identical to the obs-tiled kernel
    args = _cuda_inputs(tk.MAX_N_CHAIN, 9, chains=2)
    k = tk.sweep_chain_cuda(*args)
    t = tk.sweep_tiled_cuda(*args, cluster=1)
    torch.cuda.synchronize()
    for x, y in zip(k, t):
        assert torch.equal(x, y)
