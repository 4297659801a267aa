"""The port's subtree-regrow refresh (``ops/bart.regrow_refresh``, the
JAX package's ``regrow_per_sweep``) against the JAX package's, on the
same randomness.

The JAX function draws its variates from key splits the test replays
(``split(rng, R)``, then per regrow ``split(key, 3)`` for the tree, the
move and the leaf normals); the port takes the same draws through
``variates=``.  Tolerance: forests identical, float64 values within 1e-9
(the same arithmetic, per-node sums taken in another order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import stan4bart_torch
from stan4bart_torch.ops import bart as tb
from stan4bart_tpu.ops import bart as jb
from stan4bart_tpu.utils.friedman import (
    friedman_dataframe,
    generate_friedman_data,
)

torch.set_num_threads(2)

N, P, T, C, R = 150, 4, 8, 3, 3
TOL = dict(rtol=1e-9, atol=1e-9)


def _forest(weights):
    """A swept forest of C chains (port), its JAX twin, and the data."""
    rng = np.random.default_rng(5)
    X = rng.uniform(size=(N, P))
    y = np.sin(4 * X[:, 0]) + X[:, 1] + rng.normal(scale=0.3, size=N)
    w = np.linspace(0.5, 2.0, N) if weights else None
    tcfg = tb.BartConfig(num_trees=T, max_depth=4, n_cuts=16)
    ranks = tb.compute_ranks(X, tb.make_cut_grid(X, tcfg.n_cuts))
    sp = np.full(P, 1.0 / P)
    gen = torch.Generator()
    gen.manual_seed(2)
    ranks_t = torch.as_tensor(ranks)
    state = tb.sample_trees_from_prior(tcfg, gen, ranks_t, sp, C)
    state = state._replace(sigma_mu=torch.full((C,), 0.4,
                                               dtype=torch.float64))
    y_target = torch.as_tensor(y - y.mean()).expand(C, N).clone()
    sigma = torch.tensor([0.3, 0.5, 0.8], dtype=torch.float64)
    for _ in range(3):
        state, _ = tb.bart_sweep(tcfg, state, y_target, ranks_t, sp, sigma,
                                 gen, weights=w)
    return tcfg, state, y_target, ranks, sp, sigma, w


def _replayed_variates(keys, M, dtype=jnp.float64):
    """The draws ``jb.regrow_refresh`` makes from each chain's key."""
    def one(rng):
        def per(key):
            kj, kmv, kmu = jax.random.split(key, 3)
            j = jax.random.randint(kj, (), 0, T)
            rng_g, rng_u = jax.random.split(kmv)
            return (j, jax.random.uniform(rng_g, (3,), dtype=dtype),
                    jax.random.uniform(rng_u, (3, M), dtype=dtype),
                    jax.random.normal(kmu, (M,), dtype))
        return jax.vmap(per)(jax.random.split(rng, R))
    out = jax.vmap(one)(keys)
    return tuple(torch.as_tensor(np.array(x)) for x in out)


@pytest.mark.parametrize("weights", [False, True])
def test_regrow_refresh_matches_reference_given_variates(weights):
    tcfg, state, y_target, ranks, sp, sigma, w = _forest(weights)
    jcfg = jb.BartConfig(num_trees=T, max_depth=4, n_cuts=16,
                         regrow_per_sweep=R)
    js = jb.BartState(*(jnp.asarray(x.numpy()) for x in state))
    keys = jax.random.split(jax.random.PRNGKey(9), C)
    ref = jax.jit(jax.vmap(
        lambda s, yt, sg, k: jb.regrow_refresh(
            jcfg, s, yt, jnp.asarray(ranks), sp, sg, k,
            weights=None if w is None else jnp.asarray(w))))(
        js, jnp.asarray(y_target.numpy()), jnp.asarray(sigma.numpy()), keys)
    variates = _replayed_variates(keys, tcfg.max_nodes)
    port = tb.regrow_refresh(tcfg._replace(regrow_per_sweep=R), state,
                             y_target, torch.as_tensor(ranks), sp, sigma,
                             weights=w, variates=variates)
    for name in ("feature", "cut", "leaf_idx"):
        np.testing.assert_array_equal(np.asarray(getattr(ref, name)),
                                      getattr(port, name).numpy(),
                                      err_msg=name)
    for name in ("leaf_value", "tree_fit", "allfit", "k", "sigma_mu"):
        np.testing.assert_allclose(np.asarray(getattr(ref, name)),
                                   getattr(port, name).numpy(), **TOL,
                                   err_msg=name)
    # the regrows moved something, and every refreshed tree's fit is the
    # gather of its leaf values (to the bit)
    assert not torch.equal(port.feature, state.feature) or \
        not torch.equal(port.leaf_value, state.leaf_value)
    rebuilt = torch.gather(port.leaf_value, 2, port.leaf_idx.long())
    assert torch.equal(rebuilt, port.tree_fit)


def test_regrow_guards():
    tcfg, state, y_target, ranks, sp, sigma, w = _forest(False)
    cfg = tcfg._replace(regrow_per_sweep=2)
    u = torch.zeros((C, T, 6), dtype=torch.float64)
    zn = torch.zeros((C, T, 128), dtype=torch.float64)
    with pytest.raises(ValueError, match="regrow"):
        tb.bart_sweep(cfg, state, y_target, torch.as_tensor(ranks), sp,
                      sigma, variates=(u, zn))
    gen = torch.Generator()
    bad = tb.draw_regrow_variates(gen, C, tcfg._replace(regrow_per_sweep=3),
                                  torch.float64, "cpu")
    with pytest.raises(ValueError, match="regrow variates"):
        tb.regrow_refresh(cfg, state, y_target, torch.as_tensor(ranks), sp,
                          sigma, variates=bad)
    # off: the state comes back unchanged
    assert tb.regrow_refresh(tcfg, state, y_target, torch.as_tensor(ranks),
                             sp, sigma, gen) is state


def test_regrow_per_sweep_smoke_and_sanity():
    """The op-form sweep with regrows keeps the fit invariants and fits
    the signal (the JAX package's test_regrow_per_sweep_smoke_and_sanity
    on the port)."""
    rs = np.random.RandomState(2)
    n = 150
    X = rs.uniform(size=(n, 3))
    y = np.sin(4 * X[:, 0]) + X[:, 1] + 0.2 * rs.normal(size=n)
    cfg = tb.BartConfig(num_trees=20, max_depth=3, n_cuts=16,
                        regrow_per_sweep=3)
    ranks = torch.as_tensor(tb.compute_ranks(X, tb.make_cut_grid(X, 16)))
    sp = np.full(3, 1.0 / 3.0)
    state = tb.bart_init(cfg, 1, n, device="cpu")
    y_t = torch.as_tensor(y - y.mean())[None]
    gen = torch.Generator()
    gen.manual_seed(1)
    sigma = torch.full((1,), 0.3, dtype=torch.float64)
    for _ in range(60):
        state, _ = tb.bart_sweep(cfg, state, y_t, ranks, sp, sigma, gen)
    fit = state.allfit[0].numpy()
    assert np.all(np.isfinite(fit))
    assert np.allclose(fit, state.tree_fit[0].sum(0).numpy(), atol=1e-8)
    rebuilt = torch.gather(state.leaf_value, 2, state.leaf_idx.long())
    assert torch.equal(rebuilt, state.tree_fit)
    assert np.corrcoef(fit, y - y.mean())[0, 1] > 0.8


@pytest.mark.parametrize("step_fn", ["step_batched", "step"])
def test_tiny_fit_with_regrow(step_fn):
    """A tiny fit with regrow_per_sweep through step_batched and step:
    finite draws, the option set, and the stored BART fit equal to the
    stored forests."""
    df = friedman_dataframe(generate_friedman_data(100, ranef=True,
                                                   causal=True))
    kw = {"callback": lambda d: {"s": d["aux.1"]}} \
        if step_fn == "step" else {}
    fit = stan4bart_torch.stan4bart(
        "y ~ bart(. - g.1 - g.2 - X4 - z) + X4 + z + (1 | g.1)", df,
        chains=2, iter=20, warmup=10, seed=3, verbose=-1, device="cpu",
        bart_args={"n.trees": 5, "regrow_per_sweep": 2, "keep_trees": True},
        **kw)
    assert fit.prog.bart_cfg.regrow_per_sweep == 2
    assert fit.per_chain == (step_fn == "step")
    assert np.all(np.isfinite(fit.draws.stan))
    assert np.all(np.isfinite(fit.draws.bart_train))
    err = np.abs(fit.predict(df, type="indiv.bart")
                 - fit.extract("indiv.bart")).max()
    assert err == 0.0
