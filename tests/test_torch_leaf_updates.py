"""The port's optional exact Gibbs steps against the JAX package's, in
float64: the Walsh-direction leaf draws (``leaf_gibbs``), the joint leaf
draw (``leaf_block``) and the sigma slice sampler (``sigma_gibbs``).

Each update takes the reference's draws (its direction masks, normals
and uniforms, replayed from its key splits) and must give the same
state within 1e-9 relative (the same arithmetic, sums taken in another
order), unweighted, weighted and probit.  The tree fits stay the gather
of the leaf values to the bit; a chain whose active leaves exceed the
block dimension keeps its leaves; tiny CPU fits with each option are
finite and set its flags."""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import stan4bart_torch
from stan4bart_torch.formula import build_model_frame as port_mf
from stan4bart_torch.gibbs import GibbsProgram as PortProgram
from stan4bart_torch.models.assemble import build_parametric_model as port_pm
from stan4bart_torch.ops.bart import BartConfig as PortBartConfig
from stan4bart_torch.ops.bart import sample_trees_from_prior
from stan4bart_tpu.formula import build_model_frame as ref_mf
from stan4bart_tpu.gibbs import GibbsProgram as RefProgram
from stan4bart_tpu.models.assemble import build_parametric_model as ref_pm
from stan4bart_tpu.ops import bart as jb
from stan4bart_tpu.utils.friedman import (
    friedman_dataframe,
    generate_friedman_data,
)

torch.set_num_threads(2)

FORMULA = "y ~ bart(X1 + X2) + X4 + z + (1 + X4 | g.1) + (1 | g.2)"
FLAGSHIP = ("y ~ bart(. - g.1 - g.2 - X4 - z) + X4 + z + (1 + X4 | g.1) "
            "+ (1 | g.2)")
N, T, C = 150, 7, 3
TOL = dict(rtol=1e-9, atol=1e-9)


def _programs(weights=False, binary=False, **opts):
    d = generate_friedman_data(N, ranef=True, causal=True, binary=binary)
    df = friedman_dataframe(d)
    w = np.linspace(0.5, 2.0, N) if weights else None
    rmf = ref_mf(FORMULA, df, weights=w)
    pmf = port_mf(FORMULA, df, weights=w)
    fam = "binomial" if binary else "gaussian"
    rpm, _, _ = ref_pm(rmf, fam, {"centered_ranef": True})
    ppm, _, _ = port_pm(pmf, fam, {"centered_ranef": True}, device="cpu")
    kw = dict(weights=w, warmup=5, iterations=5, linear_gibbs=False,
              level_gibbs=False, **opts)
    rprog = RefProgram(rpm, jb.BartConfig(num_trees=T), rmf.y, rmf.bart_X,
                       **kw)
    pprog = PortProgram(ppm, PortBartConfig(num_trees=T), pmf.y, pmf.bart_X,
                        dtype=torch.float64, device="cpu", **kw)
    return d, rprog, pprog


def _state(pprog, binary):
    """A prior forest with drawn leaf values, fits, an offset, latents
    and sigma: the port's (C-batched) and the reference's (stacked)."""
    gen = torch.Generator()
    gen.manual_seed(7)
    f = sample_trees_from_prior(pprog.bart_cfg, gen, pprog.ranks,
                                pprog.split_probs, C)
    lv = torch.where(f.feature == jb.LEAF,
                     0.3 * torch.randn(f.leaf_value.shape, generator=gen,
                                       dtype=torch.float64), 0.0)
    tf = torch.gather(lv, 2, f.leaf_idx.long())
    f = f._replace(leaf_value=lv, tree_fit=tf, allfit=tf.sum(1),
                   sigma_mu=torch.tensor([0.2, 0.3, 0.4],
                                         dtype=torch.float64))
    off = 0.5 * torch.randn((C, pprog.N), generator=gen,
                            dtype=torch.float64)
    lat = (torch.randn((C, pprog.N), generator=gen, dtype=torch.float64)
           if binary else torch.zeros((C, pprog.N), dtype=torch.float64))
    sigma = (torch.ones(C, dtype=torch.float64) if binary
             else torch.tensor([0.8, 1.0, 1.3], dtype=torch.float64))
    ref = jb.BartState(*(jnp.asarray(x.numpy()) for x in f))
    return f, ref, off, lat, sigma


def _assert_state(ref, port, msg):
    for name in ("leaf_value", "tree_fit", "allfit"):
        np.testing.assert_allclose(np.asarray(getattr(ref, name)),
                                   getattr(port, name).numpy(), **TOL,
                                   err_msg=f"{msg}: {name}")
    # the fits are the gather of the leaf values, to the bit
    assert torch.equal(torch.gather(port.leaf_value, 2,
                                    port.leaf_idx.long()), port.tree_fit)


CASES = [(False, False), (True, False), (False, True)]
CASE_IDS = ["unweighted", "weighted", "probit"]


@pytest.mark.parametrize("weights,binary", CASES, ids=CASE_IDS)
def test_leaf_gibbs_matches_given_masks_and_normals(weights, binary):
    d, rprog, pprog = _programs(weights, binary, leaf_gibbs=1)
    f, rf, off, lat, sigma = _state(pprog, binary)
    M = pprog.bart_cfg.max_nodes
    masks = np.random.default_rng(3).integers(1, 2 ** M.bit_length(),
                                              size=(C, T))
    keys = jax.random.split(jax.random.PRNGKey(11), C)
    z = np.array(jax.vmap(lambda k: jax.random.normal(
        jax.random.split(k)[1], (T,), jnp.float64))(keys))
    ref = jax.jit(jax.vmap(
        lambda b, o, la, s, k, m: rprog._leaf_gibbs_update(
            b, o, la, s, k, masks=m)))(
        rf, jnp.asarray(off.numpy()), jnp.asarray(lat.numpy()),
        jnp.asarray(sigma.numpy()), keys, jnp.asarray(masks, jnp.int32))
    port = pprog._leaf_gibbs_update(f, off, lat, sigma, None,
                                    masks=torch.as_tensor(masks),
                                    z=torch.as_tensor(z))
    _assert_state(ref, port, "leaf_gibbs")
    nonleaf = f.feature != jb.LEAF
    assert torch.equal(port.leaf_value[nonleaf], f.leaf_value[nonleaf])


@pytest.mark.parametrize("weights,binary", CASES, ids=CASE_IDS)
def test_leaf_block_matches_given_normals(weights, binary):
    d, rprog, pprog = _programs(weights, binary, leaf_block=1)
    f, rf, off, lat, sigma = _state(pprog, binary)
    D = pprog.leaf_block_dim
    assert D == rprog.leaf_block_dim == min(128, T * 127)
    keys = jax.random.split(jax.random.PRNGKey(12), C)
    z = np.array(jax.vmap(lambda k: jax.random.normal(
        k, (D,), jnp.float64))(keys))
    ref = jax.jit(jax.vmap(
        lambda b, o, la, s, k: rprog._leaf_block_update(b, o, la, s, k)))(
        rf, jnp.asarray(off.numpy()), jnp.asarray(lat.numpy()),
        jnp.asarray(sigma.numpy()), keys)
    port = pprog._leaf_block_update(f, off, lat, sigma, None,
                                    z=torch.as_tensor(z))
    _assert_state(ref, port, "leaf_block")
    leaf = f.feature == jb.LEAF
    assert not torch.allclose(port.leaf_value[leaf], f.leaf_value[leaf])


def test_leaf_block_overflow_skips_and_auto_dim():
    """Active leaves above the cap: that chain keeps its state exactly.
    The auto cap is about 8 leaves per tree in whole 128s, at most the
    heap."""
    d, rprog, pprog = _programs(leaf_block=1, leaf_block_dim=2)
    assert pprog.leaf_block_dim == 2
    f, rf, off, lat, sigma = _state(pprog, False)
    port = pprog._leaf_block_update(f, off, lat, sigma, None,
                                    z=torch.zeros((C, 2),
                                                  dtype=torch.float64))
    for name in ("leaf_value", "tree_fit", "allfit"):
        assert torch.equal(getattr(port, name), getattr(f, name))
    ppm = pprog.pm
    for trees, want in ((7, 128), (75, 640), (1, 127)):
        prog = PortProgram(ppm, PortBartConfig(num_trees=trees),
                           np.zeros(N), np.zeros((N, 2)), warmup=2,
                           iterations=2, leaf_block=1, dtype=torch.float64,
                           device="cpu")
        assert prog.leaf_block_dim == want


def test_walsh_signs_match():
    x = torch.arange(128)
    for m in (0, 1, 2, 3, 37, 127):
        ref = np.asarray(RefProgram._walsh_signs(
            jnp.arange(128, dtype=jnp.int32), jnp.int32(m), jnp.float64))
        port = PortProgram._walsh_signs(x, torch.tensor(m), torch.float64)
        np.testing.assert_array_equal(ref, port.numpy())


def test_sigma_gibbs_matches_given_uniforms():
    """The slice sampler of sigma given the reference's uniforms (slice
    height, interval placement, the 32 shrink proposals)."""
    d, rprog, pprog = _programs(sigma_gibbs=True)
    assert pprog.sigma_gibbs and rprog.sigma_gibbs
    pm = pprog.pm
    rng = np.random.default_rng(4)
    U = rng.uniform(-1, 1, size=(C, pm.num_upars))
    off = d["mu_bart"][None] + rng.normal(scale=0.5, size=(C, N))
    y = np.asarray(pprog.y)
    keys = jax.random.split(jax.random.PRNGKey(13), C)
    ref = np.asarray(jax.jit(jax.vmap(
        lambda u, o, k: rprog._sigma_gibbs_update(
            u, o, jnp.asarray(y), k)))(
        jnp.asarray(U), jnp.asarray(off), keys))

    def draws(k):
        r_h, r_u, r_s = jax.random.split(k, 3)
        shrink = jax.vmap(lambda j: jax.random.uniform(
            jax.random.fold_in(r_s, j), (), jnp.float64))(jnp.arange(32))
        return (jax.random.uniform(r_h, (), jnp.float64),
                jax.random.uniform(r_u, (), jnp.float64), shrink)

    variates = tuple(torch.as_tensor(np.array(x))
                     for x in jax.vmap(draws)(keys))
    port = pprog._sigma_gibbs_update(torch.as_tensor(U),
                                     torch.as_tensor(off),
                                     torch.as_tensor(y), None,
                                     variates=variates)
    np.testing.assert_allclose(ref, port.numpy(), **TOL)
    off_aux = pm.layout.slices["aux_unscaled"][0]
    moved = np.ones(pm.num_upars, bool)
    moved[off_aux] = False
    np.testing.assert_array_equal(port.numpy()[:, moved], U[:, moved])
    assert np.all(port.numpy()[:, off_aux] != U[:, off_aux])


def test_option_bounds_checks():
    df = friedman_dataframe(generate_friedman_data(40))
    for kw, msg in (
            (dict(stan_args={"leaf_gibbs": -1}), "leaf_gibbs"),
            (dict(stan_args={"leaf_block": -2}), "leaf_block"),
            (dict(stan_args={"leaf_block_dim": -1}), "leaf_block_dim"),
            (dict(bart_args={"regrow_per_sweep": -1}), "regrow_per_sweep")):
        with pytest.raises(ValueError, match=msg):
            stan4bart_torch.stan4bart("y ~ bart(X1 + X2) + X4", df,
                                      verbose=-1, device="cpu", **kw)


@pytest.mark.parametrize("step_fn,binary", [("step_batched", False),
                                           ("step", False),
                                           ("step_batched", True)],
                         ids=["batched", "per_chain", "probit"])
def test_tiny_fit_with_gibbs_options(step_fn, binary):
    """sigma_gibbs, leaf_gibbs and leaf_block through the entry point:
    finite draws, the flags set (sigma_gibbs off for probit), the stored
    BART fit equal to the stored forests."""
    df = friedman_dataframe(generate_friedman_data(100, ranef=True,
                                                   causal=True,
                                                   binary=binary))
    kw = ({"callback": lambda d: {"f": d.yhat_train}}
          if step_fn == "step" else {})
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        fit = stan4bart_torch.stan4bart(
            FLAGSHIP, df, chains=2, iter=12, warmup=6, seed=5, verbose=-1,
            device="cpu", bart_args={"n.trees": 5, "keep_trees": True},
            stan_args={"sigma_gibbs": True, "leaf_gibbs": 2,
                       "leaf_block": 3, "max_treedepth": 4}, **kw)
    assert fit.prog.sigma_gibbs == (not binary)
    assert fit.prog.leaf_gibbs == 2 and fit.prog.leaf_block == 3
    assert fit.prog.leaf_block_dim == 128
    assert np.all(np.isfinite(fit.draws.stan))
    assert np.abs(fit.predict(df, type="indiv.bart")
                  - fit.extract("indiv.bart")).max() == 0.0


def test_every_option_draws_the_same_batched_and_per_chain():
    """Every option together on the CPU: a fit with all of them on
    draws the same through ``step_batched`` and the per-chain
    ``step`` (the two consume the generator alike and their sweeps'
    plain versions agree)."""
    df = friedman_dataframe(generate_friedman_data(100, ranef=True,
                                                   causal=True))
    kw = dict(chains=2, iter=12, warmup=6, seed=6, verbose=-1, device="cpu",
              dtype=torch.float64,
              bart_args={"n.trees": 5, "regrow_per_sweep": 1},
              stan_args={"qr": True, "centered_ranef": True,
                         "prior_covariance": stan4bart_torch.lkj(),
                         "sigma_gibbs": True, "leaf_gibbs": 1,
                         "leaf_block": 4, "max_treedepth": 4})
    batched = stan4bart_torch.stan4bart(FLAGSHIP, df, **kw)
    per_chain = stan4bart_torch.stan4bart(
        FLAGSHIP, df, callback=lambda d: {"s": d["aux.1"]}, **kw)
    assert not batched.per_chain and per_chain.per_chain
    for name in ("stan", "bart_train", "bart_test", "varcount"):
        np.testing.assert_allclose(getattr(batched.draws, name),
                                   getattr(per_chain.draws, name),
                                   rtol=1e-12, atol=1e-12, err_msg=name)
    np.testing.assert_array_equal(per_chain.extract("callback")["s"],
                                  per_chain.extract("sigma"))


@pytest.mark.parametrize("update", ["leaf_gibbs", "leaf_block"])
def test_leaf_update_keeps_a_chain_that_does_not_factor(monkeypatch,
                                                        update):
    """A chain whose leaf precision does not factor keeps its leaves;
    the other chains draw as before."""
    d, rprog, pprog = _programs(**{update: 1})
    f, rf, off, lat, sigma = _state(pprog, False)
    D = pprog.leaf_block_dim if update == "leaf_block" else T
    z = torch.as_tensor(np.random.default_rng(8).normal(size=(C, D)))
    kw = {"z": z}
    if update == "leaf_gibbs":
        kw["masks"] = torch.as_tensor(
            np.random.default_rng(9).integers(1, 128, size=(C, T)))
    fn = getattr(pprog, f"_{update}_update")
    full = fn(f, off, lat, sigma, None, **kw)
    real = torch.linalg.cholesky_ex

    def fake(A, **k):
        L, info = real(A, **k)
        info = info.clone()
        info[0] = 1
        return L, info

    monkeypatch.setattr(torch.linalg, "cholesky_ex", fake)
    kept = fn(f, off, lat, sigma, None, **kw)
    for name in ("leaf_value", "tree_fit"):
        assert torch.equal(getattr(kept, name)[0], getattr(f, name)[0])
        assert torch.equal(getattr(kept, name)[1:], getattr(full, name)[1:])
    assert not torch.equal(full.leaf_value[0], f.leaf_value[0])
