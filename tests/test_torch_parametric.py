"""The port's parametric block against the JAX package's on the flagship
model, in float64.

Tolerance: log-densities and their gradients within 1e-9 relative (the
same arithmetic; sums in another order); the conjugate refreshes equal
given the same standard normals."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stan4bart_torch.formula import build_model_frame as port_mf
from stan4bart_torch.gibbs import GibbsProgram as PortProgram
from stan4bart_torch.convert import nuts_state_from_numpy
from stan4bart_torch.models.assemble import build_parametric_model as port_pm
from stan4bart_torch.ops.bart import BartConfig as PortBartConfig
from stan4bart_torch.ops.bart import predict_trees, sample_trees_from_prior
from stan4bart_tpu.formula import build_model_frame as ref_mf
from stan4bart_tpu.gibbs import GibbsProgram as RefProgram
from stan4bart_tpu.models.assemble import build_parametric_model as ref_pm
from stan4bart_tpu.ops import bart as jb
from stan4bart_tpu.ops.nuts import nuts_init
from stan4bart_tpu.utils.friedman import (
    friedman_dataframe,
    generate_friedman_data,
)

torch.set_num_threads(2)

FLAGSHIP = ("y ~ bart(. - g.1 - g.2 - X4 - z) + X4 + z + (1 + X4 | g.1) "
            "+ (1 | g.2)")
C = 3
TOL = dict(rtol=1e-9, atol=1e-9)


@pytest.fixture(scope="module")
def models():
    d = generate_friedman_data(120, ranef=True, causal=True)
    df = friedman_dataframe(d)
    rmf, pmf = ref_mf(FLAGSHIP, df), port_mf(FLAGSHIP, df)
    rpm, _, _ = ref_pm(rmf, "gaussian", {})
    ppm, _, _ = port_pm(pmf, "gaussian", {}, device="cpu")
    rng = np.random.default_rng(0)
    U = rng.uniform(-1, 1, size=(C, rpm.num_upars))
    off = d["mu_bart"][None] + rng.normal(scale=0.5, size=(C, rmf.N))
    return d, df, rmf, pmf, rpm, ppm, U, off, np.asarray(rmf.y)


def test_layout_and_names_match(models):
    d, df, rmf, pmf, rpm, ppm, U, off, y = models
    assert rpm.num_upars == ppm.num_upars
    assert rpm.layout.slices == ppm.layout.slices
    assert rpm.constrained_names() == ppm.constrained_names()
    ref = np.asarray(jax.vmap(rpm.constrained_draw)(jnp.asarray(U)))
    np.testing.assert_allclose(
        ref, ppm.constrained_draw(torch.as_tensor(U)).numpy(), **TOL)
    np.testing.assert_allclose(np.asarray(rpm.initial_inv_mass(1.7, 120)),
                               ppm.initial_inv_mass(1.7, 120), **TOL)


def test_log_prob_and_gradient_match(models):
    d, df, rmf, pmf, rpm, ppm, U, off, y = models
    ref_lp, ref_g = jax.jit(jax.vmap(jax.value_and_grad(
        lambda u, o: rpm.log_prob(u, o, jnp.asarray(y)))))(
            jnp.asarray(U), jnp.asarray(off))
    u = torch.tensor(U, requires_grad=True)
    lp = ppm.log_prob(u, torch.as_tensor(off), torch.as_tensor(y))
    (g,) = torch.autograd.grad(lp.sum(), u)
    np.testing.assert_allclose(np.asarray(ref_lp), lp.detach().numpy(),
                               **TOL)
    np.testing.assert_allclose(np.asarray(ref_g), g.numpy(), **TOL)


def test_gram_log_prob_and_gradient_match(models):
    d, df, rmf, pmf, rpm, ppm, U, off, y = models
    assert rpm.enable_gram() and ppm.enable_gram()
    anchor_at = 0.9 * U

    def ref_one(u, at, o):
        a = rpm.gram_anchor(at, o, jnp.asarray(y))
        return jax.value_and_grad(lambda x: rpm.log_prob_gram(x, a))(u)

    ref_lp, ref_g = jax.jit(jax.vmap(ref_one))(
        jnp.asarray(U), jnp.asarray(anchor_at), jnp.asarray(off))
    anchor = ppm.gram_anchor(torch.as_tensor(anchor_at),
                             torch.as_tensor(off), torch.as_tensor(y))
    u = torch.tensor(U, requires_grad=True)
    lp = ppm.log_prob_gram(u, anchor)
    (g,) = torch.autograd.grad(lp.sum(), u)
    np.testing.assert_allclose(np.asarray(ref_lp), lp.detach().numpy(),
                               **TOL)
    np.testing.assert_allclose(np.asarray(ref_g), g.numpy(), **TOL)
    # the Gram form is the direct likelihood reorganized
    direct = ppm.log_prob(torch.as_tensor(U), torch.as_tensor(off),
                          torch.as_tensor(y))
    np.testing.assert_allclose(direct.numpy(), lp.detach().numpy(),
                               rtol=1e-9)


def test_linear_gibbs_refresh_matches_given_normals(models):
    d, df, rmf, pmf, rpm, ppm, U, off, y = models
    assert rpm.enable_linear_gibbs() and ppm.enable_linear_gibbs()
    D = ppm.gram_G.shape[0]
    keys = jax.random.split(jax.random.PRNGKey(0), C)
    z = np.array(jax.vmap(lambda k: jax.random.normal(k, (D,),
                                                      jnp.float64))(keys))
    ref = np.asarray(jax.jit(jax.vmap(
        lambda u, o, k: rpm.linear_gibbs_refresh(u, o, jnp.asarray(y), k)))(
            jnp.asarray(U), jnp.asarray(off), keys))
    port = ppm.linear_gibbs_refresh(torch.as_tensor(U), torch.as_tensor(off),
                                    torch.as_tensor(y), z=torch.as_tensor(z))
    np.testing.assert_allclose(ref, port.numpy(), **TOL)


def test_level_gibbs_update_matches_given_normals(models):
    """The additive-level interweave of GibbsProgram, one chain at a time
    in the reference, all chains at once in the port."""
    d, df, rmf, pmf, rpm, ppm, U, off, y = models
    T = 6
    cfg = jb.BartConfig(num_trees=T, max_depth=3)
    rprog = RefProgram(rpm, cfg, y, rmf.bart_X, warmup=10, iterations=10)
    pprog = PortProgram(ppm, PortBartConfig(num_trees=T, max_depth=3), y,
                        pmf.bart_X,
                        warmup=10,
                        iterations=10, dtype=torch.float64,
                        device="cpu")
    assert rprog.level_gibbs and pprog.level_gibbs
    gen = torch.Generator()
    gen.manual_seed(4)
    forest = sample_trees_from_prior(pprog.bart_cfg, gen, pprog.ranks,
                                     pprog.split_probs, C)
    lv = torch.where(forest.feature == jb.LEAF,
                     torch.randn(forest.leaf_value.shape, generator=gen,
                                 dtype=torch.float64), 0.0)
    forest = forest._replace(
        leaf_value=lv, sigma_mu=torch.full((C,), 0.3, dtype=torch.float64),
        allfit=predict_trees(pprog.bart_cfg, forest.feature, forest.cut, lv,
                             pprog.ranks))
    ref_forest = jb.BartState(*(jnp.asarray(x.numpy()) for x in forest))
    dim = T + len(pprog._level_terms)
    rkeys = jax.random.split(jax.random.PRNGKey(10), C)
    z = np.array(jax.vmap(lambda k: jax.random.normal(k, (dim,),
                                                      jnp.float64))(rkeys))
    nuts = jax.vmap(lambda u: nuts_init(None, u))(jnp.asarray(U))
    rn, rb = jax.jit(jax.vmap(
        lambda n, b, o, k: rprog._level_gibbs_update(
            n, b, o, jnp.zeros(rmf.N), k)))(nuts, ref_forest,
                                            jnp.asarray(off), rkeys)
    pn, pb = pprog._level_gibbs_update(
        nuts_state_from_numpy(nuts, device="cpu"), forest,
        torch.as_tensor(off), torch.zeros(C, rmf.N, dtype=torch.float64),
        None, z=torch.as_tensor(z))
    np.testing.assert_allclose(np.asarray(rn.q), pn.q.numpy(), **TOL)
    np.testing.assert_allclose(np.asarray(rb.leaf_value),
                               pb.leaf_value.numpy(), **TOL)
    np.testing.assert_allclose(np.asarray(rb.allfit), pb.allfit.numpy(),
                               **TOL)


@pytest.mark.parametrize("family", ["student_t_coef_t_aux", "normal_aux"])
def test_other_supported_priors_match(models, family):
    """The coefficient / aux prior families the port implements beside
    the defaults (Student-t through the Cornish-Fisher transform)."""
    from stan4bart_torch.models import priors as pp
    from stan4bart_tpu.models import priors as rp

    d, df, rmf, pmf, rpm, ppm, U, off, y = models

    def args(pr):
        if family == "normal_aux":
            return {"prior_aux": pr.normal(0.0, 2.0)}
        return {"prior": pr.student_t(df=4.0, scale=1.5),
                "prior_aux": pr.student_t(df=3.0)}

    r, _, _ = ref_pm(rmf, "gaussian", args(rp))
    p, _, _ = port_pm(pmf, "gaussian", args(pp), device="cpu")
    ref_lp, ref_g = jax.jit(jax.vmap(jax.value_and_grad(
        lambda u, o: r.log_prob(u, o, jnp.asarray(y)))))(
            jnp.asarray(U), jnp.asarray(off))
    u = torch.tensor(U, requires_grad=True)
    lp = p.log_prob(u, torch.as_tensor(off), torch.as_tensor(y))
    (g,) = torch.autograd.grad(lp.sum(), u)
    np.testing.assert_allclose(np.asarray(ref_lp), lp.detach().numpy(),
                               **TOL)
    np.testing.assert_allclose(np.asarray(ref_g), g.numpy(), **TOL)
    # prior draws land on the support of every constrained block
    draws = p.prior_draw_unconstrained(np.random.default_rng(0), 64)
    assert draws.shape == (64, p.num_upars)
    assert torch.isfinite(draws).all()
    assert torch.isfinite(p.log_prob(draws, torch.as_tensor(off[:1]),
                                     torch.as_tensor(y))).all()


def test_unported_priors_raise(models):
    """The options this test once saw raise now build, observation
    sharding (the last stan_args option to be ported) included; a
    negative shard count is the JAX package's bounds error."""
    d, df, rmf, pmf, rpm, ppm, U, off, y = models
    from stan4bart_torch.models import priors

    for args in ({"prior": priors.laplace()}, {"qr": True},
                 {"centered_ranef": True}, {"sigma_gibbs": True},
                 {"obs_shards": 2}):
        pm, _, _ = port_pm(pmf, "gaussian", args, device="cpu")
        assert pm.num_upars > 0 and pm.obs_axis is None
    with pytest.raises(ValueError, match="obs_shards must be >= 0"):
        port_pm(pmf, "gaussian", {"obs_shards": -1}, device="cpu")
