"""The port's QR rotation and centered random effects against the JAX
package's, in float64.

QR: the same R_inv and rotated X, the same un-rotation of stored draws,
the single-predictor raise, and a resume that un-rotates only its fresh
draws (never the stored ones twice), across save / load.  Centered: the
MVN prior on b, the log-density under centered x {decov, lkj}, the
conjugate linear refresh and the level interweave given the same
normals.  Tolerance: 1e-9 relative (the same arithmetic, sums taken in
another order)."""

import os
import tempfile
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.stats import multivariate_normal, norm

import stan4bart_torch
from stan4bart_torch.convert import nuts_state_from_numpy
from stan4bart_torch.formula import build_model_frame as port_mf
from stan4bart_torch.gibbs import GibbsProgram as PortProgram
from stan4bart_torch.models import priors as pp
from stan4bart_torch.models.assemble import build_parametric_model as port_pm
from stan4bart_torch.ops.bart import BartConfig as PortBartConfig
from stan4bart_torch.ops.bart import predict_trees, sample_trees_from_prior
from stan4bart_tpu.formula import build_model_frame as ref_mf
from stan4bart_tpu.gibbs import GibbsProgram as RefProgram
from stan4bart_tpu.models import priors as rp
from stan4bart_tpu.models.assemble import build_parametric_model as ref_pm
from stan4bart_tpu.ops import bart as jb
from stan4bart_tpu.ops.nuts import nuts_init
from stan4bart_tpu.results import Stan4bartFit as RefFit
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
def frames():
    d = generate_friedman_data(120, ranef=True, causal=True)
    df = friedman_dataframe(d)
    rng = np.random.default_rng(0)
    off = d["mu_bart"][None] + rng.normal(scale=0.5, size=(C, 120))
    return d, df, ref_mf(FLAGSHIP, df), port_mf(FLAGSHIP, df), off


def test_qr_rotation_matches(frames):
    d, df, rmf, pmf, off = frames
    r, _, rinfo = ref_pm(rmf, "gaussian", {"qr": True})
    p, _, pinfo = port_pm(pmf, "gaussian", {"qr": True}, device="cpu")
    np.testing.assert_allclose(rinfo["R_inv"], pinfo["R_inv"], **TOL)
    np.testing.assert_allclose(np.asarray(r.X), p.X.numpy(), **TOL)
    # the rotation is X_qr = X R_inv
    np.testing.assert_allclose(np.asarray(pmf.X) @ pinfo["R_inv"],
                               p.X.numpy(), rtol=1e-9, atol=1e-9)
    # the un-rotation of the same stored draws
    names = p.constrained_names()
    stan_names = ["lp__"] + names
    stan = np.random.default_rng(1).normal(size=(2, 4, len(stan_names)))
    ns = types.SimpleNamespace(
        _name_idx={n: i for i, n in enumerate(stan_names)},
        mf=rmf, R_inv=rinfo["R_inv"], _np_set=RefFit._np_set)
    ref_un = RefFit._unrotate_stan(ns, stan)
    from stan4bart_torch.results import Stan4bartFit as PortFit
    ns_p = types.SimpleNamespace(_name_idx=ns._name_idx, mf=pmf,
                                 R_inv=pinfo["R_inv"])
    port_un = PortFit._unrotate_stan(ns_p, stan)
    np.testing.assert_allclose(ref_un, port_un, **TOL)
    assert not np.array_equal(port_un, stan)


def test_qr_single_predictor_rejected():
    df = friedman_dataframe(generate_friedman_data(60))
    with pytest.raises(ValueError, match="multiple predictors"):
        stan4bart_torch.stan4bart("y ~ bart(X1 + X2) + X4", df, chains=1,
                                  iter=10, verbose=-1, device="cpu",
                                  stan_args={"qr": True})


def _beta_qr(fit, q):
    """The rotated coefficients of unconstrained q in the original
    coordinates, beta = R_inv beta_qr (X beta = X_qr beta_qr)."""
    c, _ = fit.pm.layout.constrain(q)
    beta = fit.pm.transformed(c, q.shape[0])["beta"].double().numpy()
    return beta @ fit.R_inv.T


def test_qr_resume_unrotates_once():
    """The last stored beta row is R_inv times the final state's rotated
    coefficients, before and after continue_sampling and across
    save / load: a resume un-rotates only its fresh draws."""
    df = friedman_dataframe(generate_friedman_data(100, ranef=True,
                                                   causal=True))
    fit = stan4bart_torch.stan4bart(
        "y ~ bart(. - g.1 - g.2 - X4 - z) + X4 + z + (1 | g.1)", df,
        chains=2, iter=12, warmup=6, seed=2, verbose=-1, device="cpu",
        dtype=torch.float64, bart_args={"n.trees": 5},
        stan_args={"qr": True, "max_treedepth": 4})
    assert fit.qr_unrotated and fit.R_inv is not None
    bi = [fit._name_idx[f"beta.{j + 1}"] for j in range(fit.mf.K)]
    np.testing.assert_allclose(fit.draws.stan[:, -1, bi],
                               _beta_qr(fit, fit.final_states.nuts.q),
                               **TOL)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "fit.pkl")
        fit.save(path)
        back = stan4bart_torch.Stan4bartFit.load(path, device="cpu")
    assert back.qr_unrotated
    np.testing.assert_array_equal(back.draws.stan, fit.draws.stan)
    for f in (fit, back):
        more = f.continue_sampling(4)
        # the stored draws are kept as they were
        np.testing.assert_array_equal(more.draws.stan[:, :12],
                                      fit.draws.stan)
        np.testing.assert_allclose(more.draws.stan[:, -1, bi],
                                   _beta_qr(more, more.final_states.nuts.q),
                                   **TOL)
        assert more.qr_unrotated


def test_centered_b_lpdf_exact():
    """The MVN(0, T T') prior on centered b against scipy, as the JAX
    package's tests/test_centered.py holds its own, for a 2-coefficient
    and a 1-coefficient term, two chains at once."""
    d = generate_friedman_data(4)
    mf = port_mf("y ~ bart(X1 + X2) + X4", friedman_dataframe(d))
    p, _, _ = port_pm(mf, "gaussian", {}, device="cpu")
    from stan4bart_torch.models.parametric import ParametricConfig
    p.cfg = ParametricConfig(N=4, K=0, is_binary=False, has_weights=False,
                             prior_dist=0, prior_dist_for_aux=3, t=2,
                             p=(2, 1), l=(3, 4), centered=True)
    rng = np.random.default_rng(0)
    theta_L = np.array([[1.5, 0.4, 0.9, 2.0], [0.7, -0.2, 1.1, 0.5]])
    b = rng.normal(size=(2, 10))
    lp = p._centered_b_lpdf(torch.as_tensor(b), torch.as_tensor(theta_L))
    for ci in range(2):
        T1 = np.array([[theta_L[ci, 0], 0.0], [theta_L[ci, 1],
                                               theta_L[ci, 2]]])
        expected = sum(
            multivariate_normal.logpdf(b[ci, 2 * j: 2 * j + 2], np.zeros(2),
                                       T1 @ T1.T) for j in range(3)
        ) + norm.logpdf(b[ci, 6:], 0, abs(theta_L[ci, 3])).sum()
        assert float(lp[ci]) == pytest.approx(expected, rel=1e-12)


@pytest.mark.parametrize("cov", ["decov", "lkj"])
def test_centered_log_prob_and_linear_refresh_match(frames, cov):
    d, df, rmf, pmf, off = frames
    y = np.asarray(rmf.y)

    def args(m):
        a = {"centered_ranef": True}
        if cov == "lkj":
            a["prior_covariance"] = m.lkj(regularization=2.0, df=3.0)
        return a

    r, _, _ = ref_pm(rmf, "gaussian", args(rp))
    p, _, _ = port_pm(pmf, "gaussian", args(pp), device="cpu")
    assert p.cfg.centered and "b_raw" in p.layout.slices
    assert r.layout.slices == p.layout.slices
    assert r.constrained_names() == p.constrained_names()
    U = np.random.default_rng(3).uniform(-1, 1, size=(C, r.num_upars))
    ref_lp, ref_g = jax.jit(jax.vmap(jax.value_and_grad(
        lambda u, o: r.log_prob(u, o, jnp.asarray(y)))))(
            jnp.asarray(U), jnp.asarray(off))
    u = torch.tensor(U, requires_grad=True)
    lp = p.log_prob(u, torch.as_tensor(off), torch.as_tensor(y))
    (g,) = torch.autograd.grad(lp.sum(), u)
    np.testing.assert_allclose(np.asarray(ref_lp), lp.detach().numpy(),
                               **TOL)
    np.testing.assert_allclose(np.asarray(ref_g), g.numpy(), **TOL)
    np.testing.assert_allclose(np.asarray(r.initial_inv_mass(1.7, 120)),
                               p.initial_inv_mass(1.7, 120), **TOL)
    # the Gram-compressed form of the same posterior
    assert p.enable_gram()
    anchor = p.gram_anchor(torch.as_tensor(0.9 * U), torch.as_tensor(off),
                           torch.as_tensor(y))
    np.testing.assert_allclose(
        p.log_prob_gram(torch.as_tensor(U), anchor).numpy(),
        lp.detach().numpy(), rtol=1e-9)
    # the conjugate refresh given the same normals, written back into b
    assert r.enable_linear_gibbs() and p.enable_linear_gibbs()
    D = p.gram_G.shape[0]
    keys = jax.random.split(jax.random.PRNGKey(0), C)
    z = np.array(jax.vmap(lambda k: jax.random.normal(k, (D,),
                                                      jnp.float64))(keys))
    ref = np.asarray(jax.jit(jax.vmap(
        lambda uu, o, k: r.linear_gibbs_refresh(uu, o, jnp.asarray(y), k)))(
            jnp.asarray(U), jnp.asarray(off), keys))
    port = p.linear_gibbs_refresh(torch.as_tensor(U), torch.as_tensor(off),
                                  torch.as_tensor(y), z=torch.as_tensor(z))
    np.testing.assert_allclose(ref, port.numpy(), **TOL)
    with pytest.raises(NotImplementedError, match="centered"):
        p.prior_draw_unconstrained(np.random.default_rng(0))


def test_centered_level_gibbs_matches_given_normals(frames):
    """The level interweave's write-back into centered b, one chain at a
    time in the reference, all chains at once in the port."""
    d, df, rmf, pmf, off = frames
    y = np.asarray(rmf.y)
    T = 5
    r, _, _ = ref_pm(rmf, "gaussian", {"centered_ranef": True})
    p, _, _ = port_pm(pmf, "gaussian", {"centered_ranef": True},
                      device="cpu")
    rprog = RefProgram(r, jb.BartConfig(num_trees=T, max_depth=3), y,
                       rmf.bart_X, warmup=10, iterations=10)
    pprog = PortProgram(p, PortBartConfig(num_trees=T, max_depth=3), y,
                        pmf.bart_X, warmup=10, iterations=10,
                        dtype=torch.float64, device="cpu")
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
    U = np.random.default_rng(5).uniform(-1, 1, size=(C, r.num_upars))
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


@pytest.mark.parametrize("step_fn", ["step_batched", "step"])
def test_tiny_fit_qr_centered_lkj(step_fn):
    """A tiny fit with qr, centered ranef and lkj through step_batched
    and step: finite draws, the flags set, the interweave pair on, fits
    equal forests."""
    df = friedman_dataframe(generate_friedman_data(100, ranef=True,
                                                   causal=True))
    kw = ({"callback": lambda d: {"s": d["aux.1"]}}
          if step_fn == "step" else {})
    fit = stan4bart_torch.stan4bart(
        FLAGSHIP, df, chains=2, iter=12, warmup=6, seed=3, verbose=-1,
        device="cpu", bart_args={"n.trees": 5, "keep_trees": True},
        stan_args={"qr": True, "centered_ranef": True, "max_treedepth": 4,
                   "prior_covariance": pp.lkj()}, **kw)
    assert fit.pm.cfg.centered and fit.pm.cfg.cov_prior == 1
    assert fit.R_inv is not None and fit.qr_unrotated
    assert fit.prog.linear_gibbs and fit.prog.level_gibbs
    assert fit.per_chain == (step_fn == "step")
    assert np.all(np.isfinite(fit.draws.stan))
    S = fit.extract("Sigma")["g.1"].mean(-1)
    assert np.all(np.linalg.eigvalsh(S) > 0)
    assert np.abs(fit.predict(df, type="indiv.bart")
                  - fit.extract("indiv.bart")).max() == 0.0


def _failing_chain_zero(monkeypatch):
    """cholesky_ex as torch computes it, but reporting chain 0's
    factorization as failed (as float32 does for a near-singular
    theta_L block)."""
    real = torch.linalg.cholesky_ex

    def fake(A, **kw):
        L, info = real(A, **kw)
        info = info.clone()
        info[0] = 1
        return L, info

    monkeypatch.setattr(torch.linalg, "cholesky_ex", fake)


@pytest.mark.parametrize("centered", [False, True])
def test_linear_refresh_keeps_a_chain_that_does_not_factor(
        frames, monkeypatch, centered):
    """A chain whose precision Q does not factor keeps its coefficients;
    the other chains draw as before."""
    d, df, rmf, pmf, off = frames
    y = torch.as_tensor(np.asarray(rmf.y))
    p, _, _ = port_pm(pmf, "gaussian", {"centered_ranef": centered},
                      device="cpu")
    assert p.enable_linear_gibbs()
    U = torch.as_tensor(np.random.default_rng(6).uniform(
        -1, 1, size=(C, p.num_upars)))
    z = torch.as_tensor(np.random.default_rng(7).normal(
        size=(C, p.gram_G.shape[0])))
    full = p.linear_gibbs_refresh(U, torch.as_tensor(off), y, z=z)
    _failing_chain_zero(monkeypatch)
    kept = p.linear_gibbs_refresh(U, torch.as_tensor(off), y, z=z)
    assert torch.equal(kept[0], U[0])
    assert torch.equal(kept[1:], full[1:])
    assert not torch.equal(full[0], U[0])


def test_float32_linear_refresh_with_a_wide_ranef_prior(frames):
    """At a state whose lkj sds are about 1.6e5 the ranef prior's
    precision is below float32 rounding of the Gram matrix, whose
    crossed intercept columns are collinear; the refresh forms and
    factors its system in float64, so a float32 model draws the same
    identified fitted mean as the float64 one given the same normals.
    Tolerance: b reaches about 4e4 there, about 3e-3 of float32
    rounding per coefficient."""
    d, df, rmf, pmf, off = frames
    y = np.asarray(rmf.y)
    args = {"centered_ranef": True, "prior_covariance": pp.lkj()}
    rng = np.random.default_rng(0)
    models = {dt: port_pm(pmf, "gaussian", dict(args), dtype=dt,
                          device="cpu")[0]
              for dt in (torch.float32, torch.float64)}
    p64 = models[torch.float64]
    for p in models.values():
        assert p.enable_linear_gibbs()
    U = rng.uniform(-1, 1, size=(C, p64.num_upars))
    o, s = p64.layout.slices["sds"][:2]
    U[:, o: o + s] = 12.0
    z = rng.normal(size=(C, p64.gram_G.shape[0]))
    eta = {}
    for dt, p in models.items():
        T_ = lambda a: torch.as_tensor(a, dtype=dt)  # noqa: E731
        new = p.linear_gibbs_refresh(T_(U), T_(off), T_(y), z=T_(z))
        assert torch.isfinite(new).all()
        assert (new.double().numpy() != U).any(1).all()
        c, _ = p.layout.constrain(new)
        eta[dt] = p.parametric_mean(
            c, p.transformed(c, new.shape[0])).double().numpy()
    np.testing.assert_allclose(eta[torch.float32], eta[torch.float64],
                               rtol=0, atol=0.05)


def test_float32_level_interweave_with_a_wide_ranef_prior(frames):
    """The level interweave at the same wide-prior state: its system is
    formed and factored in float64, so a float32 program moves the
    identified total (BART fit plus parametric mean) as the float64 one
    does given the same normals."""
    d, df, rmf, pmf, off = frames
    y = np.asarray(rmf.y)
    args = {"centered_ranef": True, "prior_covariance": pp.lkj()}
    T = 5
    rng = np.random.default_rng(1)
    total = {}
    for dt in (torch.float32, torch.float64):
        p = port_pm(pmf, "gaussian", dict(args), dtype=dt, device="cpu")[0]
        prog = PortProgram(p, PortBartConfig(num_trees=T, max_depth=3), y,
                           pmf.bart_X, warmup=10, iterations=10, dtype=dt,
                           device="cpu")
        assert prog.level_gibbs
        if not total:
            U = rng.uniform(-1, 1, size=(C, p.num_upars))
            o, s = p.layout.slices["sds"][:2]
            U[:, o: o + s] = 12.0
            z = rng.normal(size=(C, T + len(prog._level_terms)))
        if dt == torch.float32:
            # one forest for both programs, drawn in float64
            gen = torch.Generator()
            gen.manual_seed(4)
            f64 = sample_trees_from_prior(prog.bart_cfg, gen, prog.ranks,
                                          prog.split_probs, C)
            lv = torch.where(f64.feature == jb.LEAF, torch.randn(
                f64.leaf_value.shape, generator=gen,
                dtype=torch.float64), 0.0)
            tf = torch.gather(lv, 2, f64.leaf_idx.long())
            f64 = f64._replace(
                leaf_value=lv, tree_fit=tf, allfit=tf.sum(1),
                sigma_mu=torch.full((C,), 0.3, dtype=torch.float64))
        forest = f64._replace(**{
            k: getattr(f64, k).to(dt) for k in (
                "leaf_value", "tree_fit", "allfit", "sigma_mu", "k")})
        nuts = nuts_state_from_numpy(
            jax.vmap(lambda u: nuts_init(None, u))(jnp.asarray(U)),
            device="cpu")
        nuts = nuts._replace(q=nuts.q.to(dt))
        pn, pb = prog._level_gibbs_update(
            nuts, forest, torch.as_tensor(off, dtype=dt),
            torch.zeros((C, rmf.N), dtype=dt), None,
            z=torch.as_tensor(z, dtype=dt))
        assert torch.isfinite(pn.q).all()
        c, _ = p.layout.constrain(pn.q)
        total[dt] = (pb.allfit + p.parametric_mean(c, p.transformed(c, C))
                     ).double().numpy()
    np.testing.assert_allclose(total[torch.float32], total[torch.float64],
                               rtol=0, atol=0.05)
